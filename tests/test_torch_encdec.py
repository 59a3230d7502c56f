"""The port's encoder-decoder (seamless-m4t-medium) and VLM
(llama-3.2-vision-11b) families against the JAX reference, on the CPU at
smoke size.

Weights come from the reference's ``init_params`` (the vlm's and encdec's
cross gates set to 0.5 / 0.7, so the gated blocks contribute: their init
is 0) and are carried across by ``torch_bridge``, 0-d gate leaves
included; the tenants' deltas are packed by the port (``synth_tenants``,
128x spec) and carried back; ``enc_feats`` / ``image_embeds`` and tokens
are drawn from numpy seeds. The reference's functions run under
``jax.jit``. Tolerances: f32 1e-4 and bf16 1e-3 on logits
(``tests/test_torch_model.py``), except seamless in bf16 (ENC_BF16_TOL):
its encoder's residual stream is bf16 in both packages, and the two
frameworks round bf16 elementwise chains differently. Compressible leaves
and packed codes exactly; generated tokens exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.compress import is_compressible as j_is_compressible  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402

from repro_torch.core.compress import is_compressible as t_is_compressible  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, VirtualClock  # noqa: E402

import torch_bridge as br  # noqa: E402

ENCDEC, VLM = "seamless-m4t-medium", "llama-3.2-vision-11b"
ARCHS = [ENCDEC, VLM]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}
# seamless in bf16: the largest gap read (forward on three token seeds,
# with and without deltas) was 0.32 on logits of magnitude 40-52 (rel 8e-3),
# the bf16 encoder's memory differing by 1-2 ulp; the bound is 1.6x that
# reading.
ENC_BF16_TOL = dict(atol=0.5, rtol=1e-3)
ENC_LEN = 12

j_init = jax.jit(jlm.init_params, static_argnums=0)
j_forward = jax.jit(jlm.forward, static_argnums=0, static_argnames="remat")
j_prefill = jax.jit(jlm.prefill, static_argnums=0)
j_decode = jax.jit(jlm.decode_step, static_argnums=0)
j_encode = jax.jit(jlm.encode, static_argnums=0)


def _gated(base):
    """Nonzero cross gates (0-d leaves of the stacked cross blocks)."""
    base = dict(base)
    for k in ("cross", "dec_cross"):
        if k in base:
            base[k] = dict(base[k], gate_attn=base[k]["gate_attn"] + 0.5,
                           gate_mlp=base[k]["gate_mlp"] + 0.7)
    return base


@functools.lru_cache(maxsize=None)
def _setup(name, dtype="bfloat16"):
    """(cfg, jax params, [jax deltas], port params, [port deltas])."""
    cfg = dataclasses.replace(get_smoke_config(name), param_dtype=dtype)
    base = _gated(j_init(cfg, jax.random.PRNGKey(0)))
    tbase = br.params_to_port(base)
    td = [d for _, d, _ in synth_tenants(cfg, tbase, 2, RATIO_SPECS[128], seed=0)]
    return cfg, base, [br.deltas_to_jax(d) for d in td], tbase, td


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _check(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _tol(name, dtype):
    return ENC_BF16_TOL if (name, dtype) == (ENCDEC, "bfloat16") else TOL[dtype]


def _extra(cfg, B, seed):
    """The cross blocks' inputs: encoder frames or image embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_feats": rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)}
    return {"image_embeds": rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


def _batches(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = _extra(cfg, B, seed + 100)
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


# ---------------------------------------------------------------------------
# Cross attention and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [None, 30.0])
def test_cross_attention_matches_reference(cap):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    want = jax.jit(jlayers.cross_attention, static_argnums=3)(*map(jnp.asarray, (q, k, v)),
                                                              cap)
    got = tlayers.cross_attention(*map(torch.from_numpy, (q, k, v)), cap=cap)
    _check(got, want, dict(atol=1e-5, rtol=1e-5))


def test_encode_matches_reference():
    """The bidirectional encoder with the ``enc`` subtree of a tenant's
    deltas (the base encoder runs inside the f32 forward case)."""
    cfg, base, jd, tbase, td = _setup(ENCDEC, "float32")
    feats = _extra(cfg, 2, 4)["enc_feats"]
    want = j_encode(cfg, base, jnp.asarray(feats), jd[0])
    got = tlm.encode(cfg, tbase, torch.from_numpy(feats), td[0])
    _check(got, want, TOL["float32"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype,with_deltas", [
    (ENCDEC, "float32", False), (ENCDEC, "float32", True), (ENCDEC, "bfloat16", True),
    (VLM, "float32", False), (VLM, "float32", True)])
def test_forward_logits_match_reference(name, dtype, with_deltas):
    """Full-sequence logits; bf16 runs seamless's tenant only, whose
    encoder residual is the one in bf16 (the vlm's residual is f32 in both
    dtypes, as the dense configs' whose bf16 cases ``tests/test_torch_model.py``
    holds)."""
    cfg, base, jd, tbase, td = _setup(name, dtype)
    jb, tb = _batches(cfg, 2, 10, 0)
    want = j_forward(cfg, base, jb, deltas=jd[0] if with_deltas else None)
    got = tlm.forward(cfg, tbase, tb, deltas=td[0] if with_deltas else None)
    _check(got, want, _tol(name, dtype))
    assert (_np(got).argmax(-1) == np.asarray(want).argmax(-1)).all()


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name):
    """prefill (which fills the cross caches) + 3 decode steps reading
    them, with deltas and without (f32; bf16 is the forward case's); the
    cross caches hold what the reference's hold, dtype included."""
    cfg, base, jd, tbase, td = _setup(name, "float32")
    B, S, max_seq = 2, 6, 12
    jb, tb = _batches(cfg, B, S, 1)
    tol = TOL["float32"]
    enc_len = ENC_LEN if cfg.family == "encdec" else 0
    for d, tdd in ((None, None), (jd[0], td[0])):
        jc = jlm.init_cache(cfg, B, max_seq, enc_len=enc_len)
        jlog, jc = j_prefill(cfg, base, jb, jc, deltas=d)
        tc = tlm.init_cache(cfg, B, max_seq, enc_len, device="cpu")
        assert len(tc) == len(jc)
        tlog, tc = tlm.prefill(cfg, tbase, tb, tc, deltas=tdd)
        _check(tlog, jlog, tol)
        for t in range(3):
            nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
            jlog, jc = j_decode(cfg, base, jc, jnp.asarray(nxt), jnp.int32(S + t), deltas=d)
            tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(), S + t,
                                       deltas=tdd)
            _check(tlog, jlog, tol)
        for te, je in zip(tc[cfg.n_layers:], jc[cfg.n_layers:]):
            for f in ("k", "v"):
                assert str(te[f].dtype).replace("torch.", "") == je[f].dtype.name, f
                _check(te[f], je[f], tol)


@pytest.mark.parametrize("name", ARCHS)
def test_compressible_set_and_codes_match_reference(name):
    """The compressible leaves of the full config equal the reference's
    ``is_compressible`` (the 0-d gates, whose layer stacks are 1-D, and the
    norms stay dense); a cross site's packed codes equal the reference's
    given the reference's keys."""
    jspec = br.flatten_with_paths(jlm.param_specs(j_full(name)))
    want = {p for p, leaf in jspec.items() if j_is_compressible(p, leaf)}
    got = {p for p, (shape, _) in tlm.param_shapes(j_full(name)).items()
           if t_is_compressible(p, torch.empty(shape, device="meta"))}
    attn = {f"{n}" for n in ("wq", "wk", "wv", "wo")}
    stacks = ("attn", "cross") if name == VLM else ("attn", "enc/attn", "dec_cross")
    mlps = ("mlp",) if name == VLM else ("mlp", "enc/mlp")
    assert got == want == {f"{s}/{n}" for s in stacks for n in attn} | \
        {f"{m}/{n}" for m in mlps for n in ("wi", "wg", "wo")}
    br.check_codes(_setup(name)[1], "cross/wq" if name == VLM else "dec_cross/wk")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_generate_extra_inputs_matches_reference(name):
    """Engine.generate(extra_inputs=) for a tenant: the port's tokens equal
    the reference's, and the tenant's first logits differ from the base's
    (the cross sites' corrections included)."""
    cfg, base, jd, tbase, td = _setup(name)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    extra = _extra(cfg, 2, 8)
    ref = JEngine(cfg, base, max_seq=16)
    eng = Engine(cfg, tbase, max_seq=16)
    ref.register_tenant("t0", jd[0])
    eng.register_tenant("t0", td[0])
    want = ref.generate("t0", prompts, max_new_tokens=5, extra_inputs=extra)
    lg = {}
    for tenant in ("t0", None):
        lg[tenant] = []
        got = eng.generate(tenant, prompts, max_new_tokens=5, extra_inputs=extra,
                           logits_out=lg[tenant])
        assert got.shape == (2, 5)
        if tenant:
            np.testing.assert_array_equal(got, want)
    assert (lg["t0"][0] - lg[None][0]).abs().max().item() > 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_refusals_match_reference(name):
    """The continuous engine and chunked prefill refuse encdec/vlm with
    the reference's errors; serve_batch falls back to per-tenant grouping,
    which passes no encoder inputs and fails in both packages."""
    cfg, base, jd, tbase, td = _setup(name)
    msg = f"continuous batching does not support family='{cfg.family}'"
    with pytest.raises(ValueError, match=msg):
        JContinuousEngine(cfg, base, n_slots=2, max_seq=16)
    with pytest.raises(ValueError, match=msg):
        ContinuousEngine(cfg, tbase, n_slots=2, max_seq=16, clock=VirtualClock(tick=1e-3))
    chunk = {"tokens": np.zeros((1, 4), np.int32),
             "positions": np.arange(4, dtype=np.int32)[None]}
    msg = f"chunked prefill does not support family='{cfg.family}'"
    with pytest.raises(ValueError, match=msg):
        jlm.prefill_chunk(cfg, base, {k: jnp.asarray(v) for k, v in chunk.items()},
                          jlm.init_cache(cfg, 1, 16))
    with pytest.raises(ValueError, match=msg):
        tlm.prefill_chunk(cfg, tbase, {k: torch.from_numpy(v).long() for k, v in chunk.items()},
                          tlm.init_cache(cfg, 1, 16, device="cpu"))
    reqs = [("t0", np.arange(4, dtype=np.int32))]
    ref = JEngine(cfg, base, max_seq=16)
    eng = Engine(cfg, tbase, max_seq=16, clock=VirtualClock(tick=1e-3))
    ref.register_tenant("t0", jd[0])
    eng.register_tenant("t0", td[0])
    key = "enc_feats" if cfg.family == "encdec" else "image_embeds"
    with pytest.raises(KeyError, match=key):
        ref.serve_batch(reqs, max_new_tokens=2)
    with pytest.raises(KeyError, match=key):
        eng.serve_batch(reqs, max_new_tokens=2)
