"""The port's hybrid RG-LRU family (``repro_torch/models/rglru.py``,
recurrentgemma-9b: two recurrent layers to one local-attention layer)
against the JAX reference, on the CPU at smoke size.

Weights come from the reference's ``init_params`` and are carried across
by ``torch_bridge``; the tenants' deltas are packed by the port
(``synth_tenants``, 128x spec) and carried back, so both packages apply
the same packed bytes; inputs are drawn from numpy seeds. The reference's
functions run under ``jax.jit``. Tolerances: f32 1e-4 and bf16 1e-3 on
logits (``tests/test_torch_model.py``); 1e-5 on the gates and the scan,
which the port computes with a doubling scan instead of the reference's
``associative_scan`` (another association order, f32 throughout);
compressible leaves and packed codes exactly. The engine cases mirror
``tests/test_serve_scheduler.py:389`` and ``tests/test_chunked_prefill.py:100``:
the port's ``ContinuousEngine`` token-equal to the reference's
``Engine.generate``, and mixed-tenant serving equal to each tenant alone.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrec  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402

from repro_torch.core.compress import is_compressible as t_is_compressible  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trec  # noqa: E402
from repro_torch.serve import ContinuousEngine, VirtualClock  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}
PIECE_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 decode after a prefill: the conv ring is stored in bf16, and an f32
# value that differs in its last bits between the packages can round to
# the neighbouring bf16 value. The largest gap read on three prompt seeds
# each of B=2 x 10 and B=1 x 9 tokens was 4.4e-3 on logits of magnitude
# 31-38 (most steps 1e-5 to 3e-4); the bound is 2.3x that reading.
RING_TOL = dict(atol=1e-2, rtol=1e-3)

j_init = jax.jit(jlm.init_params, static_argnums=0)
j_forward = jax.jit(jlm.forward, static_argnums=0, static_argnames="remat")
j_prefill = jax.jit(jlm.prefill, static_argnums=0)
j_decode = jax.jit(jlm.decode_step, static_argnums=0)
j_gates = jax.jit(jrec._gates)
j_scan = jax.jit(jrec.rglru_scan)


@functools.lru_cache(maxsize=None)
def _setup(dtype="bfloat16", n_tenants=2):
    """(cfg, jax params, [jax deltas], port params, [port deltas]): the
    reference's init at seed 0; the tenants packed by the port at the 128x
    spec and carried back, so both packages apply the same packed bytes."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype)
    base = j_init(cfg, jax.random.PRNGKey(0))
    tbase = br.params_to_port(base)
    td = [d for _, d, _ in synth_tenants(cfg, tbase, n_tenants, RATIO_SPECS[128], seed=0)]
    return cfg, base, [br.deltas_to_jax(d) for d in td], tbase, td


@functools.lru_cache(maxsize=None)
def _jax_engine():
    """The reference's Engine over the bf16 setup's tenants: its jitted
    prefill/decode serve the bf16 model cases too, at generate's shapes
    (B=1, max_seq 32), so they compile once per file."""
    cfg, base, jd, _, _ = _setup("bfloat16")
    ref = JEngine(cfg, base, max_seq=32)
    for i, d in enumerate(jd):
        ref.register_tenant(f"t{i}", d)
    return ref


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _check(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _gate_params(lru=24, seed=0):
    rng = np.random.default_rng(seed)
    p = {"a_gate_w": 0.1 * rng.standard_normal(lru), "a_gate_b": rng.standard_normal(lru),
         "i_gate_w": 0.1 * rng.standard_normal(lru), "i_gate_b": rng.standard_normal(lru),
         "a_param": rng.uniform(2.0, 6.0, lru)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# ---------------------------------------------------------------------------
# Gates and the scan
# ---------------------------------------------------------------------------
def test_gates_match_reference():
    jp, tp = _both(_gate_params())
    xb = np.random.default_rng(1).standard_normal((2, 7, 24)).astype(np.float32)
    wa, wb = j_gates(jnp.asarray(xb), jp)
    ta, tb = trec._gates(torch.from_numpy(xb), tp)
    _check(ta, wa, PIECE_TOL)
    _check(tb, wb, PIECE_TOL)


@pytest.mark.parametrize("S", [5, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(S, with_h0):
    """The doubling scan against ``associative_scan`` at lengths between
    and past powers of two, from zero and from a carried state; and
    against the recurrence taken one step at a time."""
    jp, tp = _both(_gate_params(seed=S))
    rng = np.random.default_rng(S + 10)
    xb = rng.standard_normal((2, S, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if with_h0 else None
    wh, wl = j_scan(jnp.asarray(xb), jp, None if h0 is None else jnp.asarray(h0))
    th, tl = trec.rglru_scan(torch.from_numpy(xb), tp,
                             None if h0 is None else torch.from_numpy(h0))
    _check(th, wh, PIECE_TOL)
    _check(tl, wl, PIECE_TOL)
    a, b = trec._gates(torch.from_numpy(xb), tp)
    h = torch.zeros(2, 24) if h0 is None else torch.from_numpy(h0)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(_np(tl), _np(h), **PIECE_TOL)


def test_scan_rows_are_independent():
    """A row's scan is the same bits whatever the other rows hold."""
    _, tp = _both(_gate_params())
    xb = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 12, 24))
                          .astype(np.float32))
    h, _ = trec.rglru_scan(xb, tp, None)
    other = xb.clone()
    other[1:] = torch.flip(other[1:], dims=[0]) * 2.0
    h2, _ = trec.rglru_scan(other, tp, None)
    assert torch.equal(h[0], h2[0])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype,with_deltas", [("float32", False), ("float32", True),
                                               ("bfloat16", True)])
def test_forward_logits_match_reference(dtype, with_deltas):
    """Full-sequence logits; bf16 runs the tenant only (one jit shape less,
    and the base path is the f32 case's)."""
    cfg, base, jd, tbase, td = _setup(dtype)
    toks = _tokens(cfg, 2, 12, 0)       # past the 8-token local window
    want = j_forward(cfg, base, {"tokens": jnp.asarray(toks)},
                     deltas=jd[0] if with_deltas else None)
    got = tlm.forward(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                      deltas=td[0] if with_deltas else None)
    _check(got, want, TOL[dtype])
    assert (_np(got).argmax(-1) == np.asarray(want).argmax(-1)).all()


def _fields(e):
    return e._asdict() if isinstance(e, tuple) else e


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill + 3 decode steps, with deltas and without (f32) or with
    (bf16, through the reference engine's own jits): logits, then every
    leaf of the RecState rows and the local-attention rings (bf16 decode
    within RING_TOL)."""
    cfg, base, jd, tbase, td = _setup(dtype)
    tol = TOL[dtype] if dtype == "float32" else RING_TOL
    if dtype == "float32":
        B, S, max_seq = 2, 10, 16
        runs = ((None, None), (jd[0], td[0]))

        def prefill(b, c, d):
            return j_prefill(cfg, base, b, c, deltas=d)

        def decode(c, t, p, d):
            return j_decode(cfg, base, c, t, p, deltas=d)
    else:   # the reference engine's own jits, at its generate's shapes
        ref = _jax_engine()
        B, S, max_seq = 1, 9, 32
        runs = ((ref.store.get("t0").deltas, td[0]),)

        def prefill(b, c, d):
            return ref._prefill(base, b, c, d)

        def decode(c, t, p, d):
            return ref._decode(base, c, t, p, d)
    toks = _tokens(cfg, B, S, 1)
    for d, tdd in runs:
        jc = jlm.init_cache(cfg, B, max_seq)
        jlog, jc = prefill({"tokens": jnp.asarray(toks)}, jc, d)
        tc = tlm.init_cache(cfg, B, max_seq, device="cpu")
        assert isinstance(tc[0], trec.RecState) and isinstance(tc[2], dict)
        tlog, tc = tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                               tc, deltas=tdd)
        _check(tlog, jlog, TOL[dtype])
        for t in range(3):
            nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
            jlog, jc = decode(jc, jnp.asarray(nxt), jnp.int32(S + t), d)
            tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(), S + t,
                                       deltas=tdd)
            _check(tlog, jlog, tol)
        for te, je in zip(tc, jc):
            want = _fields(je)
            for f, got in tlm.cache_fields(te).items():
                assert str(got.dtype).replace("torch.", "") == want[f].dtype.name, f
                _check(got, want[f], tol)


def test_chunk_from_a_carried_state_matches_reference():
    """Both packages start from the same random cache (RecState rows and
    full attention rings, through the cache converter) and consume one
    position-offset chunk."""
    cfg, base, jd, tbase, td = _setup("float32")
    rng = np.random.default_rng(5)
    jc = []
    for e in jlm.init_cache(cfg, 1, 32):
        if isinstance(e, tuple):
            jc.append(jrec.RecState(*(jnp.asarray(rng.standard_normal(c.shape)
                                                  .astype(np.float32)).astype(c.dtype)
                                      for c in e)))
        else:      # a full ring holding positions 12..19
            S_c = e["k"].shape[1]
            pos = 12 + np.arange(8)
            ring = np.full((1, S_c), -1, np.int32)
            ring[0, pos % S_c] = pos
            jc.append({k: jnp.asarray(rng.standard_normal(e[k].shape).astype(np.float32)
                                      ).astype(e[k].dtype) for k in ("k", "v")}
                      | {"pos": jnp.asarray(ring)})
    tc = br.cache_to_port(cfg, jc)
    toks = _tokens(cfg, 1, 4, 6)
    pos = (20 + np.arange(4, dtype=np.int32))[None]
    jlog, jc = jax.jit(jlm.prefill_chunk, static_argnums=0)(
        cfg, base, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, jc,
        deltas=jd[0])
    tlog, tc = tlm.prefill_chunk(cfg, tbase, {"tokens": torch.from_numpy(toks).long(),
                                              "positions": torch.from_numpy(pos).long()},
                                 tc, deltas=td[0])
    _check(tlog, jlog, TOL["float32"])
    for te, je in zip(tc, jc):
        want = _fields(je)
        for f, got in tlm.cache_fields(te).items():
            _check(got, want[f], TOL["float32"])


def test_compressible_set_and_codes_match_reference():
    """The compressible leaves of the full config equal the reference's
    ``is_compressible`` (the substring rule leaves conv_*, a_param and the
    norms dense). At full depth the 26 rec layers' stacked gate vectors are
    [26, 4096] and pass the rule's shape test, so both packages compress
    them (the block never applies them); at smoke depth they do not. A new
    leaf's packed codes equal the reference's given the reference's keys."""
    jspec = br.flatten_with_paths(jlm.param_specs(j_full(ARCH)))
    want = {p for p, leaf in jspec.items() if j_is_compressible(p, leaf)}
    got = {p for p, (shape, _) in tlm.param_shapes(j_full(ARCH)).items()
           if t_is_compressible(p, torch.empty(shape, device="meta"))}
    rec = {f"rec/{n}" for n in ("linear_x", "linear_y", "linear_out", "a_gate_w",
                                "a_gate_b", "i_gate_w", "i_gate_b")}
    dense = {f"attn/{n}" for n in ("wq", "wk", "wv", "wo")} | \
        {f"mlp/{n}" for n in ("wi", "wg", "wo")}
    assert got == want == rec | dense
    br.check_codes(_setup("bfloat16")[1], "rec/linear_x")


def test_full_depth_gate_stacks_refuse_the_128x_spec_in_both():
    """At full depth the [26, 4096] gate stacks are compressible in both
    packages, and no halving of h_g 16 that stays >= alpha 8 divides 26:
    both packages' group-size pick raises, so neither compresses a
    full-depth tenant at the 128x spec with them in the tree."""
    from repro.core.codecs import _pick_hg as j_pick_hg

    from repro_torch.core.codecs import _pick_hg as t_pick_hg
    spec = RATIO_SPECS[128]
    jspec = dataclasses.replace(br.JaxDeltaDQSpec(), **{
        k: getattr(spec, k) for k in ("alpha", "k_bits", "m", "h_g")})
    shape = tlm.param_shapes(j_full(ARCH))["rec/a_gate_w"][0]
    assert tuple(shape) == (26, 4096)
    for pick, sp in ((j_pick_hg, jspec), (t_pick_hg, spec)):
        with pytest.raises(ValueError, match="no halving of h_g=16 both divides h_in=26"):
            pick(26, sp)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
NAMES = ("t0", "t1", None)


def _stream(cfg):
    """(tenant, prompt): 9-token prompts (one jit shape for the
    reference's generate) give chunked prefill an exact 1-token tail chunk
    (4 + 4 + 1) and, with the new tokens, wrap the 8-token local rings."""
    rng = np.random.default_rng(60)
    return [(NAMES[i % 3], rng.integers(0, cfg.vocab, 9).astype(np.int32))
            for i in range(6)]


def _continuous(chunked, n_slots=3):
    cfg, base, jd, tbase, td = _setup("bfloat16")
    eng = ContinuousEngine(cfg, tbase, n_slots=n_slots, max_seq=32,
                           clock=VirtualClock(tick=1e-3), chunked_prefill=chunked,
                           chunk_size=4)
    for i, d in enumerate(td):
        eng.register_tenant(f"t{i}", d)
    return eng


def _serve(eng, stream, idx):
    hs = {i: eng.submit(stream[i][0], stream[i][1], max_new_tokens=4,
                        arrival=0.002 * i) for i in idx}
    eng.run()
    return {i: h.output() for i, h in hs.items()}


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    """The reference's Engine.generate on every tenant request of the
    stream, by index (one jit shape per distinct prompt length; the base
    requests are held by mixed == alone)."""
    cfg = _setup("bfloat16")[0]
    ref = _jax_engine()
    return {i: ref.generate(name, prompt[None], max_new_tokens=4)[0]
            for i, (name, prompt) in enumerate(_stream(cfg)) if name is not None}


@pytest.mark.parametrize("chunked", [False, True])
def test_continuous_matches_reference_generate(chunked):
    """Exact length buckets (whole-prompt) and exact tail chunks (chunked):
    every tenant request equals the reference's Engine.generate."""
    cfg = _setup("bfloat16")[0]
    eng = _continuous(chunked)
    assert eng.buckets.exact and not eng._chunk_pad
    stream = _stream(cfg)
    got = _serve(eng, stream, range(len(stream)))
    for i, want in _reference_tokens().items():
        np.testing.assert_array_equal(got[i], want, err_msg=f"request {i}")


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_equals_alone_bit_for_bit(chunked):
    """Each tenant's requests alone through a fresh engine of the same
    n_slots give the mixed stream's tokens; chunked admission resets the
    slot's RG-LRU state and ring, so no occupant leaks into the next."""
    cfg = _setup("bfloat16")[0]
    stream = _stream(cfg)
    mixed = _serve(_continuous(chunked), stream, range(len(stream)))
    for name in NAMES:
        idx = [i for i, (t, _) in enumerate(stream) if t == name]
        alone = _serve(_continuous(chunked), stream, idx)
        for i in idx:
            assert np.array_equal(alone[i], mixed[i]), (name, i)


def test_slot_cache_reset_and_insert_cover_every_leaf():
    """reset() zeroes every leaf of the row (conv ring, RG-LRU state,
    k/v) and marks its ring positions invalid; insert() copies every
    leaf of a batch-1 cache into the row."""
    eng = _continuous(True, n_slots=2)
    for e in eng.kv.cache:
        for t in tlm.cache_fields(e).values():
            t.fill_(1)
    eng.kv.reset(1)
    for e in eng.kv.cache:
        for k, t in tlm.cache_fields(e).items():
            assert bool((t[1] == (-1 if k == "pos" else 0)).all())
            assert bool((t[0] == 1).all())
    eng.kv.insert(0, tlm.cache_rows(eng.kv.cache, 1, 2))
    for e in eng.kv.cache:
        for t in tlm.cache_fields(e).values():
            assert torch.equal(t[0], t[1])
