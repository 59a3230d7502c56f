"""The port's SSM family (``repro_torch/models/ssm.py``, mamba2-370m) against
the JAX reference, on the CPU at smoke size.

Weights come from the reference's ``init_params`` and are carried across
by ``torch_bridge``; the tenants' deltas are packed by the port
(``synth_tenants``, 128x spec) and carried back, so both packages apply
the same packed bytes; inputs are drawn from numpy seeds. The reference's
functions run under ``jax.jit``. Tolerances: f32 1e-4 and bf16 1e-3 on
logits (``tests/test_torch_model.py``), 1e-5 on the SSD and conv pieces
(f32 throughout, only the order of the sums differs); compressible leaves
and packed codes exactly. The engine cases mirror
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
from repro.core import DeltaDQSpec  # noqa: E402
from repro.core.compress import is_compressible as j_is_compressible  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402

from repro_torch.core.compress import is_compressible as t_is_compressible  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import ContinuousEngine, VirtualClock  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "mamba2-370m"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}
PIECE_TOL = dict(atol=1e-5, rtol=1e-5)
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)

j_init = jax.jit(jlm.init_params, static_argnums=0)
j_forward = jax.jit(jlm.forward, static_argnums=0, static_argnames="remat")
j_prefill = jax.jit(jlm.prefill, static_argnums=0)
j_decode = jax.jit(jlm.decode_step, static_argnums=0)
j_ssd = jax.jit(jssm.ssd_chunked, static_argnums=5)
j_ssd_decode = jax.jit(jssm.ssd_decode)
j_conv = jax.jit(jlayers.depthwise_conv1d)


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


def _ssd_inputs(seed, b=2, s=32, h=4, p=8, g=1, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32) * 0.1
    A = -np.exp(rng.uniform(0.0, 2.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, st


# ---------------------------------------------------------------------------
# SSD and the conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_init):
    x, dt, A, B, C, st = _ssd_inputs(chunk)
    init = st if with_init else None
    wy, wst = j_ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                    None if init is None else jnp.asarray(init))
    ty, tst = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                               initial_state=None if init is None else torch.from_numpy(init))
    assert ty.dtype == torch.float32 and tst.dtype == torch.float32
    _check(ty, wy, PIECE_TOL)
    _check(tst, wst, PIECE_TOL)


def test_ssd_chunked_refuses_ragged_length():
    """S must be a multiple of the chunk in both packages
    (``repro/models/ssm.py:57-60``)."""
    x, dt, A, B, C, _ = _ssd_inputs(0, s=24)
    with pytest.raises(ValueError, match="multiple of chunk=16"):
        jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 16)
    with pytest.raises(ValueError, match="multiple of chunk=16"):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 16)


def test_ssd_decode_matches_reference_and_is_row_stable():
    """One decode step against the reference; and a row's result is the
    same bits whatever the other rows of the batch hold."""
    x, dt, _, B, C, st = _ssd_inputs(3, b=4, s=1)
    A = -np.exp(np.random.default_rng(4).uniform(0.0, 2.0, x.shape[2])).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], st)
    wy, wst = j_ssd_decode(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    ty, tst = tssm.ssd_decode(*targs)
    _check(ty, wy, PIECE_TOL)
    _check(tst, wst, PIECE_TOL)
    other = [a.clone() for a in targs]
    for i in (0, 1, 3, 5):           # every batched input but A
        other[i][1:] = torch.flip(other[i][1:], dims=[0]) + 1.0
    oy, ost = tssm.ssd_decode(*other)
    assert torch.equal(oy[0], ty[0]) and torch.equal(ost[0], tst[0])


@pytest.mark.parametrize("state", [None, "float32", "bfloat16"])
def test_depthwise_conv1d_matches_reference(state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    s = None if state is None else rng.standard_normal((2, 3, 24)).astype(np.float32)
    js = None if s is None else jnp.asarray(s).astype(state)
    wy, wst = j_conv(jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16), js)
    ts = None if s is None else br.array_to_port(js)
    ty, tst = tlayers.depthwise_conv1d(torch.from_numpy(x),
                                       br.array_to_port(jnp.asarray(w).astype(
                                           jnp.bfloat16)), ts)
    assert str(tst.dtype).replace("torch.", "") == wst.dtype.name
    _check(ty, wy, PIECE_TOL)
    _check(tst, wst, PIECE_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_deltas", [False, True])
def test_forward_logits_match_reference(dtype, with_deltas):
    cfg, base, jd, tbase, td = _setup(dtype)
    toks = _tokens(cfg, 2, 32, 0)       # two SSD chunks of 16
    want = j_forward(cfg, base, {"tokens": jnp.asarray(toks)},
                     deltas=jd[0] if with_deltas else None)
    got = tlm.forward(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                      deltas=td[0] if with_deltas else None)
    _check(got, want, TOL[dtype])
    assert (_np(got).argmax(-1) == np.asarray(want).argmax(-1)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill + 3 decode steps, with deltas and without (f32) or with
    (bf16, through the reference engine's own jits): logits, then every
    leaf of the carried SsmState."""
    cfg, base, jd, tbase, td = _setup(dtype)
    if dtype == "float32":
        B, S, max_seq = 2, 8, 16
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
        assert isinstance(tc[0], tssm.SsmState)
        tlog, tc = tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                               tc, deltas=tdd)
        _check(tlog, jlog, TOL[dtype])
        for t in range(3):
            nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)[:, None]
            jlog, jc = decode(jc, jnp.asarray(nxt), jnp.int32(S + t), d)
            tlog, tc = tlm.decode_step(cfg, tbase, tc, torch.from_numpy(nxt).long(), S + t,
                                       deltas=tdd)
            _check(tlog, jlog, TOL[dtype])
        for li in range(cfg.n_layers):
            for f in tssm.SsmState._fields:
                got, want = getattr(tc[li], f), getattr(jc[li], f)
                assert str(got.dtype).replace("torch.", "") == want.dtype.name, f
                _check(got, want, TOL[dtype])


def test_chunk_from_a_carried_state_matches_reference():
    """Both packages start from the same random SsmState (the cache
    converter) and consume one position-offset chunk."""
    cfg, base, jd, tbase, td = _setup("float32")
    rng = np.random.default_rng(5)
    jc = [jssm.SsmState(*(jnp.asarray(rng.standard_normal(c.shape).astype(np.float32))
                          .astype(c.dtype) for c in e))
          for e in jlm.init_cache(cfg, 1, 32)]
    tc = br.cache_to_port(cfg, jc)
    toks = _tokens(cfg, 1, 8, 6)
    pos = (20 + np.arange(8, dtype=np.int32))[None]
    jlog, jc = jax.jit(jlm.prefill_chunk, static_argnums=0)(
        cfg, base, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}, jc,
        deltas=jd[0])
    tlog, tc = tlm.prefill_chunk(cfg, tbase, {"tokens": torch.from_numpy(toks).long(),
                                              "positions": torch.from_numpy(pos).long()},
                                 tc, deltas=td[0])
    _check(tlog, jlog, TOL["float32"])
    for li in range(cfg.n_layers):
        _check(tc[li].state, jc[li].state, TOL["float32"])


def test_prefill_refuses_ragged_prompt():
    """A 24-token prompt is no multiple of min(chunk 16, 24): both
    packages raise."""
    cfg, base, _, tbase, _ = _setup("float32")
    toks = _tokens(cfg, 1, 24, 7)
    with pytest.raises(ValueError, match="multiple of chunk"):
        jlm.prefill(cfg, base, {"tokens": jnp.asarray(toks)}, jlm.init_cache(cfg, 1, 32))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tlm.prefill(cfg, tbase, {"tokens": torch.from_numpy(toks).long()},
                    tlm.init_cache(cfg, 1, 32, device="cpu"))


def test_compressible_set_and_codes_match_reference():
    """The compressible leaves of the full config equal the reference's
    ``is_compressible`` (the substring rule leaves conv_*, a_log, dt_bias,
    d_skip and the norms dense); a new leaf's packed codes equal the
    reference's given the reference's keys."""
    jspec = br.flatten_with_paths(jlm.param_specs(j_full(ARCH)))
    want = {p for p, leaf in jspec.items() if j_is_compressible(p, leaf)}
    got = {p for p, (shape, _) in tlm.param_shapes(j_full(ARCH)).items()
           if t_is_compressible(p, torch.empty(shape, device="meta"))}
    assert got == want == {f"ssm/{n}" for n in ("wz", "wx", "wbc", "wdt", "wout")}
    br.check_codes(_setup("bfloat16")[1], "ssm/wbc", SPEC)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
NAMES = ("t0", "t1", None)


def _stream(cfg):
    """(tenant, prompt) with prompt lengths that give chunked prefill
    exact tail chunks (6 = 4 + 2, 9 = 4 + 4 + 1)."""
    rng = np.random.default_rng(60)
    return [(NAMES[i % 3], rng.integers(0, cfg.vocab, L).astype(np.int32))
            for i, L in enumerate((6, 9, 6, 9, 6, 9))]


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
    slot's SSM state, so no occupant leaks into the next."""
    cfg = _setup("bfloat16")[0]
    stream = _stream(cfg)
    mixed = _serve(_continuous(chunked), stream, range(len(stream)))
    for name in NAMES:
        idx = [i for i, (t, _) in enumerate(stream) if t == name]
        alone = _serve(_continuous(chunked), stream, idx)
        for i in idx:
            assert np.array_equal(alone[i], mixed[i]), (name, i)


def test_chunked_admission_zeroes_the_previous_state():
    """reset() zeroes every leaf of the row (conv rings and SSD state)."""
    eng = _continuous(True, n_slots=2)
    for e in eng.kv.cache:
        for t in e:
            t.fill_(1.0)
    eng.kv.reset(1)
    for e in eng.kv.cache:
        for t in e:
            assert not t[1].any() and bool((t[0] == 1.0).all())
