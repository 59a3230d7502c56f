"""The port's continuous-batching engine (``repro_torch.serve.ContinuousEngine``).

* against the port's ``Engine.generate``: token-exact on a staggered
  multi-tenant stream, whole-prompt and chunked;
* against the JAX ``ContinuousEngine`` (f32 smoke config, same
  ``VirtualClock`` trace): equal tokens and an equal ``Metrics.report()``;
* mixed-tenant serving against each tenant's requests served alone at
  the same ``n_slots``: token-exact;
* ``prefill_chunk`` against the reference's, the parked-row restore of a
  chunked step, the slot KV cache, and mirrors of the reference's
  scheduler and chunked-prefill tests (``tests/test_serve_scheduler.py``,
  ``tests/test_chunked_prefill.py``).

Every engine runs on a ``VirtualClock`` and every draw is seeded. The
smoke configs run on the CPU, where the delta corrections take their
plain torch versions.
"""
import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import DeltaDQSpec, compress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousEngine,
    Engine,
    SlotKVCache,
    VirtualClock,
)
from repro_torch.serve.trace import Tracer, validate_chrome_trace  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "wizard-llama2-7b"
# gemma3's 5:1 local:global pattern: 8-token windows at smoke size, so the
# streams' longer prompts wrap the local rings (the *_windowed twins)
WINDOWED = "gemma3-1b"
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)
LENGTHS = (5, 9, 7, 12, 5, 9, 3, 7)
CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)   # f32, summation order only


@functools.lru_cache(maxsize=None)
def _fleet(arch=ARCH):
    """Port-native smoke fleet (bf16 weights): base + 3 tenants at 128x."""
    cfg = get_smoke_config(arch)
    base = lm.init_params(cfg, 0, device="cpu")
    return cfg, base, synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)


@functools.lru_cache(maxsize=None)
def _jax_fleet(arch=ARCH):
    """f32 smoke fleet made by the reference and carried across."""
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    base = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tenants = []
    for t in range(2):
        ft = jax.tree.map(
            lambda p, t=t: p + 0.02 * jax.random.normal(
                jax.random.PRNGKey(7 + t), p.shape, jnp.float32).astype(p.dtype)
            if p.ndim >= 2 else p, base)
        tenants.append((f"tenant{t}", compress(base, ft, SPEC)[0]))
    tcfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    port = [(n, br.deltas_to_port(d)) for n, d in tenants]
    return jcfg, base, tenants, tcfg, br.params_to_port(base), port


def _engine(n_slots=3, max_seq=32, arch=ARCH, **kw):
    cfg, base, fleet = _fleet(arch)
    eng = ContinuousEngine(cfg, base, n_slots=n_slots, max_seq=max_seq,
                           clock=VirtualClock(tick=1e-3), **kw)
    for name, d, rep in fleet:
        eng.register_tenant(name, d, rep)
    return eng


@functools.lru_cache(maxsize=None)
def _reference():
    cfg, base, fleet = _fleet()
    ref = Engine(cfg, base, max_seq=32)
    for name, d, rep in fleet:
        ref.register_tenant(name, d, rep)
    return ref


def _stream(vocab, lengths=LENGTHS, seed=9):
    """(tenant, prompt): tenants round-robin, every 4th request the base."""
    rng = np.random.default_rng(seed)
    return [(f"tenant{i % 3}" if i % 4 else None,
             rng.integers(0, vocab, L).astype(np.int32))
            for i, L in enumerate(lengths)]


def _serve(eng, stream, max_new=6, gap=0.002):
    handles = [eng.submit(t, p, max_new_tokens=max_new, arrival=gap * i)
               for i, (t, p) in enumerate(stream)]
    eng.run()
    return handles


# ---------------------------------------------------------------------------
# Token identity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_size", [None, 3, 8])
def test_continuous_matches_generate(chunk_size):
    """Staggered stream, base requests included, more requests than
    slots: every request equals ``Engine.generate`` of it alone, token
    for token (whole-prompt, and chunked at chunk sizes 3 and 8)."""
    kw = {} if chunk_size is None else dict(chunked_prefill=True,
                                            chunk_size=chunk_size)
    eng = _engine(**kw)
    stream = _stream(eng.cfg.vocab)
    handles = _serve(eng, stream)
    ref = _reference()
    for (tenant, prompt), r in zip(stream, handles):
        want = ref.generate(tenant, prompt[None], max_new_tokens=6)[0]
        np.testing.assert_array_equal(r.output(), want, err_msg=str(tenant))
    rep = eng.metrics.report()
    assert rep["prefills"] == len(LENGTHS)
    assert rep["total_tokens"] == 6 * len(LENGTHS)
    assert eng.kv.n_free == eng.n_slots and eng.sched.active_slots() == []
    if chunk_size is None:
        assert eng.prefill_shapes == {8, 16}


@pytest.mark.parametrize("chunked", [False, True])
def test_per_row_dispatch_matches_segments(chunked):
    """``slot_dispatch="per_row"`` (each row's delta gathered) gives the
    segments dispatch's tokens, and its steps are labelled per-row."""
    kw = dict(chunked_prefill=True, chunk_size=4) if chunked else {}
    stream = _stream(get_smoke_config(ARCH).vocab)
    outs = {}
    for mode in ("segments", "per_row"):
        eng = _engine(slot_dispatch=mode, **kw)
        outs[mode] = [r.output() for r in _serve(eng, stream, max_new=5)]
        paths = eng.metrics.report()["decode_paths"]
        assert list(paths) == [{"segments": "segments-torch+packed",
                                "per_row": "per-row-gather"}[mode]]
    for a, b in zip(outs["segments"], outs["per_row"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunked", [False, True])
def test_continuous_matches_jax_engine(chunked):
    """f32 smoke config, same VirtualClock trace: the port's engine and
    the reference's give the same tokens and the same metrics report
    (timings, steps, paths and the jit_trace count included)."""
    _check_matches_jax_engine(chunked, ARCH)


@pytest.mark.parametrize("chunked", [False, True])
def test_continuous_matches_jax_engine_windowed(chunked):
    """The same on gemma3-1b: 8-token local rings that the 9-12 token
    prompts wrap, in prefill and in decode, qk-norm, softcap and tied
    embeddings."""
    _check_matches_jax_engine(chunked, WINDOWED)


def _check_matches_jax_engine(chunked, arch):
    jcfg, jbase, jten, tcfg, tbase, tten = _jax_fleet(arch)
    kw = dict(n_slots=3, max_seq=32, chunked_prefill=chunked, chunk_size=4)
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=1e-3), **kw)
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **kw)
    for (name, jd), (_, td) in zip(jten, tten):
        jeng.register_tenant(name, jd)
        teng.register_tenant(name, td)
    stream = [(t if t != "tenant2" else "tenant0", p)
              for t, p in _stream(jcfg.vocab, lengths=(5, 9, 7, 12, 3, 10))]
    jh = _serve(jeng, stream, max_new=5)
    th = _serve(teng, stream, max_new=5)
    for (tenant, _), a, b in zip(stream, jh, th):
        np.testing.assert_array_equal(b.output(), a.output(), err_msg=str(tenant))
    assert teng.metrics.report() == br.xla_to_torch(jeng.metrics.report())
    assert teng.metrics.jit_traces == jeng.metrics.jit_traces > 0
    assert teng.prefill_shapes == jeng.prefill_shapes


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_stream_equals_tenants_alone(chunked):
    """Each tenant's requests (and the base's) served alone through the
    same engine, same n_slots and arrivals, give the mixed run's tokens:
    every row's arithmetic is independent of the other rows' tenants."""
    _check_mixed_equals_alone(chunked, ARCH)


@pytest.mark.parametrize("chunked", [False, True])
def test_mixed_stream_equals_tenants_alone_windowed(chunked):
    """The same on gemma3-1b, whose local rings the 9-12 token prompts
    wrap."""
    _check_mixed_equals_alone(chunked, WINDOWED)


def _check_mixed_equals_alone(chunked, arch):
    kw = dict(chunked_prefill=True, chunk_size=4) if chunked else {}
    eng = _engine(n_slots=4, arch=arch, **kw)
    stream = _stream(eng.cfg.vocab, lengths=(5, 9, 7, 12, 5, 9, 3, 7, 11, 4))
    mixed = [r.output() for r in _serve(eng, stream)]
    for tenant in (None, "tenant0", "tenant1", "tenant2"):
        eng.reset_metrics()
        idx = [i for i, (t, _) in enumerate(stream) if t == tenant]
        handles = [eng.submit(tenant, stream[i][1], max_new_tokens=6,
                              arrival=0.002 * i) for i in idx]
        eng.run()
        for i, r in zip(idx, handles):
            np.testing.assert_array_equal(r.output(), mixed[i], err_msg=str(tenant))


# ---------------------------------------------------------------------------
# Chunked prefill: the model function and the parked-row restore
# ---------------------------------------------------------------------------
def _ring(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def test_prefill_chunk_logits_match_jax():
    """A prompt of 11 tokens as chunks of 4 (the tail right-padded, pad
    writes dropped): each chunk's logits at its real positions equal the
    reference's within 1e-4 (f32), and so does the ring it leaves."""
    jcfg, jbase, jten, tcfg, tbase, tten = _jax_fleet()
    jd, td = jten[0][1], tten[0][1]
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, 11).astype(np.int32)
    jc = jlm.init_cache(jcfg, 1, 32)
    tc = lm.init_cache(tcfg, 1, 32, device="cpu")
    j_chunk = jax.jit(jlm.prefill_chunk, static_argnums=0)
    C = 4
    for start in range(0, len(prompt), C):
        n = min(C, len(prompt) - start)
        tok = np.zeros((1, C), np.int32)
        tok[0, :n] = prompt[start:start + n]
        pos = (start + np.arange(C, dtype=np.int32))[None]
        valid = np.arange(C)[None] < n
        jlog, jc = j_chunk(jcfg, jbase, {"tokens": jnp.asarray(tok),
                                         "positions": jnp.asarray(pos),
                                         "valid": jnp.asarray(valid)}, jc, deltas=jd)
        tlog, tc = lm.prefill_chunk(
            tcfg, tbase, {"tokens": torch.from_numpy(tok).long(),
                          "positions": torch.from_numpy(pos).long(),
                          "valid": torch.from_numpy(valid)}, tc, deltas=td)
        np.testing.assert_allclose(tlog[0, :n].numpy(), np.asarray(jlog)[0, :n],
                                   **CHUNK_TOL)
    for jl, tl in zip(jc, tc):
        np.testing.assert_array_equal(tl["pos"].numpy(), np.asarray(jl["pos"]))
        for k in ("k", "v"):
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), **CHUNK_TOL)


def test_chunked_ring_equals_whole_prompt_ring():
    """Chunks of 4 (pads included) leave the ring a whole-prompt prefill
    leaves: the same valid positions, pads never written, and K/V within
    1e-4 (f32; the chunks attend in another order)."""
    _check_chunked_ring(ARCH)


def test_chunked_ring_equals_whole_prompt_ring_windowed():
    """The same on gemma3-1b: the 10-token prompt wraps the 8-token local
    rings, so the chunks overwrite their own earliest entries (the ring
    save and restore at ``pos % S_c``) and must leave what whole-prompt
    prefill leaves."""
    _check_chunked_ring(WINDOWED)


def _check_chunked_ring(arch):
    _, _, _, tcfg, tbase, tten = _jax_fleet(arch)
    td = tten[1][1]
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(0, tcfg.vocab, 10)).long()[None]
    whole = lm.init_cache(tcfg, 1, 32, device="cpu")
    wlog, _ = lm.prefill(tcfg, tbase, {"tokens": prompt}, whole, deltas=td)
    chunked = lm.init_cache(tcfg, 1, 32, device="cpu")
    C = 4
    for start in range(0, 10, C):
        n = min(C, 10 - start)
        tok = torch.zeros((1, C), dtype=torch.long)
        tok[0, :n] = prompt[0, start:start + n]
        pos = (start + torch.arange(C))[None]
        clog, _ = lm.prefill_chunk(tcfg, tbase, {"tokens": tok, "positions": pos,
                                                 "valid": torch.arange(C)[None] < n},
                                   chunked, deltas=td)
    torch.testing.assert_close(clog[:, n - 1], wlog, **CHUNK_TOL)
    for w, c in zip(whole, chunked):
        assert torch.equal(c["pos"], w["pos"])
        assert (c["pos"][0, 10:] == -1).all()
        for k in ("k", "v"):
            torch.testing.assert_close(c[k], w[k], **CHUNK_TOL)


def test_parked_rows_bit_unchanged_by_chunked_step():
    """Rows that neither decode nor take this step's chunk (free, or
    waiting mid-prefill) keep their cache bit for bit across a chunked
    step, although the fixed-batch decode writes a ring entry in every
    row; the decoding and chunk rows do change."""
    eng = _engine(n_slots=4, chunked_prefill=True, chunk_size=4)
    vocab = eng.cfg.vocab
    rng = np.random.default_rng(5)
    for i, (tenant, L) in enumerate((("tenant0", 6), (None, 13), ("tenant1", 9))):
        eng.submit(tenant, rng.integers(0, vocab, L), max_new_tokens=4)
    eng.step(eng._now())                       # admits all three
    n_checked = 0
    while eng.sched.n_active:
        decode = {s for s in eng.sched.active_slots()
                  if not eng.sched.slots[s].prefilling}
        task = eng._chunks.next_task() if len(eng._chunks) else None
        moving = decode | ({task.slot} if task is not None else set())
        before = _ring(eng.kv.cache)
        eng.step(eng._now())
        for slot in range(eng.n_slots):
            same = all(torch.equal(b[k][slot], a[k][slot])
                       for b, a in zip(before, eng.kv.cache) for k in ("k", "v", "pos"))
            if slot in moving:
                assert not same, slot
            else:
                assert same, slot
                n_checked += 1
    assert n_checked >= 4


# ---------------------------------------------------------------------------
# SlotKVCache
# ---------------------------------------------------------------------------
def test_slot_kv_cache_claim_release_insert_reset():
    cfg, base, _ = _fleet()
    kv = SlotKVCache(cfg, 3, 16, device="cpu")
    assert kv.n_free == 3 and kv.occupancy == 0.0
    kv.claim(1)
    with pytest.raises(ValueError):
        kv.claim(1)
    assert kv.n_free == 2 and kv.occupancy == pytest.approx(1 / 3)
    row = lm.init_cache(cfg, 1, 16, device="cpu")
    lm.prefill(cfg, base, {"tokens": torch.arange(5)[None]}, row)
    kv.insert(1, row)
    for g, r in zip(kv.cache, row):
        for k in ("k", "v", "pos"):
            assert torch.equal(g[k][1], r[k][0])
            assert not g[k][0].any() if k != "pos" else (g[k][0] == -1).all()
    kv.reset(1)
    for g in kv.cache:
        assert not g["k"][1].any() and not g["v"][1].any()
        assert (g["pos"][1] == -1).all()
    kv.release(1)
    with pytest.raises(ValueError):
        kv.release(1)
    assert kv.n_free == 3
    # pools must split the slots evenly; a sharded cache needs its mesh rank
    with pytest.raises(ValueError):
        SlotKVCache(cfg, 3, 16, data_shards=2, device="cpu")
    with pytest.raises(ValueError):
        SlotKVCache(cfg, 4, 16, shardings=[], data_shards=2, device="cpu")


# ---------------------------------------------------------------------------
# Mirrors of the reference's engine tests
# ---------------------------------------------------------------------------
def test_stop_token_frees_slot_early():
    eng = _engine(n_slots=1)
    prompt = np.arange(5) % eng.cfg.vocab
    want = _reference().generate("tenant0", prompt[None], max_new_tokens=8)[0]
    stop = int(want[2])                           # force an early stop
    r1 = eng.submit("tenant0", prompt, max_new_tokens=8, stop_token=stop)
    r2 = eng.submit("tenant0", prompt, max_new_tokens=4)
    eng.run()
    assert r1.done and r1.tokens[-1] == stop and len(r1.tokens) <= 3
    assert r2.done and len(r2.tokens) == 4        # queued request still served


def test_eviction_never_drops_unfinished_randomized():
    """Slot pressure + seeded random lengths/budgets/arrivals, over
    several seeds: every request completes exactly as generate makes it;
    slots are recycled only after their sequence finishes."""
    ref = _reference()
    for seed in range(3):
        eng = _engine(n_slots=2)
        rs = np.random.RandomState(42 + seed)
        reqs = []
        for _ in range(8):
            L = int(rs.randint(3, 14))
            n_new = int(rs.randint(1, 8))
            prompt = rs.randint(0, eng.cfg.vocab, size=L)
            tenant = [None, "tenant0", "tenant1", "tenant2"][rs.randint(4)]
            reqs.append((tenant, prompt, n_new,
                         eng.submit(tenant, prompt, max_new_tokens=n_new,
                                    arrival=float(rs.rand() * 0.01))))
        eng.run()
        for tenant, prompt, n_new, r in reqs:
            assert r.done and len(r.tokens) == n_new
            want = ref.generate(tenant, prompt[None], max_new_tokens=n_new)[0]
            np.testing.assert_array_equal(r.output(), want)
        assert eng.kv.n_free == eng.n_slots
        assert eng.sched.active_slots() == []


def test_serve_batch_matches_generate():
    cfg, base, fleet = _fleet()
    eng = Engine(cfg, base, max_seq=32, clock=VirtualClock(tick=1e-3))
    for name, d, rep in fleet:
        eng.register_tenant(name, d, rep)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 6) for _ in range(4)]
    reqs = [("tenant0", prompts[0]), ("tenant1", prompts[1]),
            ("tenant0", prompts[2]), ("tenant2", prompts[3])]
    outs = eng.serve_batch(reqs, max_new_tokens=4)
    assert len(outs) == 4 and eng._cont is not None
    for (tenant, prompt), out in zip(reqs, outs):
        want = eng.generate(tenant, prompt[None], max_new_tokens=4)[0]
        np.testing.assert_array_equal(out, want)
    mem = eng.memory_report()
    assert mem["n_tenants"] == 3 and mem["delta_bytes_total"] == sum(
        eng.store.get(n).bytes() for n in eng.store.names())
    assert 0 < mem["bytes_vs_n_full_models"] < 1


def test_clamped_bucket_pad_overwrite_token_identical():
    """Non-pow2 max_seq: the bucket clamps to max_seq and decode reuses
    pad ring slots; output must still equal generate's, and overlong
    requests are still rejected."""
    cfg, base, fleet = _fleet()
    eng = ContinuousEngine(cfg, base, n_slots=1, max_seq=48,
                           clock=VirtualClock(tick=1e-3))
    ref = Engine(cfg, base, max_seq=48)
    eng.register_tenant("tenant0", fleet[0][1])
    ref.register_tenant("tenant0", fleet[0][1])
    prompt = np.arange(33) % cfg.vocab        # bucket 64 -> clamped to 48
    r = eng.submit("tenant0", prompt, max_new_tokens=5)
    eng.run()
    np.testing.assert_array_equal(
        r.output(), ref.generate("tenant0", prompt[None], max_new_tokens=5)[0])
    assert eng.prefill_shapes == {48}
    with pytest.raises(ValueError):
        eng.submit("tenant0", np.arange(45) % cfg.vocab, max_new_tokens=5)


def test_live_unregister_refuses_to_remap_inflight_rows():
    eng = _engine(n_slots=1)
    eng.submit("tenant1", np.arange(5) % eng.cfg.vocab, max_new_tokens=6)
    eng.step(0.0)                        # prefill + first decode, in flight
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.unregister_tenant("tenant1")
    eng.store.unregister("tenant0")      # would shift tenant1's row 2 -> 1
    with pytest.raises(RuntimeError, match="rows shifted"):
        eng.step(0.0)


def test_register_rejects_other_structure_and_packing():
    """A tree of another structure fails with ValueError and leaves the
    engine's tenants as they were; one of another packing (DeltaDQ at
    32x beside the 128x fleet) forms a second codec group and serves
    token-identically to an engine holding it alone; serve_batch still
    serves such a fleet as Engine.generate does."""
    cfg, base, fleet = _fleet()
    eng = _engine()
    bad = {k: dict(v) for k, v in fleet[0][1].items()}
    bad["attn"]["wq"] = None
    with pytest.raises(ValueError, match="structure"):
        eng.register_tenant("bad", bad)
    assert eng.store.names() == ["tenant0", "tenant1", "tenant2"]
    assert eng._rows == {"tenant0": 1, "tenant1": 2, "tenant2": 3}
    other = synth_tenants(cfg, base, 1, RATIO_SPECS[32], seed=5)[0][1]
    eng.register_tenant("other", other)
    assert eng._rows == {"tenant0": 1, "tenant1": 2, "tenant2": 3, "other": 4}
    assert [g.names for g in eng._groups] == [["tenant0", "tenant1", "tenant2"],
                                              ["other"]]
    assert eng._groups[1].lut.tolist() == [0, 0, 0, 0, 1]
    p = np.arange(6) % cfg.vocab
    got = eng.serve([("tenant1", p), ("other", p)], max_new_tokens=4)
    alone = ContinuousEngine(cfg, base, n_slots=3, max_seq=32,
                             clock=VirtualClock(tick=1e-3))
    alone.register_tenant("other", other)
    np.testing.assert_array_equal(got[1], alone.serve([("other", p)], max_new_tokens=4)[0])

    static = Engine(cfg, base, max_seq=32, clock=VirtualClock(tick=1e-3))
    static.register_tenant("tenant0", fleet[0][1])
    static.register_tenant("other", other)
    outs = static.serve_batch([("tenant0", p), ("other", p)], max_new_tokens=3)
    np.testing.assert_array_equal(
        outs[1], static.generate("other", p[None], max_new_tokens=3)[0])


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(data=3)])
def test_options_of_later_slices_raise(kw):
    """``mesh=`` and ``data=`` are served now: a mesh that is not a
    ``launch.mesh.ServingMesh``, and pools that do not split the slots
    evenly, still raise."""
    cfg, base, _ = _fleet()
    with pytest.raises((TypeError, ValueError)):
        ContinuousEngine(cfg, base, n_slots=2, max_seq=16, **kw)


def test_residency_budget_builds_the_tier():
    """``residency_budget_bytes=`` (a later slice's option until now)
    builds the DeltaResidency tier with the tenant stack: 1 MB holds every
    smoke row, and a CPU stack serves its decode steps from values."""
    eng = _engine(n_slots=2, max_seq=16, residency_budget_bytes=1 << 20)
    p = np.arange(6) % eng.cfg.vocab
    eng.serve([("tenant1", p)], max_new_tokens=3)
    r = eng.residency
    assert r is not None and r.enabled and r.capacity == r.n_rows == 4
    res = eng.metrics.report()["residency"]
    assert res["value_steps"] == 2 and res["packed_steps"] == 0
    assert res["capacity_rows"] == 4 and res["misses"] == 1


def test_chunk_size_validation():
    cfg, base, _ = _fleet()
    with pytest.raises(ValueError):
        ContinuousEngine(cfg, base, n_slots=2, max_seq=16,
                         chunked_prefill=True, chunk_size=0)
    with pytest.raises(ValueError):           # chunk can't exceed the ring
        ContinuousEngine(cfg, base, n_slots=2, max_seq=16,
                         chunked_prefill=True, chunk_size=17)
    with pytest.raises(ValueError):
        ContinuousEngine(cfg, base, n_slots=2, max_seq=16, slot_dispatch="bogus")


class _Recorder:
    def __init__(self):
        self.events = []

    def consume(self, ev):
        self.events.append(ev)


def _run_traced_chunked(chunk_size=4, tick=1e-3):
    cfg, base, fleet = _fleet()
    tracer = Tracer()
    rec = _Recorder()
    eng = ContinuousEngine(cfg, base, n_slots=2, max_seq=32,
                           clock=VirtualClock(tick=tick), trace=tracer,
                           chunked_prefill=True, chunk_size=chunk_size)
    eng.bus.attach(rec)
    eng.register_tenant("tenant0", fleet[0][1])
    lengths = (9, 5, 7, 11)
    for i, L in enumerate(lengths):
        eng.submit("tenant0" if i % 2 else None, np.arange(L) % cfg.vocab,
                   max_new_tokens=4, arrival=0.001 * i)
    eng.run()
    return tracer, rec, lengths, chunk_size


def test_chunked_trace_spans_and_no_starvation():
    tracer, rec, lengths, C = _run_traced_chunked()
    trace = tracer.to_chrome_trace()
    assert validate_chrome_trace(trace) == []
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"
             and e["name"] == "prefill_chunk"]
    assert len(spans) == sum(math.ceil(L / C) for L in lengths)
    # every step advances EVERY active decode row (no starvation)
    by_kind = {}
    for ev in rec.events:
        by_kind.setdefault(ev.kind, []).append(ev)
    tokens_at = {}
    for ev in by_kind.get("token", []):
        tokens_at[ev.t] = tokens_at.get(ev.t, 0) + 1
    for step in by_kind["step"]:
        lasts = sum(1 for e in by_kind.get("prefill_chunk", [])
                    if e.t == step.t and e.attrs["last"])
        want = step.attrs["n_active"] + lasts
        if want:
            assert tokens_at.get(step.t, 0) == want
    # chunk cursors tile each prompt contiguously
    cursors = {}
    for ev in by_kind["prefill_chunk"]:
        rid = ev.attrs["rid"]
        assert ev.attrs["start"] == cursors.get(rid, 0)
        cursors[rid] = ev.attrs["start"] + ev.attrs["length"]
    # one jit_trace per signature, on its first call only
    sigs = [ev.attrs["signature"] for ev in by_kind["jit_trace"]]
    assert len(sigs) == len(set(sigs)) and all(ev.attrs["first"]
                                               for ev in by_kind["jit_trace"])


def test_chunked_virtualclock_trace_byte_identical():
    t1, _, _, _ = _run_traced_chunked()
    t2, _, _, _ = _run_traced_chunked()
    assert json.dumps(t1.to_chrome_trace(), sort_keys=True) \
        == json.dumps(t2.to_chrome_trace(), sort_keys=True)


@pytest.mark.parametrize("chunked", [False, True])
def test_serve_cli_on_cpu(chunked, tmp_path, capsys):
    """``python -m repro_torch.launch.serve --device cpu``: the reference's
    stream (request i -> tenant i % 2, 4 + (i % 3) * 4 prompt tokens),
    every request served, a valid trace and a telemetry snapshot."""
    from repro_torch.launch import serve as cli
    argv = ["--device", "cpu", "--requests", "6", "--max-new", "4",
            "--trace-out", str(tmp_path / "t.json"),
            "--telemetry-snapshot-secs", "0.05",
            "--telemetry-out", str(tmp_path / "tel.json")]
    if chunked:
        argv += ["--chunked", "--chunk-size", "4"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 6 requests / 24 tokens" in out
    assert "trace: " in out and "telemetry: " in out
    snap = json.loads((tmp_path / "tel.json").read_text())
    assert snap["metrics"]["total_tokens"] == 24 and "slo" in snap
    stream = cli.request_stream(get_smoke_config("llama3.2-1b"), 6, 2)
    assert [(t, len(p)) for t, p in stream] == [
        ("tenant0", 4), ("tenant1", 8), ("tenant0", 12),
        ("tenant1", 4), ("tenant0", 8), ("tenant1", 12)]
