"""The port's online tenant lifecycle: the tenant table (hot registration,
rollout, retire), the :class:`DeltaRegistry` and its tiers, and the
retrace accounting — mirrors of ``tests/test_tenant_lifecycle.py`` plus
``Metrics.report()`` against the JAX engine on one ``VirtualClock``
trace.

* a tenant hot-registered into a running table-mode engine writes a row
  in place: no re-stack, no new decode signature, and every request is
  token-identical to an engine that held all tenants up front;
* a rollout serves the new version to new requests only; in-flight
  sequences drain on the old row, which is then cleared and freed;
* the registry's cold tiers round-trip, and a spool file written by
  either package loads in the other (bf16 as raw bits, no ml_dtypes);
* a mid-run registration retraces the reference's decode step once on
  the dynamic path (the stack's leading dimension changes) and never on
  the table path — the port's ``jit_trace`` count and the whole report
  equal the reference's.

Port-only mirrors run the bf16 llama3.2-1b smoke config; comparisons
with the JAX engine run it in f32. Every engine runs on a VirtualClock
and every draw is seeded.
"""
import dataclasses
import functools
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import DeltaDQSpec as JSpec  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402
from repro.serve.registry import _load_npz as j_load_npz  # noqa: E402
from repro.serve.registry import _save_npz as j_save_npz  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.codecs import BitDeltaSpec, DeltaDQSpec, runtime_delta_tree  # noqa: E402
from repro_torch.core.compress import compress  # noqa: E402
from repro_torch.launch.serve import synth_ft  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousEngine,
    DeltaRegistry,
    DeltaStore,
    SlotKVCache,
    TenantTable,
    VirtualClock,
)
from repro_torch.serve.registry import _load_npz, _save_npz  # noqa: E402
from repro_torch.serve.trace import Tracer, validate_chrome_trace  # noqa: E402
from repro_torch.utils import iter_leaves  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "llama3.2-1b"
SPEC = DeltaDQSpec(alpha=2.0, k_bits=8, h_g=32)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_smoke_config(ARCH)
    base = lm.init_params(cfg, 0, device="cpu")
    tenants = [compress(base, _ft_of(base, t), SPEC)[0] for t in range(4)]
    return cfg, base, tenants


def _ft_of(base, t):
    return synth_ft(base, 7 + t, noise=0.05)


def _prompts(cfg, n, length=8):
    rs = np.random.RandomState(0)
    return [rs.randint(0, cfg.vocab, size=length) for _ in range(n)]


def _engine(cfg, base, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("clock", VirtualClock(0.0))
    return ContinuousEngine(cfg, base, **kw)


def _decode_keys(eng):
    return eng._decode.keys | eng._decode_masked.keys | eng._combined.keys


# ---------------------------------------------------------------------------
# The tenant table
# ---------------------------------------------------------------------------
def test_hot_register_no_retrace_token_identical():
    """Register tenant N+1 mid-traffic: a row write (no re-stack, no new
    decode signature), and both in-flight and new-tenant tokens match an
    all-up-front engine."""
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 3)
    ref = _engine(cfg, base, tenant_capacity=4)
    for i, d in enumerate(tenants[:3]):
        ref.register_tenant(f"t{i}", d)
    ref_reqs = [ref.submit(f"t{i}", prompts[i], max_new_tokens=6) for i in range(3)]
    ref.run()

    eng = _engine(cfg, base, tenant_capacity=4)
    for i, d in enumerate(tenants[:2]):
        eng.register_tenant(f"t{i}", d)
    r0 = eng.submit("t0", prompts[0], max_new_tokens=6)
    r1 = eng.submit("t1", prompts[1], max_new_tokens=6)
    for _ in range(3):
        eng.step(eng._now())
    traces, keys = eng.decode_traces, _decode_keys(eng)
    eng.register_tenant("t2", tenants[2])          # HOT, mid-traffic
    r2 = eng.submit("t2", prompts[2], max_new_tokens=6)
    eng.run()
    assert eng.decode_traces == traces == 1 and _decode_keys(eng) == keys
    assert eng.restacks == 0
    for r, want in zip((r0, r1, r2), ref_reqs):
        assert list(r.tokens) == list(want.tokens)


def test_table_seeded_from_prepopulated_store():
    """Tenants registered before the first step serve identically to
    tenants hot-registered after it, and an engine built over a
    pre-populated store seeds its table in registration order."""
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 2)
    a = _engine(cfg, base, tenant_capacity=3)
    a.register_tenant("t0", tenants[0])
    ra = a.submit("t0", prompts[0], max_new_tokens=5)
    a.run()
    b = _engine(cfg, base, tenant_capacity=3)
    b.step(b._now())                    # engine already running
    b.register_tenant("t0", tenants[0])
    rb = b.submit("t0", prompts[0], max_new_tokens=5)
    b.run()
    assert list(ra.tokens) == list(rb.tokens)

    store = DeltaStore()
    store.register("t1", tenants[1])
    store.register("t0", tenants[0])
    c = _engine(cfg, base, tenant_capacity=3, store=store)
    assert c._rows == {"t1": 1, "t0": 2} and c._table.n_free == 1
    rc = c.submit("t0", prompts[0], max_new_tokens=5)
    c.run()
    assert list(rc.tokens) == list(ra.tokens)
    with pytest.raises(ValueError, match="tenant_capacity"):
        _engine(cfg, base, tenant_capacity=1, store=store)


def test_rollout_old_version_drains_new_requests_switch():
    """Re-registering a live tenant: in-flight stays on the old row, new
    requests see the new version, the old row is reclaimed after drain."""
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 2, length=6)
    ref = _engine(cfg, base, tenant_capacity=3)
    ref.register_tenant("t0", tenants[0])
    ref_old = ref.submit("t0", prompts[0], max_new_tokens=8)
    ref.run()
    ref2 = _engine(cfg, base, tenant_capacity=3)
    ref2.register_tenant("t0", tenants[1])         # "new version" up front
    ref_new = ref2.submit("t0", prompts[1], max_new_tokens=8)
    ref2.run()

    eng = _engine(cfg, base, tenant_capacity=3)
    eng.register_tenant("t0", tenants[0])
    r_old = eng.submit("t0", prompts[0], max_new_tokens=8)
    for _ in range(3):
        eng.step(eng._now())
    old_row = eng._rows["t0"]
    eng.register_tenant("t0", tenants[1])          # rollout mid-sequence
    new_row = eng._rows["t0"]
    assert new_row != old_row and old_row in eng._retiring
    r_new = eng.submit("t0", prompts[1], max_new_tokens=8)
    eng.run()
    assert list(r_old.tokens) == list(ref_old.tokens)   # drained on old row
    assert list(r_new.tokens) == list(ref_new.tokens)   # served new version
    assert not eng._retiring and old_row in eng._table._free
    assert not eng._table.stacked["attn"]["wq"].codes[old_row].any()
    assert len(_decode_keys(eng)) == 1 and eng.restacks == 0
    assert eng.metrics.report()["tenant_lifecycle"] == {"tenant_register": 1,
                                                        "tenant_rollout": 1}


def test_retire_frees_row_and_refuses_in_flight():
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 2)
    eng = _engine(cfg, base, tenant_capacity=2)
    eng.register_tenant("t0", tenants[0])
    free_before = eng._table.n_free
    r = eng.submit("t0", prompts[0], max_new_tokens=4)
    eng.step(eng._now())
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.unregister_tenant("t0")
    eng.run()
    assert r.done
    eng.unregister_tenant("t0")
    assert eng._table.n_free == free_before + 1
    with pytest.raises(KeyError):
        eng.submit("t0", prompts[1], max_new_tokens=4)
    eng.register_tenant("t0", tenants[1])          # re-registrable after retire
    assert len(_decode_keys(eng)) == 1


def test_table_full_and_incompatible_tenant_rejected():
    """A full table and a tenant of another packing are refused before any
    change; the engine keeps serving."""
    cfg, base, tenants = _setup()
    eng = _engine(cfg, base, tenant_capacity=2)
    eng.register_tenant("t0", tenants[0])
    other = compress(base, _ft_of(base, 3), BitDeltaSpec())[0]
    with pytest.raises(ValueError, match="signature"):
        eng.register_tenant("bd", other)
    eng.register_tenant("t1", tenants[1])
    with pytest.raises(ValueError, match="full"):
        eng.register_tenant("t2", tenants[2])
    assert eng._rows == {"t0": 1, "t1": 2} and eng.store.names() == ["t0", "t1"]
    r = eng.submit("t0", _prompts(cfg, 1)[0], max_new_tokens=3)
    eng.run()
    assert r.done


def test_table_row_write_leaves_other_rows_unchanged():
    """``write`` and ``clear`` touch their row's bytes only, in place."""
    cfg, base, tenants = _setup()
    table = TenantTable(tenants[0], capacity=3)
    ptr = table.stacked["mlp"]["wi"].codes.data_ptr()
    table.write(1, tenants[0])
    table.write(3, tenants[2])
    snap = [{f: getattr(d, f).clone() for f in ("idx", "codes", "scale", "zero")}
            for _, d in iter_leaves(table.stacked) if d is not None]
    table.write(2, tenants[1])
    table.clear(3)
    after = [d for _, d in iter_leaves(table.stacked) if d is not None]
    for s, d in zip(snap, after):
        for f, before in s.items():
            a = getattr(d, f)
            assert torch.equal(a[:2], before[:2]), f       # rows 0 and 1
            assert not a[3].any(), f                       # row 3 cleared
    assert table.stacked["mlp"]["wi"].codes.data_ptr() == ptr
    wi = table.stacked["mlp"]["wi"]
    assert torch.equal(wi.codes[2], tenants[1]["mlp"]["wi"].codes)
    assert table.alloc() == 1 and table.n_free == 2
    with pytest.raises(ValueError, match="bad tenant-table row"):
        table.free(0)


# ---------------------------------------------------------------------------
# Live-mutation regressions
# ---------------------------------------------------------------------------
def test_kv_claim_release_raise_value_error():
    cfg = get_smoke_config(ARCH)
    kv = SlotKVCache(cfg, n_slots=2, max_seq=8, device="cpu")
    kv.claim(0)
    with pytest.raises(ValueError, match="not free"):
        kv.claim(0)
    kv.release(0)
    with pytest.raises(ValueError, match="double-freed"):
        kv.release(0)
    assert kv.n_free == 2


def test_store_register_refuses_silent_replace():
    _, _, tenants = _setup()
    store = DeltaStore()
    store.register("t0", tenants[0])
    with pytest.raises(ValueError, match="already registered"):
        store.register("t0", tenants[1])
    v = store.version
    store.register("t0", tenants[1], replace=True)
    assert store.version > v


def test_dynamic_reregister_refused_in_flight_engine_untouched():
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 2)
    eng = _engine(cfg, base)                      # dynamic (no capacity)
    eng.register_tenant("t0", tenants[0])
    ref = _engine(cfg, base)
    ref.register_tenant("t0", tenants[0])
    rr = ref.submit("t0", prompts[0], max_new_tokens=6)
    ref.run()
    r = eng.submit("t0", prompts[0], max_new_tokens=6)
    eng.step(eng._now())
    version, rows, groups = eng.store.version, dict(eng._rows), list(eng._groups)
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.register_tenant("t0", tenants[1])
    assert eng.store.version == version and eng._rows == rows
    assert eng._groups == groups
    eng.run()
    assert list(r.tokens) == list(rr.tokens)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------
def test_registry_promote_with_full_table_keeps_host_tree():
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 3)
    eng = _engine(cfg, base, tenant_capacity=2)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None, spool_dir=None,
                        host_capacity=1)
    for i in range(2):
        reg.ingest(f"t{i}", deltas=tenants[i])
    reg.pump()
    for i in range(2):
        reg.submit(f"t{i}", prompts[i], max_new_tokens=3)
    eng.run()
    reg.ingest("t2", deltas=tenants[2])
    reg.pump()                                    # evicts LRU -> warm
    warm = [n for n, r in reg._records.items() if r.state == "warm"]
    assert len(warm) == 1
    r = reg.submit(warm[0], prompts[0], max_new_tokens=3)   # promote
    eng.run()
    assert r.done and reg._records[warm[0]].state == "hot"
    assert reg._records[warm[0]].host is not None


def test_registry_ingest_compress_register_serve():
    cfg, base, _ = _setup()
    eng = _engine(cfg, base, tenant_capacity=3)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec="auto")
    rec = reg.ingest("a", _ft_of(base, 0))
    assert rec.state == "ready" and rec.compress_s is not None
    assert reg.pump() == ["a"]
    assert rec.report.budget_bits == 2.0 and rec.report.budget_met
    assert rec.state == "hot" and rec.register_s is not None
    r = reg.submit("a", _prompts(cfg, 1)[0], max_new_tokens=4)
    eng.run()
    assert r.done and len(r.tokens) == 4
    assert len(_decode_keys(eng)) == 1
    assert reg.stats()["tenants"] == {"a": "hot"}
    assert reg.stats()["table_free_rows"] == 2


def test_registry_cold_spool_roundtrip_identity(tmp_path):
    """Evict -> spill to disk -> promote serves the same tokens."""
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 1)
    eng = _engine(cfg, base, tenant_capacity=2)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None,
                        spool_dir=str(tmp_path / "spool"), host_capacity=0)
    reg.ingest("a", deltas=tenants[0])
    reg.pump()
    r1 = reg.submit("a", prompts[0], max_new_tokens=5)
    eng.run()
    reg.evict("a")
    rec = reg._records["a"]
    assert rec.state == "cold" and rec.host is None
    assert rec.spool and os.path.exists(rec.spool)
    r2 = reg.submit("a", prompts[0], max_new_tokens=5)   # disk promote
    eng.run()
    assert rec.state == "hot"
    assert list(r2.tokens) == list(r1.tokens)


def test_registry_watch_dir_scan_reads_a_reference_checkpoint(tmp_path):
    """A fine-tuned checkpoint written by ``repro.serve.registry._save_npz``
    (bf16 leaves as bits + sidecar) is picked up, compressed and served."""
    jcfg = j_smoke(ARCH)
    jbase = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jft = jax.tree.map(lambda p: p + 0.05 * jax.random.normal(
        jax.random.PRNGKey(8), p.shape, jnp.float32).astype(p.dtype)
        if p.ndim >= 2 else p, jbase)
    base = br.params_to_port(jbase)
    eng = _engine(get_smoke_config(ARCH), base, tenant_capacity=2)
    watch = tmp_path / "watch"
    reg = DeltaRegistry(eng, base, spec=SPEC, codec="auto", watch_dir=str(watch))
    assert reg.scan() == []                       # no dir yet: no-op
    j_save_npz(str(watch / "support-bot.npz"),
               {p: np.asarray(l) for p, l in br.flatten_with_paths(jft).items()})
    assert reg.scan() == ["support-bot"]
    assert reg.scan() == []                       # seen files not re-ingested
    reg.pump()
    want = compress(base, br.params_to_port(jft), codec="auto", budget_bits=2.0)[0]
    got = eng.store.get("support-bot").deltas
    assert torch.equal(got["mlp"]["wi"].codes,
                       runtime_delta_tree(want)["mlp"]["wi"].codes)
    r = reg.submit("support-bot", _prompts(jcfg, 1)[0], max_new_tokens=4)
    eng.run()
    assert r.done


def test_registry_rollout_rollback():
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 1)
    eng = _engine(cfg, base, tenant_capacity=3)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None)
    reg.ingest("a", deltas=tenants[0])
    reg.pump()
    r1 = reg.submit("a", prompts[0], max_new_tokens=5)
    eng.run()
    reg.ingest("a", deltas=tenants[1])
    reg.pump()                                          # v2 rollout
    assert reg._records["a"].version == 2
    reg.rollback("a")                                   # back to v1
    r3 = reg.submit("a", prompts[0], max_new_tokens=5)
    eng.run()
    assert list(r3.tokens) == list(r1.tokens)
    with pytest.raises(KeyError):
        reg.rollback("never-registered")
    reg.ingest("b", deltas=tenants[2])
    reg.pump()
    with pytest.raises(ValueError, match="no previous"):
        reg.rollback("b")


def test_lifecycle_events_reach_metrics_and_tracer(tmp_path):
    cfg, base, tenants = _setup()
    eng = _engine(cfg, base, tenant_capacity=2)
    tracer = Tracer()
    eng.bus.attach(tracer)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None,
                        spool_dir=str(tmp_path / "spool"), host_capacity=0)
    reg.ingest("a", deltas=tenants[0])
    reg.pump()
    reg.ingest("a", deltas=tenants[1])
    reg.pump()                                          # rollout
    reg.ingest("b", deltas=tenants[2])
    reg.pump()
    reg.evict("a")                                      # warm -> cold spill
    reg.submit("a", _prompts(cfg, 1)[0], max_new_tokens=3)   # back to hot
    eng.run()
    eng.unregister_tenant("b")                          # retire
    m = eng.metrics
    for kind in ("tenant_register", "tenant_rollout", "tenant_ready",
                 "tenant_evict", "tenant_promote", "tenant_retire"):
        assert m.lifecycle.get(kind, 0) >= 1, kind
    assert m.report()["tenant_lifecycle"]["tenant_ready"] == 3
    names = {e["name"] for e in tracer.events if e.get("ph") == "i"}
    assert {"tenant_register", "tenant_rollout", "tenant_retire",
            "tenant_ready", "tenant_promote", "tenant_evict"} <= names
    assert validate_chrome_trace(tracer.to_chrome_trace()) == []


def test_registry_background_worker():
    """background=True: compression runs on the worker thread, pump()
    (serving-loop thread) picks up the finished record."""
    cfg, base, _ = _setup()
    eng = _engine(cfg, base, tenant_capacity=2)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None, background=True)
    try:
        rec = reg.ingest("a", _ft_of(base, 0))
        deadline = time.time() + 60.0
        hot = []
        while not hot and time.time() < deadline:
            hot = reg.pump()
            time.sleep(0.01)
        assert hot == ["a"] and rec.state == "hot"
        r = reg.submit("a", _prompts(cfg, 1)[0], max_new_tokens=3)
        eng.run()
        assert r.done
    finally:
        reg.close()
    assert reg._worker is None


def test_registry_compress_failure_recorded_not_raised():
    cfg, base, _ = _setup()
    eng = _engine(cfg, base, tenant_capacity=2)
    reg = DeltaRegistry(eng, base, spec=SPEC, codec=None)
    rec = reg.ingest("bad", {"not": "a-param-tree"})
    assert rec.state == "failed" and rec.error
    assert reg.pump() == []                      # nothing went hot
    with pytest.raises(ValueError, match="ft_params or deltas"):
        reg.ingest("empty")


# ---------------------------------------------------------------------------
# Spool files across the two packages
# ---------------------------------------------------------------------------
def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_npz_sidecar_roundtrips_bf16(tmp_path):
    path = str(tmp_path / "x.npz")
    b = torch.arange(4, dtype=torch.bfloat16) / 3
    _save_npz(path, {"a": torch.arange(6.0).reshape(2, 3), "b": b})
    back = _load_npz(path)
    assert back["a"].dtype == torch.float32 and back["b"].dtype == torch.bfloat16
    assert torch.equal(back["b"], b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_written_by_either_package_loads_in_the_other(tmp_path, writer):
    """bf16 passes as its bits; the port reads without ml_dtypes."""
    path = str(tmp_path / "x.npz")
    want = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i": np.arange(4, dtype=np.uint8),
            "b": np.asarray(jnp.arange(4, dtype=jnp.bfloat16) / 3)}
    if writer == "reference":
        j_save_npz(path, want)
        got = _load_npz(path)
        assert got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got["b"]), want["b"].view(np.uint16))
        for k in ("a", "i"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    else:
        b = torch.from_numpy(want["b"].view(np.int16).copy()).view(torch.bfloat16)
        _save_npz(path, {"a": torch.from_numpy(want["a"]),
                         "i": torch.from_numpy(want["i"]), "b": b})
        got = j_load_npz(path)
        assert got["b"].dtype == want["b"].dtype
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].view(np.uint8), v.view(np.uint8))


# ---------------------------------------------------------------------------
# Interleaved lifecycle (the reference's property test, seeded)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(5))
def test_lifecycle_interleaving_never_corrupts(seed):
    """Seeded interleavings of register/retire/rollout with traffic keep
    the engine serving, the decode signature at one, and the table's
    free-row accounting consistent (read once the table exists)."""
    cfg, base, tenants = _setup()
    prompts = _prompts(cfg, 4)
    rs = np.random.RandomState(seed)
    ops = rs.choice(["register", "retire", "rollout", "traffic", "steps"],
                    size=rs.randint(3, 11))
    eng = _engine(cfg, base, tenant_capacity=3)
    live, version, pending = {}, {}, []
    for op in ops:
        names = sorted(live)
        if op == "register" and len(live) < 3:
            n = f"t{len(version)}"
            try:
                eng.register_tenant(n, tenants[rs.randint(4)])
                version[n] = 0
                live[n] = True
            except ValueError:
                pass                      # retiring rows not drained yet
        elif op == "rollout" and names:
            try:
                eng.register_tenant(names[rs.randint(len(names))], tenants[rs.randint(4)])
            except ValueError:
                pass                      # no free row for the new version
        elif op == "retire" and names:
            n = names[rs.randint(len(names))]
            try:
                eng.unregister_tenant(n)
                del live[n]
            except RuntimeError:
                pass                      # in-flight: correctly refused
        elif op == "traffic" and names:
            pending.append(eng.submit(names[rs.randint(len(names))],
                                      prompts[rs.randint(4)], max_new_tokens=3))
        elif op == "steps":
            for _ in range(2):
                eng.step(eng._now())
        assert len(_decode_keys(eng)) <= 1 and eng.restacks == 0
        rows = set(eng._rows.values())
        assert len(rows) == len(eng._rows) and 0 not in rows
        if eng._table is not None:
            assert not rows & set(eng._table._free)
            assert not rows & eng._retiring
    eng.run()
    assert all(r.done for r in pending)


# ---------------------------------------------------------------------------
# Against the JAX engine: retrace accounting and the report
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_fleet():
    jcfg = dataclasses.replace(j_smoke(ARCH), param_dtype="float32")
    jbase = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jspec = JSpec(**dataclasses.asdict(SPEC))
    jten = []
    for t in range(3):
        ft = jax.tree.map(lambda p, t=t: p + 0.05 * jax.random.normal(
            jax.random.PRNGKey(7 + t), p.shape, jnp.float32).astype(p.dtype)
            if p.ndim >= 2 else p, jbase)
        jten.append(jcompress(jbase, ft, jspec)[0])
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32")
    return jcfg, jbase, jten, tcfg, br.params_to_port(jbase), [
        br.deltas_to_port(d) for d in jten]


class _StepTraces:
    """Counts a bus's jit_trace events of the step's signatures."""

    def __init__(self):
        self.n = 0

    def consume(self, ev):
        self.n += ev.kind == "jit_trace" and ev.attrs["site"] != "prefill"


def _midrun(eng, ten, prompts, chunked):
    for i in range(2):
        eng.register_tenant(f"t{i}", ten[i])
    hs = [eng.submit(f"t{i}", prompts[i], max_new_tokens=6, arrival=0.001 * i)
          for i in range(2)]
    for _ in range(3):
        eng.step(eng._now())
    eng.register_tenant("t2", ten[2])              # mid-run
    hs.append(eng.submit("t2", prompts[2], max_new_tokens=6, arrival=eng._now()))
    eng.run()
    if eng.tenant_capacity is None:                # back to a stack seen before
        eng.unregister_tenant("t2")
        hs.append(eng.submit("t1", prompts[0], max_new_tokens=4, arrival=eng._now()))
        eng.run()
    return [h.output() for h in hs]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("mode", ["dynamic", "table"])
def test_midrun_registration_report_equals_jax(mode, chunked):
    """A registration while two tenants decode: the dynamic path re-stacks
    (a new leading dimension: one retrace in the reference, first=False),
    the table path writes a row (none); unregistering back to a stack
    shape seen before retraces nothing. Tokens and ``Metrics.report()``
    equal the JAX engine's on the same VirtualClock trace."""
    jcfg, jbase, jten, tcfg, tbase, tten = _jax_fleet()
    kw = dict(n_slots=3, max_seq=32,
              tenant_capacity=3 if mode == "table" else None,
              **(dict(chunked_prefill=True, chunk_size=4) if chunked else {}))
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=1e-3), **kw)
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **kw)
    prompts = _prompts(tcfg, 3, length=7)
    jsteps = _StepTraces()
    jeng.bus.attach(jsteps)
    jout = _midrun(jeng, jten, prompts, chunked)
    tout = _midrun(teng, tten, prompts, chunked)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    if jrep["decode_paths"]:
        jrep["decode_paths"] = {k.replace("-xla", "-torch"): v
                                for k, v in jrep["decode_paths"].items()}
    assert trep == jrep
    assert teng.decode_traces == jsteps.n
    if not chunked:      # one decode signature, plus the re-stack's retrace
        assert teng.decode_traces == {"dynamic": 2, "table": 1}[mode]
    assert teng.metrics.jit_traces == jeng.metrics.jit_traces
    assert teng.restacks == {"dynamic": 4, "table": 0}[mode]


def test_lifecycle_cli_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --lifecycle --check-identity``."""
    from repro_torch.launch import serve as cli
    assert cli.main(["--device", "cpu", "--tenants", "3", "--lifecycle",
                     "--check-identity", "--requests", "6", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "decode-step jit_trace events across register/rollout/retire: 0; " \
        "re-stacks: 0" in out
    assert "token identity vs up-front engines: OK" in out
