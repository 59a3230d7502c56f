"""The port's pre-decoded delta residency (``serve.engine.DeltaResidency``)
against the JAX reference's.

Twins of the reference's residency tests (``tests/test_serve_scheduler.py``,
the five ``DeltaResidency`` and residency-engine tests):

* the tier itself on the reference's toy stack, carried across: capacity,
  row bytes, the tenant-row -> residency-row map, LRU order, hits,
  misses and fallback steps equal the reference's exactly, step by step;
  resident values equal in-step decode (and the reference's values) bit
  for bit;
* the values formulation of the segment correction equals the packed one
  bit for bit;
* a residency engine (f32 smoke config, one ``VirtualClock`` stream) gives
  the reference engine's tokens and ``Metrics.report()`` — with a budget
  that holds the fleet, with one so tight that steps run packed, chunked,
  and across tenant-table rollouts that reuse a row (stale values would
  show as other tokens);
* the serving CLI's ``--residency-mb``.

All on the CPU, where the port consults the tier (as the reference does
with its Pallas backend off).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import DeltaDQSpec, compress, groupwise_dropout_pack  # noqa: E402
from repro.core.apply import stack_tenant_deltas as j_stack  # noqa: E402
from repro.core.apply import zero_delta_like as j_zero_like  # noqa: E402
from repro.core.pack import decode_values as j_decode_values  # noqa: E402
from repro.kernels import fallback as jfb  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402
from repro.serve.engine import DeltaResidency as JDeltaResidency  # noqa: E402
from repro.serve.engine import residency_bytes_from_mb as j_bytes_from_mb  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.pack import decode_values  # noqa: E402
from repro_torch.kernels import fallback, ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousEngine,
    DeltaResidency,
    VirtualClock,
    residency_bytes_from_mb,
)
from repro_torch.serve.scheduler import tenant_segments  # noqa: E402

import torch_bridge as br  # noqa: E402

ARCH = "wizard-llama2-7b"
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)
TOL = dict(atol=1e-4, rtol=1e-4)    # f32: the frameworks sum in other orders


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The tier on the reference's toy stack
# ---------------------------------------------------------------------------
def _toy_stack(n_tenants, h_in=64, h_out=16, h_g=16, alpha=4.0, k=4):
    """The reference test's stack ({"w": ...}, zero row first), and the
    port's copy of it."""
    rng = jax.random.PRNGKey(0)
    trees = [{"w": groupwise_dropout_pack(
        jax.random.fold_in(rng, t),
        jax.random.normal(jax.random.fold_in(rng, 100 + t), (h_in, h_out)) * 0.01,
        h_g=h_g, alpha=alpha, k_bits=k)} for t in range(n_tenants)]
    jstack = j_stack([j_zero_like(trees[0])] + trees)
    return jstack, br.deltas_to_port(jstack)


def _state(r):
    return (dict(r._slot_of), list(r._lru), sorted(r._free), r.stats())


@pytest.mark.parametrize("mb", [0.0, -1.0, 1e-7, 0.5, 64.0, 3.2e3])
def test_residency_bytes_from_mb_matches_reference(mb):
    assert residency_bytes_from_mb(mb) == j_bytes_from_mb(mb)


def test_budget_capacity_and_values_match_reference():
    jstack, tstack = _toy_stack(3)
    row_bytes = 4 * int(np.prod(jstack["w"].idx.shape[1:]))
    jr = JDeltaResidency(jstack, 3 * row_bytes)
    tr = DeltaResidency(tstack, 3 * row_bytes)
    assert (tr.enabled, tr.capacity, tr.row_bytes, tr.n_rows) == \
        (jr.enabled, jr.capacity, jr.row_bytes, jr.n_rows) == (True, 3, row_bytes, 4)
    for rows in ([0, 1, 2, 1], [1, 2], [2]):
        want = jr.ensure(np.asarray(rows))
        got = tr.ensure(np.asarray(rows))
        np.testing.assert_array_equal(got, want)
        assert _state(tr) == _state(jr)
    # resident rows equal in-step decode, and the reference's buffers, bit for bit
    rm = tr.ensure(np.asarray([1, 2]))
    decoded = _np(decode_values(tstack["w"]))
    vals = _np(tr.values["w"])
    jvals = np.asarray(jr.values["w"])
    for row in (0, 1, 2):
        np.testing.assert_array_equal(vals[rm[row]], decoded[row])
        np.testing.assert_array_equal(vals[rm[row]], jvals[rm[row]])
    np.testing.assert_array_equal(decoded, np.asarray(j_decode_values(jstack["w"])))


# the reference test's sequence (LRU demotion, the over-capacity fallback,
# recency refresh), then invalidations, at three budgets
_SEQUENCE = [("ensure", [0, 1]), ("ensure", [1, 2]), ("ensure", [0, 2]),
             ("ensure", [2]), ("ensure", [3]), ("ensure", [2]),
             ("invalidate", [2, 0]), ("ensure", [1, 3]), ("ensure", [0, 0]),
             ("invalidate", [3]), ("ensure", [2, 3, 1])]


@pytest.mark.parametrize("rows_fit", [2, 3, 4])
def test_lru_demotion_and_fallback_match_reference(rows_fit):
    jstack, tstack = _toy_stack(3)
    row_bytes = 4 * int(np.prod(jstack["w"].idx.shape[1:]))
    jr = JDeltaResidency(jstack, rows_fit * row_bytes)
    tr = DeltaResidency(tstack, rows_fit * row_bytes)
    assert tr.capacity == jr.capacity == rows_fit
    decoded = _np(decode_values(tstack["w"]))
    for op, rows in _SEQUENCE:
        if op == "invalidate":
            jr.invalidate(rows)
            tr.invalidate(rows)
        else:
            want = jr.ensure(np.asarray(rows))
            got = tr.ensure(np.asarray(rows))
            assert (got is None) == (want is None), (op, rows)
            if got is not None:
                np.testing.assert_array_equal(got, want)
                for r in set(rows):
                    np.testing.assert_array_equal(_np(tr.values["w"])[got[r]],
                                                  decoded[r])
        assert _state(tr) == _state(jr), (op, rows)
    tr.reset_counters()
    jr.reset_counters()
    assert _state(tr) == _state(jr)


def test_disabled_below_two_rows():
    jstack, tstack = _toy_stack(2)
    row_bytes = 4 * int(np.prod(jstack["w"].idx.shape[1:]))
    jr = JDeltaResidency(jstack, row_bytes)
    tr = DeltaResidency(tstack, row_bytes)
    assert not tr.enabled and not jr.enabled and tr.values is None
    assert tr.ensure(np.asarray([0, 1])) is None is jr.ensure(np.asarray([0, 1]))
    assert tr.stats() == jr.stats()
    with pytest.raises(ValueError):
        DeltaResidency({"w": None}, 1 << 20)


@pytest.mark.parametrize("rows", [[0, 1, 2, 1, 3, 0], [2, 2, 2], [3, 1, 0, 0]])
def test_values_formulation_equals_packed(rows):
    """ops.delta_spmm_segments with resident values (CPU: the plain values
    formulation, as the reference's XLA one) equals the packed path bit
    for bit, and the reference's values path within 1e-4 (f32)."""
    jstack, tstack = _toy_stack(3)
    d = tstack["w"]
    r = DeltaResidency(tstack, 4 * 4 * int(np.prod(d.idx.shape[1:])))
    rm = r.ensure(np.asarray(rows))
    seg = tenant_segments(np.asarray(rows, np.int32))
    x = np.random.default_rng(len(rows)).standard_normal((len(rows), 64)).astype(np.float32)
    xs = torch.from_numpy(x)[torch.as_tensor(seg.order).long()]
    sr, so = torch.as_tensor(seg.seg_rows), torch.as_tensor(seg.seg_offsets)
    packed = ops.delta_spmm_segments(xs, d, sr, so)
    vals = ops.delta_spmm_segments(xs, d, sr, so, values=r.values["w"],
                                   res_map=torch.as_tensor(rm))
    assert torch.equal(vals, packed)
    want = jfb.segment_correction(
        jnp.asarray(_np(xs)), jstack["w"], jnp.asarray(seg.seg_rows),
        jnp.asarray(seg.seg_offsets),
        values=jnp.asarray(_np(r.values["w"])), res_map=jnp.asarray(rm))
    np.testing.assert_allclose(_np(vals), np.asarray(want), **TOL)
    # the per-row formulation takes values the same way
    per_row = fallback.gather_correction_rows(
        torch.from_numpy(x)[:, None], d.with_arrays(
            d.idx[list(rows)], d.codes[list(rows)], d.scale[list(rows)],
            d.zero[list(rows)]), values=r.values["w"][torch.as_tensor(rm[rows]).long()])
    assert torch.equal(per_row[:, 0], packed[torch.as_tensor(seg.inv_order).long()])


# ---------------------------------------------------------------------------
# The residency engine against the reference's
# ---------------------------------------------------------------------------
def _ft(base, seed):
    return jax.tree.map(
        lambda p: p + 0.02 * jax.random.normal(
            jax.random.PRNGKey(seed), p.shape, jnp.float32).astype(p.dtype)
        if p.ndim >= 2 else p, base)


@functools.lru_cache(maxsize=None)
def _fleet():
    """f32 smoke base + tenant0..2 and two rollout versions (v2), made by
    the reference and carried across."""
    jcfg = dataclasses.replace(j_smoke(ARCH), param_dtype="float32")
    base = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    j = {name: compress(base, _ft(base, seed), SPEC)[0]
         for name, seed in (("tenant0", 7), ("tenant1", 8), ("tenant2", 9),
                            ("tenant0.v2", 77), ("tenant1.v2", 78))}
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="float32")
    t = {name: br.deltas_to_port(d) for name, d in j.items()}
    return jcfg, base, j, tcfg, br.params_to_port(base), t


def _row_bytes():
    from repro_torch.core.pack import PackedDelta
    from repro_torch.utils import iter_leaves
    _, _, _, _, _, t = _fleet()
    return sum(4 * leaf.idx.numel() for _, leaf in iter_leaves(t["tenant0"])
               if isinstance(leaf, PackedDelta))


def _stream(vocab, n=9, seed=21):
    rng = np.random.default_rng(seed)
    return [(f"tenant{i % 3}" if i % 4 else None,
             rng.integers(0, vocab, L).astype(np.int32))
            for i, L in enumerate([5, 9, 7, 5, 12, 3, 9, 6, 10][:n])]


def _serve(eng, stream, max_new=5, t0=0.0):
    hs = [eng.submit(t, p, max_new_tokens=max_new, arrival=t0 + 0.002 * i)
          for i, (t, p) in enumerate(stream)]
    eng.run()
    return hs


def _pair(budget_rows, **kw):
    jcfg, jbase, j, tcfg, tbase, t = _fleet()
    budget = None if budget_rows is None else budget_rows * _row_bytes()
    kw = dict(n_slots=4, max_seq=32, residency_budget_bytes=budget, **kw)
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=1e-3), **kw)
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=1e-3), **kw)
    return jeng, teng


@pytest.mark.parametrize("budget_rows,chunked", [(4, False), (4, True), (2, False),
                                                 (3, True)])
def test_residency_engine_matches_jax_engine(budget_rows, chunked):
    """Same stream on both engines: equal tokens, equal reports (the
    residency block included: hits, misses, value and packed steps), and
    the port's tokens equal its packed-only engine's. Budget 4 holds the
    zero row and all three tenants (value steps only); 2 holds one tenant,
    so mixed steps fall back packed; 3 holds two."""
    kw = dict(chunked_prefill=True, chunk_size=4) if chunked else {}
    jeng, teng = _pair(budget_rows, **kw)
    _, plain = _pair(None, **kw)
    *_, j, _, _, t = _fleet()
    for name in ("tenant0", "tenant1", "tenant2"):
        jeng.register_tenant(name, j[name])
        teng.register_tenant(name, t[name])
        plain.register_tenant(name, t[name])
    stream = _stream(jeng.cfg.vocab)
    jh, th, ph = _serve(jeng, stream), _serve(teng, stream), _serve(plain, stream)
    for (tenant, _), a, b, c in zip(stream, jh, th, ph):
        np.testing.assert_array_equal(b.output(), a.output(), err_msg=str(tenant))
        np.testing.assert_array_equal(b.output(), c.output(), err_msg=str(tenant))
    rep = teng.metrics.report()
    assert rep == br.xla_to_torch(jeng.metrics.report())
    res = rep["residency"]
    assert res["capacity_rows"] == budget_rows and res["enabled"]
    assert res["value_steps"] > 0
    if budget_rows == 2:
        assert res["packed_steps"] > 0 and res["fallback_steps"] > 0
    if budget_rows == 4:
        assert res["packed_steps"] == 0 and res["fallback_steps"] == 0
    assert teng.metrics.jit_traces == jeng.metrics.jit_traces


def test_residency_across_rollouts_matches_jax_engine():
    """Tenant table of 3 rows with residency: tenant0 rolls out to v2 (a
    new row; its old row is cleared, freed and invalidated), then tenant1
    rolls out into that reused row. A stale resident copy of the old row
    would serve tenant0's values for tenant1.v2: tokens equal the
    reference's and the packed-only engine's, and so do the reports."""
    jeng, teng = _pair(4, tenant_capacity=3)
    _, plain = _pair(None, tenant_capacity=3)
    *_, j, _, _, t = _fleet()
    engines = ((jeng, j), (teng, t), (plain, t))
    stream = _stream(jeng.cfg.vocab)
    outs = [[] for _ in engines]
    for phase, (name, version) in enumerate(((None, None), ("tenant0", "tenant0.v2"),
                                             ("tenant1", "tenant1.v2"))):
        for k, (eng, fleet) in enumerate(engines):
            if name is None:
                for n in ("tenant0", "tenant1"):
                    eng.register_tenant(n, fleet[n])
            else:
                eng.register_tenant(name, fleet[version])
            sub = [(tn if tn != "tenant2" else "tenant0", p) for tn, p in stream]
            outs[k] += [h.output() for h in _serve(eng, sub, t0=float(phase))]
    assert teng._rows == {"tenant0": 3, "tenant1": 1}
    assert 2 not in teng.residency._slot_of      # freed row, not resident
    for a, b, c in zip(*outs):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    rep = teng.metrics.report()
    assert rep == br.xla_to_torch(jeng.metrics.report())
    assert rep["residency"]["value_steps"] > 0


def test_residency_tier_left_out_where_the_reference_leaves_it():
    """Per-row dispatch and a two-group (mixed-codec) fleet build no tier,
    as the reference; a dynamic re-stack builds a fresh one."""
    from repro_torch.core.codecs import BitDeltaSpec
    from repro_torch.launch.serve import synth_tenants
    from repro_torch.models import lm
    _, _, _, tcfg, tbase, t = _fleet()
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=16,
                           slot_dispatch="per_row", residency_budget_bytes=1 << 20)
    eng.register_tenant("tenant0", t["tenant0"])
    eng._refresh_stacked()
    assert eng.residency is None
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=16,
                           residency_budget_bytes=1 << 20)
    eng.register_tenant("tenant0", t["tenant0"])
    first = eng.residency
    assert first is not None and first.n_rows == 2
    eng.register_tenant("tenant1", t["tenant1"])
    assert eng.residency is not first and eng.residency.n_rows == 3
    bit = synth_tenants(tcfg, lm.init_params(tcfg, 0, device="cpu"), 1,
                        BitDeltaSpec(), seed=3)[0][1]
    eng.register_tenant("bit", bit)
    assert len(eng._groups) == 2 and eng.residency is None


def test_serve_cli_residency(capsys):
    """``--residency-mb --check-identity``: the residency engine's tokens
    equal the default path's, and the report line counts its steps."""
    from repro_torch.launch.serve import main
    assert main(["--device", "cpu", "--tenants", "3", "--requests", "6",
                 "--slots", "4", "--residency-mb", "50", "--check-identity"]) == 0
    out = capsys.readouterr().out
    assert "token identity vs the default path: OK (6 requests)" in out
    assert "residency: 4/4 rows resident" in out and "0 packed steps" in out
