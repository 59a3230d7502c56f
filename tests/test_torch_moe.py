"""The port's MoE family (``repro_torch/models/moe.py``,
``core.apply.apply_linear_batched``, ``kernels.ops.delta_spmm_experts``)
against the JAX reference, on the CPU at smoke size.

Weights come from the reference's ``init_params`` and are carried across
(bf16 as raw bits); the tenants' deltas are packed by the port
(``synth_tenants``, 128x spec) and carried back to the reference, so both
packages apply the same packed bytes. The reference's functions run under
``jax.jit``, as its engines call them. Tolerances as
``tests/test_torch_model.py``: f32 1e-4, bf16 1e-3; indices, capacity
slots and drops exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import apply as japply  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import apply as tapply  # noqa: E402
from repro_torch.core.pack import reconstruct_dense  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, VirtualClock  # noqa: E402
from repro_torch.serve.trace import attribution  # noqa: E402

import torch_bridge as br  # noqa: E402

MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}
# the reference's consistency setting for MoE serving (tests/test_serving.py:25)
CF_CONSISTENT = 8.0

j_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(3, 4))
j_apply_batched = jax.jit(japply.apply_linear_batched)


def _cf(cfg, cf):
    return cfg if cf is None else cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                                       capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def _model(name, dtype="float32", cf=None):
    """(jax cfg, jax params, jax deltas, port cfg, port params, port deltas):
    reference init at seed 0, one tenant packed by the port."""
    jcfg = _cf(dataclasses.replace(j_smoke(name), param_dtype=dtype), cf)
    base = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = _cf(dataclasses.replace(get_smoke_config(name), param_dtype=dtype), cf)
    tbase = br.params_to_port(base)
    [(_, tdeltas, _)] = synth_tenants(tcfg, tbase, 1, RATIO_SPECS[128], seed=0)
    return jcfg, base, br.deltas_to_jax(tdeltas), tcfg, tbase, tdeltas


def _jax_dispatch(eidx, E, C):
    """``repro/models/moe.py:51-58`` as written (the reference keeps the
    dispatch inline in ``moe_ffn``)."""
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e)
    inv = jnp.argsort(order)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, jnp.arange(E))
    pos = inv - first[flat_e]
    keep = pos < C
    return jnp.where(keep, flat_e, E), jnp.where(keep, pos, 0), keep


def _logits(T, E, seed, ties=False):
    """Router-like logits [T, E]; half the rows repeat one row (padded or
    idle-slot tokens route alike), ``ties`` rounds them to a few levels so
    equal logits compete for the top k."""
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((T, E)).astype(np.float32)
    lg[T // 2:] = lg[T // 2]
    return np.round(lg) if ties else lg


# ---------------------------------------------------------------------------
# Router and capacity dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_router_topk_matches_reference(ties, K):
    lg = _logits(16, 8, 0, ties)
    jw, ji = jmoe.router_topk(jnp.asarray(lg), K)
    tw, ti = tmoe.router_topk(torch.from_numpy(lg), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    if ties:   # the case torch.topk leaves open: equal logits in the top k + 1
        top = -np.sort(-lg, axis=1)
        assert (top[:, :-1] == top[:, 1:])[:, :K].any()


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("T", [1, 3, 24, 64])
def test_capacity_dispatch_matches_reference(name, T):
    """slot_e, slot_c and keep exactly, with drops at cf 1.25."""
    cfg = get_smoke_config(name)
    m = cfg.moe
    C = tmoe.capacity(T, cfg)
    assert C == max(int(T * m.top_k / m.n_experts * m.capacity_factor), 1)
    assert tmoe.capacity(T, cfg, CF_CONSISTENT) == \
        max(int(T * m.top_k / m.n_experts * CF_CONSISTENT), 1)
    lg = _logits(T, m.n_experts, T)
    _, ji = jmoe.router_topk(jnp.asarray(lg), m.top_k)
    _, ti = tmoe.router_topk(torch.from_numpy(lg), m.top_k)
    want = _jax_dispatch(ji, m.n_experts, C)
    got = tmoe.dispatch(ti, m.n_experts, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if T >= 24:
        assert not bool(got[2].all()), "no assignment dropped"


def test_aux_load_balance_loss_matches_reference():
    lg = _logits(32, 8, 3)
    _, ji = jmoe.router_topk(jnp.asarray(lg), 2)
    want = jmoe.aux_load_balance_loss(jnp.asarray(lg), ji, 8)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(lg),
                                     torch.from_numpy(np.array(ji)).long(), 8)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# apply_linear_batched and the expert-stacked route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("leaf", ["wi", "wo"])
def test_apply_linear_batched_matches_reference(dtype, with_delta, leaf):
    _, base, jd, _, tbase, td = _model("qwen3-moe-30b-a3b", dtype)
    w, tw = base["moe"][leaf][0], tbase["moe"][leaf][0]         # [E, h_in, h_out]
    E, h_in = tw.shape[0], tw.shape[1]
    x = np.random.default_rng(5).standard_normal((E, 3, h_in)).astype(np.float32)
    d = japply.dindex(jd["moe"][leaf], 0) if with_delta else None
    want = j_apply_batched(jnp.asarray(x), w, d)
    with attribution() as notes:
        got = tapply.apply_linear_batched(
            torch.from_numpy(x), tw, td["moe"][leaf].index(0) if with_delta else None)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    forms = [n["formulation"] for n in notes]
    assert forms == (["experts-dense"] if with_delta else [])


def test_apply_linear_batched_refuses_slot_deltas():
    _, _, _, _, _, td = _model("qwen3-moe-30b-a3b")
    d = td["moe"]["wi"].index(0)
    sd = tapply.SlotDelta(d, torch.zeros(2, dtype=torch.int64))
    x = torch.zeros((d.stack_shape()[0], 2, d.h_in))
    w = torch.zeros((d.stack_shape()[0], d.h_in, d.h_out))
    for leaf in (sd, tapply.MultiSlotDelta((sd,))):
        with pytest.raises(NotImplementedError, match="slot-dispatched deltas"):
            tapply.apply_linear_batched(x, w, leaf)


@pytest.mark.parametrize("C", [1, 5])
def test_delta_spmm_experts_plain_counts_bit_equal_and_dense(C):
    """The expert route's plain version (the segments kernel's, on the
    expert layout): with per-expert counts bit-equal to the all-C layout,
    and within 1e-5 of the dense formulation."""
    _, _, _, _, _, td = _model("qwen3-moe-30b-a3b")
    d = td["moe"]["wg"].index(1)
    E = d.stack_shape()[0]
    rng = np.random.default_rng(C)
    counts = rng.integers(0, C + 1, E)
    counts[:2] = (0, C)                       # an empty and a full expert
    x = torch.from_numpy(rng.standard_normal((E, C, d.h_in)).astype(np.float32))
    x[torch.arange(C)[None, :] >= torch.from_numpy(counts)[:, None]] = 0.0
    with attribution() as notes:
        full = ops.delta_spmm_experts(x, d)
        part = ops.delta_spmm_experts(x, d, torch.from_numpy(counts))
    assert {n["formulation"] for n in notes if n["site"] == "delta_spmm_experts"} == \
        {"experts-torch"}
    assert full.dtype == torch.float32 and tuple(full.shape) == (E, C, d.h_out)
    assert torch.equal(full.view(torch.int32), part.view(torch.int32))
    dense = x @ reconstruct_dense(d)
    np.testing.assert_allclose(full.numpy(), dense.numpy(), atol=1e-5, rtol=1e-5)
    # the layout: expert e from e*C, then its rows past the count, row -1
    rows, offs = ops.expert_segments(E, C, torch.from_numpy(counts), "cpu")
    assert rows.tolist() == [r for e in range(E) for r in (e, -1)]
    assert offs.tolist() == [v for e in range(E) for v in (e * C, e * C + counts[e])] + [E * C]
    rows, offs = ops.expert_segments(E, C, None, "cpu")
    assert rows.tolist() == list(range(E)) and offs.tolist() == [e * C for e in range(E + 1)]
    with pytest.raises(ValueError, match="stack_shape"):
        ops.delta_spmm_experts(x[:2], d)


# ---------------------------------------------------------------------------
# moe_ffn and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("with_deltas", [False, True])
@pytest.mark.parametrize("cf", [None, CF_CONSISTENT])
def test_moe_ffn_matches_reference(name, with_deltas, cf):
    """One MoE layer at cf 1.25 (drops) and 8.0; llama4-scout covers the
    shared expert and top-1."""
    jcfg, base, jd, tcfg, tbase, td = _model(name)
    x = np.random.default_rng(7).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    p = jax.tree.map(lambda a: a[1], base["moe"])
    want = j_moe_ffn(jnp.asarray(x), p, japply.dindex(jd["moe"], 1) if with_deltas else None,
                     jcfg, cf)
    got = tmoe.moe_ffn(torch.from_numpy(x), tlm._slice(tbase["moe"], 1),
                       tapply.dindex(td["moe"], 1) if with_deltas else None, tcfg, cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("B,S,cf,takes_counts", [
    (1, 1, None, True),      # 2 assignments in 8 rows (C = 1)
    (2, 1, None, True),      # 4 in 8: half the buffer, the rule's edge
    (4, 1, None, False),     # 8 in 8
    (2, 12, None, False),    # 48 in 56 (C = 7), a prefill at cf 1.25
    (2, 12, CF_CONSISTENT, True),   # 48 in 384 (C = 48)
])
def test_moe_ffn_counts_layout_by_fill(monkeypatch, B, S, cf, takes_counts):
    """moe_ffn passes per-expert counts exactly where at most half the
    expert buffer can be live (ops.expert_counts_pay), and then each
    count is that expert's kept assignments, its rows past it zero."""
    _, _, _, tcfg, tbase, td = _model("qwen3-moe-30b-a3b")
    seen = []
    real = tmoe.apply_linear_batched

    def spy(x, w, d=None, counts=None):
        seen.append((x, counts))
        return real(x, w, d, counts=counts)

    monkeypatch.setattr(tmoe, "apply_linear_batched", spy)
    x = np.random.default_rng(B * S).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    tmoe.moe_ffn(torch.from_numpy(x), tlm._slice(tbase["moe"], 0),
                 tapply.dindex(td["moe"], 0), tcfg, cf)
    m = tcfg.moe
    C = tmoe.capacity(B * S, tcfg, cf)
    assert ops.expert_counts_pay(B * S * m.top_k, m.n_experts, C) == takes_counts
    assert len(seen) == 3
    for buf, counts in seen:
        assert (counts is not None) == takes_counts
        if counts is not None:
            live = buf.abs().sum(-1) > 0                          # [E, C]
            assert int(counts.max()) <= C and int(counts.sum()) <= B * S * m.top_k
            assert torch.equal(live.sum(1), counts)
            assert not (live & (torch.arange(C)[None] >= counts[:, None])).any()


def test_moe_family_registered_and_counted():
    """Both MoE configs registered; qwen3's parameter count in the
    reference's range (tests/test_models_smoke.py:73)."""
    from repro_torch.configs import list_archs
    assert set(MOE_ARCHS) <= set(list_archs())
    q = get_config("qwen3-moe-30b-a3b")
    assert 28e9 <= q.n_params() <= 32e9
    assert 2e9 <= q.n_active_params() <= 5e9
    assert 95e9 <= get_config("llama4-scout-17b-a16e").n_params() <= 120e9
    other = get_smoke_config("wizard-llama2-7b").replace(family="retention")
    with pytest.raises(NotImplementedError, match="dense, moe, ssm, hybrid, encdec, vlm"):
        tlm.param_shapes(other)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_moe_tenants_fall_back_to_grouped():
    """Twin of tests/test_serve_scheduler.py:528: a tenant with expert
    deltas makes serve_batch fall back to per-tenant grouping, which
    serves the batch as one generate call."""
    cfg = _cf(get_smoke_config("qwen3-moe-30b-a3b"), CF_CONSISTENT)
    base = tlm.init_params(cfg, 0, device="cpu")
    [(_, deltas, _)] = synth_tenants(cfg, base, 1, RATIO_SPECS[128], seed=0)
    # expert stacks compressed matrix by matrix, the router left dense
    assert deltas["moe"]["router"] is None
    assert deltas["moe"]["wi"].stack_shape() == (cfg.n_layers, cfg.moe.n_experts)
    eng = Engine(cfg, base, max_seq=32, clock=VirtualClock(tick=1e-3))
    eng.register_tenant("m", deltas)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    reqs = [("m", prompts[0]), ("m", prompts[1]), ("m", prompts[0])]
    outs = eng.serve_batch(reqs, max_new_tokens=3)   # falls back, no crash
    assert len(outs) == 3
    np.testing.assert_array_equal(outs[0], outs[2])
    want = eng.generate("m", np.stack([r[1] for r in reqs]), max_new_tokens=3)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("table", [False, True])
def test_engine_refuses_expert_deltas(table):
    """Slot dispatch refuses packed deltas at moe/{wi,wg,wo} with the
    reference's message, and the engine stays as it was."""
    cfg, base, _, tcfg, tbase, td = _model("qwen3-moe-30b-a3b")
    kw = dict(tenant_capacity=2) if table else {}
    eng = ContinuousEngine(tcfg, tbase, n_slots=2, max_seq=32,
                           clock=VirtualClock(tick=1e-3), **kw)
    with pytest.raises(ValueError, match="cannot apply deltas at MoE expert sites"):
        eng.register_tenant("m", td)
    assert list(eng.store.names()) == []
    eng.register_tenant("a", dict(td, moe=None))     # attention-only: served
    assert list(eng.store.names()) == ["a"]


def test_continuous_moe_pruned_matches_reference_engine():
    """An MoE base with an attention-only tenant (the moe subtree pruned,
    tests/test_mesh_sharding.py:438) in ContinuousEngine: the port's
    tokens equal the reference engine's, and each request equals its
    tenant served alone."""
    jcfg, base, jd, tcfg, tbase, td = _model("qwen3-moe-30b-a3b", cf=CF_CONSISTENT)
    jd, td = dict(jd, moe=None), dict(td, moe=None)
    kw = dict(n_slots=2, max_seq=32)
    prompts = [np.random.default_rng(60 + i).integers(0, tcfg.vocab, 6).astype(np.int32)
               for i in range(3)]
    who = ["m", None, "m"]

    def run(eng, idx=(0, 1, 2)):
        hs = [eng.submit(who[i], prompts[i], max_new_tokens=4, arrival=0.0) for i in idx]
        eng.run()
        return [h.output() for h in hs]

    jeng = JContinuousEngine(jcfg, base, clock=JVirtualClock(tick=0.01), **kw)
    jeng.register_tenant("m", jd)
    want = run(jeng)
    teng = ContinuousEngine(tcfg, tbase, clock=VirtualClock(tick=0.01), **kw)
    teng.register_tenant("m", td)
    got = run(teng)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for idx in ((0, 2), (1,)):
        alone = run(teng, idx)
        for i, a in zip(idx, alone):
            np.testing.assert_array_equal(a, got[i])


def test_serve_cli_moe_arch_refuses_like_reference():
    """``--arch qwen3-moe-30b-a3b`` on the serving CLI: the reference's
    CLI registers tenants with expert deltas into its continuous engine,
    which refuses them; the port's does the same."""
    from repro_torch.launch import serve as cli
    with pytest.raises(ValueError, match="MoE expert sites"):
        cli.main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b", "--tenants", "2",
                  "--requests", "4"])
