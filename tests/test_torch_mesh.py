"""The port's serving mesh: layouts, the output-sharded correction, the
serving CLI's ``--devices/--data`` and the ranks' failure handling.

* Layouts (``launch.mesh`` over ``dist.sharding``, the codecs'
  ``leaf_axes`` and ``compress.delta_axes``) equal the reference's
  ``PartitionSpec`` tuples leaf for leaf at meshes (1, 2), (2, 2) and
  (1, 4) for the dense, MoE and SSM smoke configs; the reference side
  runs through ``conftest.run_subprocess`` with forced host devices.
* ``ops.delta_correction_sharded`` on each rank's column slice equals the
  port's unsharded ``delta_matmul`` bit for bit (a shared delta, a slot
  stack, both segment layouts; f32 and bf16). Each rank is a
  ``ServingMesh.view``: the correction itself needs no collective.
* ``repro_torch.launch.serve --devices 2`` spawns its ranks on the CPU
  and serves token-identically to one device (``--devices 4 --data 2``'s
  ranks run in ``tests/test_torch_mesh_engine.py``'s world).
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import apply as ap  # noqa: E402
from repro_torch.core.codecs import BitDeltaSpec, LowRankSpec  # noqa: E402
from repro_torch.core.compress import delta_axes, delta_specs  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    TRAIN_OVERRIDES,
    AbstractMesh,
    ShardingRules,
    batch_axes,
    zero1_shardings,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.serve import RATIO_SPECS, synth_tenants  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.scheduler import tenant_segments, tenant_segments_sharded  # noqa: E402
from repro_torch.utils import iter_leaves, materialize  # noqa: E402

from conftest import run_subprocess  # noqa: E402
import torch_mesh_cases as cases  # noqa: E402

ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "mamba2-370m")
MESHES = ((1, 2), (2, 2), (1, 4))


# ---------------------------------------------------------------------------
# Layouts, against the reference's PartitionSpecs
# ---------------------------------------------------------------------------
_REFERENCE_LAYOUTS = """
import json
import jax
from repro.configs import get_smoke_config
from repro.core import BitDeltaSpec, LowRankSpec
from repro.core.compress import delta_axes, delta_specs
from repro.core.pack import PackedDelta
from repro.dist import sharding as shd
from repro.launch import mesh as M
from repro.launch.serve import RATIO_SPECS
from repro.models import lm
from repro.utils import flatten_with_paths

def tup(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def flat(tree, fn):
    return {p: fn(l) for p, l in flatten_with_paths(tree).items()}

out = {}
for arch in %(archs)r:
    cfg = get_smoke_config(arch)
    deltas = delta_specs(lm.param_specs(cfg), RATIO_SPECS[128])
    for data, model in %(meshes)r:
        mesh = M.make_host_mesh(data, model)
        key = f"{arch}|{data}x{model}"
        out[key + "|serve"] = flat(M.param_shardings(cfg, mesh), lambda s: tup(s.spec))
        out[key + "|train"] = flat(M.param_shardings(cfg, mesh, "train"),
                                   lambda s: tup(s.spec))
        rules = shd.ShardingRules(mesh).with_overrides(**shd.TRAIN_OVERRIDES)
        out[key + "|zero1"] = flat(shd.zero1_shardings(rules, lm.param_specs(cfg),
                                                       lm.param_axes(cfg)),
                                   lambda s: tup(s.spec))
        batch = {"tokens": jax.ShapeDtypeStruct((8, 16), "int32"),
                 "image_embeds": jax.ShapeDtypeStruct((8, 4, 64), "float32"),
                 "extra": jax.ShapeDtypeStruct((8, 3), "float32")}
        out[key + "|batch"] = {k: tup(shd.ShardingRules(mesh).spec_for(ax, batch[k].shape))
                               for k, ax in shd.batch_axes(batch).items()}
        cache = M.cache_shardings(cfg, mesh, 4, 16)
        out[key + "|cache"] = [
            {k: tup(v.spec) for k, v in (e._asdict() if hasattr(e, "_asdict") else e).items()}
            for e in cache]
        for so in (False, True):
            sh = M.delta_shardings(deltas, mesh, shard_output=so)
            out[key + f"|delta{int(so)}"] = {
                p: [tup(l.idx.spec), tup(l.codes.spec), tup(l.scale.spec), tup(l.zero.spec)]
                for p, l in flatten_with_paths(
                    sh, is_leaf=lambda x: isinstance(x, PackedDelta)).items()
                if isinstance(l, PackedDelta)}
        for name, spec in (("deltadq", RATIO_SPECS[128]), ("bitdelta", BitDeltaSpec()),
                           ("lowrank", LowRankSpec())):
            ax = delta_axes(lm.param_specs(cfg), lm.param_axes(cfg), spec, model)
            leaves = {}
            for p, l in flatten_with_paths(
                    ax, is_leaf=lambda x: hasattr(x, "__dataclass_fields__")).items():
                if hasattr(l, "__dataclass_fields__"):
                    leaves[p] = {f: tup(getattr(l, f)) for f in l.__dataclass_fields__
                                 if isinstance(getattr(l, f), tuple)}
            out[key + f"|axes|{name}"] = leaves
print("LAYOUTS" + json.dumps(out))
"""


def _j(x):
    """A placement or logical-axes tuple as the reference side's JSON."""
    return json.loads(json.dumps([list(e) if isinstance(e, tuple) else e for e in x]))


def _port_layouts() -> dict:
    from dataclasses import fields, is_dataclass
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        deltas = materialize(delta_specs(lm.param_specs(cfg), RATIO_SPECS[128]))
        for data, model in MESHES:
            mesh = AbstractMesh((data, model), ("data", "model"))
            key = f"{arch}|{data}x{model}"
            out[key + "|serve"] = {p: _j(s) for p, s in
                                   iter_leaves(mesh_lib.param_shardings(cfg, mesh))}
            out[key + "|train"] = {p: _j(s) for p, s in
                                   iter_leaves(mesh_lib.param_shardings(cfg, mesh, "train"))}
            rules = ShardingRules(mesh).with_overrides(**TRAIN_OVERRIDES)
            out[key + "|zero1"] = {p: _j(s) for p, s in iter_leaves(
                zero1_shardings(rules, lm.param_specs(cfg), lm.param_axes(cfg)))}
            batch = {"tokens": ((8, 16), torch.int32),
                     "image_embeds": ((8, 4, 64), torch.float32),
                     "extra": ((8, 3), torch.float32)}
            out[key + "|batch"] = {k: _j(ShardingRules(mesh).spec_for(ax, batch[k][0]))
                                   for k, ax in batch_axes(batch).items()}
            out[key + "|cache"] = [
                {k: _j(v) for k, v in (e._asdict() if hasattr(e, "_asdict") else e).items()}
                for e in mesh_lib.cache_shardings(cfg, mesh, 4, 16)]
            for so in (False, True):
                sh = mesh_lib.delta_shardings(deltas, mesh, shard_output=so)
                out[key + f"|delta{int(so)}"] = {
                    p: [_j(l.idx), _j(l.codes), _j(l.scale), _j(l.zero)]
                    for p, l in iter_leaves(sh) if l is not None}
            for name, spec in (("deltadq", RATIO_SPECS[128]), ("bitdelta", BitDeltaSpec()),
                               ("lowrank", LowRankSpec())):
                ax = delta_axes(lm.param_specs(cfg), lm.param_axes(cfg), spec, model)
                out[key + f"|axes|{name}"] = {
                    p: {f.name: _j(getattr(l, f.name)) for f in fields(l)
                        if isinstance(getattr(l, f.name), tuple)}
                    for p, l in iter_leaves(ax) if is_dataclass(l)}
    return out


@pytest.fixture(scope="module")
def layouts():
    out = run_subprocess(_REFERENCE_LAYOUTS % {"archs": ARCHS, "meshes": MESHES},
                         n_devices=8)
    ref = json.loads(out.split("LAYOUTS", 1)[1])
    return ref, _port_layouts()


@pytest.mark.parametrize("what", ["serve", "train", "zero1", "batch", "cache", "delta0",
                                  "delta1", "axes|deltadq", "axes|bitdelta",
                                  "axes|lowrank"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_equal_reference(layouts, arch, what):
    """Every leaf's placement (or logical axes) at (1, 2), (2, 2) and
    (1, 4): the reference's PartitionSpec tuples, leaf for leaf."""
    ref, port = layouts
    for data, model in MESHES:
        key = f"{arch}|{data}x{model}|{what}"
        assert port[key] == ref[key], key


def test_serve_layout_shards_the_compressible_sites():
    """The serve profile shards exactly the compressible sites' output
    axis where it divides (and replicates the rest); a layout needs no
    rank, the production meshes included."""
    cfg = get_smoke_config("llama3.2-1b")
    sh = mesh_lib.param_shardings(cfg, mesh_lib.ServingMesh.view(1, 4))
    assert sh["attn"]["wq"] == (None, None, "model")
    assert sh["embed"]["tok"] == () and sh["attn"]["ln1"] == ()
    # wk/wv are 32 wide here: 4 divides them too
    assert sh["attn"]["wk"] == (None, None, "model")
    prod = mesh_lib.param_shardings(get_smoke_config("wizard-llama2-7b"),
                                    mesh_lib.make_production_mesh(multi_pod=True))
    assert prod["mlp"]["wi"] == (None, None, "model")


# ---------------------------------------------------------------------------
# The output-sharded correction, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet():
    cfg = get_smoke_config("wizard-llama2-7b")
    base = lm.init_params(cfg, 0, device="cpu")
    return cfg, synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)


def _views(data, model):
    return [[mesh_lib.ServingMesh.view(data, model, data_index=d, model_index=m)
             for m in range(model)] for d in range(data)]


def _x(shape, dtype, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32) * 0.5).to(dtype)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("T", [3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_shared_delta_bit_identical(fleet, model, T, dtype):
    """A shared delta: each rank's columns (decode-size T on the gather
    formulation, prefill-size T on the dense one, decided on the whole
    matrix's envelope point) equal the unsharded ``delta_matmul``'s."""
    _, ten = fleet
    ap.set_mesh(None)
    for path in ("attn/wq", "mlp/wi", "mlp/wo"):
        stack, name = path.split("/")
        d = ten[0][1][stack][name].index(0)
        x = _x((2, T // 2 if T > 3 else T, d.h_in), dtype, 1)
        want = ap.delta_matmul(x, d)
        views = _views(1, model)[0]
        got = torch.cat([ops.delta_correction_sharded(x, mesh_lib.shard_delta(d, v), v)
                         for v in views], dim=-1)
        assert torch.equal(got, want), path
        # the same through apply's mesh mode, rank by rank
        parts = []
        for v in views:
            ap.set_mesh(v)
            parts.append(ap.delta_matmul(x, mesh_lib.shard_delta(d, v)))
        ap.set_mesh(None)
        assert torch.equal(torch.cat(parts, dim=-1), want), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_slot_stack_bit_identical(fleet, dtype):
    """A row-gathered stack [B] (per-row decode): rank columns equal the
    unsharded per-row correction; a stack of another extent takes the
    replicated path (None)."""
    _, ten = fleet
    d0 = [t[1]["mlp"]["wi"].index(0) for t in ten]
    stk = ap.stack_tenant_deltas(d0)
    rows = torch.tensor([0, 2, 1, 1])
    g = stk.with_arrays(stk.idx[rows], stk.codes[rows], stk.scale[rows], stk.zero[rows])
    x = _x((4, 1, g.h_in), dtype, 2)
    want = ops.delta_spmm_slots(x, g).to(dtype)
    views = _views(1, 2)[0]
    cuts = [mesh_lib.shard_delta(g, v) for v in views]
    got = torch.cat([ops.delta_correction_sharded(x, c, v) for c, v in zip(cuts, views)],
                    dim=-1)
    assert torch.equal(got, want)
    assert ops.delta_correction_sharded(x[:3], cuts[0], views[0]) is None
    # no model axis, or a delta that is not cut: the replicated path
    assert ops.delta_correction_sharded(x, g, views[0]) is None
    assert ops.delta_correction_sharded(x, g, mesh_lib.ServingMesh.view(2, 1)) is None


@pytest.mark.parametrize("layout", ["global", "per_data_shard"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_segments_bit_identical(fleet, layout, dtype):
    """The mixed step's segments over {base, tenant0..2}: the global
    layout on a (1, 2) mesh and the per-data-shard layout on (2, 2) give
    each rank its pool's rows and its columns, equal to the unsharded
    segment dispatch's."""
    _, ten = fleet
    d0 = [t[1]["mlp"]["wo"].index(0) for t in ten]
    stk = ap.stack_tenant_deltas([ap.zero_delta_like(d0[0])] + d0)
    rows = np.asarray([0, 1, 2, 3, 1, 0, 3, 2], np.int32)
    x = _x((8, stk.h_in), dtype, 3)
    if layout == "global":
        seg = tenant_segments(rows, skip_zero_row=True).to("cpu")
        xs = x[seg.order]
        want = ops.delta_spmm_segments(xs, stk, seg.seg_rows, seg.seg_offsets)
        views = _views(1, 2)[0]
        got = torch.cat([ops.delta_correction_sharded(
            xs, mesh_lib.shard_delta(stk, v), v, segments=(seg.seg_rows, seg.seg_offsets))
            for v in views], dim=-1)
        assert torch.equal(got, want)
        return
    seg = tenant_segments_sharded(rows, 2, skip_zero_row=True).to("cpu")
    order, _ = seg.global_order()
    want = ops.delta_spmm_segments(x[order], stk, *seg.global_segments())
    for d, views in enumerate(_views(2, 2)):
        xp = x[d * 4:(d + 1) * 4][seg.order[d]]
        got = torch.cat([ops.delta_correction_sharded(
            xp, mesh_lib.shard_delta(stk, v), v, segments=(seg.seg_rows, seg.seg_offsets))
            for v in views], dim=-1)
        assert torch.equal(got, want[d * 4:(d + 1) * 4]), d
    # a per-shard layout off the mesh's data axis: the replicated path
    v = mesh_lib.ServingMesh.view(1, 2)
    assert ops.delta_correction_sharded(x[:4], mesh_lib.shard_delta(stk, v), v,
                                        segments=(seg.seg_rows, seg.seg_offsets)) is None


def test_sharded_segments_match_reference_layout():
    """``tenant_segments_sharded`` equals the reference's per-pool layout
    (a copy of ``repro/serve/scheduler.py:232``), and its global
    flattening equals the reference's ``global_order``/``global_segments``."""
    from repro.serve.scheduler import tenant_segments_sharded as j_sharded
    rng = np.random.default_rng(4)
    for D, B in ((2, 8), (4, 8), (2, 6)):
        rows = rng.integers(0, 4, B).astype(np.int32)
        j, t = j_sharded(rows, D), tenant_segments_sharded(rows, D)
        for f in ("order", "inv_order", "seg_rows", "seg_offsets"):
            np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)))
        tt = t.to("cpu")
        for a, b in zip(tt.global_order() + tt.global_segments(),
                        j.global_order() + j.global_segments()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The serving CLI and the ranks' failure handling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args,shape", [
    (("--devices", "2", "--check-identity"), "{'data': 1, 'model': 2}"),
])
def test_serve_cli_devices(capfd, monkeypatch, args, shape):
    """The launcher spawns its ranks, rank 0 prints the mesh and the
    report (the ranks write to this process's stdout), and the sharded
    stream equals the one-device stream. (``--devices 4 --data 2`` runs
    its ranks in ``tests/test_torch_mesh_engine.py``'s world.)"""
    from repro_torch.launch import serve
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # each rank's threads
    rc = serve.main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                     "--arrival-gap", "0", *args])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert f"mesh: {shape}" in out
    assert "token identity vs single device: OK (3 requests)" in out
    assert out.count("served 3 requests") == 1


@pytest.mark.parametrize("bad", [["--devices", "3", "--data", "2"], ["--data", "2"],
                                 ["--devices", "2", "--data", "2", "--slots", "3"]])
def test_serve_cli_argument_checks(bad):
    """The reference's checks, before any rank is spawned."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--data"):
        serve.main(["--device", "cpu", *bad])


@pytest.mark.parametrize("fn,err,deadline", [(cases.die_on_rank_one, RuntimeError, 60.0),
                                             (cases.hang_on_rank_one, TimeoutError, 4.0)])
def test_a_dead_or_hung_rank_fails_the_world(tmp_path, monkeypatch, fn, err, deadline):
    """A rank that raises fails the call at once with its traceback (the
    rank waiting for it in a barrier does not hold the call to the
    collective's timeout); one that hangs fails it at the world's
    deadline. Two outcomes of ``run_ranks``, so two worlds."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.monotonic()
    with pytest.raises(err, match="rank 1 dies" if err is RuntimeError else "did not finish"):
        mesh_lib.run_ranks(fn, 2, device="cpu", timeout_s=deadline,
                           rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < deadline + 15.0
