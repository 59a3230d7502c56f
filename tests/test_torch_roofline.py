"""The port's roofline (``repro_torch/roofline``) and single-card dry run
(``repro_torch/launch/dryrun.py``) against the reference's.

* the reference's roofline cases under the H100 constants;
* each correction kernel's work function equals the count
  ``chip_smoke.py`` made inline before it called them (its former
  formulas, copied here), so every ``bound_ms``/``bound_by`` it prints is
  unchanged;
* FLOPs counted by ``FlopCounterMode`` on ``meta``, and the analytic
  fallback of a decode cell held to that count;
* for every registered arch (published sizes), the dry run's params,
  AdamW state and cache bytes equal the reference's ``ShapeDtypeStruct``
  trees' bytes, exactly, and ``delta_specs``'s shapes and dtypes equal
  the reference's for each codec; a codec's ``leaf_spec`` matches what
  the codec really packs.

All exact: these are integer counts.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.codecs import BitDeltaSpec as JBitDeltaSpec  # noqa: E402
from repro.core.codecs import DeltaDQSpec as JDeltaDQSpec  # noqa: E402
from repro.core.codecs import LowRankSpec as JLowRankSpec  # noqa: E402
from repro.core.compress import delta_specs as j_delta_specs  # noqa: E402
from repro.launch.dryrun import SHAPES as J_SHAPES  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.utils import tree_bytes as j_tree_bytes  # noqa: E402

from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core.codecs import (  # noqa: E402
    BitDeltaSpec,
    DeltaDQSpec,
    LowRankSpec,
    codec_for_spec,
)
from repro_torch.core.compress import delta_specs  # noqa: E402
from repro_torch.core.dropout import groupwise_dropout_pack  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis as rl  # noqa: E402
from repro_torch.utils import flatten_with_paths, materialize  # noqa: E402

HLO = """
ENTRY %main {
  %p0 = bf16[128,1024]{1,0} parameter(0)
  %ag = bf16[128,16384]{1,0} all-gather(%p0), replica_groups={{0,1}}, dimensions={1}
  %ar = f32[256]{0} all-reduce(%x), to_apply=%add
  %ars = f32[1024,8]{1,0} all-reduce-start(%y), to_apply=%add
  %ard = f32[1024,8]{1,0} all-reduce-done(%ars)
  %rs = f32[64]{0} reduce-scatter(%z), dimensions={0}
  %a2a = bf16[32,32]{1,0} all-to-all(%w), dimensions={0}
  %cp = u8[1000]{0} collective-permute(%v), source_target_pairs={{0,1}}
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""


# ---------------------------------------------------------------------------
# the reference's roofline cases, H100 constants
# ---------------------------------------------------------------------------
def test_collective_parser():
    out = rl.collective_bytes(HLO)
    b = out["bytes"]
    assert b["all-gather"] == 128 * 16384 * 2
    assert b["all-reduce"] == 256 * 4 + 1024 * 8 * 4
    assert b["reduce-scatter"] == 64 * 4
    assert b["all-to-all"] == 32 * 32 * 2
    assert b["collective-permute"] == 1000
    assert out["counts"]["all-reduce"] == 2


def test_h100_constants():
    assert rl.PEAKS == {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
    assert rl.PEAK_FLOPS == 989e12 and rl.HBM_BW == 3.35e12 and rl.HBM_BYTES == 80e9
    assert rl.LINK_BW == 450e9


def test_roofline_terms_and_bottleneck():
    r = rl.Roofline(flops=rl.PEAK_FLOPS, bytes_accessed=rl.HBM_BW / 2, coll_bytes=0,
                    model_flops=rl.PEAK_FLOPS / 2)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.bottleneck == "compute"
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert r.roofline_frac == pytest.approx(0.5)

    r2 = rl.Roofline(flops=1e12, bytes_accessed=rl.HBM_BW, coll_bytes=2 * rl.LINK_BW,
                     model_flops=1e12)
    assert r2.bottleneck == "collective"
    assert r2.t_collective == pytest.approx(2.0)
    r3 = rl.Roofline(flops=67e12, bytes_accessed=0, coll_bytes=0, model_flops=0, unit="f32")
    assert r3.t_compute == pytest.approx(1.0) and r3.to_dict()["unit"] == "f32"


def test_model_flops_convention():
    assert rl.model_flops_for("train", 10, 10, 100, 1) == 6000
    assert rl.model_flops_for("decode", 10, 4, 100, 2) == 400


def test_count_flops_on_meta_and_from_callable():
    a = torch.empty((64, 128), device="meta")
    b = torch.empty((128, 32), device="meta")
    flops, out = rl.count_flops(torch.matmul, a, b)
    assert flops == 2 * 64 * 128 * 32 and out.shape == (64, 32)
    r = rl.from_callable(torch.matmul, (a, b), "decode", 10, 10, 1, unit="f32")
    assert r.flops == flops
    assert r.bytes_accessed == (64 * 128 + 128 * 32 + 64 * 32) * 4


# ---------------------------------------------------------------------------
# kernel work functions == chip_smoke.py's inline counts before them
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S, F32_FLOP_PER_S, TF32_FLOP_PER_S = 3.35e12, 67e12, 495e12


def _inline_packed_bytes(d):
    return sum(t.numel() * t.element_size() for t in (d.idx, d.codes, d.scale, d.zero))


def _inline_bound_ms(x_bytes, delta_bytes, y_bytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = (x_bytes + delta_bytes + y_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pack(h_in, h_out, h_g=16, alpha=8, k=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return groupwise_dropout_pack(torch.randn(h_in, h_out, generator=g) * 0.01,
                                  h_g=h_g, alpha=alpha, k_bits=k, generator=g)


@pytest.mark.parametrize("h_in,h_out,k", [(256, 384, 4), (512, 128, 8), (128, 96, None),
                                          (1024, 64, 1)])
@pytest.mark.parametrize("T", [1, 2, 8, 128, 1024, 3200])
def test_kernel_work_equals_inline_counts(h_in, h_out, k, T):
    d = _pack(h_in, h_out, k=k)
    pb = _inline_packed_bytes(d)
    assert rl.packed_bytes(d) == pb
    assert rl.bound_ms(*rl.delta_spmm_work(T, d)) == _inline_bound_ms(
        T * h_in * 4, pb, T * h_out * 4, 2.0 * T * d.nnz)
    for n_deltas in (1, 4, T):
        assert rl.bound_ms(*rl.segments_work(T, d, n_deltas)) == _inline_bound_ms(
            T * h_in * 4, n_deltas * pb, T * h_out * 4, 2.0 * T * d.nnz)
    assert rl.bound_ms(*rl.dequant_work(d)) == _inline_bound_ms(
        0, pb, h_in * h_out * 4, 2.0 * d.nnz)
    assert rl.bound_ms(*rl.fused_base_delta_work(T, d, 2)) == _inline_bound_ms(
        T * h_in * 4, h_in * h_out * 2 + pb, T * h_out * 4, 2.0 * T * h_in * h_out,
        TF32_FLOP_PER_S)
    for E, C in ((16, 1), (128, 10), (16, 64)):
        live, read = min(T, E * C), min(E, T)
        assert rl.bound_ms(*rl.experts_work(d, live, read, E, C)) == _inline_bound_ms(
            live * h_in * 4, read * pb, E * C * h_out * 4, 2.0 * live * d.nnz)
        assert rl.bound_ms(*rl.experts_work(d, E * C, E, E, C))[0] == _inline_bound_ms(
            E * C * h_in * 4, E * pb, E * C * h_out * 4, 2.0 * E * C * d.nnz)[0]


@pytest.mark.parametrize("codec", ["bitdelta", "lowrank", "deltadq alpha 1", "deltadq 128x"])
@pytest.mark.parametrize("T", [1, 8, 128])
def test_work_functions_read_no_idx_of_the_lowerings_only(codec, T):
    """The decode tiles' dense-group walk reads no idx of a codec lowering
    (``core.pack.dense_groups``), so the bounds of delta_spmm and the
    segments kernel on those tiles leave its idx bytes out; the 128-row
    tile's windowed walk reads them, and every other packing (a
    DeltaDQ one at keep = h_g included) keeps them, and the stored bytes
    (``packed_bytes``, the dequant and fused bounds) keep them too."""
    from repro_torch.core import codecs
    from repro_torch.core.pack import dense_groups
    h_in, h_out = 256, 48
    g = torch.Generator().manual_seed(1)
    if codec in ("bitdelta", "lowrank"):
        c = codecs.get_codec(codec)
        ft = torch.randn(h_in, h_out, generator=g) * 0.02
        spec = BitDeltaSpec() if codec == "bitdelta" else LowRankSpec(rank=4)
        d = c.runtime_packed(c.compress_leaf(torch.zeros_like(ft), ft, spec))
    else:
        d = _pack(h_in, h_out, *((128, 1.0, 2) if codec == "deltadq alpha 1" else (16, 8, 4)))
    assert dense_groups(d) == (codec in ("bitdelta", "lowrank"))
    pb = _inline_packed_bytes(d)
    read = pb - (d.idx.numel() * d.idx.element_size() if dense_groups(d) else 0)
    assert rl.packed_bytes(d) == pb and rl.read_bytes(d) == read
    assert rl.bound_ms(*rl.delta_spmm_work(T, d)) == _inline_bound_ms(
        T * h_in * 4, read, T * h_out * 4, 2.0 * T * d.nnz)
    # the 128-row tile's windowed walk reads idx for every packing
    assert rl.read_bytes(d, 128) == pb
    assert rl.bound_ms(*rl.delta_spmm_work(T, d, 128)) == _inline_bound_ms(
        T * h_in * 4, pb, T * h_out * 4, 2.0 * T * d.nnz)
    for n_deltas in (1, 4):
        assert rl.bound_ms(*rl.segments_work(T, d, n_deltas)) == _inline_bound_ms(
            T * h_in * 4, n_deltas * read, T * h_out * 4, 2.0 * T * d.nnz)
    assert rl.bound_ms(*rl.dequant_work(d)) == _inline_bound_ms(
        0, pb, h_in * h_out * 4, 2.0 * d.nnz)


# ---------------------------------------------------------------------------
# dry run and delta_specs vs the reference, every registered arch
# ---------------------------------------------------------------------------
def _j_cache_bytes(jcfg, shape):
    info = J_SHAPES[shape]
    enc = jcfg.family == "encdec"
    if info["kind"] == "prefill":
        c = jlm.cache_specs(jcfg, info["batch"], info["seq"],
                            enc_len=info["seq"] // 2 if enc else 0)
    else:
        c = jlm.cache_specs(jcfg, info["batch"], info["seq"] // 2 if enc else info["seq"],
                            enc_len=info["seq"] // 2 if enc else 0)
    return j_tree_bytes(c)


@pytest.mark.parametrize("arch", list_archs())
def test_dryrun_bytes_equal_reference(arch):
    jcfg = j_get_config(arch)
    cfg = dryrun.get_config(arch)
    p_specs = jlm.param_specs(jcfg)
    for shape in dryrun.SHAPES:
        if shape == "long_500k" and not cfg.subquadratic:
            continue
        mem = dryrun.cell_memory(cfg, shape)
        assert mem["param_bytes"] == j_tree_bytes(p_specs), shape
        if dryrun.SHAPES[shape]["kind"] == "train":
            assert mem["optimizer_bytes"] == j_tree_bytes(jadamw.state_specs(p_specs))
            assert mem["cache_bytes"] == mem["delta_bytes"] == 0
        else:
            assert mem["cache_bytes"] == _j_cache_bytes(jcfg, shape), shape
            assert mem["delta_bytes"] == j_tree_bytes(j_delta_specs(
                p_specs, JDeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=128)))
        assert mem["total_bytes"] == sum(mem[k] for k in (
            "param_bytes", "optimizer_bytes", "cache_bytes", "delta_bytes"))


def _spec_leaves(tree):
    """{path/field: (shape, dtype name)} of a delta-spec tree (either
    package): every array field of every codec leaf."""
    out = {}
    for path, leaf in flatten_with_paths(tree).items():
        if leaf is None:
            continue
        for name in ("idx", "codes", "scale", "zero", "sign", "u", "v"):
            if not hasattr(leaf, name):
                continue
            a = getattr(leaf, name)
            if isinstance(a, tuple):
                out[f"{path}/{name}"] = (tuple(a[0]), str(a[1]).replace("torch.", ""))
            elif isinstance(a, torch.Tensor):
                out[f"{path}/{name}"] = (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            else:
                out[f"{path}/{name}"] = (tuple(a.shape), jnp.dtype(a.dtype).name)
    return out


def _j_spec_tree(jtree):
    """The reference's delta-spec pytree as a dict tree of its codec
    leaves (None where a leaf is left dense)."""
    if isinstance(jtree, dict):
        return {k: _j_spec_tree(v) for k, v in jtree.items()}
    return jtree


SPECS = [(DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=128),
          JDeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=128)),
         (DeltaDQSpec(alpha=4.0, k_bits=None, h_g=16), JDeltaDQSpec(alpha=4.0, h_g=16)),
         (BitDeltaSpec(), JBitDeltaSpec()), (LowRankSpec(), JLowRankSpec())]


@pytest.mark.parametrize("arch", list_archs())
def test_delta_specs_equal_reference(arch):
    jp = jlm.param_specs(j_get_config(arch))
    tp = dryrun.param_specs(dryrun.get_config(arch))
    for spec, jspec in SPECS:
        try:
            want = _spec_leaves(_j_spec_tree(j_delta_specs(jp, jspec)))
        except ValueError as e:   # recurrentgemma's [26, 4096] gate stacks at h_g 16
            with pytest.raises(ValueError, match="unsatisfiable group size"):
                delta_specs(tp, spec)
            assert "unsatisfiable group size" in str(e)
            continue
        got = _spec_leaves(delta_specs(tp, spec))
        assert got == want, type(spec).__name__
        assert meta_bytes(delta_specs(tp, spec)) == j_tree_bytes(j_delta_specs(jp, jspec))


def meta_bytes(tree):
    from repro_torch.utils import tree_bytes
    return tree_bytes(materialize(tree))


@pytest.mark.parametrize("spec", [s for s, _ in SPECS], ids=lambda s: type(s).__name__)
def test_leaf_spec_matches_what_the_codec_packs(spec):
    g = torch.Generator().manual_seed(1)
    base = torch.randn(2, 256, 96, generator=g)
    ft = base + 0.01 * torch.randn(2, 256, 96, generator=g)
    codec = codec_for_spec(spec)
    leaf = codec.compress_leaf(base[0], ft[0], spec, generator=g)
    want = _spec_leaves({"w": leaf})
    assert _spec_leaves({"w": codec.leaf_spec(((256, 96), torch.bfloat16), spec)}) == want
    assert _spec_leaves({"w": codec.leaf_spec(base[0], spec)}) == want


def test_dryrun_cells_run_on_meta(monkeypatch):
    """A fitting dense cell counts its FLOPs with FlopCounterMode on
    meta (prefill: the base plus the correction's work); a cell that
    does not fit one card reports fits false and names the mesh; a model
    call with an op that has no meta kernel (the MoE router's bincount
    at small decode batches) falls back to the analytic count."""
    res = dryrun.run_cell("llama3.2-1b", "prefill_32k")
    assert res.ok and res.fits and res.notes["flops_source"] == "FlopCounterMode"
    assert res.roofline["unit"] == "f32" and res.notes["correction_flops"] > 0
    model = rl.model_flops_for("prefill", 0, dryrun.get_config("llama3.2-1b").n_active_params(),
                               32 * 32768, 1)
    assert res.roofline["flops_per_device"] > model
    big = dryrun.run_cell("llama3.2-1b", "decode_32k")
    assert big.ok and not big.fits and big.roofline is None and "mesh" in big.notes["needs"]
    pod = dryrun.run_cell("llama3.2-1b", "prefill_32k", mesh="pod")
    assert pod.ok and pod.fits == (pod.memory["total_bytes"] <= rl.HBM_BYTES) and pod.fits
    assert pod.notes["mesh"] == {"data": 16, "model": 16}
    assert pod.memory["total_bytes"] < res.memory["total_bytes"] / 8
    assert pod.roofline["flops_per_device"] == pytest.approx(
        res.roofline["flops_per_device"] / 256, rel=1e-12)
    qwen = dryrun.get_config("qwen3-moe-30b-a3b")
    counted, source = dryrun.base_flops(qwen, "decode_32k")
    assert source == "FlopCounterMode"

    def no_meta_kernel(*a, **k):
        raise NotImplementedError("aten::bincount has no meta kernel")
    monkeypatch.setattr(dryrun.lm, "decode_step", no_meta_kernel)
    flops, source = dryrun.base_flops(qwen, "decode_32k")
    assert source == "analytic (NotImplementedError on meta)"
    assert flops == rl.model_flops_for("decode", qwen.n_params(), qwen.n_active_params(),
                                       128, 1) + dryrun.analytic_decode_attention_flops(
        qwen, 128, 32768)
    assert dryrun.format_cell(res).startswith("[ok] llama3.2-1b__prefill_32k__single")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_train_cell_layouts_equal_reference(multi_pod, monkeypatch):
    """A pod and a multipod train cell of llama3.2-1b: every param's
    placement and every ZeRO-1 placement equal the reference's
    ``ShardingRules(...).spec_for`` and ``zero1_shardings`` (zero axes
    ``(pod, data)`` on multipod), built from an object that carries only
    the mesh's ``shape``; the reference wraps each in a ``NamedSharding``,
    which needs devices, so the test stands a function returning the spec
    in for it. The cell's per-device params and AdamW bytes are those
    placements' ``local_shape`` sums."""
    import math
    import types

    from repro.dist import sharding as jshd

    from repro_torch.launch import mesh as mesh_lib

    am = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: tuple(spec))
    jcfg = j_get_config("llama3.2-1b")
    jrules = jshd.ShardingRules(types.SimpleNamespace(shape=dict(am.shape))).with_overrides(
        **jshd.TRAIN_OVERRIDES)
    j_specs, j_axes = jlm.param_specs(jcfg), jlm.param_axes(jcfg)
    want_p = flatten_with_paths(jshd.tree_shardings(jrules, j_specs, j_axes))
    zaxes = ("pod", "data") if multi_pod else ("data",)
    want_z = flatten_with_paths(jshd.zero1_shardings(jrules, j_specs, j_axes, zaxes))
    cfg = dryrun.get_config("llama3.2-1b")
    sh = mesh_lib.train_shardings(cfg, am)
    assert mesh_lib.zero_axes(am) == zaxes
    assert flatten_with_paths(sh["params"]) == want_p
    assert flatten_with_paths(sh["opt"]["master"]) == want_z
    shapes = {k: (tuple(v.shape), jnp.dtype(v.dtype).itemsize)
              for k, v in flatten_with_paths(j_specs).items()}

    def local(pls, f32):
        return sum(math.prod(mesh_lib.local_shape(shapes[k][0], pl, am))
                   * (4 if f32 else shapes[k][1]) for k, pl in pls.items())

    cell = dryrun.run_cell("llama3.2-1b", "train_4k", mesh="multipod" if multi_pod else "pod")
    mem = cell.memory
    assert mem["param_bytes"] == local(want_p, False)
    assert mem["optimizer_bytes"] == 3 * local(want_z, True) + 4
    # the ZeRO-1 slice of the f32 grads (which also sums the microbatches),
    # and the largest gather's whole f32 gradients twice: the leaves outside
    # the stacks (the tied embedding and the final norm)
    assert cell.notes["n_micro"] == 2
    top = sum(math.prod(s) for k, (s, _) in shapes.items()
              if not k.startswith(("attn/", "mlp/")))
    assert top > max(sum(math.prod(s[1:]) for k, (s, _) in shapes.items()
                         if k.startswith(stack)) for stack in ("attn/", "mlp/"))
    assert mem["grad_bytes"] == local(want_z, True) + 2 * 4 * top


# model_flops_for's 2*N_active counts every parameter (embedding rows,
# norms) as a MAC and leaves out what the counter also sees (router,
# rotary, softmax): measured worst 1.41e-2 (llama4-scout) at decode_32k.
DECODE_FALLBACK_REL_TOL = 2.5e-2


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_decode_fallback_counts_the_whole_cache(monkeypatch, arch):
    """The analytic fallback of a decode cell counts each new token
    against the whole cache, as the model run on meta does: at
    decode_32k (where FlopCounterMode runs for these MoE configs too) the
    forced fallback lands within DECODE_FALLBACK_REL_TOL of the counted
    FLOPs, and a dense config's counted attention grows by exactly the
    analytic term between two cache lengths."""
    cfg = dryrun.get_config(arch)
    counted, source = dryrun.base_flops(cfg, "decode_32k")
    assert source == "FlopCounterMode"
    if arch == "llama3.2-1b":
        monkeypatch.setitem(dryrun.SHAPES, "decode_16k",
                            dict(kind="decode", seq=16384, batch=128))
        half, _ = dryrun.base_flops(cfg, "decode_16k")
        assert counted - half == (dryrun.analytic_decode_attention_flops(cfg, 128, 32768)
                                  - dryrun.analytic_decode_attention_flops(cfg, 128, 16384))

    def no_meta_kernel(*a, **k):
        raise NotImplementedError("aten::bincount has no meta kernel")
    monkeypatch.setattr(dryrun.lm, "decode_step", no_meta_kernel)
    fallback, source = dryrun.base_flops(cfg, "decode_32k")
    assert source == "analytic (NotImplementedError on meta)"
    assert abs(fallback / counted - 1) <= DECODE_FALLBACK_REL_TOL
    if arch == "llama4-scout-17b-a16e":
        # the one cell that takes the fallback unforced: a token against
        # a 512k cache in 48 global layers, 15x the 2 N_active FLOPs
        monkeypatch.undo()
        flops, source = dryrun.base_flops(cfg, "long_500k")
        assert source == "analytic (NotImplementedError on meta)"
        attn = dryrun.analytic_decode_attention_flops(cfg, 1, 524288)
        assert attn == 4.0 * 524288 * 48 * cfg.head_dim * cfg.n_heads
        assert flops == rl.model_flops_for("decode", cfg.n_params(), cfg.n_active_params(),
                                           1, 1) + attn
        assert attn > 10 * (flops - attn)


def test_dryrun_cli(capsys, tmp_path):
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "mamba2-370m__long_500k__single" in out and "bottleneck=" in out
    assert (tmp_path / "mamba2-370m__long_500k__single.json").exists()
