"""Dry run: every (arch x shape x mesh) cell's bytes and roofline, per H100.

The twin of ``repro/launch/dryrun.py``, which lowers and compiles every
(arch x shape x mesh) cell on 512 placeholder devices. This one builds
each cell on the ``meta`` device — nothing is allocated, nothing is
computed, no world is spawned — and reports, against one card's 80 GB:

* the params (``lm.param_shapes``), AdamW's state for a train cell
  (``adamw.state_specs``: f32 m, v and master), the serving cache
  (``lm.init_cache``) for a prefill or decode cell, and one tenant's
  packed delta at the paper's flagship 128x point (``SERVE_DELTA``,
  ``core.compress.delta_specs``);
* the roofline terms (``repro_torch.roofline``): the base model's FLOPs
  counted by ``FlopCounterMode`` while the model runs on ``meta``
  (forward and backward for a train cell), or, where an op has no
  ``meta`` kernel (the MoE router's ``bincount``, taken at small decode
  batches),
  ``model_flops_for`` plus :func:`analytic_attention_flops` (a decode
  cell: :func:`analytic_decode_attention_flops`, the whole cache); the
  correction's work from the kernels' work functions (the kernels do not
  run on ``meta``). Compute divides by the f32 peak: the port keeps the
  reference's dtype rule, so bf16 weights are promoted to f32 products.

``--mesh pod|multipod`` takes ``launch.mesh.make_production_mesh``'s
abstract (16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data,
model)`` meshes (:func:`mesh_cell_memory`): every leaf's bytes are its
``local_shape`` under the reference's layouts (``_rules_for``: the
``train`` overrides, the long-context ones for ``long_500k``, else
serve), AdamW's state in ZeRO-1 over ``(pod, data)``, whichever the mesh
has; a train cell adds the grads the port's mesh step holds on a device
(``train/train_step.py``: its ZeRO-1 slice of the f32 grads, and the
largest block's whole f32 gradients while its backward reduces them)
and picks its microbatches (:func:`pick_n_micro`). The roofline terms are per device:
FLOPs over the device count, the per-device bytes, and the collective
bytes the port issues (:func:`train_collective_bytes`,
:func:`serve_collective_bytes`). ``fits`` compares the per-device bytes
with the card; a single-card cell that does not fit names the meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Optional

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.arch import ArchConfig
from repro_torch.core.compress import delta_specs
from repro_torch.core.codecs import DeltaDQSpec
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as roofline
from repro_torch.utils import iter_leaves, materialize, tree_bytes

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}

# serving cells carry the technique-representative path: base + one
# tenant's packed delta at the paper's flagship 128x setting
SERVE_DELTA = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=128)

MESH_ITEM = ("a mesh: --mesh pod or multipod (launch.mesh.make_production_mesh's "
             "(16, 16) and (2, 16, 16))")
# bytes of an output element the serving mesh gathers (bf16 weights are
# promoted to f32 products, the reference's dtype rule)
GATHERED_ITEMSIZE = 4


def pick_n_micro(cfg: ArchConfig, batch: int, dp: int) -> int:
    """Microbatches of a train cell (``repro/launch/dryrun.py:54-69``): more
    for bigger models, halved until they divide the batch and its share
    per data replica."""
    per_dev = batch // dp
    n = cfg.n_params()
    if n > 5e10:
        target = 8
    elif n > 5e9:
        target = 4
    elif n > 1e9:
        target = 2
    else:
        target = 1
    while per_dev % target or batch % target:
        target //= 2
    return max(target, 1)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def param_specs(cfg: ArchConfig) -> dict:
    """The params tree of ``(shape, dtype)`` specs."""
    return _unflatten(lm.param_shapes(cfg))


def _cache_lens(cfg: ArchConfig, shape) -> tuple:
    """(cache length, encoder frames) of a serving cell, as the
    reference's (``repro/launch/dryrun.py:223-224``, ``:240-242``): an
    encdec cell gives half its sequence to the encoder, and its decode
    cache the other half. ``shape``: a SHAPES name or its dict."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    seq = info["seq"]
    if cfg.family != "encdec":
        return seq, 0
    return (seq if info["kind"] == "prefill" else seq // 2), seq // 2


def input_specs(cfg: ArchConfig, shape) -> dict:
    """``(shape, dtype)`` stand-ins for every model input of this cell
    (``shape``: a SHAPES name or its dict)."""
    info = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = info["batch"], info["seq"]
    i64 = torch.int64
    pdt = getattr(torch, cfg.param_dtype)
    if info["kind"] in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"tokens": ((B, S // 2), i64),
                    "enc_feats": ((B, S // 2, cfg.d_model), pdt)}
        if cfg.family == "vlm":
            return {"tokens": ((B, S), i64),
                    "image_embeds": ((B, cfg.n_frontend_tokens, cfg.d_model), pdt)}
        return {"tokens": ((B, S), i64)}
    # decode: single new token against a seq-long cache
    return {"tokens": ((B, 1), i64)}


def _tokens_of(cfg: ArchConfig, shape) -> int:
    info = SHAPES[shape] if isinstance(shape, str) else shape
    if info["kind"] in ("train", "prefill"):
        s = info["seq"] // 2 if cfg.family == "encdec" else info["seq"]
        return info["batch"] * s
    return info["batch"]  # one token per row


def analytic_attention_flops(cfg: ArchConfig, batch: int, seq: int,
                             kind: str, n_devices: int = 1) -> float:
    """Causal-attention FLOPs (``repro/launch/dryrun.py:107``).

    QK^T + PV = 4 MACs per (query, key, head_dim, head) pair; causal and
    window masks halve/bound the pair count. Training multiplies by 4
    (forward + remat forward + ~2x backward). encdec counts the decoder
    stack only, as the reference does."""
    total = 0.0
    for w in cfg.layer_windows:
        s_eff = min(w, seq) if w else seq
        pairs = batch * (seq * s_eff - (s_eff * (s_eff - 1)) // 2 if w
                         else seq * (seq + 1) // 2)
        total += 4.0 * pairs * cfg.head_dim * cfg.n_heads
    return total * (4.0 if kind == "train" else 1.0) / n_devices


def analytic_decode_attention_flops(cfg: ArchConfig, batch: int, cache_len: int) -> float:
    """Decode attention FLOPs: one new token a row against a
    ``cache_len``-long cache. The port's decode step attends over the
    whole cache (a windowed layer over its ring of ``min(w, cache_len)``
    entries), so each attention layer has ``batch * min(w, cache_len)``
    (query, key) pairs at 4 MACs per (head_dim, head); SSM and RG-LRU
    layers have none."""
    per_row = sum(min(w, cache_len) if w else cache_len
                  for kind, w in zip(cfg.layer_kinds, cfg.layer_windows)
                  if kind in ("attn", "moe"))
    return 4.0 * batch * per_row * cfg.head_dim * cfg.n_heads


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    fits: bool
    seconds: float
    skip_reason: Optional[str] = None
    error: Optional[str] = None
    memory: Optional[dict] = None
    roofline: Optional[dict] = None
    notes: Optional[dict] = None


def cell_memory(cfg: ArchConfig, shape: str) -> dict:
    """Bytes of the cell's resident trees, built on ``meta``: params,
    AdamW state (train), cache and one tenant's delta (serving)."""
    info = SHAPES[shape]
    p_specs = param_specs(cfg)
    mem = {"param_bytes": tree_bytes(materialize(p_specs)),
           "optimizer_bytes": 0, "cache_bytes": 0, "delta_bytes": 0}
    if info["kind"] == "train":
        mem["optimizer_bytes"] = tree_bytes(materialize(adamw.state_specs(p_specs)))
    else:
        max_seq, enc_len = _cache_lens(cfg, shape)
        cache = lm.init_cache(cfg, info["batch"], max_seq, enc_len=enc_len, device="meta")
        mem["cache_bytes"] = sum(t.numel() * t.element_size() for entry in cache
                                 for t in lm.cache_fields(entry).values())
        mem["delta_bytes"] = tree_bytes(materialize(delta_specs(p_specs, SERVE_DELTA)))
    mem["total_bytes"] = sum(mem.values())
    mem["card_bytes"] = roofline.HBM_BYTES
    return mem


def _rules_for(mesh, kind: str, shape: str):
    """The reference's layout of a cell (``repro/launch/dryrun.py:89-96``)."""
    from repro_torch.dist import sharding as shd
    rules = shd.ShardingRules(mesh)
    if kind == "train":
        return rules.with_overrides(**shd.TRAIN_OVERRIDES)
    if shape == "long_500k":
        return rules.with_overrides(**{**shd.SERVE_OVERRIDES, **shd.LONG_CONTEXT_OVERRIDES})
    return rules.with_overrides(**shd.SERVE_OVERRIDES)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _local_bytes(shape: tuple, dtype: torch.dtype, placement: tuple, mesh) -> int:
    from repro_torch.launch.mesh import local_shape
    return math.prod(local_shape(tuple(shape), tuple(placement), mesh)) * _itemsize(dtype)


def _tree_local_bytes(rules, specs: Any, axes: Any) -> int:
    """Per-device bytes of a spec tree (``(shape, dtype)`` leaves, or codec
    leaves of them) under ``rules``, each leaf its ``local_shape``."""
    from repro_torch.utils import is_spec
    total = 0
    for path, spec in iter_leaves(specs):
        ax = axes
        for k in path.split("/"):
            ax = ax[k]
        if spec is None:
            continue
        pairs = ([(spec, ax)] if is_spec(spec) else
                 [(getattr(spec, f.name), getattr(ax, f.name))
                  for f in dataclasses.fields(spec) if is_spec(getattr(spec, f.name))])
        for (shape, dtype), a in pairs:
            total += _local_bytes(shape, dtype, rules.spec_for(tuple(a), tuple(shape), path),
                                  rules.mesh)
    return total


def _largest_gather(cfg: ArchConfig) -> int:
    """Elements of the largest set of leaves one gather of the port's mesh
    step makes whole (``train/train_step.py``): the leaves outside the
    stacks together, or one layer row of a stack's leaves."""
    axes = dict(iter_leaves(lm.param_axes(cfg)))
    units: dict = {}
    for path, (shape, _) in lm.param_shapes(cfg).items():
        stacked = axes[path][:1] == ("layers",)
        key = path.rsplit("/", 1)[0] if stacked else ""
        units[key] = units.get(key, 0) + math.prod(shape[1:] if stacked else shape)
    return max(units.values())


def mesh_cell_memory(cfg: ArchConfig, mesh, info: dict, shape: str = "") -> dict:
    """Per-device bytes of a cell on ``mesh`` (an abstract mesh), ``info``
    a SHAPES dict: params, AdamW's ZeRO-1 state and the grads (train: the
    device's ZeRO-1 slice of the f32 grads, which also sums the
    microbatches, and the largest gather's whole f32 gradients twice,
    autograd's and the all-reduce's buffer), the batch, the cache and one
    tenant's delta (serving)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import zero_axes
    rules = _rules_for(mesh, info["kind"], shape)
    p_specs, p_axes = lm.param_specs(cfg), lm.param_axes(cfg)
    b_specs = input_specs(cfg, info)
    mem = {"param_bytes": _tree_local_bytes(rules, p_specs, p_axes),
           "optimizer_bytes": 0, "grad_bytes": 0,
           "batch_bytes": _tree_local_bytes(rules, b_specs, shd.batch_axes(b_specs)),
           "cache_bytes": 0, "delta_bytes": 0}
    if info["kind"] == "train":
        z = shd.zero1_shardings(rules, p_specs, p_axes, zero_axes(mesh))
        state = sum(_local_bytes(sp[0], torch.float32, pl, mesh)
                    for (_, sp), (_, pl) in zip(iter_leaves(p_specs), iter_leaves(z)))
        mem["optimizer_bytes"] = 3 * state + 4            # m, v, master; step
        mem["grad_bytes"] = state + 2 * 4 * _largest_gather(cfg)
    else:
        from repro_torch.core.compress import delta_axes
        max_seq, enc_len = _cache_lens(cfg, info)
        cache = lm.init_cache(cfg, info["batch"], max_seq, enc_len=enc_len, device="meta")
        total = [0]

        def leaf(name, t, ax):
            pl = rules.spec_for(tuple(ax), tuple(t.shape), name)
            total[0] += _local_bytes(tuple(t.shape), t.dtype, pl, mesh)
        shd.map_cache(leaf, cache, shd.cache_axes(cache))
        mem["cache_bytes"] = total[0]
        mem["delta_bytes"] = _tree_local_bytes(
            rules, delta_specs(p_specs, SERVE_DELTA),
            delta_axes(p_specs, p_axes, SERVE_DELTA, mesh.shape.get("model", 1)))
    mem["total_bytes"] = sum(mem.values())
    mem["card_bytes"] = roofline.HBM_BYTES
    return mem


def train_collective_bytes(cfg: ArchConfig, mesh, n_micro: int) -> float:
    """Bytes one device receives in a step of the port's mesh train step:
    every leaf all-gathered whole from its ``train``-layout slice each
    microbatch (a stacked leaf twice: forward and the remat recompute),
    each microbatch's whole f32 grads summed over the data replicas (ring
    all-reduce: 2 (dp - 1) / dp of them) and the cast ZeRO-1 slices
    gathered back to the param layout."""
    from repro_torch.launch.mesh import train_shardings
    sh = train_shardings(cfg, mesh)
    dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    axes = dict(iter_leaves(lm.param_axes(cfg)))
    z = dict(iter_leaves(sh["opt"]["master"]))
    shapes = lm.param_shapes(cfg)
    total = 0.0
    for path, pl in iter_leaves(sh["params"]):
        shape, dtype = shapes[path]
        whole = math.prod(shape) * _itemsize(dtype)
        local = _local_bytes(shape, dtype, pl, mesh)
        uses = 2 if axes[path][:1] == ("layers",) else 1
        total += n_micro * uses * (whole - local)
        total += n_micro * 2.0 * (dp - 1) / dp * 4 * math.prod(shape)
        total += local - _local_bytes(shape, dtype, z[path], mesh)
    return total


def serve_collective_bytes(cfg: ArchConfig, mesh, info: dict) -> float:
    """Bytes one device receives in one call of a serving cell on the
    port's serving mesh: each column-parallel site's output all-gathered
    over ``model`` (``core.apply``), on the device's share of the rows
    (an expert stack: its top-k assignments)."""
    from repro_torch.launch.mesh import param_shardings
    M = mesh.shape.get("model", 1)
    dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    rows = _tokens_of(cfg, info) / dp
    shapes = lm.param_shapes(cfg)
    total = 0.0
    for path, pl in iter_leaves(param_shardings(cfg, mesh)):
        if not pl or pl[-1] != "model":
            continue
        shape = shapes[path][0]
        r = rows * cfg.moe.top_k if len(shape) == 4 else rows
        total += shape[0] * r * shape[-1] * (M - 1) / M * GATHERED_ITEMSIZE
    return total


def _meta_batch(cfg: ArchConfig, shape: str) -> dict:
    return materialize(input_specs(cfg, shape))


def base_flops(cfg: ArchConfig, shape: str) -> tuple:
    """The base model's FLOPs for one call of the cell, counted with
    ``FlopCounterMode`` on ``meta`` (a train cell: the loss forward and
    its backward); where an op has no ``meta`` kernel, the analytic
    count. -> (flops, source)."""
    info = SHAPES[shape]
    kind = info["kind"]
    params = materialize(param_specs(cfg))
    batch = _meta_batch(cfg, shape)
    max_seq, enc_len = _cache_lens(cfg, shape)
    try:
        if kind == "train":
            leaves = [t.requires_grad_() for _, t in iter_leaves(params)
                      if t.is_floating_point()]

            def run():
                loss = lm.loss_fn(cfg, params, batch)[0]
                return torch.autograd.grad(loss, leaves, allow_unused=True)
        elif kind == "prefill":
            cache = lm.init_cache(cfg, info["batch"], max_seq, enc_len=enc_len, device="meta")

            def run():
                return lm.prefill(cfg, params, batch, cache)
        else:
            cache = lm.init_cache(cfg, info["batch"], max_seq, enc_len=enc_len, device="meta")
            pos = torch.empty((info["batch"],), dtype=torch.int64, device="meta")

            def run():
                return lm.decode_step(cfg, params, cache, batch["tokens"], pos)
        flops, _ = roofline.count_flops(run)
        return flops, "FlopCounterMode"
    except (NotImplementedError, RuntimeError) as e:
        model = roofline.model_flops_for(kind, cfg.n_params(), cfg.n_active_params(),
                                         _tokens_of(cfg, shape), 1)
        if kind == "decode":
            attn = analytic_decode_attention_flops(cfg, info["batch"], max_seq)
        else:
            seq = info["seq"] // (2 if cfg.family == "encdec" else 1)
            attn = analytic_attention_flops(cfg, info["batch"], seq, kind)
        return model + attn, f"analytic ({type(e).__name__} on meta)"


def correction_work(cfg: ArchConfig, shape: str) -> tuple:
    """(flops, bytes) of one tenant's corrections in one call of a
    serving cell: each compressible site's kernel once a layer, on the
    call's tokens (an MoE expert stack: the expert route with every
    token's top-k assignments live, at the config's capacity)."""
    T = _tokens_of(cfg, shape)
    flops = nbytes = 0.0
    for path, d in iter_leaves(materialize(delta_specs(param_specs(cfg), SERVE_DELTA))):
        if d is None:
            continue
        lead = d.stack_shape()
        if path.startswith("moe/") and len(lead) == 2:
            E, K = cfg.moe.n_experts, cfg.moe.top_k
            cap = max(1, math.ceil(cfg.moe.capacity_factor * T * K / E))
            live = min(T * K, E * cap)
            f, b, _ = roofline.experts_work(d.index(0).index(0), live, min(E, live), E, cap)
            n = lead[0]
        else:
            f, b, _ = roofline.delta_spmm_work(T, d.index(0) if lead else d)
            n = math.prod(lead)
        flops += n * f
        nbytes += n * b
    return flops, nbytes


def run_cell(arch: str, shape: str, mesh: str = "single",
             out_dir: Optional[str] = None) -> CellResult:
    t0 = time.time()
    cfg = get_config(arch)
    info = SHAPES[shape]
    if shape == "long_500k" and not cfg.subquadratic:
        res = CellResult(arch, shape, mesh, ok=True, fits=False, seconds=0.0,
                         skip_reason="pure full attention (DESIGN.md §4)")
    else:
        try:
            notes: dict[str, Any] = {"n_params": cfg.n_params(),
                                     "n_active": cfg.n_active_params()}
            n_dev, coll = 1, 0.0
            if mesh == "single":
                mem = cell_memory(cfg, shape)
            else:
                from repro_torch.launch.mesh import make_production_mesh
                am = make_production_mesh(multi_pod=mesh == "multipod")
                n_dev = am.size
                notes["mesh"] = dict(am.shape)
                if info["kind"] == "train":
                    dp = am.shape.get("pod", 1) * am.shape["data"]
                    notes["n_micro"] = pick_n_micro(cfg, info["batch"], dp)
                    coll = train_collective_bytes(cfg, am, notes["n_micro"])
                else:
                    coll = serve_collective_bytes(cfg, am, info)
                mem = mesh_cell_memory(cfg, am, info, shape)
            fits = mem["total_bytes"] <= roofline.HBM_BYTES
            rl = None
            if not fits:
                notes["needs"] = (MESH_ITEM if mesh == "single" else
                                  f"{mem['total_bytes'] / 1e9:.2f} GB per device of "
                                  f"{roofline.HBM_BYTES / 1e9:.0f} GB")
            else:
                flops, notes["flops_source"] = base_flops(cfg, shape)
                nbytes = mem["total_bytes"]
                if info["kind"] != "train":
                    c_flops, c_bytes = correction_work(cfg, shape)
                    notes["correction_flops"] = c_flops
                    notes["correction_bytes"] = c_bytes
                    flops += c_flops
                r = roofline.Roofline(
                    flops=flops / n_dev, bytes_accessed=float(nbytes), coll_bytes=coll,
                    model_flops=roofline.model_flops_for(
                        info["kind"], notes["n_params"], notes["n_active"],
                        _tokens_of(cfg, shape), n_dev),
                    unit="f32")
                rl = r.to_dict()
            res = CellResult(arch, shape, mesh, ok=True, fits=fits,
                             seconds=time.time() - t0, memory=mem, roofline=rl,
                             notes=notes)
        except Exception as e:   # a failure here is a bug in a spec or the model
            res = CellResult(arch, shape, mesh, ok=False, fits=False,
                             seconds=time.time() - t0, error=f"{type(e).__name__}: {e}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json"), "w") as f:
            json.dump(dataclasses.asdict(res), f, indent=1)
    return res


def format_cell(res: CellResult) -> str:
    tag = f"{res.arch}__{res.shape}__{res.mesh}"
    if res.skip_reason:
        return f"[SKIP {res.skip_reason}] {tag}"
    if not res.ok:
        return f"[FAIL] {tag}: {res.error}"
    m = res.memory
    gb = {k: m.get(k, 0) / 1e9 for k in ("param_bytes", "optimizer_bytes", "grad_bytes",
                                         "batch_bytes", "cache_bytes", "delta_bytes",
                                         "total_bytes")}
    per = " per device" if res.mesh != "single" else ""
    extra = (f"grads {gb['grad_bytes']:.2f} GB, batch {gb['batch_bytes']:.3f} GB, "
             if res.mesh != "single" else "")
    line = (f"[{'ok' if res.fits else 'does not fit'}] {tag}: params "
            f"{gb['param_bytes']:.2f} GB, adamw {gb['optimizer_bytes']:.2f} GB, {extra}cache "
            f"{gb['cache_bytes']:.2f} GB, tenant delta {gb['delta_bytes']:.3f} GB, total "
            f"{gb['total_bytes']:.2f}{per} of {m['card_bytes'] / 1e9:.0f} GB")
    if res.roofline:
        r = res.roofline
        line += (f"; bottleneck={r['bottleneck']} compute {1e3 * r['t_compute_s']:.3f} ms, "
                 f"memory {1e3 * r['t_memory_s']:.3f} ms, collective "
                 f"{1e3 * r['t_collective_s']:.3f} ms ({res.notes['flops_source']})")
    else:
        line += f"; needs {res.notes['needs']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="single", choices=["single", "pod", "multipod"],
                    help="pod (16x16) / multipod (2x16x16): per-device bytes and roofline")
    ap.add_argument("--out", default=None, help="write one JSON file a cell here")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    failed = 0
    for arch in archs:
        for shape in shapes:
            res = run_cell(arch, shape, args.mesh, out_dir=args.out)
            failed += not res.ok
            print(format_cell(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
