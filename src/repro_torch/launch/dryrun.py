"""Single-card dry run: every (arch x shape) cell's bytes and roofline on one H100.

The twin of ``repro/launch/dryrun.py``, which lowers and compiles every
(arch x shape x mesh) cell on 512 placeholder devices. One card holds no
mesh, so this one builds each cell on the ``meta`` device — nothing is
allocated and nothing is computed — and reports, against the card's 80
GB:

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

A cell that needs a mesh (``--mesh pod|multipod``, or a model whose bytes
exceed one card) reports its bytes with ``fits: false`` and names the
mesh's queue item; nothing distributed is imported.

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

MESH_ITEM = ("a mesh: the dry run's mesh cells come with the training mesh "
             "(ROADMAP section 1, item 8), from launch.mesh.make_production_mesh")


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


def _cache_lens(cfg: ArchConfig, shape: str) -> tuple:
    """(cache length, encoder frames) of a serving cell, as the
    reference's (``repro/launch/dryrun.py:223-224``, ``:240-242``): an
    encdec cell gives half its sequence to the encoder, and its decode
    cache the other half."""
    info = SHAPES[shape]
    seq = info["seq"]
    if cfg.family != "encdec":
        return seq, 0
    return (seq if info["kind"] == "prefill" else seq // 2), seq // 2


def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """``(shape, dtype)`` stand-ins for every model input of this cell."""
    info = SHAPES[shape]
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


def _tokens_of(cfg: ArchConfig, shape: str) -> int:
    info = SHAPES[shape]
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
            mem = cell_memory(cfg, shape)
            notes: dict[str, Any] = {"n_params": cfg.n_params(),
                                     "n_active": cfg.n_active_params()}
            fits = mem["total_bytes"] <= roofline.HBM_BYTES and mesh == "single"
            rl = None
            if mesh != "single" or not fits:
                notes["needs"] = MESH_ITEM
            else:
                flops, notes["flops_source"] = base_flops(cfg, shape)
                nbytes = mem["total_bytes"]
                if info["kind"] != "train":
                    c_flops, c_bytes = correction_work(cfg, shape)
                    notes["correction_flops"] = c_flops
                    notes["correction_bytes"] = c_bytes
                    flops += c_flops
                r = roofline.Roofline(
                    flops=flops, bytes_accessed=float(nbytes), coll_bytes=0.0,
                    model_flops=roofline.model_flops_for(
                        info["kind"], notes["n_params"], notes["n_active"],
                        _tokens_of(cfg, shape), 1),
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
    gb = {k: m[k] / 1e9 for k in ("param_bytes", "optimizer_bytes", "cache_bytes",
                                  "delta_bytes", "total_bytes")}
    line = (f"[{'ok' if res.fits else 'does not fit'}] {tag}: params "
            f"{gb['param_bytes']:.2f} GB, adamw {gb['optimizer_bytes']:.2f} GB, cache "
            f"{gb['cache_bytes']:.2f} GB, tenant delta {gb['delta_bytes']:.3f} GB, total "
            f"{gb['total_bytes']:.2f} of {m['card_bytes'] / 1e9:.0f} GB")
    if res.roofline:
        r = res.roofline
        line += (f"; bottleneck={r['bottleneck']} compute {1e3 * r['t_compute_s']:.3f} ms, "
                 f"memory {1e3 * r['t_memory_s']:.3f} ms ({res.notes['flops_source']})")
    else:
        line += f"; needs {res.notes['needs']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="single", choices=["single", "pod", "multipod"],
                    help="pod/multipod cells need a mesh: bytes only, fits false")
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
