"""Public wrappers around the delta kernels (port of ``repro/kernels/ops.py``,
without ``shard_map``).

Device rule: a CUDA tensor launches the CUDA kernel
(``kernels/delta_spmm.py``) and raises if it cannot; a CPU tensor takes
the kernel's plain torch version (``kernels/fallback.py``). Outside the
envelope (h_g > 256, keep > 128, k_bits outside 1-8, a stacked delta) a
CPU tensor takes the plain gather/dense formulation, as the reference's
``ops.delta_spmm`` does (``ops.py:129-131``), and leaves a
``plain-out-of-envelope`` trace note naming the dimension; a CUDA tensor
there raises ``ValueError``: no plain version runs on the card.

``fused_base_delta`` and ``dequant`` (``ops.py:390-431`` of the
reference) follow the same rule; ``dequant`` is the merge path's
(``core/apply.py::merge_delta``). ``delta_spmm_experts`` has no
counterpart there (the reference reconstructs the dense expert stack):
it is the MoE expert sites' route onto the segments kernel, an expert
buffer being E segments of one stacked delta.

Gradients: ``delta_spmm`` and ``delta_spmm_experts`` are autograd
Functions whenever grad mode is on and ``x.requires_grad``, on every
device: the forward takes the route above, the backward is
``dx = g @ dequant(d)^T`` through :func:`dequant` (the dequant kernel on
the card), the dense product the reference differentiates
(``repro/kernels/ops.py``'s XLA formulation). ``delta_spmm_segments``,
``delta_spmm_slots`` and ``fused_base_delta`` have no backward: on a
CUDA tensor autograd tracks they raise rather than return a detached
correction.

Tiles: the kernels take every T and h_out as they are (they mask the
ragged edges themselves), so the reference's row padding and column
padding have no counterpart. On the decode route and in the segments
kernel a row tile (1, 2, 4 or 8) caps the rows one block computes; a
block computes only real rows, so the tile is the smallest holding the
whole batch up to 8 rows — the decode fast path of ``ops.py:220-223`` —
and 8 above (:func:`row_tile`); segments are tiled from their own first
row. ``delta_spmm`` takes its prefill kernel's 128-row tile above 64 rows
(:func:`spmm_row_tile`); the fused kernel keeps its caps 8/16/32
(:func:`fused_row_tile`). Output columns go 128 to a tile on the decode
route (one cluster of 8 blocks, one per class chain), 32 or 64 in the
prefill kernel, 128 in the fused kernel and 32 in dequant. No choice
changes a row's bits in the correction kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pack import PackedDelta
from repro_torch.kernels import autotune, fallback
from repro_torch.kernels import delta_spmm as _k

MAX_HG = 256
MAX_KEEP = 128
KERNEL_OB = 128    # output columns per tile on the decode route and in segments
FUSED_OB = 128     # output columns per block in the fused kernel
DEQUANT_OB = 32    # output columns per block in the dequant kernel
# delta_spmm takes the prefill kernel's 128-row tile from this many rows
# (chip_smoke.py's [route] lines, PERF.md): on an H100 the decode route
# beats it at every full-width site up to 64 rows; above, the 128-row tile
# wins at MLP wo (h_in 11008) but loses at wq and wi
PREFILL_MIN_T = 65
# delta_spmm_experts takes per-expert counts when at most this share of
# the E * C buffer rows can be live (T * K assignments): on an H100 the
# counts layout wins at a share of 1/8 and 1/2 and loses at 4/5, where
# nearly every expert is read either way (chip_smoke.py's [moe] lines)
EXPERT_COUNTS_MAX_FILL = 0.5


def _note(site: str, **attrs) -> None:
    """Report the chosen path to an open trace context (no-op otherwise)."""
    from repro_torch.serve.trace import note_path
    note_path(site, **attrs)


def envelope_miss(d: PackedDelta) -> str | None:
    """The first dimension of ``d`` outside the kernels' envelope, or None."""
    if d.stack_shape():
        return "stack"
    if d.h_g > MAX_HG:
        return "h_g"
    if d.keep > MAX_KEEP:
        return "keep"
    if d.k_bits is not None and not 1 <= d.k_bits <= 8:
        return "k_bits"
    return None


def kernel_supported(d: PackedDelta) -> bool:
    return envelope_miss(d) is None


def _out_of_envelope(site: str, d: PackedDelta, x: torch.Tensor) -> bool:
    """True when ``d`` is outside the envelope and ``x`` lies on the CPU,
    after the trace note; raises on any other device."""
    miss = envelope_miss(d)
    if miss is None:
        return False
    if _device_kind(x) != "cpu":
        raise ValueError(f"{site}: packing h_g={d.h_g} keep={d.keep} k_bits={d.k_bits} "
                         f"is outside the CUDA kernels' envelope ({miss}); the "
                         "plain formulation runs on the CPU only")
    _note(site, formulation="plain-out-of-envelope", codec=d.codec, dim=miss)
    return True


def _smallest_holding(T: int, tiles: tuple) -> int:
    for tb in tiles:
        if T <= tb:
            return tb
    return tiles[-1]


def row_tile(T: int) -> int:
    """Decode-route and segments row tile for T rows (see module doc)."""
    return _smallest_holding(T, _k.ROW_TILES)


def fused_row_tile(T: int) -> int:
    """The fused kernel's row-tile cap for T rows."""
    return _smallest_holding(T, _k.FUSED_TILES)


def spmm_row_tile(T: int, d: PackedDelta) -> int:
    """delta_spmm's row tile: the prefill kernel's 128 rows from
    :data:`PREFILL_MIN_T` rows where its shared memory fits, else
    :func:`row_tile`. Every tile gives a row the same bits."""
    tb = _k.PREFILL_TILES[0]
    if T >= PREFILL_MIN_T and _k.prefill_fits(tb, d.h_g, d.keep):
        return tb
    return row_tile(T)


def _gather_max_t(d: PackedDelta) -> int:
    return autotune.lookup(d.h_g, d.keep, d.k_bits, d.h_in, d.h_out)["gather_max_t"]


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}; the port runs on "
                         "cuda (kernels) or cpu (plain versions)")
    return x.device.type


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _refuse_grad(site: str, x: torch.Tensor) -> None:
    """A CUDA route without a backward refuses an input autograd tracks:
    the kernel's output would come back detached, and ``backward`` would
    drop the correction's share of the input's gradient without a word."""
    if _needs_grad(x) and _device_kind(x) == "cuda":
        raise RuntimeError(
            f"{site}: this CUDA route has no backward; call it under "
            "torch.no_grad() or on an input that does not require grad "
            "(training takes delta_spmm or delta_spmm_experts)")


class _Correction(torch.autograd.Function):
    """``x @ dequant(d)`` with a gradient for ``x``.

    forward: the route :func:`_delta_spmm` takes (the kernel on the card,
    the plain version on the CPU). backward: ``dx = g @ dequant(d)^T``
    through :func:`dequant` (the dequant kernel on the card), a dense
    product as the reference differentiates its XLA formulation. The
    packed delta is integer data and gets no gradient."""

    @staticmethod
    def forward(ctx, x, d):
        ctx.d, ctx.x_dtype = d, x.dtype
        return _delta_spmm(x, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        dx = g.to(torch.float32).reshape(-1, d.h_out) @ dequant(d).T
        return dx.reshape(*g.shape[:-1], d.h_in).to(ctx.x_dtype), None


def delta_spmm(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """y = x @ dequant(d). x [..., h_in] -> [..., h_out] (f32).

    With grad mode on and ``x.requires_grad`` the product is an autograd
    Function (:class:`_Correction`), on every device; its backward runs
    :func:`dequant`."""
    if _needs_grad(x):
        return _Correction.apply(x, d)
    return _delta_spmm(x, d)


def _delta_spmm(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    gmax = _gather_max_t(d)
    if _out_of_envelope("delta_spmm", d, x):
        return fallback.correction_nd(x, d, gather_max_t=gmax)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d.h_in)
    if _device_kind(x2) == "cpu":
        y = fallback.correction(x2, d, gather_max_t=gmax)
    else:
        tb = spmm_row_tile(x2.shape[0], d)
        if tb in _k.ROW_TILES:
            _note("delta_spmm", formulation="cuda", codec=d.codec, tb=tb, ob=KERNEL_OB)
        else:   # the prefill kernel picks 64 or 32 columns by the SM count
            _note("delta_spmm", formulation="cuda-prefill", codec=d.codec, tb=tb)
        # the kernels take f32 activations (the TPU kernel upcasts x itself)
        y = _k.delta_spmm_cuda(x2.to(torch.float32).contiguous(), d, tb=tb)
    return y.reshape(*lead, d.h_out)


def delta_spmm_segments(x_sorted: torch.Tensor, d: PackedDelta,
                        seg_rows: torch.Tensor,
                        seg_offsets: torch.Tensor,
                        values: torch.Tensor | None = None,
                        res_map: torch.Tensor | None = None,
                        max_rows: int | None = None) -> torch.Tensor:
    """Unique-tenant batched slot dispatch: x_sorted rows grouped by tenant.

    x_sorted [T, h_in] (each tenant one contiguous segment); d is the
    tenant-stacked PackedDelta [R, ...]; seg_rows [S] int32 maps segment
    -> tenant row; seg_offsets [S+1] int32 bounds each segment (empty
    segments allowed). Each unique delta is decoded once per segment.

    ``values``/``res_map`` (the pre-decoded residency tier) take the plain
    values formulation on CPU tensors, as the reference sends them to its
    XLA formulation (``repro/kernels/ops.py:212-214``): the segments
    kernel decodes each tile once per segment already, so no kernel reads
    values. On a CUDA tensor they raise ``ValueError``: no plain version
    runs on the card, and the engine never passes them there.

    ``max_rows`` (optional) bounds every segment's length, so the row tile
    is chosen from it instead of from all T rows (every tile gives a row
    the same bits).
    """
    _refuse_grad("delta_spmm_segments", x_sorted)
    if values is not None:
        if _device_kind(x_sorted) != "cpu":
            raise ValueError(
                "delta_spmm_segments: values= (resident decoded values) "
                "has no CUDA kernel; on the card the segments kernel "
                "decodes the packed codes, so serve those")
        return fallback.segment_correction(x_sorted, d, seg_rows, seg_offsets,
                                           values=values, res_map=res_map)
    if _out_of_envelope("delta_spmm_segments", d.index(0), x_sorted) or \
            _device_kind(x_sorted) == "cpu":
        return fallback.segment_correction(x_sorted, d, seg_rows, seg_offsets)
    tb = row_tile(x_sorted.shape[0] if max_rows is None else max_rows)
    _note("delta_spmm_segments", formulation="segments-cuda", codec=d.codec,
          residency="packed", tb=tb, ob=KERNEL_OB)
    return _k.delta_spmm_segments_cuda(
        x_sorted.to(torch.float32).contiguous(), d,
        seg_rows.to(torch.int32).contiguous(),
        seg_offsets.to(torch.int32).contiguous(), tb=tb)


def expert_segments(n_experts: int, cap: int, counts: torch.Tensor | None,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """The segment layout of an expert buffer [E, C, h_in] flattened to
    [E * C, h_in]: expert e is the segment of rows from e * C with tenant
    row e. Without ``counts`` it spans all C rows (seg_rows = arange(E),
    offsets e * C). With ``counts`` [E] (each at most C) it spans its
    counts[e] live rows and is followed by a segment over the rest of its
    C rows with tenant row -1, outside the stack, which the kernel and
    its plain version zero-fill. -> (seg_rows, seg_offsets) int32 on
    ``device``, built there (no host sync)."""
    bounds = torch.arange(n_experts + 1, dtype=torch.int32, device=device) * cap
    rows = torch.arange(n_experts, dtype=torch.int32, device=device)
    if counts is None:
        return rows, bounds
    ends = bounds[:-1] + counts.to(device=device, dtype=torch.int32).clamp(0, cap)
    seg_rows = torch.stack([rows, torch.full_like(rows, -1)], dim=1).reshape(-1)
    offsets = torch.cat([torch.stack([bounds[:-1], ends], dim=1).reshape(-1), bounds[-1:]])
    return seg_rows, offsets


def expert_counts_pay(n_assign: int, n_experts: int, cap: int) -> bool:
    """Whether an expert buffer of ``n_experts`` x ``cap`` rows filled by
    at most ``n_assign`` assignments goes through the counts layout
    (:data:`EXPERT_COUNTS_MAX_FILL`); host integers only, no sync."""
    return n_assign <= EXPERT_COUNTS_MAX_FILL * n_experts * cap


def delta_spmm_experts(x: torch.Tensor, d: PackedDelta,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """Expert-stacked correction: y[e, c] = x[e, c] @ dequant(d[e]).

    x [E, C, h_in] (an MoE expert buffer), d the expert-stacked
    PackedDelta [E, ...]; ``counts`` [E] (optional) each expert's live
    rows, the rest of its C rows being zero. -> [E, C, h_out] f32.

    The buffer is E segments of :func:`delta_spmm_segments`
    (:func:`expert_segments`): one launch decodes each expert's packed
    tile once per row tile, and with ``counts`` an expert with no token is
    not read at all. A zero row's correction is +0.0 in the kernel and its
    plain version, so ``counts`` leave every bit as the all-C layout gives
    it. The row tile is chosen from the longest segment, C rows, not from
    the E * C rows of the buffer. With grad mode on and ``x.requires_grad``
    it is an autograd Function (:class:`_ExpertCorrection`).
    """
    E, C, h_in = x.shape
    if d.stack_shape() != (E,):
        raise ValueError(f"expert-stacked delta stack_shape={d.stack_shape()} must "
                         f"equal ({E},), the experts of x {tuple(x.shape)}")
    if _device_kind(x) == "cuda":   # refuse outside the envelope under this name
        _out_of_envelope("delta_spmm_experts", d.index(0), x)
    if _needs_grad(x):
        return _ExpertCorrection.apply(x, d, counts)
    return _delta_spmm_experts(x, d, counts)


class _ExpertCorrection(torch.autograd.Function):
    """:func:`delta_spmm_experts` with a gradient for ``x``: expert by
    expert ``dx[e] = g[e] @ dequant(d[e])^T`` (:func:`dequant` refuses a
    stacked leaf on the card), zero in the rows past ``counts[e]``, whose
    output the forward zero-fills whatever x holds there."""

    @staticmethod
    def forward(ctx, x, d, counts):
        ctx.d, ctx.counts, ctx.x_dtype = d, counts, x.dtype
        return _delta_spmm_experts(x, d, counts)

    @staticmethod
    def backward(ctx, g):
        d, counts = ctx.d, ctx.counts
        g = g.to(torch.float32)
        dx = torch.stack([g[e] @ dequant(d.index(e)).T for e in range(g.shape[0])])
        if counts is not None:
            live = torch.arange(g.shape[1], device=g.device)[None, :] < \
                counts.to(g.device)[:, None]
            dx = dx * live[..., None]
        return dx.to(ctx.x_dtype), None, None


def _delta_spmm_experts(x: torch.Tensor, d: PackedDelta,
                        counts: torch.Tensor | None) -> torch.Tensor:
    E, C, h_in = x.shape
    seg_rows, seg_offsets = expert_segments(E, C, counts, x.device)
    y = delta_spmm_segments(x.reshape(E * C, h_in), d, seg_rows, seg_offsets, max_rows=C)
    where = "torch" if _device_kind(x) == "cpu" else "cuda"
    _note("delta_spmm_experts", formulation=f"experts-{where}", codec=d.codec,
          E=int(E), C=int(C), counts=counts is not None)
    return y.reshape(E, C, d.h_out)


def delta_spmm_slots(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """Per-row delta matmul: x [B, ..., h_in]; d row-gathered [B, ...].

    Row b computes ``x[b] @ dequant(d[b])``. On the card the rows are
    served as one-row segments of the segments kernel (the reference
    vmaps its per-matrix kernel over rows); on the CPU by the per-row
    gather formulation.
    """
    _refuse_grad("delta_spmm_slots", x)
    B = x.shape[0]
    if d.stack_shape() != (B,):
        raise ValueError(
            f"stacked delta stack_shape={d.stack_shape()} must equal "
            f"({B},) — one delta row per slot row of x {tuple(x.shape)}")
    if _out_of_envelope("delta_spmm_slots", d.index(0), x) or _device_kind(x) == "cpu":
        _note("delta_spmm_slots", formulation="per-row-gather",
              codec=d.codec, B=int(B))
        return fallback.gather_correction_rows(x, d)
    _note("delta_spmm_slots", formulation="per-row-segments-cuda",
          codec=d.codec, B=int(B))
    per_row = x.numel() // (B * d.h_in)
    rows = torch.arange(B, dtype=torch.int32, device=x.device)
    offsets = torch.arange(B + 1, dtype=torch.int32, device=x.device) * per_row
    y = delta_spmm_segments(x.reshape(B * per_row, d.h_in), d, rows, offsets)
    return y.reshape(*x.shape[:-1], d.h_out)


def fused_base_delta(x: torch.Tensor, w: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """y = x @ (w + dequant(d)); reads x once (separate computation, fused).
    x [..., h_in], w [h_in, h_out] -> [..., h_out] f32 (inside the
    envelope)."""
    _refuse_grad("fused_base_delta", x)
    if _out_of_envelope("fused_base_delta", d, x):
        dt = torch.promote_types(x.dtype, w.dtype)
        return (x.to(dt) @ w.to(dt)) + delta_spmm(x, d).to(w.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d.h_in)
    if _device_kind(x2) == "cpu":
        y = fallback.fused_base_delta(x2, w, d)
    else:
        tb = fused_row_tile(x2.shape[0])
        _note("fused_base_delta", formulation="cuda-3xtf32", codec=d.codec, tb=tb,
              ob=FUSED_OB)
        # f32 activations, as delta_spmm; W is read as stored (bf16 or f32)
        y = _k.fused_base_delta_cuda(x2.to(torch.float32).contiguous(),
                                     w.contiguous(), d, tb=tb)
    return y.reshape(*lead, d.h_out)


def dequant(d: PackedDelta) -> torch.Tensor:
    """Materialize the dense delta [h_in, h_out] f32 (merge path)."""
    if _out_of_envelope("dequant", d, d.idx) or _device_kind(d.idx) == "cpu":
        return fallback.dequant(d)
    _note("dequant", formulation="cuda", codec=d.codec, ob=DEQUANT_OB)
    return _k.dequant_cuda(d)


def segment_decode_tiles(seg_offsets, *, n_groups: int, h_out: int,
                         tb: int, ob: int) -> int:
    """Decode-tile work the segments kernel executes for one step.

    Counts (segment row tile, column tile, group) points — how many
    [keep, ob] tiles are decoded. The kernel tiles each nonempty segment
    from its own first row, ``ceil(len / tb)`` tiles of at most ``tb``
    rows, and decodes every group's tile once per row tile. A per-row
    dispatch decodes ``B * n_groups * ceil(h_out / ob)`` tiles regardless
    of duplication; the segments kernel decodes per *unique* tenant per
    row tile."""
    offs = np.asarray(seg_offsets).astype(np.int64)
    lens = np.maximum(offs[1:] - offs[:-1], 0)
    row_tiles = int((-(-lens // tb)).sum())
    return row_tiles * n_groups * (-(-h_out // ob))


def per_row_decode_tiles(batch: int, *, n_groups: int, h_out: int,
                         ob: int) -> int:
    """Decode-tile work of a per-row dispatch (T=1 rows)."""
    return batch * n_groups * (-(-h_out // ob))
