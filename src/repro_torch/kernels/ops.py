"""Public wrappers around the delta kernels (port of ``repro/kernels/ops.py``).

Device rule: a CUDA tensor launches the CUDA kernel
(``kernels/delta_spmm.py``) and raises if it cannot; a CPU tensor takes
the kernel's plain torch version (``kernels/fallback.py``). Outside the
reference's Pallas envelope (:func:`envelope_miss`: h_g > 256, keep >
128, k_bits outside 1-8, a stacked delta) a CPU tensor takes the plain
gather/dense formulation, as the reference's ``ops.delta_spmm`` does
(``ops.py:129-131``), and leaves a ``plain-out-of-envelope`` trace note
naming the dimension. The CUDA kernels' envelope is wider
(:func:`card_envelope_miss`): they take every packing the compressor
emits (any h_g dividing h_in, up to h_in; any keep up to h_g; int32 idx
above h_g = 256), so on the card only what no producer emits raises
``ValueError`` (k_bits outside 1-8, a stacked delta at a single-delta
entry point): no plain version runs on the card.

``fused_base_delta`` and ``dequant`` (``ops.py:390-431`` of the
reference) follow the same rule; ``dequant`` is the merge path's
(``core/apply.py::merge_delta``). ``delta_spmm_experts`` has no
counterpart there (the reference reconstructs the dense expert stack):
it is the MoE expert sites' route onto the segments kernel, an expert
buffer being E segments of one stacked delta.

Gradients: every entry point but ``dequant`` is an autograd Function
whenever grad mode is on and an input requires grad, on every device:
the forward takes the route above, the backward is
``dx = g @ dequant(d)^T`` through :func:`dequant` (the dequant kernel on
the card), the dense product the reference differentiates
(``repro/kernels/ops.py``'s XLA formulation) — per segment or row for
``delta_spmm_segments``/``delta_spmm_slots`` (rows outside every
segment get a zero gradient, as their output is zero-filled), and
``dx = g @ (w + dequant(d))^T``, ``dw = x^T g`` for
``fused_base_delta``. No kernel is added for a backward.

Mesh: :func:`delta_correction_sharded` is the reference's ``shard_map``'d
output-column-partitioned correction on one rank of a
``launch.mesh.ServingMesh``: the rank's delta is its contiguous
output-column slice, cut once at registration (``launch.mesh.shard_delta``),
and the same entry points compute that slice's columns — the kernels on
the card, with no new kernel. The formulation is decided on the whole
matrix's envelope point (``PackedDelta.shards``), and every column's
reduction order is fixed in the kernels and in the plain versions, so a
slice's columns are the unsharded correction's columns bit for bit.

Tiles: the kernels take every T and h_out as they are (they mask the
ragged edges themselves), so the reference's row padding and column
padding have no counterpart. On the decode route and in the segments
kernel a row tile (1, 2, 4 or 8) caps the rows one block computes; a
block computes only real rows, so the tile is the smallest holding the
whole batch up to 8 rows — the decode fast path of ``ops.py:220-223`` —
and 8 above (:func:`row_tile`); segments are tiled from their own first
row. ``delta_spmm`` takes its prefill kernel's 128-row tile above 64 rows
for every packing (:func:`rule_spmm_tile`); the fused kernel keeps its caps 8/16/32
(:func:`fused_row_tile`). On a CUDA tensor the swept table
(``kernels/autotune.py``) comes first: ``delta_spmm`` takes the ``tb``
it holds for the delta's envelope point and the call's token-count
bucket (a decode tile or the prefill tile, :func:`spmm_tile`), the
segments kernel its own swept ``seg_tb`` at the decode step's buckets,
else ``tb`` where it is a decode tile (:func:`segments_tile`); without a table, an entry or a matching card
the rules above decide. The expert route, the fused kernel and dequant
keep their rules. Output columns go 128 to a tile on the decode
route (one cluster of 8 blocks, one per class chain; 32 at G < 8, a
cluster of G blocks with a warp a row), 32 or 64 in the prefill kernel
(32 on its windowed walk), 128 in the fused kernel and 32 in dequant. No choice
changes a row's bits in the correction kernels. The codecs' lowerings
(``core.pack.dense_groups``) take the dense-group walk on the decode tiles
and in the segments kernel (no idx read; the notes say ``walk="dense"``,
else ``"general"``: a walk that reads idx).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pack import PackedDelta, dense_groups
from repro_torch.kernels import autotune, fallback
from repro_torch.kernels import delta_spmm as _k

MAX_HG = 256
MAX_KEEP = 128
KERNEL_OB = 128    # output columns per tile on the decode route and in segments
FUSED_OB = 128     # output columns per block in the fused kernel
DEQUANT_OB = 32    # output columns per block in the dequant kernel
# delta_spmm takes the prefill kernel's 128-row tile from this many rows
# by rule (chip_smoke.py's [route] lines, PERF.md): on an H100 the decode
# route beats it at every full-width site up to 64 rows; above, the swept
# table (kernels/autotune.py) decides where it applies
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


def card_envelope_miss(d: PackedDelta) -> str | None:
    """The first dimension of ``d`` outside the CUDA kernels' envelope, or
    None. The kernels take every packing a producer emits; outside are a
    stacked delta at a single-delta entry point (the reference reaches one
    only through its dense reconstruction) and k_bits outside 1-8
    (``quant.pack_width`` has no wider width)."""
    if d.stack_shape():
        return "stack"
    if d.k_bits is not None and not 1 <= d.k_bits <= 8:
        return "k_bits"
    return None


def _out_of_envelope(site: str, d: PackedDelta, x: torch.Tensor) -> bool:
    """True when ``d`` is outside the reference's envelope and ``x`` lies
    on the CPU, after the trace note. On the card False inside the CUDA
    kernels' envelope (:func:`card_envelope_miss`); raises outside it."""
    miss = envelope_miss(d)
    if miss is None:
        return False
    if _device_kind(x) != "cpu":
        card_miss = card_envelope_miss(d)
        if card_miss is None:
            return False
        raise ValueError(f"{site}: packing h_g={d.h_g} keep={d.keep} k_bits={d.k_bits} "
                         f"is outside the CUDA kernels' envelope ({card_miss}); the "
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


def rule_spmm_tile(T: int, d: PackedDelta) -> int:
    """delta_spmm's row tile by rule: the prefill kernel's 128 rows from
    :data:`PREFILL_MIN_T` rows where it takes the packing (every packing
    since its windowed walk, :func:`delta_spmm.prefill_fits`), else
    :func:`row_tile`. Every tile gives a row the same bits."""
    tb = _k.PREFILL_TILES[0]
    if T >= PREFILL_MIN_T and _k.prefill_fits(tb, d.h_g, d.keep):
        return tb
    return row_tile(T)


def _swept_tb(T: int, d: PackedDelta, key: str = "tb") -> int | None:
    """The table's ``tb`` (or ``key``) for ``d`` at T rows (None off the
    card, without a table for this card or without an entry); a column
    slice keys on the whole matrix's width, as :func:`_gather_max_t`."""
    return autotune.swept_tb(d.h_g, d.keep, d.k_bits, d.h_in, d.h_out * d.shards, T,
                             device=d.idx.device, key=key)


def spmm_tile(T: int, d: PackedDelta) -> tuple[int, str]:
    """delta_spmm's row tile for T rows of ``d`` and where it came from:
    ``"table"`` (the swept entry, which decides the route too) or
    ``"rule"`` (:func:`rule_spmm_tile`). A table entry naming a tile the
    packing does not take raises ``ValueError``."""
    tb = _swept_tb(T, d)
    if tb is None:
        return rule_spmm_tile(T, d), "rule"
    if tb not in _k.SPMM_TILES or (tb in _k.PREFILL_TILES and
                                   not _k.prefill_fits(tb, d.h_g, d.keep)):
        raise ValueError(f"the autotune table ({autotune.table_path()}) names tb={tb} at "
                         f"h_g={d.h_g} keep={d.keep}, T={T}: not a tile this packing takes")
    return tb, "table"


def spmm_row_tile(T: int, d: PackedDelta) -> int:
    """delta_spmm's row tile (:func:`spmm_tile`)."""
    return spmm_tile(T, d)[0]


def segments_tile(T: int, d: PackedDelta) -> tuple[int, str]:
    """The segments kernel's row tile for segments of at most T rows of
    the (stacked) ``d``, and where it came from: the table's ``seg_tb``
    (swept on the segments kernel at the decode step's layouts) where it
    holds one, else its ``tb``, where either is a decode tile; else
    :func:`row_tile`."""
    tb = _swept_tb(T, d, "seg_tb")
    if tb is None:
        tb = _swept_tb(T, d)
    if tb in _k.ROW_TILES:
        return tb, "table"
    return row_tile(T), "rule"


def _gather_max_t(d: PackedDelta) -> int:
    """The CPU crossover at the matrix's envelope point: a column slice
    (``d.shards`` > 1) keys on the whole matrix's width, as the
    reference's sharded correction decides on the global point."""
    return autotune.lookup(d.h_g, d.keep, d.k_bits, d.h_in,
                           d.h_out * d.shards)["gather_max_t"]


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}; the port runs on "
                         "cuda (kernels) or cpu (plain versions)")
    return x.device.type


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


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
        tb, src = spmm_tile(x2.shape[0], d)
        if tb in _k.ROW_TILES:
            _note("delta_spmm", formulation="cuda", codec=d.codec, tb=tb, ob=KERNEL_OB,
                  tile=src, walk="dense" if dense_groups(d) else "general")
        else:   # the prefill kernel picks 64 or 32 columns by the SM count
            _note("delta_spmm", formulation="cuda-prefill", codec=d.codec, tb=tb, tile=src)
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

    With grad mode on and ``x_sorted.requires_grad`` the packed route is
    an autograd Function (:class:`_SegmentCorrection`).
    """
    if values is None and _needs_grad(x_sorted):
        return _SegmentCorrection.apply(x_sorted, d, seg_rows, seg_offsets, max_rows)
    return _delta_spmm_segments(x_sorted, d, seg_rows, seg_offsets, values, res_map,
                                max_rows)


def _segments_grad(g: torch.Tensor, d: PackedDelta, seg_rows: torch.Tensor,
                   seg_offsets: torch.Tensor) -> torch.Tensor:
    """``dx`` of a segmented correction: each segment's rows
    ``g @ dequant(d[row])^T`` (one :func:`dequant` per tenant row),
    zero outside every segment and in a segment whose row is outside
    the stack, whose output the forward zero-fills."""
    g = g.to(torch.float32)
    dx = torch.zeros((g.shape[0], d.h_in), dtype=torch.float32, device=g.device)
    rows = seg_rows.tolist()
    offs = seg_offsets.tolist()
    dense: dict = {}
    for r, lo, hi in zip(rows, offs[:-1], offs[1:]):
        if hi <= lo or not 0 <= r < d.stack_shape()[0]:
            continue
        if r not in dense:
            dense[r] = dequant(d.index(r))
        dx[lo:hi] = g[lo:hi] @ dense[r].T
    return dx


class _SegmentCorrection(torch.autograd.Function):
    """:func:`delta_spmm_segments` with a gradient for ``x_sorted``
    (:func:`_segments_grad`)."""

    @staticmethod
    def forward(ctx, x, d, seg_rows, seg_offsets, max_rows):
        ctx.d, ctx.x_dtype = d, x.dtype
        ctx.seg = (seg_rows, seg_offsets)
        return _delta_spmm_segments(x, d, seg_rows, seg_offsets, None, None, max_rows)

    @staticmethod
    def backward(ctx, g):
        dx = _segments_grad(g, ctx.d, *ctx.seg)
        return dx.to(ctx.x_dtype), None, None, None, None


def _delta_spmm_segments(x_sorted, d, seg_rows, seg_offsets, values, res_map, max_rows,
                         table: bool = True):
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
    T = x_sorted.shape[0] if max_rows is None else max_rows
    tb, src = segments_tile(T, d) if table else (row_tile(T), "rule")
    _note("delta_spmm_segments", formulation="segments-cuda", codec=d.codec,
          residency="packed", tb=tb, ob=KERNEL_OB, tile=src,
          walk="dense" if dense_groups(d) else "general")
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
    # no grad here (the caller or _ExpertCorrection.forward); the route
    # keeps its rule tile: the table is swept for dense sites, not experts
    y = _delta_spmm_segments(x.reshape(E * C, h_in), d, seg_rows, seg_offsets, None, None,
                             max_rows=C, table=False)
    where = "torch" if _device_kind(x) == "cpu" else "cuda"
    _note("delta_spmm_experts", formulation=f"experts-{where}", codec=d.codec,
          E=int(E), C=int(C), counts=counts is not None)
    return y.reshape(E, C, d.h_out)


def delta_spmm_slots(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """Per-row delta matmul: x [B, ..., h_in]; d row-gathered [B, ...].

    Row b computes ``x[b] @ dequant(d[b])``. On the card the rows are
    served as one-row segments of the segments kernel (the reference
    vmaps its per-matrix kernel over rows); on the CPU by the per-row
    gather formulation. With grad mode on and ``x.requires_grad`` it is
    an autograd Function (:class:`_SlotsCorrection`).
    """
    B = x.shape[0]
    if d.stack_shape() != (B,):
        raise ValueError(
            f"stacked delta stack_shape={d.stack_shape()} must equal "
            f"({B},) — one delta row per slot row of x {tuple(x.shape)}")
    if _needs_grad(x):
        return _SlotsCorrection.apply(x, d)
    return _delta_spmm_slots(x, d)


class _SlotsCorrection(torch.autograd.Function):
    """:func:`delta_spmm_slots` with a gradient for ``x``: row by row
    ``dx[b] = g[b] @ dequant(d[b])^T``."""

    @staticmethod
    def forward(ctx, x, d):
        ctx.d, ctx.x_dtype = d, x.dtype
        return _delta_spmm_slots(x, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        B = g.shape[0]
        per_row = g.numel() // (B * d.h_out)
        rows = torch.arange(B, dtype=torch.int32)
        offsets = torch.arange(B + 1, dtype=torch.int32) * per_row
        dx = _segments_grad(g.reshape(B * per_row, d.h_out), d, rows, offsets)
        return dx.reshape(*g.shape[:-1], d.h_in).to(ctx.x_dtype), None


def _delta_spmm_slots(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    B = x.shape[0]
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


def delta_correction_sharded(x: torch.Tensor, d: PackedDelta, mesh, *,
                             segments: tuple | None = None,
                             values: torch.Tensor | None = None,
                             res_map: torch.Tensor | None = None) -> torch.Tensor | None:
    """y = x · dequant(d) for this rank's output columns of a mesh
    (``repro/kernels/ops.py:240-390``).

    ``d`` is this model rank's output-column slice (``d.shards`` equal to
    the mesh's ``model`` extent): a shared delta, a row-gathered stack
    ``[B]`` matching ``x``'s leading dim (per-row decode), or — with
    ``segments=(seg_rows, seg_offsets)`` — the tenant stack ``[R]`` of the
    unique-tenant dispatch (x rows pre-sorted by tenant). Segment arrays
    may be the global ``[S]``/``[S+1]`` layout or the per-data-shard
    ``[D, B_s]``/``[D, B_s+1]`` one (by ndim): then ``x`` holds this data
    rank's pool rows and the rank takes its pool's block, so it decodes
    only the tenants its pool hosts. ``values``/``res_map`` (segments
    only, CPU) are the residency tier's decoded values, which a stack cut
    into slices holds as slices too. Returns ``[..., h_out / M]``, the
    columns ``[m * h_out/M, (m + 1) * h_out/M)``, computed by the
    unsharded entry points on the slice (the kernels on the card).

    Returns None — the caller's replicated path, with a trace note —
    where the reference does: no model axis, a delta that is not cut (its
    h_out does not divide, or it is replicated), a stack shape the path
    does not take, or a per-shard layout that does not match the mesh's
    data axis."""
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    why = None
    stack = d.stack_shape()
    if n <= 1:
        why = "no model axis"
    elif d.shards == 1:
        why = "replicated delta" if d.h_out % n == 0 else "h_out not divisible"
    elif d.shards != n:
        raise ValueError(f"delta cut into {d.shards} column slices on a mesh whose "
                         f"model axis is {n}")
    elif segments is not None and len(stack) != 1:
        why = f"stack {stack} for segments"
    elif segments is None and stack not in ((), (x.shape[0],)):
        why = f"stack {stack} for {tuple(x.shape)}"
    elif segments is not None and segments[0].ndim == 2 and \
            segments[0].shape[0] != mesh.shape.get("data", 1):
        why = "per-shard layout off the data axis"
    if why is not None:
        _note("delta_correction_sharded", sharded=False, why=why, codec=d.codec)
        return None
    per_shard = segments is not None and segments[0].ndim == 2
    _note("delta_correction_sharded", sharded=True, codec=d.codec,
          model_shards=int(n), per_shard_segments=per_shard)
    if segments is not None:
        seg_rows, seg_offsets = segments
        if per_shard:
            i = mesh.index("data")
            seg_rows, seg_offsets = seg_rows[i], seg_offsets[i]
        return delta_spmm_segments(x, d, seg_rows, seg_offsets, values=values,
                                   res_map=res_map)
    if stack:
        return delta_spmm_slots(x, d).to(x.dtype)
    # same dtype round-trip as the replicated path
    return delta_spmm(x, d).to(x.dtype)


def fused_base_delta(x: torch.Tensor, w: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """y = x @ (w + dequant(d)); reads x once (separate computation, fused).
    x [..., h_in], w [h_in, h_out] -> [..., h_out] f32 (inside the
    envelope).

    With grad mode on and ``x`` or ``w`` requiring grad it is an autograd
    Function (:class:`_FusedCorrection`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FusedCorrection.apply(x, w, d)
    return _fused_base_delta(x, w, d)


class _FusedCorrection(torch.autograd.Function):
    """:func:`fused_base_delta` with gradients: ``dx = g @ (w +
    dequant(d))^T`` (:func:`dequant`, the dequant kernel on the card) and
    ``dw = x^T g``, each only where its input requires grad."""

    @staticmethod
    def forward(ctx, x, w, d):
        ctx.d = d
        ctx.save_for_backward(x, w)
        return _fused_base_delta(x, w, d)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.d
        g2 = g.to(torch.float32).reshape(-1, d.h_out)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            merged = w.to(torch.float32) + dequant(d)
            dx = (g2 @ merged.T).reshape(*g.shape[:-1], d.h_in).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.to(torch.float32).reshape(-1, d.h_in).T @ g2).to(w.dtype)
        return dx, dw, None


def _fused_base_delta(x: torch.Tensor, w: torch.Tensor, d: PackedDelta) -> torch.Tensor:
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
