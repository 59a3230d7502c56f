"""Plain-torch oracles for the delta kernels (port of ``repro/kernels/ref.py``).

Each kernel has a ref twin here; the CPU tests hold the port against
these as well as against the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.pack import PackedDelta, decode_values, dense_groups, reconstruct_dense


def delta_spmm_ref(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x [T, h_in] @ dequant(delta) [h_in, h_out] -> [T, h_out] (f32)."""
    return x.to(torch.float32) @ reconstruct_dense(d, dtype=torch.float32)



def fused_base_delta_ref(x: torch.Tensor, w: torch.Tensor,
                         d: PackedDelta) -> torch.Tensor:
    """x @ (W_base + dequant(delta)) in one pass -> [T, h_out] (f32)."""
    dense = reconstruct_dense(d, dtype=torch.float32)
    return x.to(torch.float32) @ (w.to(torch.float32) + dense)


def dequant_tile_ref(d: PackedDelta) -> torch.Tensor:
    """Materialize the dense delta [h_in, h_out] (f32)."""
    return reconstruct_dense(d, dtype=torch.float32)


def correction_kernel_order(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x [T, h_in] @ dequant(delta) -> [T, h_out] f32 in the CUDA
    correction kernels' reduction order, bit for bit.

    Eight class partials: P_c is a chain ``acc = acc + x[r, g*h_g + id] * v``
    from 0, over the groups g = c (mod 8) in increasing g, then the kept
    slots k = 0..keep-1, each product and each sum rounded on its own (no
    FMA). Then ((P0 + P1) + P2) + ... + P7. Elementwise torch ops round
    each result separately, so this is the kernels' arithmetic, one
    (group, slot) at a time."""
    x = x.to(torch.float32)
    vals = decode_values(d)                                   # [G, K, O]
    G, K, O = vals.shape
    base = torch.arange(G, dtype=torch.int64, device=x.device)[:, None, None] * d.h_g
    gidx = d.idx.to(torch.int64) + base                       # [G, K, O]
    total = None
    for c in range(8):
        part = torch.zeros((x.shape[0], O), dtype=torch.float32, device=x.device)
        for g in range(c, G, 8):
            for k in range(K):
                part = part + x[:, gidx[g, k]] * vals[g, k]
        total = part if c == 0 else total + part
    return total


def segments_kernel_order(x: torch.Tensor, d: PackedDelta, seg_rows: torch.Tensor,
                          seg_offsets: torch.Tensor) -> torch.Tensor:
    """The segments kernel, bit for bit: row r of tenant-sorted x [T, h_in]
    in segment s is :func:`correction_kernel_order` of that row with
    tenant ``seg_rows[s]`` of the stacked delta ``d`` [R, ...]; rows that
    no segment covers, and rows of a segment whose tenant row is outside
    the stack, are zero. ``seg_offsets`` [S + 1] non-decreasing."""
    return _per_segment(correction_kernel_order, x, d, seg_rows, seg_offsets)


def _per_segment(fn, x, d, seg_rows, seg_offsets) -> torch.Tensor:
    """Row r of tenant-sorted x in segment s gets ``fn`` of that segment's
    rows with tenant ``seg_rows[s]`` of the stacked ``d``; rows no segment
    covers, and rows of a segment whose tenant row is outside the stack,
    are zero."""
    x = x.to(torch.float32)
    y = torch.zeros((x.shape[0], d.h_out), dtype=torch.float32, device=x.device)
    offs = [min(max(int(o), 0), x.shape[0]) for o in seg_offsets.tolist()]
    for s, t in enumerate(seg_rows.tolist()):
        if offs[s + 1] > offs[s] and 0 <= t < d.idx.shape[0]:
            y[offs[s]:offs[s + 1]] = fn(x[offs[s]:offs[s + 1]], d.index(t))
    return y


def dense_groups_kernel_order(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """The dense-group walk, bit for bit: :func:`correction_kernel_order`
    for a packing whose groups keep every slot with idx = arange(h_g)
    (``core.pack.dense_groups``), reading ``x[:, g*h_g + k]`` directly and
    never idx, in the same order (class chains over g = c (mod 8), slots
    k = 0..h_g-1, each product and sum rounded, then the classes in
    order). Raises ``ValueError`` for any other packing."""
    if not dense_groups(d):
        raise ValueError(f"codec={d.codec!r} keep={d.keep} h_g={d.h_g}: not a dense-group "
                         "packing (a codec lowering with keep = h_g)")
    x = x.to(torch.float32)
    vals = decode_values(d)                                   # [G, h_g, O]
    G, K, O = vals.shape
    T, nq = x.shape[0], -(-G // 8)
    # the eight class chains side by side: group g = c + 8q is [q, c]; the
    # slots past G (c + 8q >= G) leave their chain as it is
    xg = torch.zeros((T, nq * 8, K), dtype=torch.float32, device=x.device)
    xg[:, :G] = x.reshape(T, G, K)
    xg = xg.reshape(T, nq, 8, K)
    vg = torch.zeros((nq * 8, K, O), dtype=torch.float32, device=x.device)
    vg[:G] = vals
    vg = vg.reshape(nq, 8, K, O)
    part = torch.zeros((8, T, O), dtype=torch.float32, device=x.device)
    for q in range(nq):
        live = (torch.arange(8, device=x.device) + 8 * q < G)[:, None, None]
        for k in range(K):
            step = part + xg[:, q, :, k].T[:, :, None] * vg[q, :, k][:, None, :]
            part = step if q < nq - 1 or G % 8 == 0 else torch.where(live, step, part)
    total = part[0]
    for c in range(1, 8):
        total = total + part[c]
    return total


def dense_segments_kernel_order(x: torch.Tensor, d: PackedDelta, seg_rows: torch.Tensor,
                                seg_offsets: torch.Tensor) -> torch.Tensor:
    """The segments kernel on the dense-group walk, bit for bit:
    :func:`segments_kernel_order` with each segment's rows through
    :func:`dense_groups_kernel_order` of its tenant (never idx); rows no
    segment covers, and rows of a segment whose tenant row is outside the
    stack, are zero."""
    if not dense_groups(d):
        raise ValueError(f"codec={d.codec!r} keep={d.keep} h_g={d.h_g}: not a dense-group "
                         "packing (a codec lowering with keep = h_g)")
    return _per_segment(dense_groups_kernel_order, x, d, seg_rows, seg_offsets)
