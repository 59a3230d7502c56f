"""The packed delta-weight runtime layout (port of ``repro/core/pack.py``).

:class:`PackedDelta` is the layout the kernels and the plain fallback
consume. Group-wise dropout with an exact per-group keep count yields
*structured* sparsity: every (group, output-column) stores a fixed-shape
``[keep]`` vector of local indices and k-bit codes (bit-packed).

Weights are stored as ``w[h_in, h_out]`` (y = x @ w); dropout groups run
along h_in, the contraction dimension. :func:`to_storage_parts` /
:func:`from_storage_parts` are the paper-faithful m-part CSR storage
layout a tenant ships in (numpy, offline, as in the reference).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.utils import resolve_device


def idx_dtype(h_g: int) -> torch.dtype:
    """The ``idx`` dtype for groups of ``h_g`` rows: uint8 up to 256, int32
    above (the reference packer's rule). Every packer and the kernels read
    it from here."""
    return torch.uint8 if h_g <= 256 else torch.int32


@dataclass
class PackedDelta:
    """Structured-sparse, quantized delta for one [h_in, h_out] weight.

    Tensor fields may carry extra *leading* stack dims (layers, tenants).
      idx:   local in-group indices, uint8 (int32 when h_g > 256) [..., G, K, O]
      codes: bit-packed k-bit codes, uint8,                  [..., G, Kp, O]
             or f32 values                                   [..., G, K, O]
             when k_bits is None
      scale: f32, zero: int32 — per-matrix quant params, shape = stack dims
    Static meta: h_in, h_out, h_g, keep, alpha, k_bits, m, codec.

    ``shards`` > 1 marks one rank's contiguous output-column slice of a
    matrix cut over a serving mesh's ``model`` axis
    (``launch.mesh.shard_delta``): the arrays and ``h_out`` are the
    slice's, and the matrix has ``h_out * shards`` columns. Every route
    decided by the matrix (the CPU gather/dense crossover) keys on that
    global width, so a slice's columns get the unsharded matrix's bits.
    """
    idx: torch.Tensor
    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    h_in: int
    h_out: int
    h_g: int
    keep: int
    alpha: float
    k_bits: Optional[int]
    m: int
    codec: str = "deltadq"
    shards: int = 1

    # -- derived -----------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return self.h_in // self.h_g

    @property
    def nnz(self) -> int:
        return self.n_groups * self.keep * self.h_out

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def stack_shape(self) -> tuple[int, ...]:
        return tuple(self.idx.shape[:-3])

    def with_arrays(self, idx, codes, scale, zero) -> "PackedDelta":
        """Same static meta, new arrays."""
        return replace(self, idx=idx, codes=codes, scale=scale, zero=zero)

    def index(self, i) -> "PackedDelta":
        """Slice one element off the leading stack dim (for layer loops)."""
        return self.with_arrays(
            self.idx[i], self.codes[i],
            self.scale[i] if self.scale.ndim else self.scale,
            self.zero[i] if self.zero.ndim else self.zero)

    def to(self, device) -> "PackedDelta":
        return self.with_arrays(self.idx.to(device), self.codes.to(device),
                                self.scale.to(device), self.zero.to(device))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.idx, self.codes, self.scale, self.zero))

    # -- storage accounting (bits; paper conventions in quant.py) ----------
    def value_bits(self) -> float:
        if self.k_bits is None:
            return 16.0 * self.nnz
        return quant.storage_bits_per_value(self.k_bits, self.m) * self.nnz

    def index_bits(self) -> float:
        return math.log2(max(self.h_g, 2)) * self.nnz

    def total_bits(self, include_indices: bool = True) -> float:
        """Storage bits for the whole (possibly stacked) delta."""
        stack = math.prod(self.stack_shape())
        per_matrix = self.value_bits() + (
            self.index_bits() if include_indices else 0.0)
        return per_matrix * stack


def dense_groups(d: PackedDelta) -> bool:
    """Whether every group of ``d`` keeps all its ``h_g`` slots with
    ``idx[g, k, o] = k``, by construction: the codecs' keep-everything
    lowerings (``core.codecs._dense_as_structured``, the only producer of a
    ``codec`` other than ``"deltadq"``; stacking, layer slices and mesh
    column slices keep the label). A DeltaDQ packing at keep = h_g (alpha
    1) is not one: its idx is whatever the packer wrote. The correction
    kernels' decode tiles take their dense-group walk, which reads no idx,
    where this holds (``kernels/delta_spmm.py``)."""
    return d.codec != "deltadq" and d.keep == d.h_g


def decode_values(d: PackedDelta) -> torch.Tensor:
    """Return dequantized kept values, f32 [..., G, K, O]."""
    if d.k_bits is None:
        return d.codes.to(torch.float32)
    q = quant.unpack_bits(d.codes, quant.pack_width(d.k_bits), d.keep,
                          axis=d.codes.ndim - 2)
    z = d.zero.to(torch.float32)
    s = d.scale.to(torch.float32)
    if z.ndim:  # stacked scalars -> broadcast over trailing (G,K,O)
        z = z.reshape(z.shape + (1, 1, 1))
        s = s.reshape(s.shape + (1, 1, 1))
    return (q.to(torch.float32) - z) * s


def reconstruct_dense(d: PackedDelta, dtype=torch.float32) -> torch.Tensor:
    """Scatter the packed delta back to a dense [..., h_in, h_out] matrix."""
    vals = decode_values(d)
    lead = vals.shape[:-3]
    G, K, O = vals.shape[-3:]
    vals = vals.reshape(-1, G, K, O)
    idx = d.idx.to(torch.int64).reshape(-1, G, K, O)
    dense = torch.zeros((vals.shape[0], G, d.h_g, O), dtype=torch.float32,
                        device=vals.device)
    # kept indices are distinct within a (group, column), so the
    # scatter-add is a plain placement
    dense.scatter_add_(2, idx, vals)
    dense = dense.reshape(*lead, d.h_in, d.h_out)
    return dense.to(dtype)


# ---------------------------------------------------------------------------
# Paper-faithful m-part CSR storage (numpy, offline)
# ---------------------------------------------------------------------------
@dataclass
class StoragePart:
    """One of the m Separate-Quantization parts: a group-CSR sparse matrix."""
    part: int                 # 1..m
    group_offsets: np.ndarray  # int64 [G*O + 1] prefix sums of per-(g,o) counts
    local_idx: np.ndarray      # per-element local index within group
    low_codes: np.ndarray      # (k - log2 m)-bit stored codes (uint8)

    def storage_bits(self, k_bits: int, m: int, h_g: int) -> float:
        vb = quant.storage_bits_per_value(k_bits, m) * len(self.low_codes)
        ib = math.log2(max(h_g, 2)) * len(self.local_idx)
        ob = 64.0 * len(self.group_offsets)
        return vb + ib + ob


def to_storage_parts(d: PackedDelta) -> list[StoragePart]:
    """Decompose a (non-stacked) PackedDelta into m paper-faithful parts
    (host numpy arrays, whatever device ``d`` lies on). The parts equal
    the reference's: each part's elements in (group, column, k) order.
    One stable sort by part id replaces the reference's m boolean masks
    (the same order, one pass)."""
    if d.k_bits is None:
        raise ValueError(
            "separate quantization requires quantized codes; this "
            "PackedDelta has k_bits=None (raw float values)")
    if d.stack_shape():
        raise ValueError(
            "storage layer operates per-matrix; got stacked delta with "
            f"stack_shape={d.stack_shape()}")
    q = quant.unpack_bits(d.codes, quant.pack_width(d.k_bits), d.keep,
                          axis=d.codes.ndim - 2).to(torch.int32)
    G, K, O = q.shape
    width = (2**d.k_bits) // d.m
    # order elements by (g, o) then k so group offsets are well defined
    qf = q.permute(0, 2, 1).reshape(G * O, K).cpu().numpy()
    idxf = d.idx.permute(0, 2, 1).reshape(G * O, K).cpu().numpy()
    pid = (qf // width).astype(np.uint8)
    low = (qf - pid.astype(np.int32) * width).astype(np.uint8).reshape(-1)
    # per (row, part) counts, and every element's place: by part, then in
    # (row, k) order within its part (a stable sort keeps that order)
    counts = np.bincount((np.arange(G * O, dtype=np.int64)[:, None] * d.m + pid).reshape(-1),
                         minlength=G * O * d.m).reshape(G * O, d.m)
    order = np.argsort(pid.reshape(-1), kind="stable")
    ends = np.cumsum(counts.sum(axis=0))
    local = idxf.reshape(-1)[order].astype(np.uint16)
    codes = low[order]
    parts = []
    for j in range(d.m):
        a, b = (ends[j - 1] if j else 0), ends[j]
        offs = np.zeros(G * O + 1, np.int64)
        np.cumsum(counts[:, j], out=offs[1:])
        parts.append(StoragePart(part=j + 1, group_offsets=offs,
                                 local_idx=local[a:b], low_codes=codes[a:b]))
    return parts


def from_storage_parts(parts: list[StoragePart], *, h_in: int, h_out: int, h_g: int,
                       keep: int, alpha: float, k_bits: int, scale, zero,
                       device=None) -> PackedDelta:
    """Reassemble the runtime layout from m storage parts (load path); the
    delta lands on ``device`` (``cuda`` unless the caller names another).

    Each (group, column)'s kept entries come back sorted by local index,
    the order packing gives them (``dropout.groupwise_dropout_pack``), so
    a round trip restores the packed arrays exactly and the kernels sum
    in the original order. The reference reassembles them part by part
    instead (``repro/core/pack.py:204-229``): the same (index, code)
    pairs in another order."""
    dev = resolve_device(device)
    m = len(parts)
    G = h_in // h_g
    width = (2**k_bits) // m
    rows = np.concatenate([np.repeat(np.arange(G * h_out), np.diff(p.group_offsets))
                           for p in parts])
    local = np.concatenate([p.local_idx for p in parts]).astype(np.int64)
    q = np.concatenate([p.low_codes.astype(np.int32) + j * width
                        for j, p in enumerate(parts)])
    # place every (index, code) pair at its column of the group; reading
    # the kept places back in row-major order sorts each row by index
    kept = np.zeros((G * h_out, h_g), bool)
    kept[rows, local] = True
    dense_q = np.zeros((G * h_out, h_g), np.int32)
    dense_q[rows, local] = q
    r, c = np.nonzero(kept)
    if len(r) != G * h_out * keep or len(rows) != len(r):
        raise ValueError(
            f"storage parts hold {len(rows)} entries ({len(r)} distinct); a "
            f"[{h_in}, {h_out}] delta at h_g={h_g}, keep={keep} has "
            f"{G * h_out * keep}")
    ix = c.reshape(G, h_out, keep).transpose(0, 2, 1)
    q = dense_q[r, c].reshape(G, h_out, keep).transpose(0, 2, 1)
    codes = quant.pack_bits(torch.from_numpy(np.ascontiguousarray(q)),
                            quant.pack_width(k_bits), axis=1)
    return PackedDelta(
        idx=torch.from_numpy(np.ascontiguousarray(ix)).to(idx_dtype(h_g)).to(dev),
        codes=codes.contiguous().to(dev),
        scale=scalar_tensor(scale, torch.float32, dev),
        zero=scalar_tensor(zero, torch.int32, dev),
        h_in=h_in, h_out=h_out, h_g=h_g, keep=keep,
        alpha=alpha, k_bits=k_bits, m=m,
    )


def scalar_tensor(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``v`` (a number, numpy scalar or 0-d tensor),
    exact: f32 goes through ``np.float32``, as ``jnp.float32`` does."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    np_dtype = np.float32 if dtype == torch.float32 else np.int32
    return torch.from_numpy(np.asarray(v, np_dtype).reshape(())).to(device)
