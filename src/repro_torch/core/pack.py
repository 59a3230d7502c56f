"""The packed delta-weight runtime layout (port of ``repro/core/pack.py``).

:class:`PackedDelta` is the layout the kernels and the plain fallback
consume. Group-wise dropout with an exact per-group keep count yields
*structured* sparsity: every (group, output-column) stores a fixed-shape
``[keep]`` vector of local indices and k-bit codes (bit-packed).

Weights are stored as ``w[h_in, h_out]`` (y = x @ w); dropout groups run
along h_in, the contraction dimension. The paper-faithful m-part CSR
storage layout (``to/from_storage_parts``) is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.core import quant


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
