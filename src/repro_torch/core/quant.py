"""Uniform quantization + the paper's Separate Quantization (§3.4).

Port of ``repro/core/quant.py``. Quantizer (paper Eqs. 6-8, per-tensor
granularity):

    q = clip(round(dW / s) + z, 0, 2^k - 1)
    s = (max(dW) - min(dW)) / (2^k - 1)
    z = round(-min(dW) / s)

Separate Quantization (Eqs. 9-11) partitions the k-bit codes into m parts
by value range; it changes *storage bits*, not code resolution, so the
compression ratio becomes alpha * 16 / (k - log2 m).

``torch.round`` rounds half to even, as ``jnp.round`` does, so codes
match the reference bit for bit on the same f32 inputs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class QuantParams(NamedTuple):
    scale: torch.Tensor   # f32, shape = the leading (stack) dims
    zero: torch.Tensor    # int32, same shape
    k_bits: int


def quantize(x: torch.Tensor, k_bits: int, lead_dims: int = 0
             ) -> tuple[torch.Tensor, QuantParams]:
    """Per-tensor uniform quantization to k-bit codes (int32 in [0, 2^k)).

    ``lead_dims`` > 0 treats the leading dims as a stack of independent
    tensors (per-layer scales), the paper's per-tensor granularity
    applied to each weight matrix.
    """
    if not 1 <= k_bits <= 8:
        raise ValueError(f"k_bits={k_bits} must be in [1, 8]")
    xf = x.to(torch.float32)
    red = tuple(range(lead_dims, x.ndim))
    lo = torch.amin(xf, dim=red, keepdim=True)
    hi = torch.amax(xf, dim=red, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    # a tensor divisor: CUDA multiplies by the rounded reciprocal of a
    # Python-number divisor, one ulp off the quotient the CPU computes
    s = span / torch.tensor(2**k_bits - 1, dtype=torch.float32, device=span.device)
    z = torch.round(-lo / s).to(torch.int32)
    q = torch.clamp(torch.round(xf / s).to(torch.int32) + z, 0, 2**k_bits - 1)
    lead = tuple(x.shape[:lead_dims])
    return q, QuantParams(scale=s.reshape(lead), zero=z.reshape(lead),
                          k_bits=k_bits)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Combined-code dequantization: s * (q - z)."""
    return (q.to(torch.float32) - qp.zero.to(torch.float32)) * qp.scale


# ---------------------------------------------------------------------------
# Separate Quantization: m-part decomposition of the code space
# ---------------------------------------------------------------------------
def part_id(q: torch.Tensor, k_bits: int, m: int) -> torch.Tensor:
    """Which of the m value-range parts each code belongs to (Eq. 10)."""
    if m < 1 or (m & (m - 1)) != 0:
        raise ValueError(f"m={m} must be a power of two >= 1")
    if m > 2**k_bits:
        raise ValueError(f"m={m} exceeds the code space of k_bits={k_bits} "
                         f"({2**k_bits} codes)")
    width = (2**k_bits) // m
    return torch.div(q, width, rounding_mode="floor")


def decompose(q: torch.Tensor, k_bits: int, m: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split combined codes into (part_id, low_code) (Eq. 9)."""
    pid = part_id(q, k_bits, m)
    width = (2**k_bits) // m
    return pid, q - pid * width


def recompose(pid: torch.Tensor, low: torch.Tensor, k_bits: int,
              m: int) -> torch.Tensor:
    """Inverse of :func:`decompose` (Eq. 12 summed over disjoint parts)."""
    width = (2**k_bits) // m
    return pid * width + low


def storage_bits_per_value(k_bits: int, m: int) -> float:
    """Stored bits per surviving value under Separate Quantization."""
    return k_bits - math.log2(m)


def compression_ratio(alpha: float, k_bits: int | None, m: int = 1) -> float:
    """Paper's ratio convention: alpha * 16/(k - log2 m); bf16 reference."""
    if k_bits is None:
        return float(alpha)
    bits = storage_bits_per_value(k_bits, m)
    if bits <= 0:
        # paper's "-" rows: every part holds identical values; one scalar each
        return float("inf")
    return alpha * 16.0 / bits


# ---------------------------------------------------------------------------
# Bit packing (k in {1,2,4,8} codes per uint8 byte, packed along one axis)
# ---------------------------------------------------------------------------
def pack_width(k_bits: int) -> int:
    """Physical bit width used to pack k-bit codes (next of 1/2/4/8).

    Odd widths (k=3,5,6,7) are stored at the next supported width; the
    *accounted* storage bits stay k."""
    for w in (1, 2, 4, 8):
        if k_bits <= w:
            return w
    raise ValueError(k_bits)


def packed_len(n: int, k_bits: int) -> int:
    per = 8 // pack_width(k_bits)
    return (n + per - 1) // per


def pack_bits(q: torch.Tensor, k_bits: int, axis: int = 0) -> torch.Tensor:
    """Pack k-bit codes into uint8 along ``axis``, LSB first (pads with
    zeros)."""
    if k_bits not in (1, 2, 4, 8):
        raise ValueError(f"k_bits={k_bits} must be one of (1, 2, 4, 8) "
                         "to pack into whole uint8 lanes")
    per = 8 // k_bits
    q = torch.movedim(q, axis, 0).to(torch.uint8)
    n = q.shape[0]
    pad = (-n) % per
    if pad:
        q = torch.cat([q, q.new_zeros((pad, *q.shape[1:]))], dim=0)
    q = q.reshape(q.shape[0] // per, per, *q.shape[1:])
    packed = q[:, 0].clone()
    for i in range(1, per):
        packed |= q[:, i] << (i * k_bits)
    return torch.movedim(packed, 0, axis)


def unpack_bits(packed: torch.Tensor, k_bits: int, n: int,
                axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns int32 codes, trimmed to n."""
    if k_bits not in (1, 2, 4, 8):
        raise ValueError(f"k_bits={k_bits} must be one of (1, 2, 4, 8) "
                         "to unpack from whole uint8 lanes")
    per = 8 // k_bits
    p = torch.movedim(packed, axis, 0)
    mask = 2**k_bits - 1
    cols = [(p >> (i * k_bits)) & mask for i in range(per)]
    q = torch.stack(cols, dim=1).reshape(p.shape[0] * per, *p.shape[1:])
    q = q[:n].to(torch.int32)
    return torch.movedim(q, 0, axis)
