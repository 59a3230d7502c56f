"""Baseline delta-compression methods the paper compares against (§4.1)
(port of ``repro/core/baselines.py``).

* ``magnitude`` — Han et al. 2015: keep the top-|w| fraction 1/alpha of the
  delta, globally per tensor, no rescale. Ties with the threshold are kept
  (``>=`` the ``keep``-th largest magnitude), as in the reference.
* ``dare`` — Yu et al. 2023: global Bernoulli dropout at keep-rate 1/alpha
  with 1/keep-rate rescale. The mask (or the uniform keys ``u`` it is
  drawn from, or a ``generator``) is an argument: torch cannot replay
  ``jax.random``, so a caller that hands both packages the same mask gets
  the same output.
* ``deltazip`` — Yao & Klimovic 2023 (lite): per-row magnitude
  sparsification followed by 4-bit group-128 quantization.

All return a **dense** compressed delta (same shape as the input), so
evaluation code can treat every method uniformly:
``W_hat = W_base + compressed_delta``; :func:`method_bits` counts the bits.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core.dropout import bernoulli_mask


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``x``'s device. A divisor given as a
    Python number makes CUDA multiply by its rounded reciprocal, one ulp
    off the CPU's quotient, which can move a value across a rounding
    boundary; a tensor divisor is divided exactly on both."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def magnitude(delta: torch.Tensor, *, alpha: float, **_) -> torch.Tensor:
    n = delta.numel()
    keep = max(int(n / alpha), 1)
    flat = torch.abs(delta.reshape(-1))
    thresh = torch.topk(flat, keep).values[-1]
    return torch.where(torch.abs(delta) >= thresh, delta, _zero(delta))


def dare(delta: torch.Tensor, *, alpha: float,
         mask: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
         generator: Optional[torch.Generator] = None, **_) -> torch.Tensor:
    """``mask`` (bool, the delta's shape) wins; else it is drawn from the
    uniform keys ``u`` or from ``generator`` (``dropout.bernoulli_mask``)."""
    keep_rate = 1.0 / alpha
    if mask is None:
        mask = bernoulli_mask(delta.shape, keep_rate, device=delta.device, u=u,
                              generator=generator)
    elif tuple(mask.shape) != tuple(delta.shape):
        raise ValueError(f"mask has shape {tuple(mask.shape)}; the delta is "
                         f"{tuple(delta.shape)}")
    return torch.where(mask.to(delta.device, torch.bool),
                       delta / _scalar(delta, keep_rate), _zero(delta))


def _group_quant(x: torch.Tensor, k_bits: int, group: int = 128) -> torch.Tensor:
    """Per-group (along h_in) uniform quant-dequant, GPTQ-style granularity."""
    h_in, h_out = x.shape[-2], x.shape[-1]
    g = max(min(group, h_in), 1)
    while h_in % g:
        g //= 2
    xg = x.reshape(*x.shape[:-2], h_in // g, g, h_out)
    lo = xg.amin(dim=-2, keepdim=True)
    hi = xg.amax(dim=-2, keepdim=True)
    s = torch.clamp_min(hi - lo, 1e-12) / _scalar(x, 2**k_bits - 1)
    q = torch.clamp(torch.round((xg - lo) / s), 0, 2**k_bits - 1)
    return (q * s + lo).reshape(x.shape)


def _colwise_thresh(mag: torch.Tensor, keep: int) -> torch.Tensor:
    """Per-output-column threshold keeping `keep` largest along h_in."""
    srt = torch.sort(mag, dim=-2).values  # ascending
    return srt.select(-2, mag.shape[-2] - keep).unsqueeze(-2)


def deltazip(delta: torch.Tensor, *, alpha: float, k_bits: int = 4, **_) -> torch.Tensor:
    # Total budget alpha = alpha_sparse * (16 / k_bits): pick the sparsity so
    # that sparsification times 4-bit quantization hits the target ratio.
    alpha_sparse = max(alpha * k_bits / 16.0, 1.0)
    keep = max(int(round(delta.shape[-2] / alpha_sparse)), 1)
    if keep >= delta.shape[-2]:
        sparse = delta
    else:
        mag = torch.abs(delta)
        sparse = torch.where(mag >= _colwise_thresh(mag, keep), delta, _zero(delta))
    return torch.where(sparse != 0, _group_quant(sparse, k_bits), _zero(delta))


METHODS: dict[str, Callable] = {
    "magnitude": magnitude,
    "dare": dare,
    "deltazip": deltazip,
}


def method_bits(name: str, delta_shape, *, alpha: float, k_bits: int = 4) -> float:
    """Stored value-bits under each method (paper convention, for reports)."""
    n = float(math.prod(delta_shape))
    if name in ("magnitude", "dare"):
        return 16.0 * n / alpha
    if name == "deltazip":
        alpha_sparse = max(alpha * k_bits / 16.0, 1.0)
        return k_bits * n / alpha_sparse
    raise KeyError(name)
