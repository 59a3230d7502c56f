"""Group-wise Dropout (paper §3.3), exact-count structured variant.

Port of ``repro/core/dropout.py``. We keep **exactly** ``h_g / alpha``
uniformly random elements per (group, column) and rescale survivors by
alpha, which yields structured sparsity with a dense packed layout.

The random keys ``u`` are an argument: the reference draws them with
``jax.random.uniform``, which torch cannot replay, so a caller that
hands both packages the same ``u`` gets the same packing bit for bit.
The selection uses a *stable* argsort, as ``jnp.argsort`` does, so ties
in ``u`` cannot reorder ``idx``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.pack import PackedDelta, idx_dtype


def keep_count(h_g: int, alpha: float) -> int:
    """Kept elements per (group, column): the ONE definition."""
    keep = int(round(h_g / alpha))
    if keep < 1:
        raise ValueError(f"alpha={alpha} too large for h_g={h_g}")
    return keep


def _check(h_in: int, h_g: int, alpha: float) -> int:
    if h_in % h_g:
        raise ValueError(f"h_g={h_g} must divide h_in={h_in}")
    return keep_count(h_g, alpha)


def groupwise_dropout_pack(
    delta: torch.Tensor,
    *,
    h_g: int,
    alpha: float,
    k_bits: Optional[int] = None,
    m: int = 1,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> PackedDelta:
    """Compress one [..., h_in, h_out] delta: dropout -> rescale ->
    quantize -> pack.

    ``u`` (f32 ``[..., G, h_g, O]``) are the uniform keys; without it they
    are drawn from ``generator`` on the delta's device. The alpha rescale
    is folded into the stored values.
    """
    h_in, h_out = delta.shape[-2:]
    keep = _check(h_in, h_g, alpha)
    G = h_in // h_g
    grouped = delta.reshape(*delta.shape[:-2], G, h_g, h_out).to(torch.float32)
    if u is None:
        u = torch.rand(grouped.shape, generator=generator,
                       device=grouped.device, dtype=torch.float32)
    elif tuple(u.shape) != tuple(grouped.shape):
        raise ValueError(f"u has shape {tuple(u.shape)}; the grouped delta "
                         f"is {tuple(grouped.shape)}")
    # exact-count uniform subset per (group, column): the `keep` positions
    # with the smallest keys, then sorted so the packed layout is ordered
    sel = torch.argsort(u.to(grouped.device), dim=-2, stable=True)[..., :keep, :]
    sel, _ = torch.sort(sel, dim=-2)
    vals = torch.take_along_dim(grouped, sel, dim=-2) * torch.tensor(
        float(alpha), dtype=torch.float32, device=grouped.device)

    lead = tuple(vals.shape[:-3])
    if k_bits is None:
        codes = vals
        scale = torch.ones(lead, dtype=torch.float32, device=vals.device)
        zero = torch.zeros(lead, dtype=torch.int32, device=vals.device)
    else:
        # per-matrix scales: leading stack dims (layers) quantize
        # independently, the paper's per-tensor granularity
        q, qp = quant.quantize(vals, k_bits, lead_dims=vals.ndim - 3)
        codes = quant.pack_bits(q, quant.pack_width(k_bits), axis=q.ndim - 2)
        scale, zero = qp.scale, qp.zero

    return PackedDelta(
        idx=sel.to(idx_dtype(h_g)), codes=codes, scale=scale, zero=zero,
        h_in=h_in, h_out=h_out, h_g=h_g, keep=keep,
        alpha=float(alpha), k_bits=k_bits, m=m,
    )


def rowwise_dropout_pack(delta: torch.Tensor, *, alpha: float,
                         k_bits: Optional[int] = None, m: int = 1,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> PackedDelta:
    """Paper's Row-wise Dropout = group size h_g == h_in (one group per row).

    The idx dtype is int32 once h_in exceeds 256, as in every packing."""
    return groupwise_dropout_pack(delta, h_g=delta.shape[-2], alpha=alpha,
                                  k_bits=k_bits, m=m, u=u, generator=generator)


def bernoulli_mask(shape, keep_rate: float, *, device,
                   u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Bernoulli(keep_rate) mask: True where the uniform key ``u`` is
    below ``keep_rate`` (``jax.random.bernoulli``'s own rule, so the
    reference's ``uniform`` draw of the same key gives the same mask);
    without ``u`` the keys are drawn from ``generator``."""
    if u is None:
        u = torch.rand(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)
    elif tuple(u.shape) != tuple(shape):
        raise ValueError(f"u has shape {tuple(u.shape)}; need {tuple(shape)}")
    return u.to(device) < keep_rate


def bernoulli_dropout_dense(delta: torch.Tensor, *, alpha: float,
                            u: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Paper's original (expected-count) formulation, dense output. Used to
    validate that the exact-count variant is statistically equivalent."""
    mask = bernoulli_mask(delta.shape, 1.0 / alpha, device=delta.device, u=u,
                          generator=generator)
    return torch.where(mask, delta * alpha, torch.zeros((), dtype=delta.dtype,
                                                        device=delta.device))
