"""Mamba-2 SSD mixer (port of ``repro/models/ssm.py``).

The chunked algorithm (Dao & Gu 2024, §6): within chunks of length Q the
recurrence is a masked quadratic attention-like product; across chunks a
small state recurrence [H, P, N] is carried. Decode is the O(1) state
update per token.

Projections are split into separate matrices (wz/wx/wbc/wdt/wout), each a
compressible linear site through ``apply_linear`` with its delta. The SSD
arithmetic is f32 throughout, as in the reference; the contractions of
the decode step are elementwise products summed over one axis, so a row's
result never depends on the other rows of the batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import apply_linear, dget
from repro_torch.models.layers import depthwise_conv1d, rmsnorm

_F32 = torch.float32


class SsmState(NamedTuple):
    conv_x: torch.Tensor    # [B, W-1, d_inner]   (cfg.param_dtype)
    conv_bc: torch.Tensor   # [B, W-1, 2*G*N]     (cfg.param_dtype)
    state: torch.Tensor     # [B, H, P, N]        f32


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.d_state, s.n_groups


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum_mask(dA_cum: torch.Tensor) -> torch.Tensor:
    """L[..., i, j] = exp(dA_cum_i - dA_cum_j) for j <= i else 0.

    dA_cum [..., l, h] -> [..., h, l, l]
    """
    c = dA_cum.movedim(-1, -2)                              # [..., h, l]
    diff = c[..., :, None] - c[..., None, :]                # [..., h, i, j]
    l = c.shape[-1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=c.device))
    return torch.where(mask, torch.exp(diff), torch.zeros((), dtype=c.dtype,
                                                          device=c.device))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Full-sequence SSD.

    x [b,s,h,p]; dt [b,s,h] (post-softplus); A [h] (negative);
    B, C [b,s,g,n]. Returns (y [b,s,h,p], final_state [b,h,p,n] f32).
    Raises unless s is a multiple of ``chunk``, as the reference does.
    """
    b, s, h, p = x.shape
    g, n = B.shape[-2:]
    hpg = h // g
    if s % chunk:
        raise ValueError(
            f"sequence length {s} must be a multiple of chunk={chunk}")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, h, p).to(_F32)
    dtr = dt.reshape(b, nc, chunk, h).to(_F32)
    Br = B.reshape(b, nc, chunk, g, n).to(_F32)
    Cr = C.reshape(b, nc, chunk, g, n).to(_F32)

    dA = dtr * A.to(_F32)                                   # [b,nc,l,h]
    dA_cum = torch.cumsum(dA, dim=2)

    # intra-chunk: quadratic within the chunk
    L = _segsum_mask(dA_cum)                                # [b,nc,h,l,l]
    CB = torch.einsum("bclgn,bcmgn->bcglm", Cr, Br)         # [b,nc,g,l,m]
    CB = CB.repeat_interleave(hpg, dim=2)                   # [b,nc,h,l,m]
    att = CB * L * dtr.movedim(-1, -2)[..., None, :]        # * dt_j
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", att, xr)

    # chunk states
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # [b,nc,l,h]
    weighted_x = xr * (dtr * decay_to_end)[..., None]       # [b,nc,l,h,p]
    Bh = Br.repeat_interleave(hpg, dim=3)                   # [b,nc,l,h,n]
    chunk_states = torch.einsum("bclhp,bclhn->bchpn", weighted_x, Bh)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])            # [b,nc,h]

    carry = (torch.zeros((b, h, p, n), dtype=_F32, device=x.device)
             if initial_state is None else initial_state.to(_F32))
    # the reference's lax.scan over chunks, emitting the state at each
    # chunk's START
    before = []
    for c in range(nc):
        before.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + chunk_states[:, c]
    states_before = torch.stack(before, dim=1)              # [b,nc,h,p,n]

    # inter-chunk contribution
    Ch = Cr.repeat_interleave(hpg, dim=3)                   # [b,nc,l,h,n]
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Ch * torch.exp(dA_cum)[..., None],
                           states_before)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_decode(x, dt, A, B, C, state):
    """One-token SSD update. x [b,h,p]; dt [b,h]; B,C [b,g,n]; state
    [b,h,p,n] f32. Returns (y [b,h,p], new_state)."""
    g = B.shape[-2]
    hpg = x.shape[1] // g
    Bh = B.repeat_interleave(hpg, dim=1).to(_F32)           # [b,h,n]
    Ch = C.repeat_interleave(hpg, dim=1).to(_F32)
    dtf = dt.to(_F32)
    dA = torch.exp(dtf * A.to(_F32))                        # [b,h]
    upd = dtf[..., None, None] * x.to(_F32)[..., None] * Bh[..., None, :]
    new_state = state * dA[..., None, None] + upd           # [b,h,p,n]
    y = (new_state * Ch[:, :, None, :]).sum(dim=-1)         # [b,h,p]
    return y.to(x.dtype), new_state


def mamba_block(x, p, d, cfg: ArchConfig, state: Optional[SsmState] = None,
                decode: bool = False):
    """Full Mamba-2 block. x [B,S,d_model] (S=1 when decode=True).

    Returns (out [B,S,d_model], new SsmState); the conv rings are cast to
    ``cfg.param_dtype`` (``ssm.py:167-170``): a serving slot holds the
    same bits however its row was filled.
    """
    d_inner, H, P, N, G = dims(cfg)
    B_, S, _ = x.shape

    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    z = apply_linear(u, p["wz"], dget(d, "wz"))
    xin = apply_linear(u, p["wx"], dget(d, "wx"))
    bc = apply_linear(u, p["wbc"], dget(d, "wbc"))          # [B,S,2*G*N]
    dt = apply_linear(u, p["wdt"], dget(d, "wdt"))          # [B,S,H]

    xin, new_conv_x = depthwise_conv1d(xin, p["conv_x_w"],
                                       state.conv_x if state is not None else None)
    bc, new_conv_bc = depthwise_conv1d(bc, p["conv_bc_w"],
                                       state.conv_bc if state is not None else None)
    xin = F.silu(xin + p["conv_x_b"])
    bc = F.silu(bc + p["conv_bc_b"])

    Bmat = bc[..., :G * N].reshape(B_, S, G, N)
    Cmat = bc[..., G * N:].reshape(B_, S, G, N)
    xh = xin.reshape(B_, S, H, P)
    dt = softplus(dt.to(_F32) + p["dt_bias"].to(_F32))
    A = -torch.exp(p["a_log"].to(_F32))

    if decode:
        if S != 1:
            raise ValueError(f"decode takes one token per row, got S={S}")
        prev = state.state if state is not None else \
            torch.zeros((B_, H, P, N), dtype=_F32, device=x.device)
        y, new_state = ssd_decode(xh[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0], prev)
        y = y[:, None]
    else:
        init = state.state if state is not None else None
        y, new_state = ssd_chunked(xh, dt.to(xh.dtype), A, Bmat, Cmat,
                                   min(cfg.ssm.chunk, S), initial_state=init)

    y = y + xh.to(_F32) * p["d_skip"].to(_F32)[None, None, :, None]
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z.to(_F32)).to(y.dtype), p["out_norm"], cfg.norm_eps)
    out = apply_linear(y, p["wout"], dget(d, "wout"))
    cdt = getattr(torch, cfg.param_dtype)
    return out, SsmState(new_conv_x.to(cdt), new_conv_bc.to(cdt), new_state)
