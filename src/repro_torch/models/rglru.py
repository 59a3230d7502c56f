"""RG-LRU recurrent mixer (port of ``repro/models/rglru.py``, RecurrentGemma /
Griffin).

    r_t = sigmoid(a_gate(x_t));  i_t = sigmoid(i_gate(x_t))
    a_t = exp(-c * r_t * softplus(-Lambda))        (a = sigmoid(Lambda)^(c r))
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference mixes the sequence with ``jax.lax.associative_scan``; here
a log-depth doubling scan (Hillis-Steele, f32) computes the same
recurrence with another association order, so the two agree within a
stated tolerance, not bit for bit. Every step is elementwise, so a row's
result never depends on the other rows. Decode is one fused step. The
three 2-D projections (linear_x/y/out) are the compressible sites.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import apply_linear, dget
from repro_torch.models.layers import _gelu_tanh, depthwise_conv1d, rmsnorm
from repro_torch.models.ssm import softplus

_C = 8.0
_F32 = torch.float32


class RecState(NamedTuple):
    conv: torch.Tensor   # [B, W-1, lru]   (cfg.param_dtype)
    h: torch.Tensor      # [B, lru]        f32


def _gates(xb, p):
    r = torch.sigmoid(xb * p["a_gate_w"].to(_F32) + p["a_gate_b"].to(_F32))
    i = torch.sigmoid(xb * p["i_gate_w"].to(_F32) + p["i_gate_b"].to(_F32))
    log_a = -_C * r * softplus(-p["a_param"].to(_F32))
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb)
    return a, gated_in


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1
    in ceil(log2 S) doubling steps: after the step of stride k, (a_t, b_t)
    is the composition of the 2k steps ending at t."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_scan(xb: torch.Tensor, p: dict,
               h0: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """xb [B,S,lru] (f32) -> (h [B,S,lru], h_last [B,lru])."""
    a, b = _gates(xb, p)
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(_F32)[:, None], b[:, 1:]], dim=1)
    h = _doubling_scan(a, b)
    return h, h[:, -1]


def rglru_block(x, p, d, cfg: ArchConfig, state: Optional[RecState] = None,
                decode: bool = False):
    """Full recurrent block: conv + gated RG-LRU + output projection.

    x [B,S,d_model] (the block normalizes its input itself). Returns (out,
    new RecState); the conv ring is cast to ``cfg.param_dtype``
    (``rglru.py:89-91``).
    """
    B, S, _ = x.shape
    lru = cfg.rglru.lru_width or cfg.d_model
    u = rmsnorm(x, p["norm"], cfg.norm_eps)
    xb = apply_linear(u, p["linear_x"], dget(d, "linear_x"))
    yb = _gelu_tanh(apply_linear(u, p["linear_y"], dget(d, "linear_y")).to(_F32))

    xb, new_conv = depthwise_conv1d(xb, p["conv_w"],
                                    state.conv if state is not None else None)
    xb = (xb + p["conv_b"]).to(_F32)

    if decode:
        if S != 1:
            raise ValueError(f"decode takes one token per row, got S={S}")
        h0 = state.h if state is not None else \
            torch.zeros((B, lru), dtype=_F32, device=x.device)
        a, b = _gates(xb[:, 0], p)
        h_last = a * h0.to(_F32) + b
        h = h_last[:, None]
    else:
        h, h_last = rglru_scan(xb, p, state.h if state is not None else None)

    out = (h * yb).to(x.dtype)
    out = apply_linear(out, p["linear_out"], dget(d, "linear_out"))
    return out, RecState(new_conv.to(getattr(torch, cfg.param_dtype)),
                         h_last.to(_F32))
