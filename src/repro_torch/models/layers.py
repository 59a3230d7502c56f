"""Shared layers of the model zoo (port of ``repro/models/layers.py``).

All matmuls route through :func:`repro_torch.core.apply.apply_linear` so
every linear site supports the paper's separate-computation delta
correction. Attention is plain torch ops, q-blocked so long prefill never
materializes a full [S, S] score tensor per head; it keeps the
reference's einsum/softmax numerics rather than a fused attention call,
so the two packages stay comparable.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.apply import apply_linear, dget, local_linear

_NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x [..., S, H, D]; positions [S] or [..., S]."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                                device=x.device) / half)
    ang = positions.to(torch.float32)[..., :, None] * freqs   # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]   # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def head_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """QK-norm: RMSNorm over head_dim. x [..., H, D], scale [D]."""
    return rmsnorm(x, scale, eps)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _attend(q, k, v, q_pos, k_pos, window: int, causal: bool, cap):
    """One q-block of GQA attention.

    q [B,Sq,Hq,D]; k,v [B,Sk,Hkv,D]; q_pos [Sq] or [B,Sq]; k_pos [Sk] or
    [B,Sk] (entries < 0 are invalid ring-buffer slots); window: 0 =
    global, > 0 = sliding window.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (D ** -0.5)
    scores = softcap(scores, cap)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None]       # [B*, Sq]
    kp = k_pos if k_pos.ndim == 2 else k_pos[None]       # [B*, Sk]
    valid = (kp >= 0)[:, None, :]
    if causal:
        valid = valid & (kp[:, None, :] <= qp[:, :, None])
    if window > 0:
        valid = valid & (qp[:, :, None] - kp[:, None, :] < window)
    scores = torch.where(valid[:, None, None], scores,
                         torch.tensor(_NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def cross_attention(q, k, v, cap=None):
    """Unmasked attention over a fixed memory (frontend embeddings or the
    encoder's output): every position 0, no causal mask, no window."""
    q_pos = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    k_pos = torch.zeros(k.shape[1], dtype=torch.int64, device=q.device)
    return _attend(q, k, v, q_pos, k_pos, 0, False, cap)


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, causal: bool = True,
              cap=None, block_q: int = 1024):
    """GQA attention, blocked over the query dim to bound live memory."""
    Sq = q.shape[1]
    if Sq <= block_q or Sq % block_q:
        return _attend(q, k, v, q_pos, k_pos, window, causal, cap)
    outs = []
    for s0 in range(0, Sq, block_q):
        pos = q_pos[:, s0:s0 + block_q] if q_pos.ndim == 2 else q_pos[s0:s0 + block_q]
        outs.append(_attend(q[:, s0:s0 + block_q], k, v, pos, k_pos, window,
                            causal, cap))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Blocks' inner projections
# ---------------------------------------------------------------------------
def qkv_project(x, p, d, cfg, positions, rope_on: bool = True,
                kv_local: Optional[int] = None):
    """x [B,S,d_model] -> q [B,S,Hq,D], k,v [B,S,Hkv,D] (+rope, +qk-norm).

    ``kv_local`` below ``cfg.n_kv`` (a ring that holds this model rank's
    kv-heads): the rank's heads alone, kv-heads ``[m * kv_local, (m + 1) *
    kv_local)`` and the query heads grouped on them, which are its own
    columns of wq/wk/wv (``local_linear``: no gather)."""
    B, S, _ = x.shape
    n_kv = cfg.n_kv if kv_local is None else kv_local
    n_q = cfg.n_heads // cfg.n_kv * n_kv
    proj = apply_linear if n_kv == cfg.n_kv else local_linear
    q = proj(x, p["wq"], dget(d, "wq")).reshape(B, S, n_q, cfg.head_dim)
    k = proj(x, p["wk"], dget(d, "wk")).reshape(B, S, n_kv, cfg.head_dim)
    v = proj(x, p["wv"], dget(d, "wv")).reshape(B, S, n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def glu_mlp(x, p, d, act: str):
    """SwiGLU (silu) / GeGLU (gelu) feed-forward."""
    gate = apply_linear(x, p["wg"], dget(d, "wg"))
    up = apply_linear(x, p["wi"], dget(d, "wi"))
    h = (F.silu(gate) if act == "silu" else _gelu_tanh(gate)) * up
    return apply_linear(h, p["wo"], dget(d, "wo"))


def depthwise_conv1d(x, w, state=None):
    """Causal depthwise conv. x [B,S,C], w [W,C]; state [B,W-1,C] or None.

    The taps are summed in f32 in tap order, each output element on its
    own (no reduction whose order depends on the batch). Returns (y
    [B,S,C] in x's dtype, new_state [B,W-1,C] in the dtype of the
    concatenated input, as ``jnp.concatenate`` promotes it).
    """
    W = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)      # [B, S+W-1, C]
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + S].to(torch.float32) * w[i].to(torch.float32)
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return y.to(x.dtype), new_state
