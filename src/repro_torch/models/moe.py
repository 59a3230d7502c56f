"""Mixture-of-Experts FFN with capacity-based top-k dispatch (port of
``repro/models/moe.py``).

Tokens are scattered into a fixed-capacity per-expert buffer ``[E, C, d]``,
every expert runs one batched product (``core.apply.apply_linear_batched``:
the base one batched matmul, a tenant's expert-stacked delta correction
one launch of the segments kernel on the card) and the results are
gathered back with the router weights. Assignments past an expert's
capacity are dropped, exactly the ones the reference drops.

Expert weights are stacked ``[E, d_in, d_out]``; a tenant's deltas at
``wi``/``wg``/``wo`` are PackedDelta leaves with the same leading expert
axis (compressed one matrix at a time, ``core/compress.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import _matmul, apply_linear_batched, dget
from repro_torch.kernels import ops
from repro_torch.models.layers import _gelu_tanh, glu_mlp


def router_topk(logits: torch.Tensor, top_k: int):
    """logits [T, E] -> (weights [T, K] f32, idx [T, K]); softmax over the
    top-k, ranked as ``jax.lax.top_k`` ranks: by IEEE total order (+0.0
    above -0.0), equal logits the lower expert first. That is the first k
    of a stable descending sort of the f32 bits mapped to ordered ints;
    ``torch.topk`` leaves the order of ties unspecified and a float sort
    takes -0.0 for +0.0."""
    bits = logits.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :top_k]
    gates = torch.gather(logits, -1, idx)
    return torch.softmax(gates.to(torch.float32), dim=-1), idx


def capacity(n_tokens: int, cfg: ArchConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Rows per expert buffer, ``max(int(T * K / E * cf), 1)`` in Python
    float arithmetic (``repro/models/moe.py:44``)."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    return max(int(n_tokens * m.top_k / m.n_experts * cf), 1)


def dispatch(eidx: torch.Tensor, n_experts: int, cap: int):
    """Buffer slots of the assignments, flattened (token, k) -> t * K + k.

    An assignment's position within its expert is its rank among that
    expert's assignments in flat order: a stable argsort, its inverse and
    a ``searchsorted`` for each expert's first rank
    (``repro/models/moe.py:51-58``). Positions at or past ``cap`` overflow
    to the dummy expert ``n_experts`` (slot 0) and are dropped.
    -> (slot_e, slot_c, keep), each [T * K]."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)                          # rank of each assignment
    first = torch.searchsorted(flat_e[order], torch.arange(
        n_experts, dtype=flat_e.dtype, device=flat_e.device))
    pos = inv - first[flat_e]                           # position within expert run
    keep = pos < cap
    slot_e = torch.where(keep, flat_e, n_experts)
    slot_c = torch.where(keep, pos, 0)
    return slot_e, slot_c, keep


def moe_ffn(x: torch.Tensor, p: dict, d: Optional[dict], cfg: ArchConfig,
            capacity_factor: Optional[float] = None) -> torch.Tensor:
    """x [B, S, d_model] -> [B, S, d_model]."""
    m = cfg.moe
    B, S, dm = x.shape
    T, E, K = B * S, m.n_experts, m.top_k
    xt = x.reshape(T, dm)

    logits = _matmul(xt, p["router"])                   # router stays uncompressed
    weights, eidx = router_topk(logits, K)              # [T, K]
    C = capacity(T, cfg, capacity_factor)
    slot_e, slot_c, keep = dispatch(eidx, E, C)

    tok_of_assign = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E + 1, C, dm), dtype=x.dtype, device=x.device)
    buf[slot_e, slot_c] = xt[tok_of_assign]             # dropped -> dummy row E
    buf = buf[:E]                                       # [E, C, dm]
    # each expert's live rows, [0, counts[e]) of its C (the rest are zero),
    # where that layout pays: the kernel then skips the empty experts
    counts = (torch.bincount(slot_e, minlength=E + 1)[:E]
              if ops.expert_counts_pay(T * K, E, C) else None)

    gate = apply_linear_batched(buf, p["wg"], dget(d, "wg"), counts=counts)
    up = apply_linear_batched(buf, p["wi"], dget(d, "wi"), counts=counts)
    act = F.silu(gate) if cfg.act == "silu" else _gelu_tanh(gate)
    out = apply_linear_batched(act * up, p["wo"], dget(d, "wo"), counts=counts)

    # gather back: assignment (t, k) reads out[e, c]; dropped ones read 0
    out_pad = torch.cat([out, out.new_zeros((1, C, dm))], dim=0)
    per_assign = torch.where(keep[:, None], out_pad[slot_e, slot_c], 0.0)
    w_assign = weights.reshape(-1)[:, None].to(per_assign.dtype)
    contrib = (per_assign * w_assign).reshape(T, K, dm)
    # the reference's scatter-add, in its order: each token's K terms
    # added to zero one after another (index_add_ adds them with atomics
    # on the card, in no fixed order)
    y = torch.zeros((T, dm), dtype=contrib.dtype, device=x.device)
    for k in range(K):
        y = y + contrib[:, k]

    if m.shared_expert:
        y = y + glu_mlp(xt, p["shared"], dget(d, "shared"), cfg.act)
    return y.reshape(B, S, dm)


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (training)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    frac_routed = F.one_hot(eidx[:, 0], n_experts).to(torch.float32).mean(dim=0)
    frac_prob = probs.mean(dim=0)
    return n_experts * torch.sum(frac_routed * frac_prob)
