"""The decoder-only LM (port of ``repro/models/lm.py``, dense and MoE
families).

A model is (ArchConfig, params): params are a nested dict of tensors with
the reference's layout — per-kind stacks with a leading layer dim:

    embed/tok [V, d] f32          final_norm/scale [d] f32
    unembed/w [d, V] f32          (absent when embeddings are tied)
    attn/{ln1 [L, d] f32, wq [L, d, q], wk, wv [L, d, kv], wo [L, q, d]}
    mlp/{ln [L, d] f32, wi, wg [L, d, f], wo [L, f, d]}     ("attn" layers)
    moe/{ln [L, d] f32, router [L, d, E], wi, wg [L, E, d, f_e],
         wo [L, E, f_e, d], shared/{wi, wg [L, d, f_e], wo [L, f_e, d]}}
                                  ("moe" layers; shared/ with a shared expert)

An "attn" layer is attention + GLU MLP, a "moe" layer attention + the
routed expert FFN (``models/moe.py``); the attention stack holds both
kinds' attention in layer order, as the reference's does.

Stacked weight matrices are in ``cfg.param_dtype``; everything with fewer
than three dims is f32, as in the reference — so the residual stream is
f32 and each projection multiplies an f32 activation by the bf16 weight
promoted to f32. Every entry point takes an optional ``deltas`` tree
mirroring params (None at uncompressed leaves; PackedDelta or, for
mixed-tenant decode, SlotDelta leaves).

Entry points
    init_params(cfg, seed, device=)                 -> params
    forward(cfg, params, batch, deltas)             -> logits  [B,S,V]
    init_cache(cfg, batch, max_seq, device=)        -> cache
    prefill(cfg, params, batch, cache, deltas)      -> (last logits, cache)
    prefill_chunk(cfg, params, batch, cache, deltas) -> (logits [B,C,V], cache)
    decode_step(cfg, params, cache, tokens, pos, deltas) -> (logits, cache)

The KV cache is updated **in place** (the reference returns a new cache;
eager torch would otherwise copy every layer's cache per step) and the
same cache list is returned.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import apply_linear, dget, dindex
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import attention, glu_mlp, qkv_project, rmsnorm, softcap
from repro_torch.utils import resolve_device


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------
def layer_plan(cfg: ArchConfig):
    """[(kind, index_within_kind_stack, window)] for the decoder stack."""
    counters: dict[str, int] = {}
    plan = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kinds[i]
        j = counters.get(kind, 0)
        counters[kind] = j + 1
        plan.append((kind, j, int(cfg.layer_windows[i])))
    return plan


_FAMILIES = ("dense", "moe")
_OTHER_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES or not set(cfg.layer_kinds) <= {"attn", "moe"}:
        raise NotImplementedError(
            f"the port serves the dense and MoE families only (not "
            f"{', '.join(_OTHER_FAMILIES)}); {cfg.name!r} is "
            f"family={cfg.family!r} with kinds {sorted(set(cfg.layer_kinds))}")


def _count(cfg: ArchConfig, kinds: tuple, upto: Optional[int] = None) -> int:
    """Layers of ``kinds`` among the first ``upto`` (default all)."""
    return sum(1 for k in cfg.layer_kinds[:upto] if k in kinds)


def _attn_index(cfg: ArchConfig, li: int) -> int:
    """Row of layer ``li``'s attention in the attention stack (attn and
    moe layers both hold one)."""
    return _count(cfg, ("attn", "moe"), li)


# ---------------------------------------------------------------------------
# Param table: path -> (shape, init, fan_in)
# ---------------------------------------------------------------------------
def _param_table(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d, q, kv, f, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.head_dim
    t: dict[str, tuple] = {
        "embed/tok": ((cfg.vocab, d), "embed", d),
        "final_norm/scale": ((d,), "zeros", 1),
    }
    if not cfg.tie_embeddings:
        t["unembed/w"] = ((d, cfg.vocab), "normal", d)
    attn = [("ln1", (d,), "zeros"), ("wq", (d, q), "normal"),
            ("wk", (d, kv), "normal"), ("wv", (d, kv), "normal"),
            ("wo", (q, d), "normal")]
    if cfg.qk_norm:
        attn += [("q_norm", (hd,), "zeros"), ("k_norm", (hd,), "zeros")]
    mlp = [("ln", (d,), "zeros"), ("wi", (d, f), "normal"),
           ("wg", (d, f), "normal"), ("wo", (f, d), "normal")]
    stacks = [("attn", _count(cfg, ("attn", "moe")), attn),
              ("mlp", _count(cfg, ("attn",)) if f else 0, mlp)]
    m = cfg.moe
    if m is not None:
        E, fe = m.n_experts, m.d_expert
        moe = [("ln", (d,), "zeros"), ("router", (d, E), "normal"),
               ("wi", (E, d, fe), "normal"), ("wg", (E, d, fe), "normal"),
               ("wo", (E, fe, d), "normal")]
        if m.shared_expert:
            moe += [("shared/wi", (d, fe), "normal"), ("shared/wg", (d, fe), "normal"),
                    ("shared/wo", (fe, d), "normal")]
        stacks.append(("moe", _count(cfg, ("moe",)), moe))
    for stack, L, rows in stacks:
        if not L:
            continue
        for name, shape, init in rows:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            t[f"{stack}/{name}"] = ((L, *shape), init, fan_in)
    return t


def _dtype(cfg: ArchConfig, shape: tuple) -> torch.dtype:
    # stacked weight matrices (>= 3 dims) take the param dtype, the rest f32
    return getattr(torch, cfg.param_dtype) if len(shape) >= 3 else torch.float32


def param_shapes(cfg: ArchConfig) -> dict:
    """Flat {path: (shape, dtype)} of the params tree."""
    return {p: (shape, _dtype(cfg, shape))
            for p, (shape, _, _) in _param_table(cfg).items()}


def _set_path(tree: dict, path: str, leaf) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def init_params(cfg: ArchConfig, seed: int = 0, *, scale: float = 1.0,
                device=None) -> dict:
    """Random init from a ``torch.Generator`` seeded with ``seed`` (on
    ``device``, default ``cuda``). Stacked weights are drawn one layer at
    a time so no full-size f32 temporary is held."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: dict = {}
    for path, (shape, init, fan_in) in _param_table(cfg).items():
        dtype = _dtype(cfg, shape)
        if init == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            std = scale if init == "embed" else scale / math.sqrt(max(fan_in, 1))
            leaf = torch.empty(shape, dtype=dtype, device=dev)
            flat = leaf.view(-1, *shape[-2:])
            for i in range(flat.shape[0]):
                flat[i] = (torch.randn(shape[-2:], generator=gen, device=dev,
                                       dtype=torch.float32) * std).to(dtype)
        _set_path(params, path, leaf)
    return params


# ---------------------------------------------------------------------------
# Sub-blocks
# ---------------------------------------------------------------------------
def _attn_block_train(cfg, p, d, x, positions, window):
    """Self-attention sub-block, no cache."""
    u = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(u, p, d, cfg, positions)
    out = attention(q, k, v, positions, positions, window=window, causal=True,
                    cap=cfg.attn_softcap)
    out = apply_linear(out.reshape(*x.shape[:-1], cfg.q_dim), p["wo"], dget(d, "wo"))
    return x + out


def _attn_block_prefill(cfg, p, d, x, positions, window, cache):
    """Attention over the prompt + cache write of the last S_c tokens.

    ``positions`` is [S] (shared) or [B, S] (per-row; negative entries
    mark pad slots, which the cache records as invalid)."""
    u = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(u, p, d, cfg, positions)
    out = attention(q, k, v, positions, positions, window=window, causal=True,
                    cap=cfg.attn_softcap)
    S = k.shape[1]
    S_c = cache["k"].shape[1]
    n_write = min(S, S_c)
    if positions.ndim == 1:
        pos_w = positions[-n_write:]
        slots = pos_w % S_c
        cache["k"][:, slots] = k[:, -n_write:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -n_write:].to(cache["v"].dtype)
        cache["pos"][:, slots] = pos_w[None].to(cache["pos"].dtype)
    else:
        B = x.shape[0]
        pos_w = positions[:, -n_write:]                   # [B, n_write]
        slots = pos_w % S_c
        bi = torch.arange(B, device=x.device)[:, None]
        cache["k"][bi, slots] = k[:, -n_write:].to(cache["k"].dtype)
        cache["v"][bi, slots] = v[:, -n_write:].to(cache["v"].dtype)
        cache["pos"][bi, slots] = pos_w.to(cache["pos"].dtype)
    out = apply_linear(out.reshape(*x.shape[:-1], cfg.q_dim), p["wo"], dget(d, "wo"))
    return x + out


def _attn_block_chunk(cfg, p, d, x, positions, window, cache, valid):
    """Multi-token ring attention for one chunked-prefill row.

    ``positions`` [B, C] are absolute prompt positions (a resumable
    cursor offset, NOT starting at 0). Queries attend the pre-write ring
    concatenated with the chunk's own K/V (position-masked, so a token
    sees earlier chunks plus its own prefix), THEN every real token's
    K/V is written into its ring slot. Attending first matters for a
    windowed ring, which keeps only the last token's window: writing all
    C tokens first would evict keys the chunk's earlier queries need.

    ``valid`` [B, C] bool (or None) marks real tokens of a right-padded
    chunk. The reference drops pad writes (``mode="drop"``); here each
    pad entry writes back the value its slot already holds, so a pad
    never shadows a live ring key and no host sync is needed. The C
    slots of one chunk are distinct (C consecutive positions, C <= the
    ring size, which the engine enforces), so the scatter has no
    duplicate indices. Pad keys sit at positions past every real query
    (causally masked); their query outputs are garbage the caller
    discards.
    """
    u = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(u, p, d, cfg, positions)
    B = x.shape[0]
    S_c = cache["k"].shape[1]
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    pos_c = positions.to(cache["pos"].dtype)
    k_all = torch.cat([cache["k"], k], dim=1)
    v_all = torch.cat([cache["v"], v], dim=1)
    kp_all = torch.cat([cache["pos"], pos_c], dim=1)
    out = attention(q, k_all, v_all, positions, kp_all, window=window,
                    causal=True, cap=cfg.attn_softcap)
    slots = positions % S_c                               # [B, C]
    bi = torch.arange(B, device=x.device)[:, None]
    for name, new in (("k", k), ("v", v), ("pos", pos_c)):
        if valid is not None:
            m = valid.reshape(valid.shape + (1,) * (new.ndim - 2))
            new = torch.where(m, new, cache[name][bi, slots])
        cache[name][bi, slots] = new
    out = apply_linear(out.reshape(*x.shape[:-1], cfg.q_dim), p["wo"], dget(d, "wo"))
    return x + out


def _attn_block_decode(cfg, p, d, x, pos, window, cache):
    """Single-token attention over the (ring-buffer) cache.

    ``pos`` an int: all rows decode at the same position (static batch).
    ``pos`` [B]: per-slot positions — each row writes its own ring slot.
    """
    u = rmsnorm(x, p["ln1"], cfg.norm_eps)
    S_c = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        B = x.shape[0]
        positions = pos[:, None]                          # [B, 1]
        q, k, v = qkv_project(u, p, d, cfg, positions)
        slot = pos % S_c                                  # [B]
        bi = torch.arange(B, device=x.device)
        cache["k"][bi, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bi, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bi, slot] = pos.to(cache["pos"].dtype)
    else:
        positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q, k, v = qkv_project(u, p, d, cfg, positions)
        slot = pos % S_c          # a host int: no device sync to index
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = pos
    out = attention(q, cache["k"], cache["v"], positions, cache["pos"],
                    window=window, causal=True, cap=cfg.attn_softcap)
    out = apply_linear(out.reshape(*x.shape[:-1], cfg.q_dim), p["wo"], dget(d, "wo"))
    return x + out


def _mlp_block(cfg, p, d, x):
    u = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + glu_mlp(u, p, d, cfg.act)


def _moe_block(cfg, p, d, x):
    u = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + moe_mod.moe_ffn(u, p, d, cfg)


def _slice(tree: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _walk(cfg: ArchConfig, params, x, positions, deltas=None, caches=None,
          decode_pos=None, chunk=False, chunk_valid=None):
    """Python loop over the layers (train, prefill, chunk and decode
    paths). A layer's attention is row ``_attn_index`` of the attention
    stack; its FFN is row ``j`` of its own kind's stack (the GLU MLP for
    "attn", the experts for "moe")."""
    for li, (kind, j, window) in enumerate(layer_plan(cfg)):
        ai = _attn_index(cfg, li)
        p_a = _slice(params["attn"], ai)
        d_a = dindex(dget(deltas, "attn"), ai)
        if decode_pos is not None:
            x = _attn_block_decode(cfg, p_a, d_a, x, decode_pos, window, caches[li])
        elif caches is not None and chunk:
            x = _attn_block_chunk(cfg, p_a, d_a, x, positions, window, caches[li],
                                  chunk_valid)
        elif caches is not None:
            x = _attn_block_prefill(cfg, p_a, d_a, x, positions, window, caches[li])
        else:
            x = _attn_block_train(cfg, p_a, d_a, x, positions, window)
        stack, block = ("moe", _moe_block) if kind == "moe" else ("mlp", _mlp_block)
        x = block(cfg, _slice(params[stack], j), dindex(dget(deltas, stack), j), x)
    return x


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def embed_tokens(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens]


def unembed(cfg, params, h, deltas=None) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        tok = params["embed"]["tok"]
        logits = h.to(torch.promote_types(h.dtype, tok.dtype)) @ tok.T.to(
            torch.promote_types(h.dtype, tok.dtype))
    else:
        logits = apply_linear(h, params["unembed"]["w"],
                              dget(dget(deltas, "unembed"), "w"))
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


def forward(cfg: ArchConfig, params, batch: dict, deltas=None) -> torch.Tensor:
    """Scoring forward: full-sequence causal logits [B,S,V]."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = _walk(cfg, params, x, positions, deltas=deltas)
    return unembed(cfg, params, h, deltas)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device=None) -> list:
    """Zero-initialized serving cache (one dict per layer). ``pos`` starts
    at -1 (invalid)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    out = []
    for _, _, window in layer_plan(cfg):
        S_c = max_seq if window == 0 else min(window, max_seq)
        shape = (batch, S_c, cfg.n_kv, cfg.head_dim)
        out.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev),
                    "pos": torch.full((batch, S_c), -1, dtype=torch.int32,
                                      device=dev)})
    return out


def prefill(cfg: ArchConfig, params, batch: dict, cache, deltas=None):
    """Run the prompt through the model, filling ``cache`` in place.

    Returns (logits for the LAST position [B,V], cache). ``batch
    ["positions"]`` ([B, S], optional) overrides the default arange(S).
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = _walk(cfg, params, x, positions, deltas=deltas, caches=cache)
    logits = unembed(cfg, params, h[:, -1:], deltas)
    return logits[:, 0], cache


def prefill_chunk(cfg: ArchConfig, params, batch: dict, cache, deltas=None):
    """Consume one position-offset prompt chunk against an existing cache.

    The resumable middle of chunked prefill: ``batch["tokens"]`` [B, C]
    is a slice of the prompt, ``batch["positions"]`` [B, C] its absolute
    positions (cursor offset, NOT restarting at 0), and ``cache`` the
    row's cache as earlier chunks left it (updated in place). An
    optional ``batch["valid"]`` [B, C] bool marks real tokens when the
    engine right-pads the tail chunk to a fixed width; pad K/V never
    reach the ring.

    Returns (logits [B, C, V] for EVERY chunk position, cache): the
    caller picks the last real position's logits of the final chunk for
    the first generated token.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    h = _walk(cfg, params, x, batch["positions"], deltas=deltas, caches=cache,
              chunk=True, chunk_valid=batch.get("valid"))
    return unembed(cfg, params, h, deltas), cache


def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                pos: Union[int, torch.Tensor], deltas: Optional[Any] = None):
    """One decode step. tokens [B,1]; pos an int (all rows at the same
    position) or [B] (per-slot positions — ``deltas`` may then be a
    slot-dispatched tree). Updates ``cache`` in place.

    Returns (logits [B,V], cache).
    """
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=tokens.device, dtype=torch.int64)
    else:
        pos = int(pos)
    h = _walk(cfg, params, x, None, deltas=deltas, caches=cache, decode_pos=pos)
    logits = unembed(cfg, params, h, deltas)
    return logits[:, 0], cache
