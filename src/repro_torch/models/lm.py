"""The model zoo's LM (port of ``repro/models/lm.py``): the dense, MoE,
SSM, hybrid (RG-LRU), encoder-decoder and VLM families.

A model is (ArchConfig, params): params are a nested dict of tensors with
the reference's layout — per-kind stacks with a leading layer dim:

    embed/tok [V, d] f32          final_norm/scale [d] f32
    unembed/w [d, V] f32          (absent when embeddings are tied)
    attn/{ln1 [L, d] f32, wq [L, d, q], wk, wv [L, d, kv], wo [L, q, d]}
    mlp/{ln [L, d] f32, wi, wg [L, d, f], wo [L, f, d]}
    moe/{ln, router [L, d, E], wi, wg [L, E, d, f_e], wo [L, E, f_e, d],
         shared/{wi, wg, wo}}                       ("moe" layers)
    ssm/{norm, wz, wx, wbc, wdt, conv_*, a_log, d_skip, dt_bias, out_norm,
         wout}                                      ("ssm" layers, Mamba-2)
    rec/{norm, linear_x, linear_y, linear_out, conv_*, a_param, *_gate_*}
                                                    ("rec" layers, RG-LRU)
    cross/{ln1, wq, wk, wv, wo, gate_attn [L], gate_mlp [L]}   (vlm)
    enc/{attn, mlp, final_norm}, dec_cross/{...}               (encdec)

An "attn" layer is attention + GLU MLP, a "moe" layer attention + the
routed expert FFN (``models/moe.py``), an "ssm" layer the Mamba-2 mixer
alone (``models/ssm.py``), a "rec" layer the RG-LRU mixer + GLU MLP
(``models/rglru.py``). The attention stack holds attn and moe layers'
attention in layer order; the mlp stack holds attn and rec layers' MLPs,
then the vlm's gated cross blocks' MLPs. A vlm adds a gated cross block
(``tanh(gate)``-scaled) after every ``cross_attn_every``-th layer over the
image embeddings; an encdec adds an ungated cross block after every
decoder layer over the bidirectional encoder's output (:func:`encode`).

Stacked weight matrices are in ``cfg.param_dtype``; everything with fewer
than three dims is f32, as in the reference — so the residual stream is
f32 and each projection multiplies an f32 activation by the bf16 weight
promoted to f32 (the encoder's residual starts in ``param_dtype``, as
there). Every entry point takes an optional ``deltas`` tree mirroring
params (None at uncompressed leaves; PackedDelta or, for mixed-tenant
decode, SlotDelta leaves).

Entry points
    init_params(cfg, seed, device=)                 -> params
    forward(cfg, params, batch, deltas, remat)      -> logits  [B,S,V]
    loss_fn(cfg, params, batch, deltas, remat)      -> (loss, {"loss", "tokens"})
    encode(cfg, params, feats, deltas)              -> memory  [B,S,d]
    init_cache(cfg, batch, max_seq, enc_len, device=) -> cache
    prefill(cfg, params, batch, cache, deltas)      -> (last logits, cache)
    prefill_chunk(cfg, params, batch, cache, deltas) -> (logits [B,C,V], cache)
    decode_step(cfg, params, cache, tokens, pos, deltas) -> (logits, cache)

``batch`` carries ``enc_feats`` [B, S_enc, d] (encdec) or
``image_embeds`` [B, n_frontend_tokens, d] (vlm) beside ``tokens``.

The cache is a list with one entry per decoder layer — a ``{"k", "v",
"pos"}`` ring for attention layers, an :class:`~repro_torch.models.ssm.
SsmState` or :class:`~repro_torch.models.rglru.RecState` for ssm and rec
layers — then the cross blocks' ``{"k", "v"}`` memory caches. It is
updated **in place** (the reference returns a new cache; eager torch
would otherwise copy every layer's cache per step) and the same list is
returned; a cross cache's entries are replaced by the memory's k/v at
prefill, in the dtype the reference's cache holds them.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch.configs.arch import ArchConfig
from repro_torch.core.apply import apply_linear, dget, dindex
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    attention,
    cross_attention,
    glu_mlp,
    qkv_project,
    rmsnorm,
    softcap,
)
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


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
_KINDS = ("attn", "moe", "ssm", "rec")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES or not set(cfg.layer_kinds) <= set(_KINDS):
        raise NotImplementedError(
            f"the port serves the families {', '.join(_FAMILIES)} with layer "
            f"kinds {', '.join(_KINDS)}; {cfg.name!r} is family={cfg.family!r} "
            f"with kinds {sorted(set(cfg.layer_kinds))}")


def _count(cfg: ArchConfig, kinds: tuple, upto: Optional[int] = None) -> int:
    """Layers of ``kinds`` among the first ``upto`` (default all)."""
    return sum(1 for k in cfg.layer_kinds[:upto] if k in kinds)


def _attn_index(cfg: ArchConfig, li: int) -> int:
    """Row of layer ``li``'s attention in the attention stack (attn and
    moe layers both hold one)."""
    return _count(cfg, ("attn", "moe"), li)


def _mlp_index(cfg: ArchConfig, li: int) -> int:
    """Row of layer ``li``'s MLP in the mlp stack (attn and rec layers)."""
    return _count(cfg, ("attn", "rec"), li)


def _cross_after(cfg: ArchConfig) -> list:
    """The decoder layers a vlm's gated cross blocks follow."""
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return list(range(cfg.cross_attn_every - 1, cfg.n_layers, cfg.cross_attn_every))
    return []


def n_cross_blocks(cfg: ArchConfig) -> int:
    return len(_cross_after(cfg))


def n_mlp_layers(cfg: ArchConfig) -> int:
    """attn and rec layers' MLPs, then the vlm cross blocks'."""
    return _count(cfg, ("attn", "rec")) + n_cross_blocks(cfg)


# ---------------------------------------------------------------------------
# Param table: path -> (shape, init, fan_in)
# ---------------------------------------------------------------------------
def _attn_rows(cfg: ArchConfig) -> list:
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    rows = [("ln1", (d,), "zeros"), ("wq", (d, q), "normal"),
            ("wk", (d, kv), "normal"), ("wv", (d, kv), "normal"),
            ("wo", (q, d), "normal")]
    if cfg.qk_norm:
        rows += [("q_norm", (hd,), "zeros"), ("k_norm", (hd,), "zeros")]
    return rows


def _mlp_rows(cfg: ArchConfig) -> list:
    d, f = cfg.d_model, cfg.d_ff
    return [("ln", (d,), "zeros"), ("wi", (d, f), "normal"),
            ("wg", (d, f), "normal"), ("wo", (f, d), "normal")]


def _moe_rows(cfg: ArchConfig) -> list:
    d, m = cfg.d_model, cfg.moe
    E, fe = m.n_experts, m.d_expert
    rows = [("ln", (d,), "zeros"), ("router", (d, E), "normal"),
            ("wi", (E, d, fe), "normal"), ("wg", (E, d, fe), "normal"),
            ("wo", (E, fe, d), "normal")]
    if m.shared_expert:
        rows += [("shared/wi", (d, fe), "normal"), ("shared/wg", (d, fe), "normal"),
                 ("shared/wo", (fe, d), "normal")]
    return rows


def _ssm_rows(cfg: ArchConfig) -> list:
    d = cfg.d_model
    d_inner, H, _, N, G = ssm_mod.dims(cfg)
    W = cfg.ssm.conv_width
    bc = 2 * G * N
    return [("norm", (d,), "zeros"), ("wz", (d, d_inner), "normal"),
            ("wx", (d, d_inner), "normal"), ("wbc", (d, bc), "normal"),
            ("wdt", (d, H), "normal"), ("conv_x_w", (W, d_inner), "normal"),
            ("conv_x_b", (d_inner,), "zeros"), ("conv_bc_w", (W, bc), "normal"),
            ("conv_bc_b", (bc,), "zeros"), ("a_log", (H,), "a_log"),
            ("d_skip", (H,), "ones"), ("dt_bias", (H,), "dt_bias"),
            ("out_norm", (d_inner,), "zeros"), ("wout", (d_inner, d), "normal")]


def _rec_rows(cfg: ArchConfig) -> list:
    d = cfg.d_model
    lru = cfg.rglru.lru_width or d
    W = cfg.rglru.conv_width
    return [("norm", (d,), "zeros"), ("linear_x", (d, lru), "normal"),
            ("linear_y", (d, lru), "normal"), ("linear_out", (lru, d), "normal"),
            ("conv_w", (W, lru), "normal"), ("conv_b", (lru,), "zeros"),
            ("a_param", (lru,), "a_param"), ("a_gate_w", (lru,), "normal_vec"),
            ("a_gate_b", (lru,), "zeros"), ("i_gate_w", (lru,), "normal_vec"),
            ("i_gate_b", (lru,), "zeros")]


def _cross_rows(cfg: ArchConfig) -> list:
    return _attn_rows(cfg.replace(qk_norm=False)) + [
        ("gate_attn", (), "zeros"), ("gate_mlp", (), "zeros")]


def _param_table(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    t: dict[str, tuple] = {
        "embed/tok": ((cfg.vocab, d), "embed", d),
        "final_norm/scale": ((d,), "zeros", 1),
    }
    if not cfg.tie_embeddings:
        t["unembed/w"] = ((d, cfg.vocab), "normal", d)
    stacks = [("attn", _count(cfg, ("attn", "moe")), _attn_rows(cfg)),
              ("mlp", n_mlp_layers(cfg) if cfg.d_ff else 0, _mlp_rows(cfg))]
    if _count(cfg, ("moe",)):
        stacks.append(("moe", _count(cfg, ("moe",)), _moe_rows(cfg)))
    if _count(cfg, ("ssm",)):
        stacks.append(("ssm", _count(cfg, ("ssm",)), _ssm_rows(cfg)))
    if _count(cfg, ("rec",)):
        stacks.append(("rec", _count(cfg, ("rec",)), _rec_rows(cfg)))
    if cfg.family == "vlm":
        stacks.append(("cross", n_cross_blocks(cfg), _cross_rows(cfg)))
    if cfg.family == "encdec":
        stacks += [("enc/attn", cfg.n_enc_layers, _attn_rows(cfg)),
                   ("enc/mlp", cfg.n_enc_layers, _mlp_rows(cfg))]
        t["enc/final_norm/scale"] = ((d,), "zeros", 1)
        stacks.append(("dec_cross", cfg.n_layers, _cross_rows(cfg)))
    for stack, L, rows in stacks:
        if not L:
            continue
        for name, shape, init in rows:
            fan_in = shape[-2] if len(shape) >= 2 else (shape[0] if shape else 1)
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


def _uniform(gen, shape, dev, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                       dtype=torch.float32)


# the reference's non-normal inits (``repro/models/lm.py:160-185``), as
# draws from the port's generator
_DRAWS = {
    "a_log": lambda g, s, dev: torch.log(_uniform(g, s, dev, 1.0, 16.0)),
    "dt_bias": lambda g, s, dev: torch.log(torch.expm1(_uniform(g, s, dev, 1e-3, 0.1))),
    "a_param": lambda g, s, dev: _uniform(g, s, dev, 2.0, 6.0),
    "normal_vec": lambda g, s, dev: 0.1 * torch.randn(s, generator=g, device=dev,
                                                      dtype=torch.float32),
}


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
        if init in ("zeros", "ones"):
            leaf = (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=dtype, device=dev)
        else:
            std = scale if init == "embed" else scale / math.sqrt(max(fan_in, 1))
            leaf = torch.empty(shape, dtype=dtype, device=dev)
            flat = leaf.view(-1, *shape[-2:])
            for i in range(flat.shape[0]):
                if init in _DRAWS:
                    v = _DRAWS[init](gen, shape[-2:], dev)
                else:
                    v = torch.randn(shape[-2:], generator=gen, device=dev,
                                    dtype=torch.float32) * std
                flat[i] = v.to(dtype)
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


def _mem_kv(cfg, p, d, memory):
    B, S, _ = memory.shape
    k = apply_linear(memory, p["wk"], dget(d, "wk")).reshape(B, S, cfg.n_kv, cfg.head_dim)
    v = apply_linear(memory, p["wv"], dget(d, "wv")).reshape(B, S, cfg.n_kv, cfg.head_dim)
    return k, v


def _cross_block(cfg, p, d, x, mem_kv, gated: bool):
    u = rmsnorm(x, p["ln1"], cfg.norm_eps)
    B, S, _ = u.shape
    q = apply_linear(u, p["wq"], dget(d, "wq")).reshape(B, S, cfg.n_heads, cfg.head_dim)
    out = cross_attention(q, *mem_kv, cap=cfg.attn_softcap)
    out = apply_linear(out.reshape(B, S, cfg.q_dim), p["wo"], dget(d, "wo"))
    if gated:
        out = out * torch.tanh(p["gate_attn"].to(out.dtype))
    return x + out


def _cross_kv(cfg, p, d, memory, cache, decode: bool):
    """A cross block's memory k/v: read from its cache at decode, else
    projected from ``memory`` (and, with a cache, stored there)."""
    if cache is not None and decode:
        return cache["k"], cache["v"]
    k, v = _mem_kv(cfg, p, d, memory)
    if cache is not None:
        cache["k"], cache["v"] = k, v
    return k, v


def _write_state(cache_l: tuple, new: tuple) -> None:
    """Copy a mixer's new SsmState/RecState into its cache entry."""
    for c, n in zip(cache_l, new):
        c.copy_(n)


# ---------------------------------------------------------------------------
# Encoder (encdec family)
# ---------------------------------------------------------------------------
def encode(cfg: ArchConfig, params, feats: torch.Tensor, deltas=None) -> torch.Tensor:
    """Bidirectional encoder over precomputed frontend features [B,S,d],
    with the ``enc`` subtree of the deltas. The residual starts in
    ``cfg.param_dtype``, as the reference's does."""
    enc = params["enc"]
    denc = dget(deltas, "enc")
    x = feats.to(getattr(torch, cfg.param_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_enc_layers):
        p_a = _slice(enc["attn"], i)
        d_a = dindex(dget(denc, "attn"), i)
        u = rmsnorm(x, p_a["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(u, p_a, d_a, cfg, positions)
        out = attention(q, k, v, positions, positions, window=0, causal=False,
                        cap=cfg.attn_softcap)
        x = x + apply_linear(out.reshape(*x.shape[:-1], cfg.q_dim), p_a["wo"],
                             dget(d_a, "wo"))
        x = _mlp_block(cfg, _slice(enc["mlp"], i), dindex(dget(denc, "mlp"), i), x)
    return rmsnorm(x, enc["final_norm"]["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Layer walk
# ---------------------------------------------------------------------------
def _remat(fn):
    """``jax.checkpoint`` of the reference's ``_walk``: the block's
    activations are recomputed in backward instead of kept."""
    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return run


def _walk(cfg: ArchConfig, params, x, positions, deltas=None, caches=None,
          memory=None, decode_pos=None, chunk=False, chunk_valid=None,
          remat=False):
    """Python loop over the layers (train, prefill, chunk and decode
    paths). A layer's attention is row ``_attn_index`` of the attention
    stack, its MLP row ``_mlp_index`` of the mlp stack; a moe, ssm or rec
    layer's block is row ``j`` of its own kind's stack. The cross caches
    sit after the ``n_layers`` self-layer entries. ``remat`` (training,
    no cache) checkpoints each self block as the reference's ``mr`` does
    (``repro/models/lm.py:503-504``)."""
    mr = _remat if remat else (lambda fn: fn)
    decode = decode_pos is not None
    cross_after = _cross_after(cfg)
    ci = cfg.n_layers
    cross_i = 0
    for li, (kind, j, window) in enumerate(layer_plan(cfg)):
        cache_l = caches[li] if caches is not None else None
        if kind in ("attn", "moe"):
            ai = _attn_index(cfg, li)
            p_a = _slice(params["attn"], ai)
            d_a = dindex(dget(deltas, "attn"), ai)
            if decode:
                x = _attn_block_decode(cfg, p_a, d_a, x, decode_pos, window, cache_l)
            elif cache_l is not None and chunk:
                x = _attn_block_chunk(cfg, p_a, d_a, x, positions, window, cache_l,
                                      chunk_valid)
            elif cache_l is not None:
                x = _attn_block_prefill(cfg, p_a, d_a, x, positions, window, cache_l)
            else:
                # bind the layer's window now: remat calls the block again
                # in backward, after the loop has moved on
                x = mr(lambda x, p, d, w=window: _attn_block_train(
                    cfg, p, d, x, positions, w))(x, p_a, d_a)
        else:
            mod = ssm_mod.mamba_block if kind == "ssm" else rec_mod.rglru_block
            p_s, d_s = _slice(params[kind], j), dindex(dget(deltas, kind), j)
            if cache_l is None:
                out = mr(lambda x, p, d, mod=mod: mod(x, p, d, cfg, state=None,
                                                      decode=False)[0])(x, p_s, d_s)
            else:
                out, new_st = mod(x, p_s, d_s, cfg, state=cache_l, decode=decode)
                _write_state(cache_l, new_st)
            x = x + out
        if kind == "moe":
            x = mr(lambda x, p, d: _moe_block(cfg, p, d, x))(
                x, _slice(params["moe"], j), dindex(dget(deltas, "moe"), j))
        elif kind in ("attn", "rec"):
            mi = _mlp_index(cfg, li)
            x = mr(lambda x, p, d: _mlp_block(cfg, p, d, x))(
                x, _slice(params["mlp"], mi), dindex(dget(deltas, "mlp"), mi))

        if li in cross_after:        # vlm: the gated cross block and its MLP
            p_c = _slice(params["cross"], cross_i)
            d_c = dindex(dget(deltas, "cross"), cross_i)
            mem_kv = _cross_kv(cfg, p_c, d_c, memory,
                               caches[ci + cross_i] if caches is not None else None,
                               decode)
            x = _cross_block(cfg, p_c, d_c, x, mem_kv, gated=True)
            cmi = _count(cfg, ("attn", "rec")) + cross_i
            p_m = _slice(params["mlp"], cmi)
            d_m = dindex(dget(deltas, "mlp"), cmi)
            u = rmsnorm(x, p_m["ln"], cfg.norm_eps)
            x = x + glu_mlp(u, p_m, d_m, cfg.act) * torch.tanh(p_c["gate_mlp"].to(x.dtype))
            cross_i += 1

        if cfg.family == "encdec":   # ungated cross block into the encoder's memory
            p_c = _slice(params["dec_cross"], li)
            d_c = dindex(dget(deltas, "dec_cross"), li)
            mem_kv = _cross_kv(cfg, p_c, d_c, memory,
                               caches[ci + li] if caches is not None else None, decode)
            x = _cross_block(cfg, p_c, d_c, x, mem_kv, gated=False)
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


def _memory(cfg, params, batch: dict, x: torch.Tensor, deltas):
    """The cross blocks' memory: the encoder's output (encdec), the image
    embeddings in the residual's dtype (vlm), else None."""
    if cfg.family == "encdec":
        return encode(cfg, params, batch["enc_feats"], deltas)
    if cfg.family == "vlm":
        return batch["image_embeds"].to(x.dtype)
    return None


def forward(cfg: ArchConfig, params, batch: dict, deltas=None,
            remat: bool = False) -> torch.Tensor:
    """Training/scoring forward: full-sequence causal logits [B,S,V].
    ``remat`` recomputes each block in backward (training)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = _walk(cfg, params, x, positions, deltas=deltas,
              memory=_memory(cfg, params, batch, x, deltas), remat=remat)
    return unembed(cfg, params, h, deltas)


def loss_fn(cfg: ArchConfig, params, batch: dict, deltas=None, remat: bool = False):
    """Mean next-token cross-entropy (``repro/models/lm.py:679-692``):
    default labels are the tokens shifted left with a 0 pad, the last
    position masked; ``loss_mask`` weighs positions. -> (loss, {"loss",
    "tokens"}), f32 scalars."""
    logits = forward(cfg, params, batch, deltas, remat=remat)
    labels = batch.get("labels")
    mask = batch.get("loss_mask")
    if labels is None:
        tokens = batch["tokens"]
        labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1), value=0)
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
            mask[:, -1] = 0.0
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask = mask.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    nll = (logz - ll) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss, "tokens": torch.sum(mask)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_len: int = 0, *,
               device=None) -> list:
    """Zero-initialized serving cache (``repro/models/lm.py:699-758``):
    one entry per decoder layer, then the vlm's cross blocks' image caches
    or the encdec's per-layer encoder caches of ``enc_len`` frames. ``pos``
    starts at -1 (invalid)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    out: list = []
    for kind, _, window in layer_plan(cfg):
        if kind in ("attn", "moe"):
            S_c = max_seq if window == 0 else min(window, max_seq)
            out.append({"k": z(batch, S_c, cfg.n_kv, cfg.head_dim),
                        "v": z(batch, S_c, cfg.n_kv, cfg.head_dim),
                        "pos": torch.full((batch, S_c), -1, dtype=torch.int32,
                                          device=dev)})
        elif kind == "ssm":
            d_inner, H, P, N, G = ssm_mod.dims(cfg)
            W = cfg.ssm.conv_width
            out.append(ssm_mod.SsmState(conv_x=z(batch, W - 1, d_inner),
                                        conv_bc=z(batch, W - 1, 2 * G * N),
                                        state=z(batch, H, P, N, dt=torch.float32)))
        else:
            lru = cfg.rglru.lru_width or cfg.d_model
            out.append(rec_mod.RecState(conv=z(batch, cfg.rglru.conv_width - 1, lru),
                                        h=z(batch, lru, dt=torch.float32)))
    mem = [(n_cross_blocks(cfg), cfg.n_frontend_tokens)] if cfg.family == "vlm" else \
        [(cfg.n_layers, enc_len)] if cfg.family == "encdec" else []
    for n, S_mem in mem:
        out += [{"k": z(batch, S_mem, cfg.n_kv, cfg.head_dim),
                 "v": z(batch, S_mem, cfg.n_kv, cfg.head_dim)} for _ in range(n)]
    return out


def cache_fields(entry) -> dict:
    """{name: tensor} of one cache entry (a ring dict, a cross-cache dict,
    an SsmState or a RecState); every tensor leads with the batch."""
    return entry._asdict() if isinstance(entry, tuple) else entry


def cache_rows(cache: list, lo: int, hi: int) -> list:
    """Views of rows ``lo:hi`` of every cache entry, in the entries' own
    types: in-place writes through them land in ``cache``."""
    return [type(e)(*(t[lo:hi] for t in e)) if isinstance(e, tuple)
            else {k: t[lo:hi] for k, t in e.items()} for e in cache]


def prefill(cfg: ArchConfig, params, batch: dict, cache, deltas=None):
    """Run the prompt through the model, filling ``cache`` in place.

    Returns (logits for the LAST position [B,V], cache). ``batch
    ["positions"]`` ([B, S], optional) overrides the default arange(S);
    ``enc_feats`` / ``image_embeds`` feed the cross blocks.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = _walk(cfg, params, x, positions, deltas=deltas, caches=cache,
              memory=_memory(cfg, params, batch, x, deltas))
    logits = unembed(cfg, params, h[:, -1:], deltas)
    return logits[:, 0], cache


def prefill_chunk(cfg: ArchConfig, params, batch: dict, cache, deltas=None):
    """Consume one position-offset prompt chunk against an existing cache.

    The resumable middle of chunked prefill: ``batch["tokens"]`` [B, C]
    is a slice of the prompt, ``batch["positions"]`` [B, C] its absolute
    positions (cursor offset, NOT restarting at 0), and ``cache`` the
    row's cache as earlier chunks left it (updated in place). Attention
    layers ring-append the chunk; ssm/rec mixers continue from their
    carried state. An optional ``batch["valid"]`` [B, C] bool marks real
    tokens when the engine right-pads the tail chunk to a fixed width
    (attention-only archs; pad K/V never reach the ring). Stateful mixers
    are never padded: the engine sends exact-length tail chunks.

    Returns (logits [B, C, V] for EVERY chunk position, cache): the
    caller picks the last real position's logits of the final chunk for
    the first generated token. Refuses encdec and vlm (per-request
    encoder inputs), as the reference does.
    """
    _check_family(cfg)
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(
            f"chunked prefill does not support family={cfg.family!r} "
            "(per-request encoder inputs); use the whole-prompt path")
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    h = _walk(cfg, params, x, batch["positions"], deltas=deltas, caches=cache,
              chunk=True, chunk_valid=batch.get("valid"))
    return unembed(cfg, params, h, deltas), cache


def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                pos: Union[int, torch.Tensor], deltas: Optional[Any] = None):
    """One decode step. tokens [B,1]; pos an int (all rows at the same
    position) or [B] (per-slot positions — ``deltas`` may then be a
    slot-dispatched tree). Updates ``cache`` in place; the cross blocks
    read their memory from it.

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
