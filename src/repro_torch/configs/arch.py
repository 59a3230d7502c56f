"""Architecture configuration system (copy of ``repro/configs/arch.py``).

Every supported model is described by one frozen :class:`ArchConfig`.
The port registers every config the reference serves; each config file
also exposes a ``smoke()``-sized reduced config of the same family for
CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoeCfg:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN hidden dim
    shared_expert: bool = False  # llama4-style always-on shared expert
    router_jitter: float = 0.0
    capacity_factor: float = 1.25  # per-expert buffer slack; tokens beyond it drop


@dataclass(frozen=True)
class SsmCfg:
    """Mamba-2 SSD settings."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class RglruCfg:
    """RecurrentGemma RG-LRU settings."""
    lru_width: int = 0      # 0 -> d_model
    conv_width: int = 4
    window: int = 2048      # local-attention window of the attn layers


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int

    act: str = "silu"       # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # Per-layer attention pattern. ``layer_windows[i] == 0`` means full/global
    # attention at layer i; ``w > 0`` means sliding-window (local) attention
    # of width w. ``layer_kinds[i]`` in {"attn", "moe", "ssm", "rec"}.
    layer_kinds: tuple = ()
    layer_windows: tuple = ()

    moe: Optional[MoeCfg] = None
    ssm: Optional[SsmCfg] = None
    rglru: Optional[RglruCfg] = None

    # --- encoder-decoder (seamless-m4t) ---
    n_enc_layers: int = 0

    # --- multimodal stub frontend ---
    frontend: Optional[str] = None   # "audio" | "vision"
    n_frontend_tokens: int = 0       # precomputed embedding tokens per example
    cross_attn_every: int = 0        # vlm: gated cross-attn block after every k-th layer

    # long-context capability: archs without a sub-quadratic path skip long_500k
    subquadratic: bool = False
    # chunked-attention chunk size for iRoPE-style long context (llama4)
    attn_chunk: int = 0

    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if not self.layer_kinds:
            kind = {"moe": "moe", "ssm": "ssm"}.get(self.family, "attn")
            object.__setattr__(self, "layer_kinds", tuple([kind] * self.n_layers))
        if not self.layer_windows:
            object.__setattr__(self, "layer_windows", tuple([0] * self.n_layers))
        if len(self.layer_kinds) != self.n_layers:
            raise ValueError(
                f"arch {self.name!r}: {len(self.layer_kinds)} layer_kinds "
                f"for n_layers={self.n_layers}")
        if len(self.layer_windows) != self.n_layers:
            raise ValueError(
                f"arch {self.name!r}: {len(self.layer_windows)} "
                f"layer_windows for n_layers={self.n_layers}")

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    def n_params(self) -> int:
        """Analytic parameter count (matches the port's param_shapes)."""
        from repro_torch.models.lm import param_shapes
        total = 0
        for shape, _ in param_shapes(self).values():
            n = 1
            for s in shape:
                n *= s
            total += n
        return total

    def n_active_params(self, seq_len: int = 1) -> int:
        """Active params per token (MoE: only routed experts count)."""
        total = self.n_params()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        n_moe = sum(1 for k in self.layer_kinds if k == "moe")
        inactive = (m.n_experts - m.top_k) * per_expert * n_moe
        return total - inactive

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, "ArchConfig"] = {}
_SMOKE: dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ArchConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every config module for its register() side effect
    from repro_torch.configs import (  # noqa: F401
        gemma3_1b,
        gemma_7b,
        llama4_scout_17b_a16e,
        llama32_1b,
        llama32_vision_11b,
        mamba2_370m,
        phi3_medium_14b,
        qwen3_moe_30b_a3b,
        recurrentgemma_9b,
        seamless_m4t_medium,
        wizard_llama2_7b,
    )
