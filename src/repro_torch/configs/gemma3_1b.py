"""Gemma3-1B — 5:1 local:global attention, 128k-class context.

[hf:google/gemma-3-1b-pt; unverified]
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256.
Pattern: 5 sliding-window (512) layers then 1 global, repeating.
Mostly-local attention -> long_500k runs (global-layer KV sequence-sharded).
"""
from repro_torch.configs.arch import ArchConfig, register

_N = 26
_WINDOWS = tuple(0 if (i % 6 == 5) else 512 for i in range(_N))

FULL = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=_N,
    d_model=1152,
    n_heads=4,
    n_kv=1,
    head_dim=256,
    d_ff=6912,
    vocab=262_144,
    act="gelu",
    rope_theta=1_000_000.0,
    qk_norm=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    layer_windows=_WINDOWS,
    subquadratic=True,
)

_SN = 6
SMOKE = ArchConfig(
    name="gemma3-1b-smoke",
    family="dense",
    n_layers=_SN,
    d_model=64,
    n_heads=2,
    n_kv=1,
    head_dim=32,
    d_ff=128,
    vocab=512,
    act="gelu",
    qk_norm=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    layer_windows=tuple(0 if (i % 6 == 5) else 8 for i in range(_SN)),
    subquadratic=True,
)

register(FULL, SMOKE)
