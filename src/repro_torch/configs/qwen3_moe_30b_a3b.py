"""Qwen3-30B-A3B — MoE, 128 experts top-8, QK-norm.

[hf:Qwen/Qwen3-30B-A3B; hf]
48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936, 128e top-8.
Pure full attention -> long_500k skipped (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.arch import ArchConfig, MoeCfg, register

FULL = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    act="silu",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=False,
    moe=MoeCfg(n_experts=128, top_k=8, d_expert=768),
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=32,
    vocab=512,
    act="silu",
    qk_norm=True,
    tie_embeddings=False,
    moe=MoeCfg(n_experts=8, top_k=2, d_expert=32),
)

register(FULL, SMOKE)
