"""Llama-4-Scout-17B-16E — MoE, 16 experts top-1 + shared expert, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.

Long context: Llama-4 uses iRoPE chunked attention; we model it as
chunked-local attention (8192-token chunks) which is sub-quadratic, so the
long_500k cell runs for this arch (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.arch import ArchConfig, MoeCfg, register

FULL = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=False,
    moe=MoeCfg(n_experts=16, top_k=1, d_expert=8192, shared_expert=True),
    subquadratic=True,
    attn_chunk=8192,
)

SMOKE = ArchConfig(
    name="llama4-scout-17b-a16e-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    act="silu",
    tie_embeddings=False,
    moe=MoeCfg(n_experts=4, top_k=1, d_expert=128, shared_expert=True),
    subquadratic=True,
    attn_chunk=32,
)

register(FULL, SMOKE)
