"""Phi-3-medium-14B — dense, RoPE SwiGLU GQA.

[arXiv:2404.14219; unverified]
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv=10,
    head_dim=128,
    d_ff=17_920,
    vocab=100_352,
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    act="silu",
    tie_embeddings=False,
)

register(FULL, SMOKE)
