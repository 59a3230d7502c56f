"""Llama-3.2-1B — small dense llama3.

[hf:meta-llama/Llama-3.2-1B; unverified]
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    head_dim=64,
    d_ff=8192,
    vocab=128_256,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    act="silu",
    tie_embeddings=True,
)

register(FULL, SMOKE)
