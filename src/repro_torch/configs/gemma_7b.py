"""Gemma-7B — GeGLU, head_dim=256.

[arXiv:2403.08295; hf]
28L d_model=3072 16H (GQA kv=16, i.e. MHA) d_ff=24576 vocab=256000.
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv=16,
    head_dim=256,
    d_ff=24_576,
    vocab=256_000,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="gemma-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    act="gelu",
    tie_embeddings=True,
)

register(FULL, SMOKE)
