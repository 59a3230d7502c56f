"""Llama-3.2-11B-Vision — text backbone with gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
A gated cross-attention block is inserted after every 5th self-attn layer
(8 cross blocks). The vision tower is a STUB: ``input_specs()`` supplies
precomputed patch embeddings (batch, 1600, d_model).
Full self-attention backbone -> long_500k skipped.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=14_336,
    vocab=128_256,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=False,
    frontend="vision",
    n_frontend_tokens=1600,
    cross_attn_every=5,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    act="silu",
    tie_embeddings=False,
    frontend="vision",
    n_frontend_tokens=16,
    cross_attn_every=2,
)

register(FULL, SMOKE)
