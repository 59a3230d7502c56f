"""Mamba2-370m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]
48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
SSM decode is O(1)/token -> long_500k runs.
"""
from repro_torch.configs.arch import ArchConfig, SsmCfg, register

FULL = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,          # SSD heads: d_inner(2048) / head_dim(64)
    n_kv=32,
    head_dim=64,
    d_ff=0,
    vocab=50_280,
    tie_embeddings=True,
    ssm=SsmCfg(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,           # d_inner 128 / head_dim 32
    n_kv=4,
    head_dim=32,
    d_ff=0,
    vocab=256,
    tie_embeddings=True,
    ssm=SsmCfg(d_state=16, head_dim=32, expand=2, conv_width=4, chunk=16),
    subquadratic=True,
)

register(FULL, SMOKE)
