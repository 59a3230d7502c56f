"""RecurrentGemma-9B — RG-LRU + local attention, 2 recurrent : 1 attention.

[arXiv:2402.19427; unverified]
38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000, head_dim=256.
Pattern: (rec, rec, attn) repeating; attn layers use a 2048 sliding window.
Recurrent state decode + windowed attention -> long_500k runs.
"""
from repro_torch.configs.arch import ArchConfig, RglruCfg, register

_N = 38
_KINDS = tuple("attn" if i % 3 == 2 else "rec" for i in range(_N))
_WINDOWS = tuple(2048 if k == "attn" else 0 for k in _KINDS)

FULL = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=_N,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12_288,
    vocab=256_000,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    layer_kinds=_KINDS,
    layer_windows=_WINDOWS,
    rglru=RglruCfg(lru_width=4096, conv_width=4, window=2048),
    subquadratic=True,
)

_SN = 6
_SKINDS = tuple("attn" if i % 3 == 2 else "rec" for i in range(_SN))
SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=_SN,
    d_model=64,
    n_heads=2,
    n_kv=1,
    head_dim=32,
    d_ff=128,
    vocab=512,
    act="gelu",
    tie_embeddings=True,
    layer_kinds=_SKINDS,
    layer_windows=tuple(8 if k == "attn" else 0 for k in _SKINDS),
    rglru=RglruCfg(lru_width=64, conv_width=4, window=8),
    subquadratic=True,
)

register(FULL, SMOKE)
