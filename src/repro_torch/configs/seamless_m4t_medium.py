"""SeamlessM4T-medium — encoder-decoder multimodal backbone.

[arXiv:2308.11596; hf]
12L (enc) + 12L (dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.

The audio frontend (w2v-BERT conformer feature extractor) is a STUB per the
task spec: ``input_specs()`` supplies precomputed frame embeddings of shape
(batch, frames, d_model); the transformer backbone (encoder, decoder with
cross-attention) is real. Full attention enc-dec -> long_500k skipped.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    head_dim=64,
    d_ff=4096,
    vocab=256_206,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    frontend="audio",
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    act="gelu",
    tie_embeddings=True,
    frontend="audio",
)

register(FULL, SMOKE)
