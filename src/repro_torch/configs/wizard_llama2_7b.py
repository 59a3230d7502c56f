"""WizardMath/WizardLM-7B class — the paper's own evaluation target.

Llama-2-7B geometry [arXiv:2308.09583]: 32L d_model=4096 32H (MHA) d_ff=11008
vocab=32000. Used by the paper-fidelity benchmarks (Tables 1-4) and by the
end-to-end SFT -> delta -> DeltaDQ examples.
"""
from repro_torch.configs.arch import ArchConfig, register

FULL = ArchConfig(
    name="wizard-llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    head_dim=128,
    d_ff=11_008,
    vocab=32_000,
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    subquadratic=False,
)

SMOKE = ArchConfig(
    name="wizard-llama2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=192,
    vocab=512,
    act="silu",
    tie_embeddings=False,
)

register(FULL, SMOKE)
