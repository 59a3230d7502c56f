"""Plain-torch oracles for the delta kernels (port of ``repro/kernels/ref.py``).

Each ported kernel has a ref twin here (the fused and dequant kernels'
twins come with those kernels); the CPU tests hold the port against
these as well as against the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.pack import PackedDelta, reconstruct_dense


def delta_spmm_ref(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x [T, h_in] @ dequant(delta) [h_in, h_out] -> [T, h_out] (f32)."""
    return x.to(torch.float32) @ reconstruct_dense(d, dtype=torch.float32)

