"""Plain-torch oracles for the delta kernels (port of ``repro/kernels/ref.py``).

Each kernel has a ref twin here; the CPU tests hold the port against
these as well as against the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.pack import PackedDelta, reconstruct_dense


def delta_spmm_ref(x: torch.Tensor, d: PackedDelta) -> torch.Tensor:
    """x [T, h_in] @ dequant(delta) [h_in, h_out] -> [T, h_out] (f32)."""
    return x.to(torch.float32) @ reconstruct_dense(d, dtype=torch.float32)



def fused_base_delta_ref(x: torch.Tensor, w: torch.Tensor,
                         d: PackedDelta) -> torch.Tensor:
    """x @ (W_base + dequant(delta)) in one pass -> [T, h_out] (f32)."""
    dense = reconstruct_dense(d, dtype=torch.float32)
    return x.to(torch.float32) @ (w.to(torch.float32) + dense)


def dequant_tile_ref(d: PackedDelta) -> torch.Tensor:
    """Materialize the dense delta [h_in, h_out] (f32)."""
    return reconstruct_dense(d, dtype=torch.float32)
