"""Delta codecs (port of ``repro/core/codecs.py``, DeltaDQ only so far).

A codec packages one delta-compression format: compress a (base, ft)
weight pair into a leaf, account its storage bits, and lower the leaf to
the :class:`~repro_torch.core.pack.PackedDelta` runtime layout every
decode path consumes. DeltaDQ's leaf *is* the runtime layout, so its
lowering is the identity. BitDelta and LowRank come with the
mixed-codec serving slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core import quant
from repro_torch.core.dropout import groupwise_dropout_pack
from repro_torch.core.pack import PackedDelta
from repro_torch.utils import tree_map


@dataclass(frozen=True)
class DeltaDQSpec:
    """DeltaDQ hyperparameters (group-wise dropout + separate quant)."""
    alpha: float = 8.0            # dropout compression (keep-rate 1/alpha)
    k_bits: Optional[int] = None  # None -> dropout only (paper's 2x..8x rows)
    m: int = 1                    # separate-quantization parts
    h_g: Optional[int] = None     # None -> use h_in (row-wise)
    seed: int = 0

    def ratio(self) -> float:
        return quant.compression_ratio(self.alpha, self.k_bits, self.m)


def _pick_hg(h_in: int, spec: DeltaDQSpec) -> int:
    if spec.h_g is None:
        return h_in
    # clamp to a divisor of h_in: largest halving of h_g dividing h_in.
    # Candidates below alpha are unsatisfiable (keep would round to 0).
    floor = max(spec.alpha, 1.0)
    hg = min(spec.h_g, h_in)
    if hg < floor:
        raise ValueError(
            f"unsatisfiable group size: requested h_g={spec.h_g} "
            f"(clamped to {hg} for h_in={h_in}) is below alpha={spec.alpha}; "
            f"every group must keep h_g/alpha >= 1 elements, so pick "
            f"h_g >= alpha")
    while h_in % hg:
        hg //= 2
        if hg < floor:
            raise ValueError(
                f"unsatisfiable group size: no halving of h_g={spec.h_g} "
                f"both divides h_in={h_in} and stays >= alpha={spec.alpha}")
    return int(hg)


class DeltaDQCodec:
    """The paper's codec: group-wise dropout + separate quantization."""

    name = "deltadq"

    def compress_leaf(self, base_leaf: torch.Tensor, ft_leaf: torch.Tensor,
                      spec: DeltaDQSpec, *, u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> PackedDelta:
        delta = ft_leaf.to(torch.float32) - base_leaf.to(torch.float32)
        hg = _pick_hg(delta.shape[-2], spec)
        return groupwise_dropout_pack(delta, h_g=hg, alpha=spec.alpha,
                                      k_bits=spec.k_bits, m=spec.m, u=u,
                                      generator=generator)

    def storage_bits(self, leaf: PackedDelta) -> dict:
        stack = math.prod(leaf.stack_shape())
        vb = leaf.value_bits() * stack
        return {"value_bits": vb, "total_bits": vb + leaf.index_bits() * stack}


_DELTADQ = DeltaDQCodec()


def codec_for_spec(spec: Any) -> DeltaDQCodec:
    if isinstance(spec, DeltaDQSpec):
        return _DELTADQ
    raise TypeError(f"no codec of the port accepts spec {type(spec).__name__}")


def runtime_packed_leaf(leaf: Any) -> Any:
    """Lower one codec leaf to the PackedDelta runtime layout (identity on
    PackedDelta and on None)."""
    if leaf is None or isinstance(leaf, PackedDelta):
        return leaf
    raise TypeError(f"no codec of the port owns leaf {type(leaf).__name__}")


def runtime_delta_tree(tree: Any) -> Any:
    """Lower every codec leaf of a deltas tree to PackedDelta (identity for
    DeltaDQ trees). Engines call this at tenant registration."""
    return tree_map(runtime_packed_leaf, tree)
