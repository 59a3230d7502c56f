"""Tile/formulation lookup for the delta-correction hot path (lookup only).

Port of the lookup half of ``repro/kernels/autotune.py``. The port has no
swept table of its own yet, so :func:`lookup` returns :data:`DEFAULTS`
(with the identity floor applied). The JAX package's
``results/autotune_kernels.json`` holds TPU/CPU tiles and is not read.

``gather_max_t`` is floored at :data:`MIN_GATHER_T`: the segment
dispatch always uses the gather formulation, so the per-tenant path must
pick gather for every decode-sized batch too.
"""
from __future__ import annotations

from typing import Optional

DEFAULTS = {"tb": 128, "ob": 128, "kc": 8, "gather_max_t": 64}

# floor for the gather/dense crossover (see module doc)
MIN_GATHER_T = 32

T_GRID = (1, 4, 8, 16, 32, 64, 128, 256)


def snap_t(t: int) -> int:
    """Snap a token count to its :data:`T_GRID` bucket (smallest grid
    point >= t; counts past the grid share the largest bucket)."""
    for g in T_GRID:
        if t <= g:
            return g
    return T_GRID[-1]


def lookup(h_g: int, keep: int, k_bits: Optional[int], h_in: int,
           h_out: int, t: Optional[int] = None) -> dict:
    """Tile/formulation parameters for an envelope point (always complete).

    Every envelope point maps to :data:`DEFAULTS` until the port has a
    table swept on the card."""
    got = dict(DEFAULTS)
    got["gather_max_t"] = max(int(got["gather_max_t"]), MIN_GATHER_T)
    return got
