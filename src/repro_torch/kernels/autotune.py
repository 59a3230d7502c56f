"""Tile/formulation lookup for the delta-correction hot path (lookup only).

Port of the lookup half of ``repro/kernels/autotune.py``. The port has no
swept table of its own and takes no tile sizes from the reference: those
are TPU/CPU timings, and the CUDA kernels pick their own tiles
(``kernels/ops.py``). What it does keep is the reference table's
``gather_max_t`` at each envelope point (:data:`GATHER_MAX_T`), because
that value only chooses the CPU plain formulation (gather vs dense
reconstruction, ``fallback.correction``): with the same crossover the
port's CPU results match the reference's formulation for formulation.
Every other point, and every other key, comes from :data:`DEFAULTS`.

``gather_max_t`` is floored at :data:`MIN_GATHER_T`: the segment
dispatch always uses the gather formulation, so the per-tenant path must
pick gather for every decode-sized batch too.
"""
from __future__ import annotations

from typing import Optional

DEFAULTS = {"tb": 128, "ob": 128, "kc": 8, "gather_max_t": 64}

# floor for the gather/dense crossover (see module doc)
MIN_GATHER_T = 32

# The reference table's gather_max_t per base envelope key
# "h_g/keep/k_bits/h_in/h_out" (results/autotune_kernels.json, version 3).
GATHER_MAX_T = {
    "128/16/4/256/256": 64,
    "16/2/4/128/64": 64,
    "16/2/4/64/128": 128,
    "16/2/4/64/32": 128,
    "16/2/4/64/64": 32,
    "16/2/None/64/64": 128,
    "64/8/4/128/128": 128,
    "64/8/4/128/256": 64,
    "64/8/4/128/64": 128,
    "64/8/4/256/128": 128,
    "64/8/4/512/512": 64,
    "64/8/8/128/256": 64,
}


def envelope_key(h_g: int, keep: int, k_bits: Optional[int], h_in: int,
                 h_out: int) -> str:
    return f"{h_g}/{keep}/{k_bits}/{h_in}/{h_out}"


def lookup(h_g: int, keep: int, k_bits: Optional[int], h_in: int,
           h_out: int) -> dict:
    """Tile/formulation parameters for an envelope point (always complete).
    The reference's per-T overlays carry tiles only, which the port does
    not take, so there is no token-count argument."""
    got = dict(DEFAULTS)
    key = envelope_key(h_g, keep, k_bits, h_in, h_out)
    got["gather_max_t"] = max(GATHER_MAX_T.get(key, got["gather_max_t"]),
                              MIN_GATHER_T)
    return got
