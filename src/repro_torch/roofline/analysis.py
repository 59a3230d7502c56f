"""Three-term roofline on one NVIDIA H100 (port of ``repro/roofline/analysis.py``).

    compute    = FLOPs / peak FLOP/s of the unit that runs them
    memory     = bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program. An eager torch program has no such artifact:
:func:`count_flops` counts a callable's FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (on ``meta`` tensors too, so
nothing is allocated or computed), and :func:`from_callable` takes the
bytes from the tensors it is given and returns (each read once, each
written once). :func:`collective_bytes` stays the reference's parser of
optimized HLO text, a pure function the mesh can use later.

The correction kernels are counted from their shapes and the packed
delta by one work function each (:func:`delta_spmm_work`,
:func:`segments_work`, :func:`experts_work`, :func:`fused_base_delta_work`,
:func:`dequant_work`), whatever kernel implements them: each returns
``(flops, bytes, unit)`` with every input byte read once and every output
byte written once, and :func:`bound_ms` turns it into the least time the
card could take. The unit is the peak the operations divide by: ``f32``
for the correction kernels, which multiply and add in f32 on CUDA cores
in a fixed order tensor cores cannot keep, and ``tf32`` for the fused
kernel (3xTF32 tensor-core products; the bound counts the function's
``2*T*h_in*h_out`` operations once).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

# H100 SXM5, NVIDIA data sheet, dense (no sparsity) peaks per unit
PEAKS = {
    "bf16": 989e12,   # tensor cores
    "tf32": 495e12,   # tensor cores
    "f32": 67e12,     # CUDA cores, outside the tensor cores
}
PEAK_FLOPS = PEAKS["bf16"]
HBM_BW = 3.35e12               # bytes/s
HBM_BYTES = 80e9               # device memory
LINK_BW = 450e9                # NVLink 4, bytes/s each way (900 GB/s both ways)

_DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# `%x = bf16[4,128]{1,0} all-gather(...)` / tuple results `= (f32[..], ...)`
_OP_RE = re.compile(
    r"=\s*\(?\s*([a-z0-9]+)\[([0-9,]*)\][^=]*?\s"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")


def _size_bytes(dtype: str, dims: str) -> float:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> dict:
    """Sum per-device bytes moved by collectives in optimized HLO text."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for m in _OP_RE.finditer(hlo_text):
        dtype, dims, op = m.groups()
        # ignore the -done halves of async pairs (bytes counted at -start)
        if "-done(" in m.group(0):
            continue
        out[op] += _size_bytes(dtype, dims)
        counts[op] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": float(sum(out.values()))}


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device
    model_flops: float           # 6ND / 2ND useful-work reference (per device)
    unit: str = "bf16"           # the peak the FLOPs divide by (PEAKS)

    @property
    def peak(self) -> float:
        return PEAKS[self.unit]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat/redundancy waste detector."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the compute roofline achievable at the bound:
        (useful FLOP time) / (time of the dominant term)."""
        t_useful = self.model_flops / self.peak
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
            "model_flops_per_device": self.model_flops,
            "unit": self.unit,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops_for(kind: str, n_params: int, n_active: int, tokens: int,
                    n_devices: int) -> float:
    """6ND for training, 2ND for inference (active params for MoE)."""
    per_tok = 6 * n_active if kind == "train" else 2 * n_active
    return per_tok * tokens / n_devices


# ---------------------------------------------------------------------------
# counting an eager program
# ---------------------------------------------------------------------------
def _tensors(obj: Any):
    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def tensor_bytes(obj: Any) -> int:
    """Bytes of every tensor in a (nested) dict, list, tuple or dataclass."""
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def count_flops(fn: Callable, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under ``FlopCounterMode``: -> (FLOPs,
    its result). On ``meta`` tensors nothing is allocated or computed."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def from_callable(fn: Callable, args: tuple, kind: str, n_params: int,
                  n_active: int, tokens: int, n_devices: int = 1,
                  unit: str = "bf16") -> Roofline:
    """The twin of the reference's ``from_compiled``: FLOPs counted by
    :func:`count_flops`, bytes those of ``args`` read once and the result
    written once; no collectives on one device."""
    flops, out = count_flops(fn, *args)
    return Roofline(flops=flops, bytes_accessed=float(tensor_bytes(args) + tensor_bytes(out)),
                    coll_bytes=0.0,
                    model_flops=model_flops_for(kind, n_params, n_active, tokens, n_devices),
                    unit=unit)


# ---------------------------------------------------------------------------
# the correction kernels' work, from shapes and the packed delta
# ---------------------------------------------------------------------------
def packed_bytes(d) -> int:
    """Bytes of one packed delta's arrays (idx, codes, scale, zero)."""
    return sum(t.numel() * t.element_size() for t in (d.idx, d.codes, d.scale, d.zero))


def read_bytes(d, tb: int = 8) -> int:
    """Bytes of ``d`` that the correction kernels must read on row tile
    ``tb``: :func:`packed_bytes`, less ``idx`` where the decode tiles
    (1, 2, 4, 8) run a packing whose groups keep every slot with idx =
    arange (``core.pack.dense_groups``: the codecs' lowerings) and so
    take their dense-group walk, which reads no idx. The 128-row tile's
    windowed walk reads idx for every packing. The stored bytes stay
    :func:`packed_bytes`."""
    from repro_torch.core.pack import dense_groups
    idx = d.idx.numel() * d.idx.element_size() if tb <= 8 and dense_groups(d) else 0
    return packed_bytes(d) - idx


def delta_spmm_work(T: int, d, tb: int = 8) -> tuple:
    """``x @ dequant(d)`` for T rows of f32 x on row tile ``tb`` (a
    decode tile unless given): read x and the packed delta
    (:func:`read_bytes`), write f32 y; two operations a kept entry and
    row."""
    return 2.0 * T * d.nnz, T * d.h_in * 4 + read_bytes(d, tb) + T * d.h_out * 4, "f32"


def segments_work(T: int, d, n_deltas: int) -> tuple:
    """The segments kernel on T rows over ``n_deltas`` distinct tenant
    deltas shaped like ``d`` (one matrix), on its decode tiles: each
    tenant's bytes (:func:`read_bytes`) read once."""
    return (2.0 * T * d.nnz,
            T * d.h_in * 4 + n_deltas * read_bytes(d) + T * d.h_out * 4, "f32")


def experts_work(d_expert, live: int, read: int, n_experts: int, cap: int) -> tuple:
    """The expert route on an [E, C, h_in] buffer with ``live`` live rows
    over ``read`` experts that hold any (``d_expert`` one expert's
    matrix): this run's data, not the most it could need. Every row of
    the [E, C, h_out] output is written."""
    return (2.0 * live * d_expert.nnz,
            live * d_expert.h_in * 4 + read * packed_bytes(d_expert)
            + n_experts * cap * d_expert.h_out * 4, "f32")


def fused_base_delta_work(T: int, d, w_itemsize: int) -> tuple:
    """``x @ (w + dequant(d))``: read x, W (``w_itemsize`` bytes an
    element) and the packed delta once, write f32 y; the dense product's
    operations on the TF32 tensor cores."""
    return (2.0 * T * d.h_in * d.h_out,
            T * d.h_in * 4 + (d.h_in * d.h_out * w_itemsize + packed_bytes(d))
            + T * d.h_out * 4, "tf32")


def dequant_work(d) -> tuple:
    """The dense f32 delta from its packed form: read the packed bytes,
    write h_in * h_out f32 values."""
    return 2.0 * d.nnz, packed_bytes(d) + d.h_in * d.h_out * 4, "f32"


def bound_ms(flops: float, nbytes: int, unit: str) -> tuple:
    """The least time (ms) the card could take for the work, and what
    sets it: ``bytes`` over the HBM rate or ``operations`` over the
    unit's peak, the larger (bytes on a tie)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAKS[unit] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
