"""End-to-end delta compression over a params tree (DeltaDQ only).

Port of ``repro/core/compress.py``::

    spec = DeltaDQSpec(alpha=8, k_bits=4, m=8, h_g=16)     # 128x
    deltas, report = compress(base_params, ft_params, spec, seed=0)

Selection rule: 2-D projection matrices (layer-stacked 3-D leaves) are
compressed; embeddings, unembeddings, norms and biases stay dense.

Each leaf's dropout keys come from a ``torch.Generator`` seeded with
``seed ^ crc32(path)`` — the stable path digest of ``compress.py:139``
(``hash()`` is randomized per process). A layer-stacked leaf is
compressed **one layer slice at a time**: quantization is per matrix,
so the result equals whole-leaf compression given the same keys, and a
full-width ``[32, 4096, 11008]`` leaf never needs its ~25 GB of f32 and
int64 temporaries at once.
"""
from __future__ import annotations

import math
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.codecs import DeltaDQCodec, DeltaDQSpec, codec_for_spec
from repro_torch.core.pack import PackedDelta
from repro_torch.utils import map_with_paths

_EXCLUDE_TOKENS = (
    "embed", "unembed", "norm", "ln1", "ln2", "ln", "scale", "bias",
    "conv", "a_param", "dt_bias", "a_log", "d_skip", "gate_attn",
    "gate_mlp", "router", "q_norm", "k_norm",
)


def is_compressible(path: str, leaf) -> bool:
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    low = path.lower()
    if any(t in low.split("/") or t in low for t in _EXCLUDE_TOKENS):
        return False
    h_in, h_out = leaf.shape[-2], leaf.shape[-1]
    return h_in >= 16 and h_out >= 8


@dataclass
class CompressionReport:
    spec: Any = None
    n_compressed: int = 0
    n_dense: int = 0
    dense_delta_bits: float = 0.0      # bits of the raw bf16 delta we compressed
    packed_value_bits: float = 0.0     # paper convention (values only)
    packed_total_bits: float = 0.0     # honest: + indices
    skipped_paths: list = field(default_factory=list)
    per_codec: dict = field(default_factory=dict)
    leaf_codecs: dict = field(default_factory=dict)   # path -> codec name
    wall_s: float = 0.0

    @property
    def ratio_paper(self) -> float:
        return self.dense_delta_bits / max(self.packed_value_bits, 1e-9)

    @property
    def ratio_honest(self) -> float:
        return self.dense_delta_bits / max(self.packed_total_bits, 1e-9)

    def add_leaf(self, path: str, codec: DeltaDQCodec, leaf: PackedDelta) -> None:
        """Account one compressed leaf via its codec's storage_bits."""
        bits = codec.storage_bits(leaf)
        stack = math.prod(leaf.stack_shape())
        dense = 16.0 * leaf.h_in * leaf.h_out * stack
        self.n_compressed += 1
        self.dense_delta_bits += dense
        self.packed_value_bits += bits["value_bits"]
        self.packed_total_bits += bits["total_bits"]
        pc = self.per_codec.setdefault(
            codec.name, {"n_leaves": 0, "dense_bits": 0.0,
                         "value_bits": 0.0, "total_bits": 0.0})
        pc["n_leaves"] += 1
        pc["dense_bits"] += dense
        pc["value_bits"] += bits["value_bits"]
        pc["total_bits"] += bits["total_bits"]
        self.leaf_codecs[path] = codec.name

    def skip(self, path: str) -> None:
        self.n_dense += 1
        self.skipped_paths.append(path)

    def summary(self) -> str:
        s = self.spec
        return (f"DeltaDQ(alpha={s.alpha}, h_g={s.h_g}, k={s.k_bits}, "
                f"m={s.m}): {self.n_compressed} tensors packed, "
                f"{self.n_dense} left dense; ratio "
                f"paper-convention={self.ratio_paper:.1f}x "
                f"honest(+indices)={self.ratio_honest:.1f}x "
                f"(spec target {s.ratio():.0f}x)")


def leaf_generator(seed: int, path: str, device) -> torch.Generator:
    """The per-leaf dropout-key generator: ``seed ^ crc32(path)``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed ^ (zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF))
    return g


def _stack_slices(parts: list, lead: tuple) -> PackedDelta:
    """Re-stack per-matrix PackedDeltas into one leaf with ``lead`` dims."""
    p0 = parts[0]

    def st(ts):
        t = torch.stack(ts)
        return t.reshape(*lead, *t.shape[1:])

    return p0.with_arrays(st([p.idx for p in parts]),
                          st([p.codes for p in parts]),
                          st([p.scale for p in parts]),
                          st([p.zero for p in parts]))


def compress_leaf_layerwise(codec: DeltaDQCodec, spec: DeltaDQSpec,
                            base_leaf: torch.Tensor,
                            ft_slice: Callable[[int], torch.Tensor],
                            generator: Optional[torch.Generator] = None,
                            u_slice: Optional[Callable[[int], torch.Tensor]] = None
                            ) -> PackedDelta:
    """Compress a (possibly layer-stacked) leaf one matrix at a time.

    ``ft_slice(i)`` returns the fine-tuned matrix of flat stack index i
    (so a caller can synthesize it on the fly); ``u_slice(i)`` optionally
    supplies that matrix's dropout keys, else they are drawn from
    ``generator`` in stack order.
    """
    lead = tuple(base_leaf.shape[:-2])
    flat = base_leaf.reshape(-1, *base_leaf.shape[-2:])
    parts = []
    for i in range(flat.shape[0]):
        parts.append(codec.compress_leaf(
            flat[i], ft_slice(i), spec, generator=generator,
            u=u_slice(i) if u_slice is not None else None))
    if not lead:
        return parts[0]
    return _stack_slices(parts, lead)


def compress(base_params: Any, ft_params: Any, spec: Optional[DeltaDQSpec] = None,
             seed: Optional[int] = None) -> tuple[Any, CompressionReport]:
    """Compress every eligible delta leaf; returns (deltas tree, report).
    ``seed`` defaults to ``spec.seed``."""
    t0 = time.perf_counter()
    spec = spec if spec is not None else DeltaDQSpec()
    codec = codec_for_spec(spec)
    seed = spec.seed if seed is None else seed
    report = CompressionReport(spec=spec)

    def fn(path: str, b, f):
        if not is_compressible(path, b):
            report.skip(path)
            return None
        f_flat = f.reshape(-1, *f.shape[-2:])
        d = compress_leaf_layerwise(codec, spec, b, lambda i: f_flat[i],
                                    generator=leaf_generator(seed, path, b.device))
        report.add_leaf(path, codec, d)
        return d

    deltas = map_with_paths(fn, base_params, ft_params)
    report.wall_s = time.perf_counter() - t0
    return deltas, report


def decompress(base_params: Any, deltas: Any) -> Any:
    """Reconstruct approximate fine-tuned params (reference/eval path)."""
    from repro_torch.core.apply import merge_delta
    return merge_delta(base_params, deltas)
