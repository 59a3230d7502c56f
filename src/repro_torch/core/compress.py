"""End-to-end delta compression over a params tree, any codec.

Port of ``repro/core/compress.py``::

    spec = DeltaDQSpec(alpha=8, k_bits=4, m=8, h_g=16)     # 128x
    deltas, report = compress(base_params, ft_params, spec, seed=0)

    # pick a codec by name (default spec), or per leaf under a budget:
    deltas, report = compress(base, ft, codec="bitdelta")
    deltas, report = compress(base, ft, codec="auto", budget_bits=1.5)

``compress`` routes each leaf through the codec owning the given spec.
``codec="auto"`` compresses each leaf with every registered codec's
candidate spec and keeps the one that meets ``budget_bits`` (total
stored bits per weight element, indices included) at the lowest relative
reconstruction error — recorded per leaf in the report.

Selection rule: 2-D projection matrices (layer-stacked 3-D leaves) are
compressed; embeddings, unembeddings, norms and biases stay dense.

Each leaf's dropout keys come from a ``torch.Generator`` seeded with
``seed ^ crc32(path)`` — the stable path digest of ``compress.py:139``
(``hash()`` is randomized per process). A layer-stacked leaf is
compressed **one layer slice at a time**, on the base's device:
quantization and the per-tensor scales are per matrix, so the result
equals whole-leaf compression given the same keys, and a full-width
``[32, 4096, 11008]`` leaf never needs its ~25 GB of f32 and int64
temporaries at once.
"""
from __future__ import annotations

import math
import time
import zlib
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import torch

from repro_torch.core.codecs import (
    DeltaCodec,
    DeltaDQSpec,
    codec_for_spec,
    codec_names,
    get_codec,
)
from repro_torch.utils import map_with_paths, materialize

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
    spec: Any = None                   # None for codec="auto"
    n_compressed: int = 0
    n_dense: int = 0
    dense_delta_bits: float = 0.0      # bits of the raw bf16 delta we compressed
    packed_value_bits: float = 0.0     # paper convention (values only)
    packed_total_bits: float = 0.0     # honest: + indices/factors/metadata
    skipped_paths: list = field(default_factory=list)
    # per-codec breakdown: name -> {n_leaves, dense_bits, value_bits, total_bits}
    per_codec: dict = field(default_factory=dict)
    leaf_codecs: dict = field(default_factory=dict)   # path -> codec name
    # auto-picker records: path -> {codec, bits_per_element, rel_error, budget_met}
    auto_choices: dict = field(default_factory=dict)
    budget_bits: Optional[float] = None
    wall_s: float = 0.0

    @property
    def ratio_paper(self) -> float:
        return self.dense_delta_bits / max(self.packed_value_bits, 1e-9)

    @property
    def ratio_honest(self) -> float:
        return self.dense_delta_bits / max(self.packed_total_bits, 1e-9)

    @property
    def budget_met(self) -> bool:
        """True iff every auto-picked leaf met the requested budget."""
        return all(c["budget_met"] for c in self.auto_choices.values())

    def add_leaf(self, path: str, codec: DeltaCodec, leaf) -> None:
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

    def account(self, path: str, result: tuple) -> None:
        """Account a :func:`compress_leaf_any` result."""
        leaf, codec, choice = result
        self.add_leaf(path, codec, leaf)
        if choice is not None:
            self.auto_choices[path] = choice

    def summary(self) -> str:
        if isinstance(self.spec, DeltaDQSpec):
            head = (f"DeltaDQ(alpha={self.spec.alpha}, h_g={self.spec.h_g}, "
                    f"k={self.spec.k_bits}, m={self.spec.m})")
        elif self.spec is not None:
            head = repr(self.spec)      # dataclass repr: Name(field=...)
        else:
            head = (f"auto(budget={self.budget_bits} bits/elt, "
                    f"met={self.budget_met})")
        s = (f"{head}: "
             f"{self.n_compressed} tensors packed, {self.n_dense} left dense; "
             f"ratio paper-convention={self.ratio_paper:.1f}x "
             f"honest(+indices)={self.ratio_honest:.1f}x")
        if self.spec is not None and hasattr(self.spec, "ratio"):
            s += f" (spec target {self.spec.ratio():.0f}x)"
        if len(self.per_codec) > 1 or self.spec is None:
            for name, pc in self.per_codec.items():
                r = pc["dense_bits"] / max(pc["total_bits"], 1e-9)
                s += (f"\n  {name}: {pc['n_leaves']} leaves, "
                      f"honest {r:.1f}x")
        return s


def leaf_generator(seed: int, path: str, device) -> torch.Generator:
    """The per-leaf dropout-key generator: ``seed ^ crc32(path)``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed ^ (zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF))
    return g


def _stack_slices(parts: list, lead: tuple) -> Any:
    """Re-stack per-matrix codec leaves into one leaf with ``lead`` dims
    (every tensor field gains them; static meta comes from the first)."""
    p0 = parts[0]

    def st(name):
        t = torch.stack([getattr(p, name) for p in parts])
        return t.reshape(*lead, *t.shape[1:])

    names = [f for f in p0.__dataclass_fields__
             if isinstance(getattr(p0, f), torch.Tensor)]
    return replace(p0, **{f: st(f) for f in names})


def compress_leaf_layerwise(codec: DeltaCodec, spec: Any,
                            base_leaf: torch.Tensor,
                            ft_slice: Callable[[int], torch.Tensor],
                            generator: Optional[torch.Generator] = None,
                            u_slice: Optional[Callable[[int], torch.Tensor]] = None
                            ) -> Any:
    """Compress a (possibly layer-stacked) leaf one matrix at a time.

    ``ft_slice(i)`` returns the fine-tuned matrix of flat stack index i
    (so a caller can synthesize it on the fly); ``u_slice(i)`` optionally
    supplies that matrix's DeltaDQ dropout keys, else they are drawn from
    ``generator`` in stack order.
    """
    lead = tuple(base_leaf.shape[:-2])
    flat = base_leaf.reshape(-1, *base_leaf.shape[-2:])
    parts = []
    for i in range(flat.shape[0]):
        kw = {"generator": generator}
        if u_slice is not None:
            kw["u"] = u_slice(i)
        parts.append(codec.compress_leaf(flat[i], ft_slice(i), spec, **kw))
    if not lead:
        return parts[0]
    return _stack_slices(parts, lead)


def _resolve(spec, codec: Optional[str]) -> tuple[Any, DeltaCodec]:
    if codec is not None:
        c = get_codec(codec)
        if spec is None:
            spec = c.default_spec()
        elif not isinstance(spec, c.spec_cls):
            raise ValueError(
                f"spec {type(spec).__name__} does not belong to codec "
                f"{codec!r} (expects {c.spec_cls.__name__})")
        return spec, c
    if spec is None:
        spec = DeltaDQSpec()
    return spec, codec_for_spec(spec)


def auto_candidates(spec: Any = None) -> list[tuple[DeltaCodec, Any]]:
    """The (codec, spec) candidates the auto-picker evaluates: every
    registered codec at its default spec, except that an explicit ``spec``
    replaces its own codec's default."""
    out = []
    for name in codec_names():
        c = get_codec(name)
        sp = spec if (spec is not None and isinstance(spec, c.spec_cls)) \
            else c.default_spec()
        out.append((c, sp))
    return out


def compress_leaf_any(path: str, base_leaf: torch.Tensor,
                      ft_slice: Callable[[int], torch.Tensor], *, spec: Any = None,
                      codec: Optional[DeltaCodec] = None, seed: int = 0,
                      candidates: Optional[list] = None,
                      budget_bits: Optional[float] = None) -> tuple:
    """Compress one eligible leaf with ``codec``/``spec``, or, with
    ``candidates``, by the auto-picker's rule: among candidates whose
    honest bits/element fit ``budget_bits``, the lowest relative Frobenius
    reconstruction error (ties -> fewer bits); if none fit, the smallest
    candidate, marked ``budget_met=False``. ``ft_slice`` may be called
    once per candidate. Returns ``(leaf, codec, auto-choice record or
    None)`` for :meth:`CompressionReport.account`."""
    dev = base_leaf.device
    if candidates is None:
        d = compress_leaf_layerwise(codec, spec, base_leaf, ft_slice,
                                    generator=leaf_generator(seed, path, dev))
        return d, codec, None
    flat = base_leaf.reshape(-1, *base_leaf.shape[-2:])
    delta = torch.stack([ft_slice(i).to(torch.float32) - flat[i].to(torch.float32)
                         for i in range(flat.shape[0])]).reshape(base_leaf.shape)
    dnorm = float(torch.linalg.vector_norm(delta))

    def score(c, sp):
        d = compress_leaf_layerwise(c, sp, base_leaf, ft_slice,
                                    generator=leaf_generator(seed, path, dev))
        bpe = c.storage_bits(d)["total_bits"] / delta.numel()
        err = float(torch.linalg.vector_norm(c.reconstruct_dense(d) - delta)) \
            / max(dnorm, 1e-12)
        return c, d, bpe, err

    # a candidate whose size the shapes fix above the budget can win only
    # if no candidate fits, so it is compressed only then (LowRank's host
    # SVD is the costly part); the picks are the rule's either way
    planned = [c.planned_total_bits(tuple(base_leaf.shape), sp) for c, sp in candidates]
    over = [p is not None and p / delta.numel() > budget_bits for p in planned]
    scored = {i: score(*cs) for i, cs in enumerate(candidates) if not over[i]}
    if not any(s[2] <= budget_bits for s in scored.values()):
        scored.update({i: score(*cs) for i, cs in enumerate(candidates) if over[i]})
    scored = [scored[i] for i in sorted(scored)]
    del delta
    feasible = [s for s in scored if s[2] <= budget_bits]
    if feasible:
        c, d, bpe, err = min(feasible, key=lambda s: (s[3], s[2]))
    else:
        c, d, bpe, err = min(scored, key=lambda s: (s[2], s[3]))
    return d, c, {"codec": c.name, "bits_per_element": bpe, "rel_error": err,
                  "budget_met": bool(bpe <= budget_bits)}


def compress(base_params: Any, ft_params: Any, spec: Any = None,
             seed: Optional[int] = None, *, codec: Optional[str] = None,
             budget_bits: Optional[float] = None,
             progress: Optional[Callable[[str, Optional[str]], None]] = None,
             ) -> tuple[Any, CompressionReport]:
    """Compress every eligible delta leaf; returns (deltas tree, report).

    ``spec`` picks the codec by its class (default: ``DeltaDQSpec()``,
    dropout-only). ``codec`` selects by name with the codec's default
    spec; ``codec="auto"`` runs the per-leaf auto-picker and requires
    ``budget_bits`` (stored bits per weight element, indices included).
    ``seed`` defaults to the spec's. ``progress(path, codec_name_or_None)``
    is called once per leaf as it resolves (None = left dense).
    """
    t0 = time.perf_counter()
    candidates = None
    if codec == "auto":
        if budget_bits is None:
            raise ValueError("codec='auto' requires budget_bits")
        candidates = auto_candidates(spec)
        c = None
        report = CompressionReport(spec=None, budget_bits=budget_bits)
        if seed is None:
            seed = getattr(spec, "seed", 0) if spec is not None else 0
    else:
        if budget_bits is not None:
            raise ValueError("budget_bits only applies to codec='auto'")
        spec, c = _resolve(spec, codec)
        report = CompressionReport(spec=spec)
        if seed is None:
            seed = getattr(spec, "seed", 0)

    def fn(path: str, b, f):
        if not is_compressible(path, b):
            report.skip(path)
            if progress is not None:
                progress(path, None)
            return None
        f_flat = f.reshape(-1, *f.shape[-2:])
        res = compress_leaf_any(path, b, lambda i: f_flat[i], spec=spec, codec=c,
                                seed=seed, candidates=candidates,
                                budget_bits=budget_bits)
        report.account(path, res)
        if progress is not None:
            progress(path, res[1].name)
        return res[0]

    deltas = map_with_paths(fn, base_params, ft_params)
    report.wall_s = time.perf_counter() - t0
    return deltas, report


def decompress(base_params: Any, deltas: Any) -> Any:
    """Reconstruct approximate fine-tuned params (reference/eval path)."""
    from repro_torch.core.apply import merge_delta
    return merge_delta(base_params, deltas)


# ---------------------------------------------------------------------------
# Shape-only twin for the dry run (no compression computed)
# ---------------------------------------------------------------------------
def delta_specs(param_specs: Any, spec: Any) -> Any:
    """``(shape, dtype)`` deltas tree mirroring a params tree of tensors
    or ``(shape, dtype)`` specs, for any registered codec's spec: each
    compressible leaf's ``codec.leaf_spec``, None elsewhere, as
    :func:`compress` leaves it. Its sharding twin is :func:`delta_axes`."""
    c = codec_for_spec(spec)

    def fn(path: str, leaf):
        if not is_compressible(path, materialize(leaf)):
            return None
        return c.leaf_spec(leaf, spec)

    return map_with_paths(fn, param_specs)


def delta_axes(param_specs: Any, param_axes: Any, spec: Any,
               model_axis_size: int) -> Any:
    """Logical-axes tree matching :func:`delta_specs`' structure
    (``repro/core/compress.py:305``): each compressible leaf's
    ``codec.leaf_axes`` from the base weight's axes, None elsewhere.

    For DeltaDQ, idx/codes ``[lead..., G, K, O]``: O inherits the base
    weight's output axis; the G (group) axis inherits the input axis only
    when group boundaries align with the shard boundaries (G divisible by
    the mesh axis) — else it replicates, which is cheap because deltas
    are tiny (the paper's point). scale/zero inherit the lead axes."""
    c = codec_for_spec(spec)

    def fn(path: str, leaf, ax):
        if not is_compressible(path, materialize(leaf)):
            return None
        return c.leaf_axes(leaf, ax, spec, model_axis_size)

    return map_with_paths(fn, param_specs, param_axes)
