"""Logical-axis sharding rules: one table from model axes to mesh axes
(port of ``repro/dist/sharding.py``).

Every parameter, cache and packed-delta leaf is annotated with *logical*
axis names (``lm.param_axes``, :func:`batch_axes`, :func:`cache_axes`,
``core.compress.delta_axes``). This module owns the one mapping from
those names to mesh axes:

* base weights are tensor-parallel along the matmul output or
  contraction axes per layer type (attention heads, MLP, MoE experts,
  SSM inner width, RG-LRU width all map to ``model``);
* ``batch`` maps to ``(pod, data)``, whichever of those the mesh has;
* everything else (norms, layer stacks, scalar quant params) replicates.

A placement is a plain tuple with one entry per dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names — the twin of the
reference's ``PartitionSpec`` (``tuple(P(...))`` gives the same tuple).
The rules take an **abstract mesh** (:class:`AbstractMesh`: axis names
and sizes, no process group), so the layouts of the dry run's (16, 16)
and (2, 16, 16) production meshes build without any rank;
``launch/mesh.py`` pairs them with the process groups of a live one.

Divisibility is checked per leaf: an axis whose size the mesh axis does
not divide falls back to replicated, and the fallback is *recorded* in
``ShardingRules.fallbacks``.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.utils import map_with_paths

# Default (serving) profile: pure tensor parallelism over `model`; the
# embedding/residual dim stays replicated.
DEFAULT_RULES: dict[Optional[str], tuple] = {
    "batch": ("pod", "data"),
    "seq": (),
    "vocab": ("model",),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_ff": ("model",),
    "inner": ("model",),
    "lru": ("model",),
    "layers": (),
}

# Training: FSDP — additionally shard the embedding/residual dim of every
# weight over the data axis.
TRAIN_OVERRIDES = dict(embed=("data",))

# Serving keeps the default pure-TP layout (explicit so launchers can say
# which profile they mean).
SERVE_OVERRIDES: dict[str, tuple] = {}

# 500k-token decode: batch=1, the KV ring is the footprint — spread the
# sequence axis of the cache over the (otherwise idle) data axis.
LONG_CONTEXT_OVERRIDES = dict(seq=("data",), batch=())


class AbstractMesh:
    """Mesh axis names and sizes, in order, with no devices or process
    groups: ``AbstractMesh((16, 16), ("data", "model"))``. ``shape`` is
    the ``{name: size}`` dict the rules read (``jax``'s ``mesh.shape``)."""

    def __init__(self, sizes: tuple, names: tuple):
        if len(sizes) != len(names):
            raise ValueError(f"mesh sizes {sizes} and names {names} differ in rank")
        self.axis_names = tuple(names)
        self.sizes = tuple(int(s) for s in sizes)
        self.shape = dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class ShardingRules:
    """Maps logical axis tuples to placements, with fallbacks.

    ``rules`` maps logical axis name -> candidate mesh axes, tried in
    order; a candidate is used when the mesh has it, the placement has
    not used it yet, and it divides the dimension. Several candidates can
    stack on one dimension (``batch`` over ``(pod, data)``).
    """

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
        self.fallbacks: list[tuple] = []   # (leaf path, logical axes, shape)

    def with_overrides(self, **overrides) -> "ShardingRules":
        return ShardingRules(self.mesh, {**self.rules, **overrides})

    def spec_for(self, axes: tuple, shape: tuple, path: str = "?") -> tuple:
        """Placement of one leaf; records a fallback when a mapped logical
        axis exists but no mesh axis fits (divisibility or reuse)."""
        if len(axes) != len(shape):
            raise ValueError(
                f"leaf {path!r}: logical axes {axes} (rank {len(axes)}) do "
                f"not match shape {shape} (rank {len(shape)})")
        used: set = set()
        entries = []
        fell_back = False
        for name, dim in zip(axes, shape):
            cands = self.rules.get(name, ()) if name is not None else ()
            avail = [a for a in cands if a in self.mesh.shape and a not in used]
            picked: list = []
            span = 1
            for a in avail:
                sz = self.mesh.shape[a]
                if dim % (span * sz) == 0:
                    picked.append(a)
                    span *= sz
            if avail and not picked:
                fell_back = True
            used.update(picked)
            if not picked:
                entries.append(None)
            elif len(picked) == 1:
                entries.append(picked[0])
            else:
                entries.append(tuple(picked))
        if fell_back:
            self.fallbacks.append((path, tuple(axes), tuple(shape)))
        return tuple(entries)


def _shape(leaf) -> tuple:
    """A tensor's shape, or a ``(shape, dtype)`` spec's."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def tree_shardings(rules: ShardingRules, specs: Any, axes: Any) -> Any:
    """Placement tree for a (specs, logical-axes) tree pair.

    ``specs`` leaves are tensors or ``(shape, dtype)`` specs; ``axes``
    mirrors the structure with a tuple of logical names (len == ndim) at
    each leaf position. ``None`` leaves map to None."""
    def fn(path, leaf, ax):
        if leaf is None:
            return None
        return rules.spec_for(tuple(ax), _shape(leaf), path)
    return map_with_paths(fn, specs, axes)


def zero1_shardings(rules: ShardingRules, specs: Any, axes: Any,
                    zero_axes: tuple = ("data",)) -> Any:
    """Optimizer-state placements: base layout + ZeRO-1 partitioning.

    Each leaf starts from the parameter's own placement; every
    ``zero_axes`` mesh axis not already used is then added on the first
    still-replicated, divisible dimension."""
    def fn(path, leaf, ax):
        shape = _shape(leaf)
        spec = list(rules.spec_for(tuple(ax), shape, path))
        spec += [None] * (len(shape) - len(spec))
        used = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        for z in zero_axes:
            if z not in rules.mesh.shape or z in used:
                continue
            sz = rules.mesh.shape[z]
            for i, (e, dim) in enumerate(zip(spec, shape)):
                if e is None and dim % sz == 0:
                    spec[i] = z
                    used.add(z)
                    break
        return tuple(spec)
    return map_with_paths(fn, specs, axes)


# ---------------------------------------------------------------------------
# Logical axes for non-parameter trees
# ---------------------------------------------------------------------------
_BATCH_AXES_BY_NAME = {
    "tokens": ("batch", "seq"),
    "positions": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "enc_feats": ("batch", "seq", "embed"),
    "image_embeds": ("batch", "seq", "embed"),
}


def batch_axes(batch_specs: dict) -> dict:
    """Logical axes for a model-input batch dict."""
    out = {}
    for k, v in batch_specs.items():
        ax = _BATCH_AXES_BY_NAME.get(k)
        if ax is None or len(ax) != len(_shape(v)):
            ax = ("batch",) + (None,) * (len(_shape(v)) - 1)
        out[k] = ax
    return out


_CACHE_AXES_BY_NAME = {
    # attention KV ring + per-row slot positions
    "k": ("batch", "seq", "kv_heads", None),
    "v": ("batch", "seq", "kv_heads", None),
    "pos": ("batch", "seq"),
    # ssm state (conv tails + expanded state)
    "conv_x": ("batch", None, "inner"),
    "conv_bc": ("batch", None, None),
    "state": ("batch", None, None, None),
    # rg-lru state
    "conv": ("batch", None, "lru"),
    "h": ("batch", "lru"),
}


def cache_axes(cache: Any) -> Any:
    """Logical-axes tree matching the ``lm.init_cache`` structure (a list
    of ring dicts and SsmState/RecState tuples).

    Every cache leaf leads with the batch (slot) dim; KV rings shard along
    kv-heads, ssm/rglru states along their inner width. NamedTuple states
    are rebuilt as NamedTuples of axis tuples so the result pairs with the
    cache leaf for leaf."""
    def leaf_axes(name: str, leaf) -> tuple:
        ax = _CACHE_AXES_BY_NAME.get(name)
        nd = len(_shape(leaf))
        if ax is None or len(ax) != nd:
            ax = ("batch",) + (None,) * (nd - 1)
        return ax

    def rec(node, name=""):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if hasattr(node, "_fields"):          # NamedTuple state
            return type(node)(**{f: rec(getattr(node, f), f)
                                 for f in node._fields})
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, name) for v in node)
        return leaf_axes(name, node)

    return rec(cache)


def map_cache(fn, cache: Any, *rest: Any) -> Any:
    """``fn(name, leaf, *rest_leaves)`` over a cache-structured tree (list
    of dicts and NamedTuples), keeping the structure."""
    if isinstance(cache, dict):
        return {k: _map_leaf(fn, k, v, *[r[k] for r in rest]) for k, v in cache.items()}
    if hasattr(cache, "_fields"):
        return type(cache)(**{f: _map_leaf(fn, f, getattr(cache, f),
                                           *[getattr(r, f) for r in rest])
                              for f in cache._fields})
    if isinstance(cache, list):
        return [map_cache(fn, c, *[r[i] for r in rest]) for i, c in enumerate(cache)]
    raise TypeError(f"not a cache tree node: {type(cache).__name__}")


def _map_leaf(fn, name, leaf, *rest):
    if isinstance(leaf, (dict, list)) or hasattr(leaf, "_fields"):
        return map_cache(fn, leaf, *rest)
    return fn(name, leaf, *rest)
