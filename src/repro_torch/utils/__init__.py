"""Path utilities for the port's dict-of-tensor trees.

Params and deltas are nested dicts addressed by "/"-joined path strings
(``"attn/wq"``), the same strings ``repro.utils.path_str`` builds for
the JAX package's pytrees — the per-leaf compression seed digests them.
Leaves that are not dicts (tensors, ``PackedDelta``, ``None``) are
terminal.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator

import torch


def iter_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield (path, leaf) in dict insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def flatten_with_paths(tree: Any) -> dict[str, Any]:
    """Flatten a dict tree into {path: leaf} (``repro/utils/pytree.py:39``;
    insertion order, where the reference sorts dict keys)."""
    return dict(iter_leaves(tree))


def map_with_paths(fn: Callable[..., Any], tree: Any, *rest: Any,
                   prefix: str = "") -> Any:
    """Map ``fn(path, leaf, *rest_leaves)`` over a dict tree."""
    if isinstance(tree, dict):
        return {k: map_with_paths(
                    fn, v, *[r[k] if r is not None else None for r in rest],
                    prefix=f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn(leaf, *rest_leaves)`` over a dict tree."""
    return map_with_paths(lambda _p, x, *r: fn(x, *r), tree, *rest)


def tensor_bytes(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (PackedDelta leaves count their
    arrays)."""
    total = 0
    for _, leaf in iter_leaves(tree):
        if hasattr(leaf, "nbytes") and not isinstance(leaf, torch.Tensor):
            total += leaf.nbytes()
        else:
            total += tensor_bytes(leaf)
    return total


def tree_params(tree: Any) -> int:
    """Total element count of all tensor leaves (``(shape, dtype)`` spec
    leaves count their shape)."""
    total = 0
    for _, leaf in iter_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel()
        elif isinstance(leaf, tuple) and leaf and isinstance(leaf[0], (tuple, torch.Size)):
            total += math.prod(leaf[0])
    return total


def resolve_device(device: Any) -> torch.device:
    """The port's device rule: an explicit device wins, else ``cuda``."""
    return torch.device(device if device is not None else "cuda")
