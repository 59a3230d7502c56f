"""AdamW with decoupled weight decay, global-norm clipping and f32 master
params; port of ``repro/optim/adamw.py``.

State layout (a dict tree mirroring params):
    {"m": .., "v": .., "master": f32 params, "step": int32 scalar}

``update`` consumes grads in the param dtype, runs the moments in f32,
applies the schedule, and casts back. It works leaf by leaf and writes
``m``, ``v``, ``master`` and ``step`` of the state **in place** (the
reference returns a new tree; at full width a second copy of the f32
state would double its 15 GB), so at most one leaf's f32 temporaries
are live beside the state. The arithmetic is the reference's, operation
for operation; the new params are fresh tensors, ``master`` cast to
each param's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.utils import iter_leaves, map_with_paths, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable] = None   # step -> multiplier


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: Any) -> dict:
    device = next(t for _, t in iter_leaves(params)).device
    return {
        "m": tree_map(_f32_zeros, params),
        "v": tree_map(_f32_zeros, params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_specs(param_specs: Any) -> dict:
    """The state's ``(shape, dtype)`` tree for a tree of ``(shape, dtype)``
    param specs (``lm.param_shapes`` nested), without allocating."""
    f32 = lambda s: (tuple(s[0]), torch.float32)
    return {"m": tree_map(f32, param_specs), "v": tree_map(f32, param_specs),
            "master": tree_map(f32, param_specs), "step": ((), torch.int32)}


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32))) for _, g in iter_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _decay_mask(path: str) -> float:
    """No weight decay on norms / biases / 1-D params (by convention)."""
    toks = path.lower()
    if any(t in toks for t in ("norm", "ln", "bias", "scale", "a_param", "gate")):
        return 0.0
    return 1.0


@torch.no_grad()
def update(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
           gnorm: Optional[torch.Tensor] = None):
    """Returns (new_params, state, metrics); ``state`` is updated in place.
    ``gnorm``: the whole gradient tree's norm, where ``grads`` are one
    rank's ZeRO-1 slices of it (the training mesh); each new param is
    then that slice of the master, cast, and only ``dtype`` of
    ``params`` is read."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    mult = cfg.schedule(step) if cfg.schedule is not None else 1.0
    lr = cfg.lr * mult
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(path, p, g, m, v, master):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * _decay_mask(path) * master
        master.copy_(master - lr * delta)
        return master.to(p.dtype, copy=True)

    new_params = map_with_paths(upd, params, grads, state["m"], state["v"], state["master"])
    state["step"] = step
    return new_params, state, {"grad_norm": gnorm,
                               "lr": torch.as_tensor(lr, dtype=torch.float32)}
