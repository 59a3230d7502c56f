"""Training step: loss -> grads -> AdamW, with gradient accumulation; port
of ``repro/train/train_step.py``.

``make_train_step(cfg, opt_cfg, n_micro)`` returns
    step(params, opt_state, batch, rng) -> (params, opt_state, metrics)

run eagerly: the grads are ``torch.autograd.grad`` of ``lm.loss_fn``
with respect to detached copies of the params, so the params that come
back are plain tensors (no ``requires_grad``, no graph), and the
optimizer state is updated in place (``optim/adamw.py``).

The reference's quirks are kept. Grads come in the param dtype (bf16 for
the stacks). With ``n_micro > 1`` the global batch [B, S] is split into
``n_micro`` chunks whose f32 grads are summed in order and divided by
``n_micro``, and ``metrics["loss"]`` is the **last** chunk's loss (the
scan's carry keeps the last ``l``). ``rng`` is unused: the data pipeline
is deterministic. With ``n_micro == 1`` and no ``grad_transform`` the
param-dtype grads go to ``adamw.update``, which casts each leaf to f32
as it reaches it: the same numbers as the reference's cast of the whole
tree, without holding an f32 copy of every grad.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.arch import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.utils import iter_leaves, map_with_paths, tree_map


def make_loss(cfg: ArchConfig, remat: bool = True):
    def loss(params, batch):
        return lm.loss_fn(cfg, params, batch, remat=remat)
    return loss


def _device(params) -> torch.device:
    return next(t for _, t in iter_leaves(params)).device


def batch_to_device(batch: dict, device) -> dict:
    """numpy arrays or tensors -> tensors on ``device``; integer arrays
    become int64 (token ids index the embedding)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=t.dtype if t.is_floating_point() else torch.int64)
    return out


def _split_micro(batch: dict, n_micro: int) -> list:
    for x in batch.values():
        if x.shape[0] % n_micro:
            raise ValueError(
                f"batch size {x.shape[0]} must be a multiple of n_micro={n_micro}")
    return [{k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n_micro)]


def value_and_grad(loss_fn: Callable, params, batch: dict):
    """((loss, metrics), grads): grads mirror ``params`` in the param dtype
    (zeros at a leaf the loss does not reach, as ``jax.grad`` gives)."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, xs = zip(*iter_leaves(ps))
    with torch.enable_grad():
        loss, metrics = loss_fn(ps, batch)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    flat = {path: torch.zeros_like(x) if g is None else g
            for path, x, g in zip(paths, xs, gs)}
    grads = map_with_paths(lambda path, _p: flat[path], params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    remat: bool = True,
                    grad_transform: Optional[Callable] = None):
    """grad_transform: optional fn(grads) -> grads applied to the f32 grads
    before the optimizer (the reference's hook for its compressed
    all-reduce; the port has no mesh yet)."""
    loss_fn = make_loss(cfg, remat=remat)

    def step(params, opt_state, batch, rng=None):
        del rng  # data pipeline is deterministic; kept for API stability
        batch = batch_to_device(batch, _device(params))
        if n_micro == 1:
            (l, _), grads = value_and_grad(loss_fn, params, batch)
            if grad_transform is not None:
                grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for mb in _split_micro(batch, n_micro):
                (l, _), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(torch.float32), grads, g)
                del g
            grads = tree_map(lambda g: g / n_micro, grads)

        if grad_transform is not None:
            grads = grad_transform(grads)

        params, opt_state, opt_metrics = adamw.update(opt_cfg, params, grads, opt_state)
        metrics = {"loss": l, **opt_metrics}
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ArchConfig):
    def step(params, batch, deltas=None):
        with torch.no_grad():
            _, metrics = lm.loss_fn(cfg, params, batch_to_device(batch, _device(params)),
                                    deltas=deltas)
        return metrics
    return step
