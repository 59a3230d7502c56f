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

``make_train_step(..., mesh=)`` is the training mesh (the reference's
GSPMD step over ``(data, model)``, ``repro/launch/train.py:237-283``,
made explicit over ``torch.distributed``). A rank stores its slice of
every param in the ``train`` layout and of AdamW's m, v and master in
that layout plus ZeRO-1 over ``data`` (``launch.mesh.train_shardings``,
:func:`shard_state`); ``step`` is replicated. It computes in the
single-device order:

* each block's weights are all-gathered whole where the block uses them,
  inside its remat checkpoint (``lm.loss_fn(gather=)``), so backward
  gathers again instead of holding every block; the other leaves
  (embedding, final norm) are gathered once a forward;
* rows are split over ``data`` only (rank ``d`` takes rows
  ``[d*B/D, (d+1)*B/D)`` of each microbatch, the microbatches cut from
  the global batch first); every ``model`` rank runs the same rows, so
  nothing is summed over ``model``;
* each data rank's loss is ``sum(nll_local) / global_tokens`` (the token
  count all-reduced first), so ``metrics["loss"]``, their sum, is the
  global batch's and the grads are the global mean's;
* a bf16 stacked weight is gathered as f32 (its values exactly; an f32
  activation promotes it to f32 in every product anyway, the reference's
  dtype rule), so the gather's backward receives this rank's f32
  gradient of the block, not one rounded to bf16 from a part of the
  batch. It sums the block's gradients over ``data`` (one all-reduce;
  gloo has no reduce-scatter in every build), rounds each to the param
  dtype (one rounding of the whole batch's gradient, where the single
  device rounds it: per microbatch, as there) and keeps only this rank's
  ZeRO-1 slice: no rank holds more of the grads than its slice and one
  block's whole gradients. The encoder-decoder's ``enc`` and
  ``dec_cross`` stacks multiply bf16 activations in bf16, so they are
  gathered in their own dtype;
* ``grad_transform`` rounds each slice on its whole leaf's int8 grid
  (the leaf's max from a MAX all-reduce of the slices'), and the global
  norm is a SUM all-reduce of the slices' squares, each slice counted
  once: the single device's clip;
* each rank updates its ZeRO-1 slice of master/m/v from its slice of
  the grads, casts it to the param dtype and gathers it over the zero
  axis into its param slice.

Without a mesh, or on a mesh of one rank, the step is the one above.
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
                    grad_transform: Optional[Callable] = None, mesh=None):
    """grad_transform: optional fn(grads, amax=None) -> grads applied to the
    f32 grads before the optimizer (``dist.make_compressed_allreduce``; on
    a mesh the step passes each leaf's whole max by path). ``mesh``: a
    ``launch.mesh.ServingMesh`` with process groups; the step then takes
    and returns this rank's slices (:func:`shard_state`)."""
    if mesh is not None and mesh.size > 1:
        return _make_mesh_step(cfg, opt_cfg, n_micro, remat, grad_transform, mesh)
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


# ---------------------------------------------------------------------------
# The training mesh
# ---------------------------------------------------------------------------
def shard_state(cfg: ArchConfig, params, mesh) -> tuple:
    """(params, opt): this rank's slices on ``mesh`` of whole ``params``
    in the ``train`` layout, and of ``adamw.init``'s state in ZeRO-1
    (zero moments, the params in f32 as master, step 0)."""
    from repro_torch.launch.mesh import local_slice, train_shardings
    sh = train_shardings(cfg, mesh)
    local = map_with_paths(lambda _path, t, pl: local_slice(t, pl, mesh), params,
                           sh["params"])
    z = sh["opt"]["master"]
    master = map_with_paths(
        lambda _path, p, zl: local_slice(p.detach().to(torch.float32, copy=True), zl, mesh),
        params, z)
    zeros = lambda m: torch.zeros_like(m)
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return local, {"m": tree_map(zeros, master), "v": tree_map(zeros, master),
                   "master": master, "step": step}


# stacks whose products take bf16 activations (the encoder's residual
# starts in the param dtype, and the cross blocks' k/v project it): their
# weights are gathered in their own dtype, so the products stay bf16
_OWN_DTYPE_STACKS = ("enc/", "dec_cross/")


class _Shard:
    """A param leaf's local slice on the training mesh (or one layer row of
    a stacked leaf's), gathered whole, in ``dtype``, where a block uses it.
    ``sink`` is this rank's ZeRO-1 slice (placement ``zero``) of the leaf's
    (or row's) f32 gradient, which the gather's backward adds into; a
    stacked leaf whose layers ZeRO-1 cuts holds the rows from ``lo`` on,
    and a row of another rank's has no sink."""
    __slots__ = ("local", "placement", "sink", "zero", "lo", "dtype", "param_dtype")

    def __init__(self, local: torch.Tensor, placement: tuple, sink: Optional[torch.Tensor],
                 zero: tuple, lo: int, dtype: torch.dtype, param_dtype: torch.dtype):
        self.local, self.placement, self.sink, self.zero, self.lo = \
            local, placement, sink, zero, lo
        self.dtype, self.param_dtype = dtype, param_dtype

    def __getitem__(self, i: int) -> "_Shard":
        if self.placement[0] is not None:
            raise ValueError(f"a layer row of a leaf cut along its layers "
                             f"({self.placement}) is not one rank's")
        j = i - self.lo
        sink = self.sink[j] if self.sink is not None and 0 <= j < self.sink.shape[0] else None
        return _Shard(self.local[i], self.placement[1:], sink, self.zero[1:], 0, self.dtype,
                      self.param_dtype)


def _reduce_grads(flat: torch.Tensor, mesh) -> None:
    """Sum a block's f32 gradients over ``data``, in place (all-reduce;
    gloo has no reduce-scatter in every build)."""
    mesh.all_reduce(flat, "data")


class _Gather(torch.autograd.Function):
    """Forward: each shard's whole leaf, in the shard's dtype, from one
    all-gather over the mesh (``launch.mesh.gather_leaves``). Backward:
    the block's whole gradients, in f32, summed over ``data`` in one
    all-reduce, each rounded to its param dtype (the single device's
    rounding) and this rank's ZeRO-1 slice of it added to the shard's
    sink; the local slices get none."""

    @staticmethod
    def forward(ctx, mesh, shards, *local):
        from repro_torch.launch.mesh import gather_leaves
        ctx.mesh, ctx.shards = mesh, shards
        wholes = gather_leaves(list(local), [s.placement for s in shards], mesh)
        return tuple(w.to(s.dtype, copy=w is t) for w, t, s in zip(wholes, local, shards))

    @staticmethod
    def backward(ctx, *grads):
        from repro_torch.launch.mesh import local_slice
        live = [(s, g) for s, g in zip(ctx.shards, grads) if g is not None]
        if live:
            flat = torch.cat([g.reshape(-1).to(torch.float32) for _, g in live])
            _reduce_grads(flat, ctx.mesh)
            off = 0
            for s, g in live:
                whole = flat[off:off + g.numel()].view(g.shape).to(s.param_dtype)
                off += g.numel()
                if s.sink is not None:
                    s.sink.add_(local_slice(whole, s.zero, ctx.mesh))
        return (None, None) + (None,) * len(grads)


def _gather_block(p: dict, mesh) -> dict:
    """A block's params with every shard (at any depth) gathered whole, in
    one collective."""
    found = [(path, v) for path, v in iter_leaves(p) if isinstance(v, _Shard)]
    if not found:
        return p
    wholes = dict(zip([path for path, _ in found],
                      _Gather.apply(mesh, [s for _, s in found], *[s.local for _, s in found])))
    return map_with_paths(lambda path, v: wholes.get(path, v), p)


def _rows(batch: dict, mesh) -> dict:
    """This data rank's contiguous rows of every batch leaf."""
    n, d = mesh.shape.get("data", 1), mesh.index("data")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch rows {v.shape[0]} do not divide over data={n}")
        b = v.shape[0] // n
        out[k] = v[d * b:(d + 1) * b]
    return out


def _sum_over_mesh(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    for axis in mesh.shape:
        mesh.all_reduce(t, axis, op)
    return t


def _make_mesh_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int, remat: bool,
                    grad_transform: Optional[Callable], mesh):
    from repro_torch.launch.mesh import _cut, gather_whole, local_shape, train_shardings
    sh = train_shardings(cfg, mesh)
    p_sh, z_sh = sh["params"], sh["opt"]["master"]
    stacked = {path: ax[:1] == ("layers",) for path, ax in iter_leaves(lm.param_axes(cfg))}
    shapes = lm.param_shapes(cfg)
    gather = lambda p: _gather_block(p, mesh)

    def used(pl):
        return {a for e in pl if e is not None for a in ((e,) if isinstance(e, str) else e)}

    # a leaf's squares count once over the mesh: on the ranks at coordinate
    # 0 of every axis its ZeRO-1 slice is replicated over
    owner = {path: all(mesh.index(a) == 0 for a in mesh.shape if a not in used(z))
             for path, z in iter_leaves(z_sh)}

    def emit(path, dtype):
        return dtype if path.startswith(_OWN_DTYPE_STACKS) else \
            torch.promote_types(dtype, torch.float32)

    def shard(path, p, pl, z, sink):
        lo = _cut(mesh, z[0], p.shape[0])[0] if stacked[path] and z[0] is not None else 0
        return _Shard(p.detach().requires_grad_(True), tuple(pl), sink, tuple(z), lo,
                      emit(path, p.dtype), p.dtype)

    def local_loss(params, sinks, mb):
        """Forward and backward of this rank's rows of ``mb``: this rank's
        ZeRO-1 slices of the f32 grads of the global loss are added into
        ``sinks``; -> the global loss."""
        rows = _rows(mb, mesh)
        with torch.enable_grad():
            tree = map_with_paths(shard, params, p_sh, z_sh, sinks)
            # the leaves outside the stacks (embedding, final norm): once a forward
            top = {path: s for path, s in iter_leaves(tree) if not stacked[path]}
            whole = _gather_block(top, mesh)
            tree = map_with_paths(lambda path, s: whole.get(path, s), tree)
            loss, metrics = lm.loss_fn(cfg, tree, rows, remat=remat, gather=gather)
            mine = torch.clamp(metrics["tokens"].detach(), min=1.0)
            total = torch.clamp(mesh.all_reduce(metrics["tokens"].detach().clone(), "data"),
                                min=1.0)
            share = loss * (mine / total)
            share.backward()
        return mesh.all_reduce(share.detach().clone(), "data")

    def step(params, opt_state, batch, rng=None):
        del rng
        device = _device(params)
        batch = batch_to_device(batch, device)
        grads = map_with_paths(lambda path, z: torch.zeros(
            local_shape(shapes[path][0], z, mesh), dtype=torch.float32, device=device), z_sh)
        for mb in (_split_micro(batch, n_micro) if n_micro > 1 else [batch]):
            l = local_loss(params, grads, mb)
        if n_micro > 1:
            tree_map(lambda g: g.div_(n_micro), grads)
        paths = [path for path, _ in iter_leaves(grads)]
        if grad_transform is not None:
            # each leaf rounded on the whole leaf's int8 grid
            amax = _sum_over_mesh(torch.stack(
                [torch.max(torch.abs(g)) for _, g in iter_leaves(grads)]), mesh, "max")
            grads = grad_transform(grads, amax=dict(zip(paths, amax)))
        sq = _sum_over_mesh(torch.stack(
            [torch.sum(torch.square(g)) if owner[path] else g.new_zeros(())
             for path, g in iter_leaves(grads)]), mesh)
        gnorm = torch.sqrt(torch.sum(sq))
        cast, opt_state, opt_metrics = adamw.update(opt_cfg, params, grads, opt_state,
                                                    gnorm=gnorm)
        del grads
        # the ZeRO-1 slice gathered over the axes the param layout does not cut
        new_params = map_with_paths(
            lambda _path, c, pl, z: gather_whole(
                c, tuple(ze if ze != pe else None for ze, pe in zip(z, pl)), mesh),
            cast, p_sh, z_sh)
        return new_params, opt_state, {"loss": l, **opt_metrics}

    return step


def make_eval_step(cfg: ArchConfig):
    def step(params, batch, deltas=None):
        with torch.no_grad():
            _, metrics = lm.loss_fn(cfg, params, batch_to_device(batch, _device(params)),
                                    deltas=deltas)
        return metrics
    return step
