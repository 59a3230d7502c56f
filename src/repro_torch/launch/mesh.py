"""Mesh construction and the serving layouts (port of ``repro/launch/mesh.py``).

The reference runs one SPMD program over a ``jax`` mesh. The port runs
one process per rank over ``torch.distributed``: every rank executes the
same host loop on the same inputs, holds only its own slice of each
sharded leaf, and the cross-rank traffic the reference's ``shard_map``
and sharding constraints imply becomes explicit collectives between
layers (``ServingMesh.all_gather``), outside the kernels.

FUNCTIONS, not module-level state: importing this module starts no
process group. Layouts take an **abstract mesh** (``dist.AbstractMesh``:
axis names and sizes), so they build without any rank — the production
meshes (16, 16) ``(data, model)`` and (2, 16, 16) ``(pod, data, model)``
of :func:`make_production_mesh` included. A live rank's
:class:`ServingMesh` adds its coordinates and process groups.

Serving layout (the DeltaDQ deployment, Fig. 2 at scale):

* **base weights** — column-parallel at exactly the compressible matmul
  sites: each rank keeps output columns ``[m * O/M, (m + 1) * O/M)`` of
  every such weight whose width divides (:func:`param_shardings`); the
  rest replicates. Each site's output is all-gathered over ``model``
  right after the site (``core.apply``), so every matmul reduces over the
  full contraction locally, in the single-card order; q/k/v that feed a
  ring cut on kv-heads stay the rank's own columns.
* **packed tenant deltas** — replicated, or cut once at registration into
  each rank's output-column slice (``shard_output``,
  :func:`shard_delta`), the layout ``ops.delta_correction_sharded``
  consumes.
* **KV cache** — attention rings sharded along kv-heads, slot rows over
  ``data`` in contiguous pools (:func:`cache_shardings`). The placements
  also name the reference's inner-width cut of ssm/rg-lru states, which
  ``serve.kv.SlotKVCache`` does not take: every model rank runs the whole
  mixer, so it keeps the whole state.

Training layout (:func:`train_shardings`, the reference's
``launch/train.py``): params in the logical rules' ``train`` profile
(FSDP over ``data`` plus Megatron's cuts over ``model``), AdamW's state
in that layout plus ZeRO-1 over ``(pod, data)``; the training step
(``train.make_train_step(mesh=)``) gathers what it uses whole
(:func:`gather_leaves`).

The process-group backend follows the layout, and is printed: ``nccl``
when every rank has a card of its own, ``gloo`` on the CPU, and ``gloo``
when ranks share one card (NCCL refuses two ranks on one device). gloo
takes CUDA tensors and moves them through host memory itself (checked on
an H100 by ``chip_smoke.py``'s ``[mesh]`` phase); the compute stays on
the card.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch.core.pack import PackedDelta
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import AbstractMesh

# seconds a rank waits in a rendezvous or a collective before it fails
RANK_TIMEOUT_S = 300.0


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's TPU v5e production topology, as an abstract mesh."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# A live rank's view of the mesh
# ---------------------------------------------------------------------------
class ServingMesh:
    """One rank's view of a ``(data, model)`` mesh, for serving and for
    training (``train.make_train_step(mesh=)``, ``launch.train --data
    --model``).

    ``shape`` is the ``{axis: size}`` dict the layouts read, ``coords``
    this rank's ``{axis: index}``. ``device_mesh`` is the
    ``torch.distributed.device_mesh.DeviceMesh`` whose per-axis process
    groups the collectives use; a view built with :meth:`view` has none
    and serves layouts and local compute only (its collectives raise on
    an axis wider than 1). ``transport`` says how the backend moves a
    gathered tensor (:func:`backend_for`)."""

    def __init__(self, abstract: AbstractMesh, coords: dict, *, device_mesh=None,
                 backend: Optional[str] = None, transport: str = "none", group=None):
        self.abstract = abstract
        self.coords = dict(coords)
        self.device_mesh = device_mesh
        self.backend = backend
        self.transport = transport
        self.group = group          # every rank of the mesh, in coordinate order

    @classmethod
    def view(cls, data: int = 1, model: int = 1, *, data_index: int = 0,
             model_index: int = 0) -> "ServingMesh":
        """The (data, model) mesh seen from one coordinate, with no
        process group: layouts, slicing and per-rank local compute."""
        return cls(AbstractMesh((data, model), ("data", "model")),
                   {"data": data_index, "model": model_index})

    @property
    def shape(self) -> dict:
        return self.abstract.shape

    @property
    def size(self) -> int:
        return self.abstract.size

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """Concatenate every rank's ``t`` along ``dim``, in ``axis`` index
        order, over the ranks that share this rank's other coordinates."""
        n = self.shape.get(axis, 1)
        if n == 1:
            return t
        import torch.distributed as dist
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def _group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError(f"mesh view {self.shape} has no process group for "
                               f"a collective over {axis!r}")
        return self.device_mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``op`` (``sum`` or ``max``) of every rank's ``t`` over the ranks
        that share this rank's other coordinates, **in place** (``t``, which
        must be contiguous, is returned)."""
        if self.shape.get(axis, 1) == 1:
            return t
        if not t.is_contiguous():
            raise ValueError("all_reduce works in place on a contiguous tensor")
        import torch.distributed as dist
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(t, op=ops[op], group=self._group(axis))
        return t

    def gather_all(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape and dtype on each), one a rank, in
        coordinate order (row-major over the axes)."""
        if self.size == 1:
            return [t]
        if self.group is None:
            raise RuntimeError(f"mesh view {self.shape} has no process group")
        import torch.distributed as dist
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return parts

    def at(self, index: int) -> "ServingMesh":
        """The mesh seen from the rank at coordinate-order ``index``, with
        no process group (its coordinates, for layouts)."""
        coords = {}
        for name, n in reversed(list(zip(self.abstract.axis_names, self.abstract.sizes))):
            coords[name] = index % n
            index //= n
        return ServingMesh(self.abstract, coords)

    def barrier(self) -> None:
        """Every rank of the mesh has reached this call."""
        if self.size == 1:
            return
        if self.group is None:
            raise RuntimeError(f"mesh view {self.shape} has no process group")
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank: host decisions that read a
        clock (admission against arrivals) must be the same on every rank
        of an SPMD world, or their collectives stop pairing up."""
        if self.device_mesh is None or self.size == 1:
            return value
        import torch.distributed as dist
        t = torch.tensor([value], dtype=torch.float64,
                         device="cuda" if self.backend == "nccl" else "cpu")
        dist.broadcast(t, src=0)
        return float(t.item())

    def __repr__(self) -> str:
        return f"ServingMesh({self.shape}, coords={self.coords})"


def backend_for(device, world: int) -> tuple[str, str]:
    """(backend, transport) the layout calls for: ``nccl`` when each of the
    ``world`` ranks has a CUDA card of its own (card to card), ``gloo``
    when ranks share cards (CUDA tensors through host memory, which gloo
    does itself) and on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported mesh device {dev}")
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= world \
        else "gloo"
    return backend, _transport(backend, dev.type)


def _transport(backend: str, device_type: str) -> str:
    if backend == "nccl":
        return "card to card"
    if device_type == "cuda":
        return "CUDA tensors through host memory, by gloo"
    return "host memory"


def init_rank(rank: int, world: int, init_method: str, device="cuda", *,
              timeout_s: float = RANK_TIMEOUT_S) -> str:
    """Join the world as ``rank``: the backend :func:`backend_for` picks,
    a ``timeout`` on the rendezvous and every collective. On CUDA each
    rank selects its card first (card ``rank`` with nccl; ranks spread
    over the cards there are with gloo). -> the backend."""
    import torch.distributed as dist
    backend, _ = backend_for(device, world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_mesh(data: int = 1, model: int = 1, *, ranks: Optional[list] = None,
              device=None) -> Optional[ServingMesh]:
    """(data, model) mesh over ``ranks`` of the initialized world (default:
    every rank, which must number ``data * model``), rank ``ranks[d *
    model + m]`` at coordinates (d, m). Every rank of the world must call
    it, in the same order (it creates the mesh's process groups); a rank
    outside ``ranks`` (ascending) gets None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(launch.mesh.init_rank / run_ranks)")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if len(ranks) != data * model or ranks != sorted(set(ranks)):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ascending "
                         f"ranks, got {ranks}")
    backend = dist.get_backend()
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    dev_type = torch.device(device).type
    dm = DeviceMesh(dev_type, torch.tensor(ranks).reshape(data, model),
                    mesh_dim_names=("data", "model"))
    group = dist.new_group(ranks) if len(ranks) > 1 else None
    if dm.get_coordinate() is None:
        return None
    return ServingMesh(AbstractMesh((data, model), ("data", "model")),
                       {"data": dm.get_local_rank("data"),
                        "model": dm.get_local_rank("model")},
                       device_mesh=dm, backend=backend,
                       transport=_transport(backend, dev_type), group=group)


def make_serving_mesh(devices: Optional[int] = None, *, data: int = 1,
                      device=None) -> ServingMesh:
    """(data, model) mesh over the ``devices`` ranks of the initialized
    world (default: all of them), ``model = devices / data``.

    Serving wants the model axis as large as possible (the base is the
    footprint); ``data > 1`` replicates the model shards for decode
    throughput: slot rows split over ``data`` in contiguous pools
    (``ContinuousEngine(mesh=make_serving_mesh(n, data=d))``;
    ``launch.serve --devices n --data d``). Every rank of the world must
    call it, in the same order (it creates the axes' process groups)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialized process group "
                           "(launch.mesh.init_rank / run_ranks)")
    world = dist.get_world_size()
    n = world if devices is None else devices
    if n != world:
        raise ValueError(f"requested {n} devices but the world has {world} ranks")
    if data < 1 or n % data:
        raise ValueError(f"data={data} must divide the device count {n} "
                         "(equal contiguous shard pools)")
    return make_mesh(data, n // data, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> ServingMesh:
    """Small mesh over the initialized world, which must have
    ``data * model`` ranks."""
    return make_serving_mesh(data * model, data=data, device=device)


# ---------------------------------------------------------------------------
# Layout assembly (serve profile unless stated otherwise)
# ---------------------------------------------------------------------------
def _abstract(mesh) -> AbstractMesh:
    return mesh.abstract if isinstance(mesh, ServingMesh) else mesh


def serve_rules(mesh, **overrides) -> shd.ShardingRules:
    return shd.ShardingRules(_abstract(mesh)).with_overrides(
        **{**shd.SERVE_OVERRIDES, **overrides})


def param_shardings(cfg, mesh, profile: str = "serve", **overrides) -> Any:
    """Placement tree for every base-model parameter.

    ``serve``: **column-parallel** — every compressible weight (exactly
    the ``apply_linear`` sites, the delta sites) shards its output (last)
    axis over ``model`` when it divides; contraction axes are never
    sharded, and everything else (embedding, norms, conv taps, router)
    replicates, ``()``. With each site's output gathered back to
    replicated (``core.apply``), every matmul reduces over the full
    contraction locally, in the single-card order: sharded decode gives
    the single-card tokens.

    ``train``: the logical-rules layout (Megatron row+column TP plus the
    FSDP overrides), which the training mesh stores its params in
    (:func:`train_shardings`; ``train.make_train_step(mesh=)`` gathers
    each block's weights whole on use)."""
    from repro_torch.core.compress import is_compressible
    from repro_torch.models import lm
    from repro_torch.utils import map_with_paths, materialize
    abstract = _abstract(mesh)
    if profile == "train":
        rules = shd.ShardingRules(abstract).with_overrides(
            **{**shd.TRAIN_OVERRIDES, **overrides})
        return shd.tree_shardings(rules, lm.param_specs(cfg), lm.param_axes(cfg))
    if profile != "serve":
        raise ValueError(f"profile {profile!r} not in ('train', 'serve')")
    n_model = abstract.shape.get("model", 1)

    def one(path: str, spec) -> tuple:
        shape = tuple(spec[0])
        if not is_compressible(path, materialize({"x": spec})["x"]):
            return ()
        if shape[-1] % n_model == 0:
            return (None,) * (len(shape) - 1) + ("model",)
        return ()

    return map_with_paths(one, lm.param_specs(cfg))


def zero_axes(mesh) -> tuple:
    """The ZeRO-1 axes of a mesh: ``(pod, data)``, whichever it has (the
    reference's ``launch/train.py`` and ``launch/dryrun.py``)."""
    return tuple(a for a in ("pod", "data") if a in _abstract(mesh).shape)


def train_shardings(cfg, mesh) -> dict:
    """``{"params", "opt"}`` placement trees of a training state on
    ``mesh``: params in the ``train`` profile, AdamW's m, v and f32
    master in that layout plus ZeRO-1 over :func:`zero_axes`
    (``dist.zero1_shardings``, the reference's ``o_sh``), ``step``
    replicated."""
    from repro_torch.models import lm
    rules = shd.ShardingRules(_abstract(mesh)).with_overrides(**shd.TRAIN_OVERRIDES)
    specs, axes = lm.param_specs(cfg), lm.param_axes(cfg)
    z = shd.zero1_shardings(rules, specs, axes, zero_axes(mesh))
    return {"params": shd.tree_shardings(rules, specs, axes),
            "opt": {"m": z, "v": z, "master": z, "step": ()}}


def cache_shardings(cfg, mesh, batch: int, max_seq: int, enc_len: int = 0,
                    **overrides) -> Any:
    """Placement tree for the slot cache (``lm.init_cache``'s structure):
    KV rings on kv-heads, recurrent states on their width, slot rows over
    ``data``."""
    from repro_torch.models import lm
    rules = serve_rules(mesh, **overrides)
    cache = lm.init_cache(cfg, batch, max_seq, enc_len=enc_len, device="meta")
    axes = shd.cache_axes(cache)
    return shd.map_cache(lambda name, leaf, ax: rules.spec_for(ax, tuple(leaf.shape), name),
                         cache, axes)


def delta_shardings(deltas: Any, mesh, *, shard_output: bool = False) -> Any:
    """Placements for a packed-delta tree (possibly tenant-stacked): each
    PackedDelta leaf becomes a PackedDelta whose array fields hold their
    placements.

    Replicated by default — compressed deltas are tiny, and a replicated
    delta keeps the correction collective-free. With ``shard_output``,
    idx/codes shard their output-column axis over ``model`` wherever the
    mesh axis divides it (the layout ``ops.delta_correction_sharded``
    consumes); scale/zero stay replicated."""
    n_model = _abstract(mesh).shape.get("model", 1)

    def one(d):
        if d is None:
            return None
        if isinstance(d, dict):
            return {k: one(v) for k, v in d.items()}
        if shard_output and d.h_out % n_model == 0:
            arr = (None,) * (d.idx.ndim - 1) + ("model",)
        else:
            arr = ()
        return dataclasses.replace(d, idx=arr, codes=arr, scale=(), zero=())

    return one(deltas)


def replicate(tree: Any, mesh) -> Any:
    """Every leaf whole on every rank: the tree itself (each rank holds its
    own copy already)."""
    return tree


# ---------------------------------------------------------------------------
# This rank's slices
# ---------------------------------------------------------------------------
def _cut(mesh: ServingMesh, entry, size: int) -> tuple[int, int]:
    """[lo, hi) of a dimension of ``size`` placed on mesh axis/axes
    ``entry`` for this rank (the first named axis major)."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    k, idx = 1, 0
    for a in axes:
        n = mesh.shape[a]
        idx = idx * n + mesh.index(a)
        k *= n
    if size % k:
        raise ValueError(f"dimension {size} does not divide over {axes} ({k})")
    step = size // k
    return idx * step, (idx + 1) * step


def local_slice(t: torch.Tensor, placement: tuple, mesh: ServingMesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` under ``placement`` (a
    replicated placement returns ``t`` itself, no copy)."""
    out = t
    cut = False
    for dim, entry in enumerate(placement):
        if entry is None:
            continue
        lo, hi = _cut(mesh, entry, t.shape[dim])
        out = out.narrow(dim, lo, hi - lo)
        cut = True
    return out.contiguous() if cut else t


def gather_whole(t: torch.Tensor, placement: tuple, mesh: ServingMesh) -> torch.Tensor:
    """The whole leaf from every rank's :func:`local_slice` of it under
    ``placement``: an all-gather over each named axis along its dimension
    (a dimension on several axes: the minor axis first). ``t`` itself
    when nothing is cut."""
    out = t
    for dim, entry in enumerate(placement):
        if entry is None:
            continue
        for a in reversed((entry,) if isinstance(entry, str) else tuple(entry)):
            out = mesh.all_gather(out, a, dim=dim)
    return out


def gather_leaves(ts: list, placements: list, mesh: ServingMesh) -> list:
    """Each leaf whole from every rank's :func:`local_slice` of it, all in
    one all-gather of the cut leaves' bytes over the mesh
    (:meth:`ServingMesh.gather_all`), each rank's piece written where its
    coordinates put it. A leaf nothing cuts is returned as it is."""
    cut = [i for i, pl in enumerate(placements)
           if any(e is not None for e in pl)] if mesh.size > 1 else []
    out = list(ts)
    if not cut:
        return out
    # each leaf's bytes padded to 8, so every piece starts aligned for its dtype
    nbytes = {i: ts[i].numel() * ts[i].element_size() for i in cut}
    parts = mesh.gather_all(torch.cat(
        [torch.nn.functional.pad(ts[i].contiguous().reshape(-1).view(torch.uint8),
                                 (0, -nbytes[i] % 8)) for i in cut]))
    wholes = {}
    for i in cut:
        k = [1 if e is None else math.prod(
            mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
             for e in placements[i]]
        wholes[i] = ts[i].new_empty([n * f for n, f in zip(ts[i].shape, k)])
    for r, part in enumerate(parts):
        at, off = mesh.at(r), 0
        for i in cut:
            t, whole, n = ts[i], wholes[i], nbytes[i]
            idx = tuple(slice(None) if e is None else slice(*_cut(at, e, whole.shape[d]))
                        for d, e in enumerate(placements[i]))
            whole[idx] = part[off:off + n].view(t.dtype).view(t.shape)
            off += n + (-n % 8)
    for i in cut:
        out[i] = wholes[i]
    return out


def local_shape(shape: tuple, placement: tuple, mesh) -> tuple:
    """The shape of this rank's slice of a leaf of ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(placement):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        k = 1
        for a in axes:
            k *= mesh.shape[a]
        out[dim] = shape[dim] // k
    return tuple(out)


def shard_tree(tree: Any, shardings: Any, mesh: ServingMesh) -> Any:
    """This rank's slice of every tensor leaf of a dict tree, cut once,
    contiguous. Column-parallel weights (a placement ending in ``model``
    and nothing else) come back as ``core.apply.ColumnShard``, which
    ``apply_linear`` gathers after its local product; a leaf that is
    already a slice stays as it is. Packed deltas are cut by
    :func:`shard_delta`."""
    from repro_torch.core.apply import ColumnShard
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k], mesh) for k, v in tree.items()}
    if tree is None or isinstance(tree, ColumnShard):
        return tree
    placement = tuple(shardings)
    if placement and placement[-1] == "model" and all(e is None for e in placement[:-1]):
        n = mesh.shape["model"]
        return ColumnShard(local_slice(tree, placement, mesh), n) if n > 1 else tree
    return local_slice(tree, placement, mesh)


def shard_delta(d: PackedDelta, mesh: ServingMesh, *, copy: bool = True) -> PackedDelta:
    """This rank's output-column slice of a packed delta (stacked or not):
    idx/codes columns ``[m * O/M, (m + 1) * O/M)``, scale/zero whole,
    ``shards = M``. Leaves whose width does not divide, and meshes without
    a model axis, stay whole. ``copy=False`` returns views (for copying
    into pre-allocated rows)."""
    n = mesh.shape.get("model", 1)
    if n <= 1 or d.shards > 1 or d.h_out % n:
        return d
    lo, hi = _cut(mesh, "model", d.h_out)

    def cols(a: torch.Tensor) -> torch.Tensor:
        v = a.narrow(a.ndim - 1, lo, hi - lo)
        return v.contiguous() if copy else v

    return dataclasses.replace(d, idx=cols(d.idx), codes=cols(d.codes),
                               h_out=hi - lo, shards=n)


def shard_delta_tree(tree: Any, mesh: ServingMesh, *, copy: bool = True) -> Any:
    """:func:`shard_delta` at every PackedDelta leaf of a deltas tree."""
    if isinstance(tree, dict):
        return {k: shard_delta_tree(v, mesh, copy=copy) for k, v in tree.items()}
    if isinstance(tree, PackedDelta):
        return shard_delta(tree, mesh, copy=copy)
    return tree


def shard_params(cfg, params: Any, mesh: ServingMesh) -> Any:
    """A full params tree cut to this rank's serve layout."""
    return shard_tree(params, param_shardings(cfg, mesh), mesh)


# ---------------------------------------------------------------------------
# Ranks as processes
# ---------------------------------------------------------------------------
def _rank_entry(rank: int, world: int, init_method: str, device: str,
                timeout_s: float, results, fn: Callable, args: tuple) -> None:
    """A spawned rank: join the world, run ``fn(rank, world, *args)``, put
    ``(rank, ok, result or traceback)`` on ``results``, leave the world."""
    import torch.distributed as dist
    if torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores (OMP_NUM_THREADS, where set, is
        # each rank's own count, as torch reads it)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_rank(rank, world, init_method, device, timeout_s=timeout_s)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (), *, device="cuda",
              timeout_s: float = 600.0, rank_timeout_s: float = RANK_TIMEOUT_S,
              rendezvous_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    into one process group; returns each rank's result, rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path; CUDA
    tensors in ``args`` go as IPC handles, so ranks on the parent's card
    share its memory). The rendezvous is a file under ``rendezvous_dir``
    (a fresh temporary directory by default), so concurrent worlds never
    collide on a port. A rank that raises fails the call at once with its
    traceback; the whole world fails after ``timeout_s``; every rank has
    ``rank_timeout_s`` on its rendezvous and collectives. Every process
    is gone when this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rendezvous-", dir=rendezvous_dir)
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(r, world, init_method, str(device), rank_timeout_s,
                               results, fn, args)) for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    raise RuntimeError(f"mesh ranks died without a result: {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh world of {world} ranks did not finish "
                                       f"in {timeout_s:.0f} s ({sorted(got)} done)")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        try:
            os.remove(os.path.join(tmp, "store"))
        except OSError:
            pass
        try:
            os.rmdir(tmp)
        except OSError:
            pass
    return [got[r] for r in range(world)]
