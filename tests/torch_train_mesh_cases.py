"""Training-mesh cases run by every rank of one spawned world of 4 gloo
ranks (``tests/test_torch_train_mesh.py``), from seeds; the test process
runs the single-device twins. Imports torch and the port only.

Every rank builds the same meshes in the same order over the one world
((4, 1), (2, 2), (1, 4), and (2, 1) on ranks 0 and 1) and trains the
llama3.2-1b smoke config on each, from the params the test process
hands it (the reference's init at seed 0, as numpy) and with
``tests/test_torch_train.py``'s optimizer (lr 1e-3, warmup 2 of a
10-step cosine); the tests read back losses, the params and masters
gathered whole, the per-rank bytes and the layouts' sums.
"""
from __future__ import annotations

WORLD = 4
ARCH = "llama3.2-1b"
SEQ, BATCH = 16, 8
STEPS = 3            # steps on each mesh; the elastic restore adds MORE
MORE = 2
LR = 1e-3
WARMUP, HORIZON = 2, 10
LAYOUTS = ((4, 1), (2, 2), (1, 4))
N_MICRO = 2         # the microbatch case, at (2, 2)


def setup():
    """(cfg, data, opt_cfg) shared by the ranks and the test process."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import PretrainMixture
    from repro_torch.optim import schedule
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_smoke_config(ARCH)
    return cfg, PretrainMixture(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH), \
        AdamWConfig(lr=LR, schedule=schedule.cosine_with_warmup(WARMUP, HORIZON))


def train(cfg, data, opt_cfg, params, opt, start: int, n: int, mesh=None,
          grad_transform=None, n_micro: int = 1) -> tuple:
    """``n`` steps from step ``start``; -> (params, opt, losses)."""
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, opt_cfg, n_micro=n_micro, grad_transform=grad_transform,
                           mesh=mesh)
    losses = []
    for i in range(start, start + n):
        params, opt, m = step(params, opt, data.batch_at(i), i)
        losses.append(float(m["loss"]))
    return params, opt, losses


def whole(tree, shardings, mesh) -> dict:
    """Every leaf of a rank's slices gathered whole, by path, as numpy
    (bf16 as f32, which holds it exactly: a result sent to the test
    process holds no tensor, whose shared memory dies with the rank)."""
    import torch

    from repro_torch.launch.mesh import gather_whole
    from repro_torch.utils import flatten_with_paths
    pls = flatten_with_paths(shardings)
    out = {}
    for k, v in flatten_with_paths(tree).items():
        w = gather_whole(v, tuple(pls[k]), mesh)
        out[k] = (w.to(torch.float32) if w.dtype == torch.bfloat16 else w).numpy().copy()
    return out


def layout_bytes(cfg, mesh) -> dict:
    """Per-rank bytes the layouts give: params in the train layout, each
    of m, v and master in ZeRO-1 (``local_shape`` sums)."""
    import math

    import torch

    from repro_torch.launch.mesh import local_shape, train_shardings
    from repro_torch.models import lm
    from repro_torch.utils import iter_leaves
    sh = train_shardings(cfg, mesh)
    shapes = lm.param_shapes(cfg)

    def total(tree, f32):
        out = 0
        for path, pl in iter_leaves(tree):
            shape, dtype = shapes[path]
            dt = torch.float32 if f32 else dtype
            out += math.prod(local_shape(shape, pl, mesh)) * dt.itemsize
        return out

    return {"params": total(sh["params"], False), "state": total(sh["opt"]["master"], True)}


def held_bytes(params, opt) -> dict:
    from repro_torch.utils import tree_bytes
    return {"params": tree_bytes(params),
            "state": [tree_bytes(opt[k]) for k in ("m", "v", "master")]}


def run(rank: int, world: int, ckpt_dir: str, host: dict, bits: dict) -> dict:
    """Every case on this rank, from the params ``host`` (numpy, bf16 as
    the bits ``bits`` names). Rank 0 returns the gathered trees; every
    rank returns its losses and bytes."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import compressed_all_reduce, make_compressed_allreduce
    from repro_torch.launch.mesh import make_mesh, train_shardings
    from repro_torch.train import train_step
    from repro_torch.train.train_step import shard_state

    torch.set_num_threads(1)      # ranks and test workers share the cores
    cfg, data, opt_cfg = setup()
    meshes = {dm: make_mesh(*dm) for dm in LAYOUTS}
    sub = make_mesh(2, 1, ranks=[0, 1])
    full = params_from_numpy(host, bits, device="cpu")
    out: dict = {"coords": {dm: m.coords for dm, m in meshes.items()},
                 "backend": meshes[(2, 2)].backend, "losses": {}, "bytes": {}}

    def fresh(mesh):
        return shard_state(cfg, full, mesh)

    # (a) each layout, 3 steps; (d) the bytes each rank holds after them;
    # (e) the (2, 2) run saves its state at step 3
    for dm, mesh in meshes.items():
        sh = train_shardings(cfg, mesh)
        p, o, losses = train(cfg, data, opt_cfg, *fresh(mesh), 0, STEPS, mesh)
        out["losses"][dm] = losses
        out["bytes"][dm] = {"held": held_bytes(p, o), "layout": layout_bytes(cfg, mesh)}
        params, master = whole(p, sh["params"], mesh), whole(o["master"], sh["opt"]["master"],
                                                              mesh)
        if rank == 0:
            out.setdefault("params", {})[dm] = params
            out.setdefault("master", {})[dm] = master
        if dm == (2, 2):
            ck = Checkpointer(ckpt_dir)
            ck.save(STEPS, {"params": p, "opt": o}, extra={"data_step": STEPS},
                    blocking=False, shardings=sh, mesh=mesh)
            ck.wait()
    # (e) elastic: the (2, 2) checkpoint restored at (4, 1), MORE steps
    mesh = meshes[(4, 1)]
    p, o = fresh(mesh)
    state, man = Checkpointer(ckpt_dir).restore({"params": p, "opt": o},
                                                shardings=train_shardings(cfg, mesh),
                                                mesh=mesh)
    *_, out["losses"]["elastic"] = train(cfg, data, opt_cfg, state["params"], state["opt"],
                                         man["extra"]["data_step"], MORE, mesh)
    # (b) --grad-compress at (2, 2)
    mesh = meshes[(2, 2)]
    sh = train_shardings(cfg, mesh)
    p, o, out["losses"]["compress"] = train(
        cfg, data, opt_cfg, *fresh(mesh), 0, STEPS, mesh,
        grad_transform=make_compressed_allreduce(mesh, "data"))
    params = whole(p, sh["params"], mesh)
    if rank == 0:
        out["params"]["compress"] = params
    # (f) the control: both data ranks fed data rank 0's rows (one step:
    # the first loss already leaves the bound)
    real = train_step._rows
    train_step._rows = lambda batch, m: real(batch, m.view(data=m.shape["data"],
                                                           model=m.shape["model"]))
    try:
        *_, out["losses"]["same_rows"] = train(cfg, data, opt_cfg, *fresh(mesh), 0, 1, mesh)
    finally:
        train_step._rows = real
    # (a) microbatches at (2, 2): the global batch cut first, then each
    # microbatch's rows over data
    *_, out["losses"]["micro"] = train(cfg, data, opt_cfg, *fresh(mesh), 0, STEPS, mesh,
                                       n_micro=N_MICRO)
    # the second control: the data all-reduce of the grads skipped, so each
    # data rank updates its ZeRO-1 slice from its own rows' gradient
    real = train_step._reduce_grads
    train_step._reduce_grads = lambda flat, m: None
    try:
        *_, out["losses"]["unreduced"] = train(cfg, data, opt_cfg, *fresh(mesh), 0, STEPS,
                                               mesh)
    finally:
        train_step._reduce_grads = real
    # (c) the wire-form int8 all-reduce over the 4 data ranks
    v = torch.from_numpy(wire_vector(rank))
    out["wire"] = compressed_all_reduce(v, meshes[(4, 1)], "data").numpy().copy()
    # (d) ZeRO-1 on the sub-mesh (2, 1)
    if sub is not None:
        out["bytes"]["sub"] = held_bytes(*shard_state(cfg, full, sub))
    return out


def wire_vector(rank: int):
    import numpy as np
    return np.random.default_rng(100 + rank).normal(size=1000).astype(np.float32) * (rank + 1)
