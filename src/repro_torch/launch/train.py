"""Training launcher (port of ``repro/launch/train.py``).

Ties together the arch configs, the deterministic data pipeline, AdamW
with a cosine warmup, microbatching, remat, the (data, model) training
mesh with ZeRO-1, the int8 compressed gradient all-reduce, periodic
async checkpoints and crash-restart resume:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu      # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --data 2 --model 2 \
        --grad-compress --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch llama3.2-1b \
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--resume]

It runs the smoke config by default and the production config with
``--full``, on ``cuda`` unless ``--device cpu`` is given; without a card
it exits non-zero. ``--data D --model M`` spawns ``D*M`` ranks
(``launch.mesh.run_ranks``: ``nccl`` with a card per rank, ``gloo`` on the
CPU and where ranks share a card), each building the params from seed 0
and keeping its slices (``train.make_train_step(mesh=)``);
``--grad-compress`` rounds the data-reduced grads onto the int8 grid
when ``D > 1``, as the reference does. ``--resume`` restores onto the
mesh's layouts, whatever mesh wrote the checkpoint. Rank 0 prints the
mesh and its backend, then the reference's lines (``step … loss … gnorm
… lr … tok/s``); ``main`` returns the run's losses, per-step wall times
(synchronized with the device) and each rank's peak device memory.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import PretrainMixture
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import make_train_step

# the whole world's deadline (a rank's collectives each have their own)
RANKS_TIMEOUT_S = 3600.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true", help="production config (not smoke)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--data", type=int, default=1, help="data-parallel mesh size")
    ap.add_argument("--model", type=int, default=1, help="model-parallel mesh size")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback compressed DP all-reduce")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns ``{"losses", "step_ms", "tokens_per_s", "start",
    "peak_bytes", "backend", "mesh"}`` (``step_ms`` the wall time of each
    step, device work included; ``peak_bytes`` each rank's
    ``torch.cuda.max_memory_allocated``, None on the CPU)."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device; pass --device cpu "
                         "to train on the CPU")
    if args.data < 1 or args.model < 1:
        raise SystemExit("--data and --model must be at least 1")
    world = args.data * args.model
    if world == 1:
        return _train(args, None)
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(_rank_main, world, (argv,), device=args.device,
                      timeout_s=RANKS_TIMEOUT_S)
    return {**ranks[0], "peak_bytes": [r["peak_bytes"][0] for r in ranks]}


def _rank_main(rank: int, world: int, argv: list) -> dict:
    """One spawned rank of ``--data D --model M``: join the mesh and train
    on it; only rank 0 prints."""
    from repro_torch.launch.mesh import make_mesh
    args = parse_args(argv)
    mesh = make_mesh(args.data, args.model, device=args.device)
    if rank == 0:
        print(f"mesh: {mesh.shape} ({mesh.backend}, transport {mesh.transport})",
              flush=True)
        return _train(args, mesh)
    with contextlib.redirect_stdout(io.StringIO()):
        return _train(args, mesh)


def _train(args, mesh) -> dict:
    """The training loop, on one device (``mesh`` None) or on this rank's
    slices of ``mesh``."""
    device = torch.device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    data = PretrainMixture(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=schedule.cosine_with_warmup(
                              max(args.steps // 20, 1), args.steps))
    grad_transform = None
    if args.grad_compress and args.data > 1:
        from repro_torch.dist import make_compressed_allreduce
        grad_transform = make_compressed_allreduce(mesh, "data")
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro, remat=True,
                              grad_transform=grad_transform, mesh=mesh)

    params = lm.init_params(cfg, 0, device=device)
    if mesh is None:
        opt, sh = adamw.init(params), {}
    else:
        from repro_torch.launch.mesh import train_shardings
        from repro_torch.train.train_step import shard_state
        params, opt = shard_state(cfg, params, mesh)
        sh = {"shardings": train_shardings(cfg, mesh), "mesh": mesh}
    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ck and ck.latest_step() is not None:
        state, man = ck.restore({"params": params, "opt": opt}, **sh)
        params, opt, start = state["params"], state["opt"], man["extra"]["data_step"]
        print(f"resumed from step {start}")

    losses, step_ms = [], []
    t0 = time.time()
    tokens = 0
    for i in range(start, args.steps):
        _sync(device)
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, data.batch_at(i), i)
        _sync(device)
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(m["loss"]))
        tokens += args.batch * args.seq
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} lr {float(m['lr']):.2e} "
                  f"tok/s {tokens / max(dt, 1e-9):.0f}", flush=True)
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, {"params": params, "opt": opt},
                    extra={"data_step": i + 1}, blocking=False, **sh)
    if ck:
        ck.wait()
        ck.save(args.steps, {"params": params, "opt": opt},
                extra={"data_step": args.steps}, **sh)
        ck.wait()
    print("done")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"losses": losses, "step_ms": step_ms, "start": start,
            "tokens_per_s": tokens / max(time.time() - t0, 1e-9),
            "peak_bytes": [peak], "backend": mesh.backend if mesh else None,
            "mesh": dict(mesh.shape) if mesh else None}


if __name__ == "__main__":
    main()
