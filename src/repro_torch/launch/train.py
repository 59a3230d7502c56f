"""Training launcher (port of ``repro/launch/train.py``, one device).

Ties together the arch configs, the deterministic data pipeline, AdamW
with a cosine warmup, microbatching, remat, periodic async checkpoints
and crash-restart resume:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu      # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch llama3.2-1b \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--resume]

It runs the smoke config by default and the production config with
``--full``, on ``cuda`` unless ``--device cpu`` is given; without a card
it exits non-zero. ``--data``/``--model`` above 1 and ``--grad-compress``
need the port's mesh (ROADMAP item 10) and raise. Each logged line is the
reference's (``step … loss … gnorm … lr … tok/s``); ``main`` returns the
run's losses and per-step wall times (synchronized with the device).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import PretrainMixture
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import make_train_step


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
    """Train; returns ``{"losses", "step_ms", "tokens_per_s", "start"}``
    (``step_ms`` the wall time of each step, device work included)."""
    args = parse_args(argv)
    if args.data > 1 or args.model > 1 or args.grad_compress:
        raise NotImplementedError(
            "--data/--model > 1 and --grad-compress need the port's mesh "
            "(ROADMAP item 10); the port trains on one device")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device; pass --device cpu "
                         "to train on the CPU")

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    data = PretrainMixture(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch)
    opt_cfg = AdamWConfig(lr=args.lr,
                          schedule=schedule.cosine_with_warmup(
                              max(args.steps // 20, 1), args.steps))
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro, remat=True)

    params = lm.init_params(cfg, 0, device=device)
    opt = adamw.init(params)
    start = 0
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and ck and ck.latest_step() is not None:
        state, man = ck.restore({"params": params, "opt": opt})
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
                    extra={"data_step": i + 1}, blocking=False)
    if ck:
        ck.wait()
        ck.save(args.steps, {"params": params, "opt": opt},
                extra={"data_step": args.steps})
    print("done")
    return {"losses": losses, "step_ms": step_ms, "start": start,
            "tokens_per_s": tokens / max(time.time() - t0, 1e-9)}


if __name__ == "__main__":
    main()
