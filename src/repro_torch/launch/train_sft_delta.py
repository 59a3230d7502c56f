"""End-to-end run: pretrain -> SFT -> DeltaDQ -> serve -> evaluate (the
port's twin of ``examples/train_sft_delta.py``).

The paper's whole lifecycle on one device:
 1. pretrain a base LM (noise mixture + task format),
 2. fine-tune it on the Sort task (the "WizardMath" stand-in),
 3. compress the delta at 16x, 64x and the paper's 128x flagship,
 4. serve base + tenants through ``Engine.generate`` (the ``delta_spmm``
    kernel on the card),
 5. report exact-match task accuracy per tenant and the memory ledger.

    PYTHONPATH=src python -m repro_torch.launch.train_sft_delta --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_sft_delta      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train_sft_delta --preset 100m --steps 300

``main`` returns the accuracies and ``Engine.memory_report()``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import DeltaDQSpec, compress
from repro_torch.data import FormatOnlyTask, PretrainMixture, SortTask
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve import Engine
from repro_torch.train import make_train_step
from repro_torch.utils import tree_params

PRESETS = {
    "3m": ArchConfig(name="sft-3m", family="dense", n_layers=4, d_model=128,
                     n_heads=4, n_kv=2, head_dim=32, d_ff=256, vocab=64,
                     tie_embeddings=True),
    "25m": ArchConfig(name="sft-25m", family="dense", n_layers=8, d_model=384,
                      n_heads=8, n_kv=4, head_dim=48, d_ff=1024, vocab=512,
                      tie_embeddings=True),
    "100m": ArchConfig(name="sft-100m", family="dense", n_layers=12, d_model=768,
                       n_heads=12, n_kv=4, head_dim=64, d_ff=2048, vocab=4096,
                       tie_embeddings=True),
}
TENANTS = {
    "16x": DeltaDQSpec(alpha=8.0, k_bits=8, m=1, h_g=16),
    "64x": DeltaDQSpec(alpha=8.0, k_bits=4, m=4, h_g=16),
    "128x": DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16),
}
N_DIGITS, SEQ = 6, 32


def train(cfg, params, data, steps, lr, label):
    opt = adamw.init(params)
    opt_cfg = AdamWConfig(lr=lr, weight_decay=0.0,
                          schedule=schedule.cosine_with_warmup(steps // 10 + 1, steps))
    step = make_train_step(cfg, opt_cfg)
    t0 = time.time()
    m = {}
    for i in range(steps):
        params, opt, m = step(params, opt, data.batch_at(i), i)
        if i % max(steps // 5, 1) == 0:
            print(f"  [{label}] step {i:4d} loss {float(m['loss']):.4f}")
    print(f"  [{label}] done in {time.time() - t0:.0f}s, final loss {float(m['loss']):.4f}")
    return params


def accuracy(engine: Engine, tenant, task: SortTask) -> float:
    """Exact-match digit accuracy over three prompt batches."""
    c = t = 0
    for s in range(3):
        prompts, targets = task.prompts_at(9000 + s)
        gen = engine.generate(tenant, prompts, max_new_tokens=N_DIGITS)
        c += int((gen[:, :N_DIGITS] == targets).sum())
        t += targets.size
    return c / t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="3m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train_sft_delta: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    cfg = PRESETS[args.preset]
    steps = args.steps or {"3m": 250, "25m": 300, "100m": 300}[args.preset]
    print(f"arch={cfg.name}: {tree_params(lm.param_shapes(cfg)) / 1e6:.1f}M params")

    base = lm.init_params(cfg, 0, device=device)
    print("1) pretraining base ...")
    base = train(cfg, base, PretrainMixture(cfg.vocab, SEQ, 32), steps // 3, 5e-3, "pretrain")
    base = train(cfg, base, FormatOnlyTask(cfg.vocab, SEQ, 32, n_digits=N_DIGITS),
                 steps, 3e-3, "format")
    task = SortTask(cfg.vocab, SEQ, 32, n_digits=N_DIGITS, seed=1)
    print("2) supervised fine-tuning ...")
    ft = train(cfg, base, task, steps, 1e-3, "sft")

    print("3) DeltaDQ compression ...")
    eng = Engine(cfg, base, max_seq=SEQ + N_DIGITS + 2)
    for name, spec in TENANTS.items():
        deltas, report = compress(base, ft, spec)
        eng.register_tenant(name, deltas, report)
        print("  ", report.summary())

    print("4) serving + evaluation ...")
    eng_ft = Engine(cfg, ft, max_seq=SEQ + N_DIGITS + 2)
    acc = {"fine_tuned": accuracy(eng_ft, None, task), "base": accuracy(eng, None, task)}
    print(f"  fine-tuned (uncompressed): {acc['fine_tuned']:.3f}")
    print(f"  raw base                 : {acc['base']:.3f}")
    for name in TENANTS:
        acc[name] = accuracy(eng, name, task)
        print(f"  tenant {name:5s}            : {acc[name]:.3f}")

    rep = eng.memory_report()
    print(f"5) memory: base={rep['base_bytes'] / 1e6:.1f}MB, "
          f"{rep['n_tenants']} tenants={rep['delta_bytes_total'] / 1e6:.2f}MB total "
          f"(vs {rep['n_tenants']} full copies "
          f"{rep['base_bytes'] * rep['n_tenants'] / 1e6:.1f}MB)")
    return {"accuracy": acc, "memory": rep}


if __name__ == "__main__":
    main()
