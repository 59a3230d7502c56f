"""Quickstart: compress a fine-tuned model's delta with DeltaDQ at 128x,
serve it with separate computation, and hold it against the merged
weights (the port's twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --full        # full width

The merged model is ``decompress(base, deltas)``: ``merge_delta``, which
runs the dequant kernel once per matrix on the card. It is merged from
f32 copies of the base weights, so the only difference from separate
computation is the order of summation; merging into bf16 weights would
round base + delta once more, which the deployment never does.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DeltaDQSpec, compress, decompress, is_compressible
from repro_torch.models import lm
from repro_torch.utils import map_with_paths, tree_map

ARCH = "wizard-llama2-7b"
# group-wise dropout (alpha=8) + separate quantization (k=4 codes stored
# as m=8 one-bit parts) => 128x, as the reference quickstart
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=32)
NOISE = 0.01
# Bound on max|separate - merged| / max|logit|. At the full width the
# random 32-layer stack amplifies an early relative error ~100x by the
# logits, so the bound leaves two decades above f32 summation-order
# noise; at the smoke size the two agree to ~1e-6.
REL_TOL = 1e-2


def perturb(base: dict, noise: float, seed: int) -> dict:
    """A "fine-tuned" variant: every compressible weight plus
    ``noise * N(0, 1)`` (cast to its dtype), drawn one matrix at a time
    from a generator seeded with ``seed``. Other leaves are shared with
    the base: ``compress`` would drop their deltas anyway."""
    dev = base["embed"]["tok"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def fn(path: str, p: torch.Tensor) -> torch.Tensor:
        if not is_compressible(path, p):
            return p
        out = torch.empty_like(p)
        src, dst = p.reshape(-1, *p.shape[-2:]), out.view(-1, *p.shape[-2:])
        for i in range(src.shape[0]):
            z = torch.randn(src.shape[1:], generator=gen, device=dev)
            dst[i] = src[i] + (noise * z).to(p.dtype)
        return out

    return map_with_paths(fn, base)


def run(cfg, *, device, seed: int = 0, batch: int = 2, seq: int = 16,
        verbose: bool = True) -> dict:
    """Compress, serve separately and merged, compare. Returns the
    separate computation's logits and the comparison."""
    say = print if verbose else (lambda *a: None)
    base = lm.init_params(cfg, seed, device=device)
    ft = perturb(base, NOISE, seed + 1)
    deltas, report = compress(base, ft, SPEC)
    del ft
    say(report.summary())

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=device)
    with torch.inference_mode():
        sep = lm.forward(cfg, base, {"tokens": tokens}, deltas=deltas)
        plain = lm.forward(cfg, base, {"tokens": tokens})
        base = tree_map(lambda p: p.to(torch.float32), base)
        merged = decompress(base, deltas)
        del base
        mrg = lm.forward(cfg, merged, {"tokens": tokens})
        del merged
    err = (sep - mrg).abs().max().item()
    scale = sep.abs().max().item()
    gap = (sep - plain).abs().max().item()
    say(f"separate computation == merged weights: max |logit diff| = {err:.2e} "
        f"(rel {err / scale:.2e}, bound {REL_TOL}); the delta moves the logits by "
        f"{gap:.2e}")
    return {"separate": sep, "rel": err / scale, "delta_gap": gap,
            "ok": err <= REL_TOL * scale and err < 0.1 * gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help=f"the full {ARCH} width instead of its smoke config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_config(ARCH) if args.full else get_smoke_config(ARCH)
    out = run(cfg, device=args.device, seed=args.seed)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
