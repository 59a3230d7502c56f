"""Multi-tenant serving demo: one base, many fine-tunes, mixed live stream
(the port's twin of ``examples/multi_tenant_serving.py``).

Simulates the paper's deployment (Fig. 2): N tenants fine-tuned for
different "skills" register 128x-compressed deltas with one
continuous-batching engine; a staggered mixed request stream is served
with slot-level scheduling — one decode step advances sequences belonging
to *different* tenants, each corrected by its own packed delta. Request
0's tokens are streamed as they are made.

    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_serving --device cpu
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_serving   # on the card
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import DeltaDQSpec
from repro_torch.launch.serve import synth_tenants
from repro_torch.models import lm
from repro_torch.serve import ContinuousEngine, Engine
from repro_torch.utils import tree_bytes

ARCH = "llama3.2-1b"
SPEC = DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16)   # 128x
MAX_SEQ, PROMPT_LEN, MAX_NEW = 48, 8, 8
SEED = 0


def run(args) -> dict:
    """Serve the stream; -> the metrics report, request 0's streamed
    tokens and the distinct generations of one prompt across tenants."""
    cfg = get_smoke_config(ARCH)
    base = lm.init_params(cfg, SEED, device=args.device)
    eng = ContinuousEngine(cfg, base, n_slots=args.slots, max_seq=MAX_SEQ)

    print(f"registering {args.tenants} tenants at 128x delta compression ...")
    for name, deltas, report in synth_tenants(cfg, base, args.tenants, SPEC,
                                              seed=SEED):
        eng.register_tenant(name, deltas, report)
        print(f"  {name}: {report.summary()}")

    # staggered mixed request stream with token streaming on request 0
    streamed = []

    def stream(req, tok, done):
        streamed.append(int(tok))
        print(f"  [stream r{req.rid}] token {tok}{' <done>' if done else ''}")

    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
        reqs.append(eng.submit(f"tenant{i % args.tenants}", prompt,
                               max_new_tokens=MAX_NEW, arrival=0.01 * i,
                               on_token=stream if i == 0 else None))

    rep = eng.run().report()
    print(f"served {len(reqs)} requests across {args.tenants} tenants in "
          f"{rep['wall_time_s']:.1f}s ({args.device}): "
          f"{rep['tokens_per_sec']:.0f} tok/s, "
          f"occupancy {rep['batch_occupancy']:.2f}, "
          f"{rep['decode_steps']} decode steps for {rep['prefills']} prefills")
    for name, t in rep["tenants"].items():
        print(f"  {name}: {t['requests']} reqs, ttft p50 "
              f"{1e3 * t['ttft_p50']:.0f}ms, latency p95 "
              f"{1e3 * t['latency_p95']:.0f}ms")

    # different tenants produce different generations for the same prompt
    ref = Engine(cfg, base, max_seq=MAX_SEQ)
    ref.store = eng.store
    same_prompt = reqs[0].prompt
    gens = {t: ref.generate(f"tenant{t}", same_prompt[None], max_new_tokens=MAX_NEW)[0]
            for t in range(min(args.tenants, 3))}
    uniq = {tuple(g.tolist()) for g in gens.values()}
    print(f"distinct generations for one prompt across tenants: {len(uniq)}/{len(gens)}")

    base_bytes = tree_bytes(base)
    delta_bytes = eng.store.total_bytes()
    n = args.tenants
    print(f"memory ledger: base {base_bytes / 1e6:.1f}MB + "
          f"{n} deltas {delta_bytes / 1e6:.2f}MB  "
          f"vs naive {n} full models {base_bytes * n / 1e6:.1f}MB  "
          f"=> {(base_bytes * n) / (base_bytes + delta_bytes):.1f}x saving")
    return {"report": rep, "streamed": streamed, "request0": reqs[0].output(),
            "distinct": len(uniq), "generations": gens}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
