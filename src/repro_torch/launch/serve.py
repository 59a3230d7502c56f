"""Serving launcher: base model + N DeltaDQ tenants (port of
``repro/launch/serve.py``).

Synthesizes fine-tuned variants of a random base model, compresses their
deltas at the requested ratio, and drives a mixed, staggered request
stream through the continuous-batching engine — the deployment of paper
Fig. 2 as a runnable process, with per-tenant metrics.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch wizard-llama2-7b --tenants 3 --requests 12 --slots 8 --max-seq 256

The request stream is the reference's: request i goes to tenant
``i % tenants`` with a prompt of ``4 + (i % 3) * 4`` tokens, arriving
``i * arrival_gap`` seconds in; the prompt tokens are drawn from a numpy
generator seeded with ``100 + i``. Other codecs, the lifecycle drill,
meshes, residency and the identity check against a mesh engine are not
ported yet.

:data:`RATIO_SPECS` maps a target compression ratio to its DeltaDQ spec,
and :func:`synth_tenants` makes fine-tuned variants of a base model and
compresses their deltas.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core.codecs import DeltaDQSpec, codec_for_spec
from repro_torch.core.compress import (
    CompressionReport,
    compress_leaf_layerwise,
    is_compressible,
    leaf_generator,
)
from repro_torch.utils import map_with_paths, tree_bytes

RATIO_SPECS = {
    8: DeltaDQSpec(alpha=8.0, k_bits=None, h_g=16),
    16: DeltaDQSpec(alpha=8.0, k_bits=8, m=1, h_g=16),
    32: DeltaDQSpec(alpha=8.0, k_bits=4, m=1, h_g=16),
    64: DeltaDQSpec(alpha=8.0, k_bits=4, m=4, h_g=16),
    128: DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16),
}


def synth_tenants(cfg, base: dict, n: int, spec: DeltaDQSpec, seed: int = 0,
                  *, noise: float = 0.02) -> list:
    """Synthesize n fine-tuned variants and compress their deltas.

    Tenant t's weight matrix is ``w + noise * N(0, 1)`` (the noise cast to
    the weight's dtype first, as the reference does), drawn from a
    generator seeded with ``seed + 7 + t``. The fine-tuned weights are
    made one matrix at a time on the base's device and compressed at
    once, so no second full-size model is ever held. Leaves that stay
    dense (embeddings, norms) are not perturbed: their deltas would be
    dropped anyway. Returns ``[(name, deltas, report)]``.
    """
    codec = codec_for_spec(spec)
    out = []
    for t in range(n):
        report = CompressionReport(spec=spec)

        def fn(path: str, b: torch.Tensor, gen=None):
            if not is_compressible(path, b):
                report.skip(path)
                return None
            flat = b.reshape(-1, *b.shape[-2:])

            def ft_slice(i: int) -> torch.Tensor:
                z = torch.randn(flat.shape[1:], generator=gen, device=b.device,
                                dtype=torch.float32)
                return flat[i] + (noise * z).to(b.dtype)

            d = compress_leaf_layerwise(
                codec, spec, b, ft_slice,
                generator=leaf_generator(spec.seed, path, b.device))
            report.add_leaf(path, codec, d)
            return d

        noise_gen = torch.Generator(device=base["embed"]["tok"].device)
        noise_gen.manual_seed(seed + 7 + t)
        deltas = map_with_paths(lambda p, b: fn(p, b, noise_gen), base)
        out.append((f"tenant{t}", deltas, report))
    return out


def request_stream(cfg, n_requests: int, n_tenants: int) -> list:
    """[(tenant, prompt)]: mixed prompt lengths -> several buckets."""
    out = []
    for i in range(n_requests):
        L = 4 + (i % 3) * 4
        prompt = np.random.default_rng(100 + i).integers(0, cfg.vocab, L)
        out.append((f"tenant{i % n_tenants}", prompt.astype(np.int32)))
    return out


def main(argv=None) -> int:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of the smoke config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--ratio", type=int, default=128, choices=sorted(RATIO_SPECS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--arrival-gap", type=float, default=0.05,
                    help="seconds between request arrivals (staggered stream)")
    ap.add_argument("--json", action="store_true",
                    help="print the metrics report as JSON")
    ap.add_argument("--print-tokens", action="store_true",
                    help="print every request's generated tokens")
    ap.add_argument("--chunked", action="store_true",
                    help="chunked prefill: prompts stream in --chunk-size "
                         "token chunks inside the decode step")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prompt tokens per prefill chunk (--chunked)")
    ap.add_argument("--chunk-share", type=float, default=1.0,
                    help="max fraction of decode-active steps that may "
                         "carry a prefill chunk (--chunked)")
    ap.add_argument("--admission", default="occupancy",
                    choices=("occupancy", "affinity"),
                    help="slot admission policy (one slot pool: both place "
                         "the same way until data-parallel pools exist)")
    ap.add_argument("--trace-out", metavar="FILE", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="keep every Nth decode-step span in the trace")
    ap.add_argument("--telemetry-snapshot-secs", type=float, default=0.0,
                    help="write a JSON telemetry snapshot every N seconds of "
                         "engine time; 0 disables")
    ap.add_argument("--telemetry-out", metavar="FILE", default="telemetry.json",
                    help="snapshot file for --telemetry-snapshot-secs")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    base = lm.init_params(cfg, 0, device=args.device)
    tenants = synth_tenants(cfg, base, args.tenants, RATIO_SPECS[args.ratio], seed=0)
    stream = request_stream(cfg, args.requests, args.tenants)

    kw = {}
    if args.trace_out:
        from repro_torch.serve.trace import Tracer
        kw["trace"] = Tracer(step_sample=args.trace_sample)
    if args.telemetry_snapshot_secs > 0:
        from repro_torch.serve.telemetry import SLOCounters, TelemetrySnapshotWriter
        kw["slo"] = SLOCounters()
        kw["telemetry"] = TelemetrySnapshotWriter(args.telemetry_out,
                                                  args.telemetry_snapshot_secs)
    for name, _, report in tenants:
        print(f"registered {name}: {report.summary()}", flush=True)
    eng = ContinuousEngine(cfg, base, n_slots=args.slots, max_seq=args.max_seq,
                           admission=args.admission,
                           chunked_prefill=args.chunked, chunk_size=args.chunk_size,
                           chunk_share=args.chunk_share, **kw)
    for name, deltas, report in tenants:
        eng.register_tenant(name, deltas, report)
    reqs = [eng.submit(tenant, prompt, max_new_tokens=args.max_new,
                       arrival=i * args.arrival_gap)
            for i, (tenant, prompt) in enumerate(stream)]
    rep = eng.run().report()
    undone = [r.rid for r in reqs if not r.done]
    if undone:
        raise RuntimeError(f"engine run() left requests {undone} unfinished")

    if args.print_tokens:
        for r in reqs:
            print(f"tokens {r.rid} {r.tenant}: {' '.join(map(str, r.output()))}")
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        # occupancy (and, with a zero-width wall clock, tokens/sec) is
        # None when no decode step ran, e.g. --max-new 1
        tps = "n/a" if rep["tokens_per_sec"] is None \
            else f"{rep['tokens_per_sec']:.0f}"
        occ = "n/a" if rep["batch_occupancy"] is None \
            else f"{rep['batch_occupancy']:.2f}"
        print(f"served {len(reqs)} requests / {rep['total_tokens']} tokens in "
              f"{rep['wall_time_s']:.2f}s "
              f"({tps} tok/s, occupancy {occ}, "
              f"{len(eng.prefill_shapes)} prefill shapes)")
        for name, t in rep["tenants"].items():
            print(f"  {name}: {t['requests']} reqs, {t['tokens']} toks, "
                  f"ttft p50 {1e3 * t['ttft_p50']:.0f}ms "
                  f"latency p95 {1e3 * t['latency_p95']:.0f}ms")

    if eng.trace is not None:
        trace = eng.trace.export(args.trace_out)
        from repro_torch.serve.trace import validate_chrome_trace
        problems = validate_chrome_trace(trace)
        if problems:
            raise SystemExit("emitted trace failed validation: " + "; ".join(problems))
        n_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        print(f"trace: {args.trace_out} ({n_spans} spans, "
              f"{eng.trace.n_request_spans} requests)", flush=True)
    if eng.telemetry is not None:
        # final snapshot at drain so the file always reflects the full run
        eng.telemetry.write(rep["wall_time_s"], eng._telemetry_payload())
        print(f"telemetry: {args.telemetry_out} "
              f"({eng.telemetry.n_written} snapshots)", flush=True)

    base_bytes = tree_bytes(base)
    n = len(eng.store.ordered())
    print(f"memory: base {base_bytes / 1e6:.1f}MB + deltas "
          f"{eng.store.total_bytes() / 1e6:.2f}MB vs {n} full models "
          f"{base_bytes * n / 1e6:.1f}MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
