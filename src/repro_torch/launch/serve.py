"""Serving launcher: base model + N tenants of any codec (port of
``repro/launch/serve.py``).

Synthesizes fine-tuned variants of a random base model, compresses their
deltas, and drives a mixed, staggered request stream through the
continuous-batching engine — the deployment of paper Fig. 2 as a runnable
process, with per-tenant metrics.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # smoke config
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch wizard-llama2-7b --tenants 3 --requests 12 --slots 8 --max-seq 256
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --tenants 3 --codec mixed --check-identity
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --tenants 3 --lifecycle --check-identity --strict-compile
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --devices 4 --data 2 --check-identity

The request stream is the reference's: request i goes to tenant
``i % tenants`` with a prompt of ``4 + (i % 3) * 4`` tokens, arriving
``i * arrival_gap`` seconds in; the prompt tokens are drawn from a numpy
generator seeded with ``100 + i``. ``--codec`` picks each tenant's codec
(``mixed`` alternates DeltaDQ and BitDelta: one engine, two codec
groups); ``--residency-mb`` gives the engine a :class:`DeltaResidency`
budget (pre-decoded tenant values; served on the CPU, accounted on the
card); ``--check-identity`` serves the stream again on the default path
(whole-prompt prefill, no residency) when ``--chunked`` or
``--residency-mb`` is set, and each tenant alone when ``--codec mixed``,
and fails unless every request's tokens match; ``--lifecycle`` runs the
online-lifecycle drill (:func:`run_lifecycle`, whose zero-retrace gate
is ``analysis.CompileGuard``); ``--strict-compile`` attaches a strict
``CompileGuard`` to the serving engine, so a new signature of a seen
call (a retrace in the reference) raises where it happens.

``--devices N --data D`` serves sharded: the launcher spawns N ranks
itself (``launch.mesh.run_ranks``: ``torch.multiprocessing``, start
method ``spawn``, a file rendezvous, a deadline on the whole world and a
timeout on every collective), joins them into a ``(D, N/D)``
``(data, model)`` mesh (``launch.mesh.make_serving_mesh``; nccl with a
card per rank, gloo on the CPU or with ranks sharing a card), and every
rank serves the stream with ``ContinuousEngine(mesh=)``. Rank 0 prints
the mesh shape and the usual report; ``--check-identity`` also serves
the stream unsharded on every rank and fails unless the tokens match.

:data:`RATIO_SPECS` maps a target compression ratio to its DeltaDQ spec,
and :func:`synth_tenants` makes fine-tuned variants of a base model and
compresses their deltas.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.analysis import CompileBudgetError, CompileGuard
from repro_torch.core.codecs import BitDeltaSpec, DeltaDQSpec, codec_for_spec, get_codec
from repro_torch.core.compress import (
    CompressionReport,
    auto_candidates,
    compress_leaf_any,
    is_compressible,
)
from repro_torch.utils import map_with_paths, tree_bytes

RATIO_SPECS = {
    8: DeltaDQSpec(alpha=8.0, k_bits=None, h_g=16),
    16: DeltaDQSpec(alpha=8.0, k_bits=8, m=1, h_g=16),
    32: DeltaDQSpec(alpha=8.0, k_bits=4, m=1, h_g=16),
    64: DeltaDQSpec(alpha=8.0, k_bits=4, m=4, h_g=16),
    128: DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=16),
}


def _perturbed(b: torch.Tensor, gen: torch.Generator, noise: float):
    """ft_slice(i) of ``w + noise * N(0, 1)`` for layer slice i of ``b``
    (the noise cast to the weight's dtype first, as the reference does)."""
    flat = b.reshape(-1, *b.shape[-2:])

    def ft_slice(i: int) -> torch.Tensor:
        z = torch.randn(flat.shape[1:], generator=gen, device=b.device,
                        dtype=torch.float32)
        return flat[i] + (noise * z).to(b.dtype)

    return ft_slice


def synth_tenants(cfg, base: dict, n: int, spec, seed: int = 0, *,
                  noise: float = 0.02, budget_bits: float | None = None) -> list:
    """Synthesize n fine-tuned variants and compress their deltas.

    ``spec`` is one codec spec (every tenant), a list of n per-tenant
    specs (mixed-codec fleets), or a codec name (``"deltadq"``,
    ``"bitdelta"``, ``"lowrank"`` at their default specs, or ``"auto"``,
    which takes ``budget_bits``). Tenant t's weight matrix is
    ``w + noise * N(0, 1)``, drawn from a generator seeded with
    ``seed + 7 + t``, so a tenant's fine-tuned weights do not depend on
    its codec. They are made one matrix at a time on the base's device
    and compressed at once (a whole leaf at a time for ``"auto"``, whose
    candidates each read it), so no second full-size model is ever held.
    Leaves that stay dense (embeddings, norms) are not perturbed: their
    deltas would be dropped anyway. Returns ``[(name, deltas, report)]``.
    """
    specs = spec if isinstance(spec, list) else [spec] * n
    if len(specs) != n:
        raise ValueError(f"{len(specs)} codec specs for {n} tenants")
    out = []
    for t in range(n):
        sp, codec, candidates = specs[t], None, None
        if sp == "auto":
            if budget_bits is None:
                raise ValueError("codec 'auto' requires budget_bits")
            sp, candidates = None, auto_candidates()
            report = CompressionReport(spec=None, budget_bits=budget_bits)
        else:
            if isinstance(sp, str):
                sp = get_codec(sp).default_spec()
            codec = codec_for_spec(sp)
            report = CompressionReport(spec=sp)

        def fn(path: str, b: torch.Tensor, gen=None):
            if not is_compressible(path, b):
                report.skip(path)
                return None
            ft_slice = _perturbed(b, gen, noise)
            if candidates is not None:
                f = [ft_slice(i) for i in range(b.reshape(-1, *b.shape[-2:]).shape[0])]
                ft_slice = f.__getitem__
            res = compress_leaf_any(path, b, ft_slice, spec=sp, codec=codec,
                                    seed=getattr(sp, "seed", 0), candidates=candidates,
                                    budget_bits=budget_bits)
            report.account(path, res)
            return res[0]

        noise_gen = torch.Generator(device=base["embed"]["tok"].device)
        noise_gen.manual_seed(seed + 7 + t)
        deltas = map_with_paths(lambda p, b: fn(p, b, noise_gen), base)
        out.append((f"tenant{t}", deltas, report))
    return out


def synth_ft(base: dict, seed: int, *, noise: float = 0.02) -> dict:
    """One fine-tuned variant as a whole params tree: every compressible
    matrix ``w + noise * N(0, 1)`` from a generator seeded with ``seed``
    (drawn in the order :func:`synth_tenants` draws, so
    ``synth_ft(base, s + 7 + t)`` is tenant t's model), the other leaves
    shared with ``base``."""
    gen = torch.Generator(device=base["embed"]["tok"].device)
    gen.manual_seed(seed)

    def fn(path: str, b: torch.Tensor):
        if not is_compressible(path, b):
            return b
        ft_slice = _perturbed(b, gen, noise)
        n = b.reshape(-1, *b.shape[-2:]).shape[0]
        return torch.stack([ft_slice(i) for i in range(n)]).reshape(b.shape)

    return map_with_paths(fn, base)


def request_stream(cfg, n_requests: int, n_tenants: int) -> list:
    """[(tenant, prompt)]: mixed prompt lengths -> several buckets."""
    out = []
    for i in range(n_requests):
        L = 4 + (i % 3) * 4
        prompt = np.random.default_rng(100 + i).integers(0, cfg.vocab, L)
        out.append((f"tenant{i % n_tenants}", prompt.astype(np.int32)))
    return out


def tenant_specs(codec: str, n: int, ratio: int = 128) -> list:
    """Per-tenant spec list for ``--codec``: ``deltadq`` keeps the ratio
    spec table, ``mixed`` alternates DeltaDQ (even tenants) and BitDelta
    (odd), the other names go to every tenant as they are."""
    if codec == "deltadq":
        return [RATIO_SPECS[ratio]] * n
    if codec == "mixed":
        return [RATIO_SPECS[ratio] if t % 2 == 0 else BitDeltaSpec() for t in range(n)]
    return [codec] * n


def _engine_kw(args) -> dict:
    from repro_torch.serve import residency_bytes_from_mb
    return dict(n_slots=args.slots, max_seq=args.max_seq, admission=args.admission,
                chunked_prefill=args.chunked, chunk_size=args.chunk_size,
                chunk_share=args.chunk_share,
                residency_budget_bytes=residency_bytes_from_mb(args.residency_mb))


def _serve_stream(cfg, base, tenants, stream, args, *, default_path=False, **kw):
    """One engine over ``tenants`` serving ``stream`` at its arrivals; the
    default path is whole-prompt prefill without residency.
    -> (engine, requests)."""
    from repro_torch.serve import ContinuousEngine
    ekw = _engine_kw(args)
    if default_path:
        ekw.update(chunked_prefill=False, residency_budget_bytes=None)
    eng = ContinuousEngine(cfg, base, **ekw, **kw)
    guard = None
    if args.strict_compile and not default_path:
        # fresh engine: every first signature is first=True and allowed;
        # strict mode raises only on a new signature of a seen call
        guard = CompileGuard(eng, strict=True, label="serve").attach()
    for name, deltas, report in tenants:
        eng.register_tenant(name, deltas, report)
    reqs = [eng.submit(tenant, prompt, max_new_tokens=args.max_new,
                       arrival=i * args.arrival_gap)
            for i, (tenant, prompt) in enumerate(stream)]
    eng.run()
    if guard is not None:
        guard.detach()
    undone = [r.rid for r in reqs if not r.done]
    if undone:
        raise RuntimeError(f"engine run() left requests {undone} unfinished")
    return eng, reqs


def run_lifecycle(args, cfg, base) -> dict:
    """Online-lifecycle drill: the fleet registers INTO a running engine.

    tenant0 is compressed and registered up front and starts serving;
    tenants 1..N-1 then arrive as raw fine-tuned models mid-traffic and
    are compressed and hot-registered by the :class:`DeltaRegistry` while
    tenant0's sequences keep decoding. Afterwards tenant0 rolls out a v2
    (new requests only) and tenant1 is retired. The drill fails on any
    re-stack or new decode signature after warm-up (``CompileGuard``'s
    ``max_new={"decode": 0}``, the reference's zero decode recompiles;
    with ``--strict-compile`` it raises at the call). With ``--check-identity`` every
    request is also held token-identical to engines built with the same
    tenant versions up front. Returns the metrics report."""
    from repro_torch.serve import ContinuousEngine, DeltaRegistry, VirtualClock

    spec = RATIO_SPECS[args.ratio]
    n = args.tenants
    stream = request_stream(cfg, args.requests, n)

    # +1 row so the rollout lands without evicting anyone
    eng = ContinuousEngine(cfg, base, n_slots=args.slots, max_seq=args.max_seq,
                           tenant_capacity=n + 1, clock=VirtualClock(tick=1e-3))
    reg = DeltaRegistry(eng, base, spec=spec, codec=None)
    # each fine-tuned model is made when it arrives (one at a time: a
    # full-width model is as large as the base)
    reg.ingest("tenant0", synth_ft(base, 7))
    reg.pump()
    phase_a = [(i, reg.submit(t, p, max_new_tokens=args.max_new))
               for i, (t, p) in enumerate(stream) if t == "tenant0"]
    for _ in range(2):
        eng.step(eng._now())            # tenant0 genuinely in flight
    # warm-up done: from here the decode step must see no new signature
    guard = CompileGuard(eng, max_new={"decode": 0}, strict=args.strict_compile,
                         label="lifecycle").attach()
    restacks0 = eng.restacks
    for t in range(1, n):
        name = f"tenant{t}"
        reg.ingest(name, synth_ft(base, 7 + t))
        reg.pump()
        rec = reg._records[name]
        print(f"hot-registered {name}: compress {rec.compress_s:.2f}s, "
              f"register {1e3 * rec.register_s:.1f}ms", flush=True)
        phase_a += [(i, reg.submit(tn, p, max_new_tokens=args.max_new))
                    for i, (tn, p) in enumerate(stream) if tn == name]
        eng.step(eng._now())
    eng.run()
    undone = [r.rid for _, r in phase_a if not r.done]
    if undone:
        raise RuntimeError(f"lifecycle phase A left requests {undone} unfinished")

    # rollout: tenant0 v2 serves NEW requests only; then retire tenant1
    reg.ingest("tenant0", synth_ft(base, 777))     # tenant0's v2
    reg.pump()
    phase_b = [(i, eng.submit("tenant0", p, max_new_tokens=args.max_new))
               for i, (t, p) in enumerate(stream) if t == "tenant0"][:2]
    eng.run()
    undone = [r.rid for _, r in phase_b if not r.done]
    if undone:
        raise RuntimeError(f"lifecycle phase B left requests {undone} unfinished")
    if n > 1:
        eng.unregister_tenant("tenant1")

    guard.detach()
    retraces = guard.new_compiles("decode")
    restacks = eng.restacks - restacks0
    rep = eng.metrics.report()
    print(f"lifecycle events: {rep['tenant_lifecycle']}")
    print(f"decode-step jit_trace events across register/rollout/retire: {retraces}; "
          f"re-stacks: {restacks}; CompileGuard {guard.report()}")
    try:
        guard.check()
    except CompileBudgetError as e:
        raise SystemExit(f"the hot lifecycle retraced the decode step: {e}")
    if restacks:
        raise SystemExit(f"the hot lifecycle re-stacked the tenant rows {restacks} times")

    if args.check_identity:
        # registration time must not change tokens: engines holding the
        # SAME tenant versions (the registry's copies) up front serve the
        # same prompts
        recs = reg._records
        v1 = {f"tenant{t}": recs[f"tenant{t}"].host for t in range(1, n)}
        v1["tenant0"] = recs["tenant0"].prev

        def ref_engine(deltas_by_name):
            e = ContinuousEngine(cfg, base, n_slots=args.slots, max_seq=args.max_seq,
                                 tenant_capacity=n + 1, clock=VirtualClock(tick=1e-3))
            for name, d in deltas_by_name.items():
                e.register_tenant(name, d)
            return e

        ref = ref_engine(v1)
        ref_a = [ref.submit(stream[i][0], stream[i][1], max_new_tokens=args.max_new)
                 for i, _ in phase_a]
        ref.run()
        ref2 = ref_engine({"tenant0": recs["tenant0"].host})
        ref_b = [ref2.submit("tenant0", stream[i][1], max_new_tokens=args.max_new)
                 for i, _ in phase_b]
        ref2.run()
        bad = [r.rid for (_, r), s in zip(phase_a + phase_b, ref_a + ref_b)
               if not np.array_equal(r.output(), s.output())]
        if bad:
            raise SystemExit(f"lifecycle token identity FAILED for requests {bad}")
        print(f"token identity vs up-front engines: OK "
              f"({len(phase_a)} + {len(phase_b)} requests)", flush=True)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print(f"served {len(phase_a) + len(phase_b)} requests / "
              f"{rep['total_tokens']} tokens across the lifecycle drill")
    return rep


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of the smoke config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--ratio", type=int, default=128, choices=sorted(RATIO_SPECS))
    ap.add_argument("--codec", default="deltadq",
                    choices=("deltadq", "bitdelta", "lowrank", "auto", "mixed"),
                    help="delta codec for every tenant: 'deltadq' keeps the --ratio "
                         "spec table; 'bitdelta'/'lowrank' use those codecs' defaults; "
                         "'auto' per-leaf picks the cheapest codec meeting "
                         "--budget-bits; 'mixed' alternates DeltaDQ/BitDelta across "
                         "tenants (one engine, two codec groups)")
    ap.add_argument("--budget-bits", type=float, default=None,
                    help="per-element bit budget for --codec auto")
    ap.add_argument("--lifecycle", action="store_true",
                    help="online-lifecycle drill: tenant0 serves while the rest of "
                         "the fleet is compressed and hot-registered mid-traffic, "
                         "then a tenant0 version rollout and a tenant1 retirement; "
                         "fails on any re-stack or decode-step jit_trace after "
                         "warm-up")
    ap.add_argument("--check-identity", action="store_true",
                    help="with --chunked, serve the stream again with whole-prompt "
                         "prefill; with --codec mixed, serve each tenant's requests "
                         "on an engine holding only that tenant; with --lifecycle, "
                         "against engines holding the tenant versions up front; "
                         "fail unless every request's tokens match")
    ap.add_argument("--strict-compile", action="store_true",
                    help="attach a strict CompileGuard to the serving engine: a new "
                         "signature of an already-seen call (a retrace in the "
                         "reference) raises at that call; with --lifecycle, the "
                         "drill's post-warm-up gate also raises at the call")
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
    ap.add_argument("--residency-mb", type=float, default=0.0,
                    help="pre-decoded delta residency budget in MB: hot "
                         "tenants' dequantized f32 delta values stay "
                         "resident (LRU) and decode steps on the CPU skip "
                         "the per-step unpack; 0 disables the tier")
    ap.add_argument("--admission", default="occupancy",
                    choices=("occupancy", "affinity"),
                    help="shard admission policy: 'occupancy' (balanced) or "
                         "'affinity' (prefer the pool already hosting the "
                         "request's tenant within a bounded imbalance); with one "
                         "pool both place the same way")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the base over N ranks, spawned by this launcher "
                         "((data, N/data) mesh over torch.distributed)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-axis extent of the serving mesh: slot rows split "
                         "into `data` contiguous pools (requires --devices and "
                         "--slots divisible by data)")
    ap.add_argument("--trace-out", metavar="FILE", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="keep every Nth decode-step span in the trace")
    ap.add_argument("--telemetry-snapshot-secs", type=float, default=0.0,
                    help="write a JSON telemetry snapshot every N seconds of "
                         "engine time; 0 disables")
    ap.add_argument("--telemetry-out", metavar="FILE", default="telemetry.json",
                    help="snapshot file for --telemetry-snapshot-secs")
    return ap


def main(argv=None) -> int:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.data > 1 and args.devices % args.data:
        raise SystemExit(f"--devices {args.devices} must be a multiple of "
                         f"--data {args.data}")
    if args.data > 1 and args.slots % args.data:
        raise SystemExit(f"--slots {args.slots} must be a multiple of "
                         f"--data {args.data} (equal shard pools)")
    if args.devices <= 1:
        if args.data > 1:
            raise SystemExit("--data > 1 requires --devices > 1 (the shard "
                             "pools mirror the mesh data axis)")
        return _run(args, None)
    if args.lifecycle:
        raise SystemExit("--lifecycle runs single-device (the drill "
                         "measures lifecycle, not sharding)")
    from repro_torch.launch.mesh import run_ranks
    try:
        codes = run_ranks(_rank_main, args.devices, (argv,), device=args.device,
                          timeout_s=RANKS_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        print(f"serve: {e}", file=sys.stderr, flush=True)
        return 1
    return max(codes)


# the whole world's deadline (a rank's collectives each have their own)
RANKS_TIMEOUT_S = 3600.0


def _rank_main(rank: int, world: int, argv: list) -> int:
    """One spawned rank of ``--devices``: join the mesh, serve the stream
    on it; only rank 0 prints."""
    import contextlib
    import io

    from repro_torch.launch.mesh import make_serving_mesh
    args = _parser().parse_args(argv)
    mesh = make_serving_mesh(world, data=args.data, device=args.device)
    if rank == 0:
        print(f"mesh: {mesh.shape} ({mesh.backend}, transport {mesh.transport})",
              flush=True)
        return _run(args, mesh)
    with contextlib.redirect_stdout(io.StringIO()):
        return _run(args, mesh)


def _run(args, mesh) -> int:
    """Serve the stream (on ``mesh``, or on one device)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    base = lm.init_params(cfg, 0, device=args.device)
    if args.lifecycle:
        run_lifecycle(args, cfg, base)
        return 0
    if args.codec == "auto" and args.budget_bits is None:
        raise SystemExit("--codec auto needs --budget-bits")
    nondefault = args.chunked or args.residency_mb > 0
    if args.check_identity and mesh is None and not (nondefault or args.codec == "mixed"):
        raise SystemExit("--check-identity requires --devices N > 1, --chunked, "
                         "--residency-mb > 0 or --codec mixed (nothing to compare "
                         "against otherwise)")
    tenants = synth_tenants(cfg, base, args.tenants,
                            tenant_specs(args.codec, args.tenants, args.ratio),
                            seed=0, budget_bits=args.budget_bits)
    stream = request_stream(cfg, args.requests, args.tenants)

    ref_reqs = None
    if args.check_identity and (nondefault or mesh is not None):
        # the unsharded default path first, on every rank alike
        _, ref_reqs = _serve_stream(cfg, base, tenants, stream, args, default_path=True)

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
    eng, reqs = _serve_stream(cfg, base, tenants, stream, args, mesh=mesh, **kw)
    rep = eng.metrics.report()

    if ref_reqs is not None:
        bad = [r.rid for r, s in zip(reqs, ref_reqs)
               if not np.array_equal(r.output(), s.output())]
        if bad:
            raise SystemExit(f"token identity FAILED for requests {bad}")
        vs = "single device" if mesh is not None else "the default path"
        print(f"token identity vs {vs}: OK ({len(reqs)} requests)", flush=True)
    if args.check_identity and args.codec == "mixed":
        # mixed-codec contract: each request's tokens match an engine
        # serving ONLY that tenant (same prompts, same arrivals per tenant)
        # — the other codec group's zero row contributes exactly 0.0
        bad = []
        for name, deltas, report in tenants:
            mine = [(i, r) for i, r in enumerate(reqs) if r.tenant == name]
            eng_a = ContinuousEngine(cfg, base, mesh=mesh, **_engine_kw(args))
            eng_a.register_tenant(name, deltas, report)
            alone = [eng_a.submit(name, stream[i][1], max_new_tokens=args.max_new,
                                  arrival=k * args.arrival_gap)
                     for k, (i, _) in enumerate(mine)]
            eng_a.run()
            bad += [r.rid for (_, r), s in zip(mine, alone)
                    if not np.array_equal(r.output(), s.output())]
        if bad:
            raise SystemExit(f"mixed-codec identity FAILED for requests {bad}")
        print(f"token identity vs per-tenant-alone engines: OK "
              f"({len(reqs)} requests, {len(eng._groups)} codec groups)", flush=True)

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
        if rep.get("residency"):
            r_ = rep["residency"]
            hr = "n/a" if r_.get("hit_rate") is None else f"{r_['hit_rate']:.2f}"
            print(f"  residency: {r_.get('resident_rows')}/"
                  f"{r_.get('capacity_rows')} rows resident "
                  f"({(r_.get('allocated_bytes') or 0) / 1e6:.2f}MB "
                  f"allocated), hit rate {hr}, {r_['value_steps']} value / "
                  f"{r_['packed_steps']} packed steps")

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
