"""Engine cases for the port's serving mesh, built (:func:`build_cases`,
from seeds) and run by every rank of one spawned world
(``tests/test_torch_mesh_engine.py``) and, unsharded, by the test process
itself: the same inputs through :func:`serve` with and without a mesh
must give the same tokens.

A case is a plain dict: ``cfg``, ``base``, ``tenants`` [(name, deltas, report)],
``requests`` [(tenant, prompt, arrival, max_new)] or ``waves`` (lists of
those, each drained before the next), ``engine`` (ContinuousEngine
keywords), ``data`` (the mesh's data extent) and ``kind`` (what else the
case reads back). Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io

import numpy as np

WORLD = 4
# the serving CLI as every rank of the world runs it (``--devices`` WORLD)
CLI_ARGV = ("--device", "cpu", "--requests", "3", "--max-new", "3", "--arrival-gap", "0",
            "--devices", str(WORLD), "--data", "2", "--check-identity")


@functools.lru_cache(maxsize=None)
def port_fleet(arch, n, ratio=128, codecs=None, f32=False):
    """(cfg, base, tenants) of a smoke config from seed 0: ``n`` tenants at
    ``ratio`` (``codecs`` picks DeltaDQ or BitDelta per tenant); ``f32``
    takes the config in float32 (the fleet the reference is held to)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.codecs import BitDeltaSpec
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32")
    if arch == "qwen3-moe-30b-a3b":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    base = lm.init_params(cfg, 0, device="cpu")
    specs = [RATIO_SPECS[ratio] if c == "deltadq" else BitDeltaSpec()
             for c in codecs] if codecs else RATIO_SPECS[ratio]
    return cfg, base, synth_tenants(cfg, base, n, specs, seed=0)


def _requests(vocab, n, seed, *, lengths=lambda i: 4 + (i % 3) * 4, tenant=None,
              max_new=3, gap=0.05):
    ps = prompts(vocab, [lengths(i) for i in range(n)], seed)
    pick = tenant or (lambda i: None if i % 4 == 3 else f"tenant{i % 3}")
    return [(pick(i), p, gap * i, max_new) for i, p in enumerate(ps)]


def serve(case: dict, mesh=None, **overrides) -> dict:
    """One engine over ``case`` (on ``mesh``, or unsharded): every wave's
    requests submitted at their arrivals and drained. -> {"tokens":
    [[...]] per request, plus what ``case["kind"]`` reads back}."""
    from repro_torch.core.pack import PackedDelta
    from repro_torch.serve import ContinuousEngine, VirtualClock
    from repro_torch.utils import iter_leaves

    kw = {**case["engine"], **overrides}
    eng = ContinuousEngine(case["cfg"], case["base"], clock=VirtualClock(tick=0.01),
                           mesh=mesh, **kw)
    for name, deltas, rep in case["tenants"]:
        eng.register_tenant(name, deltas, rep)
    out: dict = {"tokens": [], "parked": []}
    for wave in case.get("waves", [case.get("requests", [])]):
        reqs = [eng.submit(t, p, max_new_tokens=n, arrival=a) for t, p, a, n in wave]
        metrics = eng.run()
        if not all(r.done for r in reqs):
            raise RuntimeError("engine left requests unfinished")
        out["tokens"] += [r.output().tolist() for r in reqs]
        out["parked"].append(bool((eng._row == 0).all()))
    rep = metrics.report()
    out["residency"] = rep.get("residency")
    out["unique_per_shard"] = rep.get("unique_tenants_per_shard_mean")
    out["data"] = (eng.data, eng.sched.data_shards, eng.kv.rows)
    out["shards"] = sorted({(leaf.h_out, leaf.shards) for g in eng._groups
                            for _, leaf in iter_leaves(g.stacked)
                            if isinstance(leaf, PackedDelta)})
    out["groups"] = len(eng._groups)
    return out


def build_cases() -> dict:
    """Every case, from seeds (the same on every rank and in the test)."""
    out = {}
    tcfg, tbase, tten = port_fleet("llama3.2-1b", 3, f32=True)
    out["mixed_stream"] = dict(cfg=tcfg, base=tbase, tenants=tten, data=1,
                               requests=_requests(tcfg.vocab, 5, 100,
                                                  lengths=lambda i: 4 + (i % 2) * 4),
                               engine=dict(n_slots=4, max_seq=64))
    out["drain_refill"] = dict(
        cfg=tcfg, base=tbase, tenants=tten[:2], data=2, engine=dict(n_slots=4, max_seq=64),
        waves=[_requests(tcfg.vocab, 4, 50 + 10 * w, lengths=lambda i: 4 + (i % 2) * 4,
                         tenant=lambda i: f"tenant{i % 2}", gap=0.0) for w in range(2)])
    # wizard's 4 kv-heads: the rings shard over model 2
    cfg, base, ten = port_fleet("wizard-llama2-7b", 3)
    out["chunked_2x2"] = dict(cfg=cfg, base=base, tenants=ten, data=2,
                              requests=_requests(cfg.vocab, 4, 310),
                              engine=dict(n_slots=4, max_seq=64, chunked_prefill=True,
                                          chunk_size=4))
    cfg, base, ten = port_fleet("llama3.2-1b", 2, codecs=("deltadq", "bitdelta"))
    out["mixed_codecs"] = dict(
        cfg=cfg, base=base, tenants=ten, data=2, engine=dict(n_slots=4, max_seq=64),
        requests=_requests(cfg.vocab, 4, 100, lengths=lambda i: 4 + (i % 2) * 4,
                           tenant=lambda i: f"tenant{i % 2}"))
    cfg, base, ten = port_fleet("llama3.2-1b", 2)
    out["placement"] = dict(
        cfg=cfg, base=base, tenants=ten, data=1, kind="placement",
        engine=dict(n_slots=4, max_seq=64),
        requests=_requests(cfg.vocab, 4, 200, lengths=lambda i: 4 + (i % 2) * 4,
                           tenant=lambda i: None if i == 3 else f"tenant{i % 2}"))
    # at (2, 2) the 2 kv-heads shard: q/k/v are a rank's own columns, with a
    # whole (replicated) delta's correction cut to them
    out["placement_2x2"] = dict(out["placement"], data=2)
    out["coexist"] = dict(cfg=cfg, base=base, tenants=ten, data=1, kind="coexist",
                          engine=dict(n_slots=2, max_seq=64),
                          requests=_requests(cfg.vocab, 2, 40, lengths=lambda i: 6,
                                             tenant=lambda i: f"tenant{i % 2}", gap=0.0))
    cfg, base, ten = port_fleet("llama3.2-1b", 3, ratio=32)
    out["affinity_residency"] = dict(
        cfg=cfg, base=base, tenants=ten, data=2,
        engine=dict(n_slots=4, max_seq=32, admission="affinity",
                    residency_budget_bytes=64 << 20),
        requests=_requests(cfg.vocab, 6, 70, lengths=lambda i: 4 + (i % 2) * 4,
                           tenant=lambda i: f"tenant{i % 3}" if i % 4 else None,
                           gap=0.01))
    cfg, base, ten = port_fleet("qwen3-moe-30b-a3b", 1, ratio=8)
    ten = [(n, dict(d, moe=None), r) for n, d, r in ten]   # expert deltas: no slot dispatch
    out["moe"] = dict(cfg=cfg, base=base, tenants=ten, data=1,
                      engine=dict(n_slots=2, max_seq=32),
                      requests=_requests(cfg.vocab, 2, 60, lengths=lambda i: 6,
                                         tenant=lambda i: [ten[0][0], None][i % 2],
                                         gap=0.0))
    for arch, key in (("mamba2-370m", "ssm"), ("recurrentgemma-9b", "rglru")):
        cfg, base, ten = port_fleet(arch, 2, ratio=8)
        out[key] = dict(cfg=cfg, base=base, tenants=ten, data=1,
                        engine=dict(n_slots=2, max_seq=32),
                        requests=_requests(cfg.vocab, 2, 50, lengths=lambda i: 6,
                                           tenant=lambda i: f"tenant{i % 2}", gap=0.0))
    return out


def run_cases(rank: int, world: int) -> dict:
    """Every case of :func:`build_cases` on this rank's mesh ((1, WORLD) or
    (2, WORLD/2) by the case's ``data``); the meshes are built once, in
    the same order on every rank."""
    import torch

    from repro_torch.core import apply as ap
    from repro_torch.launch.mesh import make_serving_mesh

    torch.set_num_threads(1)      # ranks and test workers share the cores
    cases = build_cases()
    meshes = {d: make_serving_mesh(world, data=d) for d in (1, 2)}
    out = {"coords": meshes[2].coords, "backend": meshes[1].backend}
    with torch.inference_mode():
        for name, case in cases.items():
            mesh = meshes[case["data"]]
            if case.get("kind") == "placement":
                out[name] = {sd: serve(case, mesh, shard_deltas=sd)
                             for sd in ("replicated", "auto")}
            elif case.get("kind") == "coexist":
                got = serve(case, mesh)                # the mesh engine first
                installed = ap.get_mesh() is mesh
                plain = serve(case, None)              # a plain engine after it
                out[name] = {"mesh": got, "plain": plain, "installed": installed,
                             "cleared": ap.get_mesh() is None}
            else:
                out[name] = serve(case, mesh)
    # the serving CLI's ranks, as ``launch.serve --devices 4 --data 2``
    # spawns them, in this world; rank 0 prints, the others print nothing
    from repro_torch.launch import serve as serve_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["cli_rc"] = serve_cli._rank_main(rank, world, list(CLI_ARGV))
    out["cli_out"] = buf.getvalue()
    return out


def prompts(vocab: int, lengths, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lengths]


def hang_on_rank_one(rank: int, world: int) -> int:
    """Rank 1 never returns (a hung rank); the others return at once."""
    import time
    while rank == 1:
        time.sleep(1.0)
    return rank


def die_on_rank_one(rank: int, world: int) -> int:
    """Rank 1 raises (a dead rank) while the others wait for it in a
    collective, which would block them until its own timeout."""
    if rank == 1:
        raise RuntimeError("rank 1 dies")
    import torch.distributed as dist
    dist.barrier()
    return rank
