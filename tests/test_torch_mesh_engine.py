"""The port's ``ContinuousEngine(mesh=, data=)`` against the unsharded port,
mirroring ``tests/test_mesh_sharding.py``'s engine cases.

One world of 4 CPU ranks (gloo) is spawned for the whole file
(``launch.mesh.run_ranks``, a file rendezvous under the test's temporary
directory, a deadline on the world and a timeout on every collective);
every rank serves every case of :func:`_cases` on a (1, 4) or a (2, 2)
mesh (``tests/torch_mesh_cases.py``), and the tests read the results:

* each case's tokens on every rank equal the unsharded port's, served in
  this process on the same inputs (the mixed stream; mixed codecs;
  ``shard_deltas`` placement; mesh and plain engines in one process;
  MoE; SSM; RG-LRU; affinity with residency; data=2 drain/refill;
  chunked prefill at data=2 with kv-head rings);
* the unsharded port's tokens equal the reference's unsharded
  ``ContinuousEngine`` on the same f32 inputs (made by the port, carried
  through numpy) for the mixed stream and the data=2 drain/refill — the
  reference's contract, whose
  sharded engine cannot run here (``tests/test_torch_serve.py`` holds the
  unsharded port to the reference on its other streams);
* ``launch.serve --devices 4 --data 2``'s rank entry, run by every rank;
* the slot KV cache per data pool, on mesh views (no ranks).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.serve import ContinuousEngine as JContinuousEngine  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.kv import SlotKVCache  # noqa: E402

import torch_bridge as br  # noqa: E402
import torch_mesh_cases as C  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_fleet(arch, n):
    """The f32 fleet ``torch_mesh_cases`` builds (compressed by the port)
    carried to the reference through numpy: the same inputs in both
    packages."""
    _, tbase, port = C.port_fleet(arch, n, f32=True)
    jcfg = dataclasses.replace(j_smoke(arch), param_dtype="float32")
    # copies: a JAX array may alias the numpy buffer of a tensor
    jbase = jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True), tbase)
    return jcfg, jbase, [(name, br.deltas_to_jax(d)) for name, d, _ in port]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on every rank of one spawned world of 4 (each rank
    builds the cases itself, from their seeds), and each case unsharded
    in this process."""
    cases = C.build_cases()
    ranks = mesh_lib.run_ranks(C.run_cases, C.WORLD, device="cpu",
                               timeout_s=240.0, rank_timeout_s=120.0,
                               rendezvous_dir=str(tmp_path_factory.mktemp("mesh")))
    plain = {}
    with torch.inference_mode():
        for name, case in cases.items():
            plain[name] = C.serve(case)
    return cases, ranks, plain


def _check(world, name, sub=None):
    """Every rank's tokens equal the unsharded port's; -> rank 0's result."""
    _, ranks, plain = world
    for r in ranks:
        got = r[name] if sub is None else r[name][sub]
        assert got["tokens"] == plain[name]["tokens"], (name, sub, r["coords"])
    return ranks[0][name] if sub is None else ranks[0][name][sub]


def test_serve_cli_ranks_in_world(world):
    """``launch.serve --devices 4 --data 2 --check-identity``'s rank entry
    on every rank of this world: rank 0 prints the mesh and the report
    once, the sharded stream equals the one-device stream, the other
    ranks print nothing (``tests/test_torch_mesh.py`` spawns the CLI's
    own world at ``--devices 2``)."""
    _, ranks, _ = world
    out = ranks[0]["cli_out"]
    assert [r["cli_rc"] for r in ranks] == [0] * C.WORLD, out
    assert "mesh: {'data': 2, 'model': 2} (gloo, " in out
    assert "token identity vs single device: OK (3 requests)" in out
    assert out.count("served 3 requests") == 1
    assert all(r["cli_out"] == "" for r in ranks[1:])


def test_world_is_gloo_over_four_ranks(world):
    _, ranks, _ = world
    assert ranks[0]["backend"] == "gloo"
    assert sorted((r["coords"]["data"], r["coords"]["model"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, n_tenants, n_slots, max_seq):
    """One reference engine per fleet and shape, its jits compiled once for
    every case it serves: a row's tokens do not depend on the engine's
    history or on the other registered tenants (mixed == alone)."""
    jcfg, jbase, jten = _jax_fleet(arch, n_tenants)
    jeng = JContinuousEngine(jcfg, jbase, clock=JVirtualClock(tick=0.01),
                             n_slots=n_slots, max_seq=max_seq)
    for name, d in jten:
        jeng.register_tenant(name, d)
    return jeng


def _jax_tokens(case, arch, n_tenants):
    """The reference's unsharded engine on ``case``'s requests."""
    jeng = _jax_engine(arch, n_tenants, case["engine"]["n_slots"],
                       case["engine"]["max_seq"])
    out = []
    for wave in case.get("waves", [case.get("requests")]):
        hs = [jeng.submit(t, p, max_new_tokens=n, arrival=a) for t, p, a, n in wave]
        jeng.run()
        out += [h.output().tolist() for h in hs]
    return out


def test_mixed_stream_token_identity(world):
    """3 tenants + base requests, mixed lengths, staggered arrivals on a
    (1, 4) mesh: kv-heads (2) do not divide 4, so the rings replicate while
    the base and the deltas shard; the unsharded port equals the
    reference's engine."""
    got = _check(world, "mixed_stream")
    assert got["shards"] and all(s == 4 for _, s in got["shards"])
    cases, _, plain = world
    assert plain["mixed_stream"]["tokens"] == _jax_tokens(cases["mixed_stream"],
                                                          "llama3.2-1b", 3)


def test_data_sharded_drain_refill(world):
    """data=2: two waves through 2 pools of 2 slots, the second reusing the
    freed slots (parked on row 0 after each wave), each rank storing its
    pool's rows; equal to the unsharded data=1 engine and the reference."""
    got = _check(world, "drain_refill")
    cases, ranks, plain = world
    assert got["parked"] == [True, True]
    assert {r["drain_refill"]["data"][2] for r in ranks} == {(0, 2), (2, 4)}
    assert got["data"][:2] == (2, 2)
    assert plain["drain_refill"]["tokens"] == _jax_tokens(cases["drain_refill"],
                                                          "llama3.2-1b", 3)


def test_chunked_prefill_data_sharded(world):
    """Chunked prefill at data=2 on wizard, whose 4 kv-heads shard over
    model 2 (each rank attends its heads and stores its ring slice): a
    chunk is prefilled by its pool's ranks and its first token gathered
    over data."""
    _check(world, "chunked_2x2")


def test_mixed_codec_token_identity(world):
    """DeltaDQ + BitDelta codec groups on (2, 2): equal to the unsharded
    engine, and each request to that tenant served alone."""
    got = _check(world, "mixed_codecs")
    assert got["groups"] == 2
    cases, _, plain = world
    case = cases["mixed_codecs"]
    for name, deltas, rep in case["tenants"]:
        alone = dict(case, tenants=[(name, deltas, rep)],
                     requests=[r for r in case["requests"] if r[0] == name])
        want = [t for r, t in zip(case["requests"], plain["mixed_codecs"]["tokens"])
                if r[0] == name]
        assert C.serve(alone)["tokens"] == want, name


def test_shard_output_placement(world):
    """``shard_deltas="auto"`` cuts every stacked leaf whose h_out divides
    into column slices, ``"replicated"`` keeps them whole; both serve the
    unsharded tokens."""
    rep = _check(world, "placement", "replicated")
    auto = _check(world, "placement", "auto")
    assert all(s == 1 for _, s in rep["shards"])
    assert auto["shards"] and all(s == 4 for _, s in auto["shards"])


def test_shard_output_placement_kv_head_rings(world):
    """The same at (2, 2), where the 2 kv-heads shard: q/k/v are a rank's
    own columns, and a replicated delta's correction is cut to them."""
    rep = _check(world, "placement_2x2", "replicated")
    auto = _check(world, "placement_2x2", "auto")
    assert all(s == 1 for _, s in rep["shards"])
    assert auto["shards"] and all(s == 2 for _, s in auto["shards"])


def test_mesh_and_plain_engines_coexist(world):
    """A plain engine after a mesh engine in the same rank serves unsharded
    (each engine installs its own mesh, or none, before its steps)."""
    _check(world, "coexist", "mesh")
    _check(world, "coexist", "plain")
    _, ranks, _ = world
    assert all(r["coexist"]["installed"] and r["coexist"]["cleared"] for r in ranks)


def test_moe_token_identity(world):
    """MoE: expert stacks shard their output axis and gather after the
    batched product; attention/MLP deltas take the sharded correction."""
    _check(world, "moe")


@pytest.mark.parametrize("name", ["ssm", "rglru"])
def test_recurrent_token_identity(world, name):
    """State-carrying mixers (exact-length buckets): conv/ssm/rg-lru states
    kept whole on every model rank, which runs the whole mixer."""
    _check(world, name)


def test_affinity_residency_token_identity(world):
    """Affinity admission + residency on (2, 2): the CPU values path over
    each rank's column slice runs (hit rate > 0, value steps > 0), with the
    unsharded tokens and per-pool unique-tenant means."""
    got = _check(world, "affinity_residency")
    assert got["residency"]["value_steps"] > 0 and got["residency"]["hit_rate"] > 0
    assert len(got["unique_per_shard"]) == 2


@pytest.mark.parametrize("pool", [0, 1])
def test_kv_insert_evict_per_data_pool(pool):
    """A rank of pool ``pool`` on a (2, 2) mesh stores its 2 of 4 slots at
    its kv-head slice; an insert into its pool reads back exactly and leaves
    its other row alone, one into the other pool is not its to make."""
    cfg = get_smoke_config("llama3.2-1b")
    view = mesh_lib.ServingMesh.view(2, 2, data_index=pool, model_index=1)
    csh = mesh_lib.cache_shardings(cfg, view, 4, 16)
    assert csh[0]["k"] == ("data", None, "model", None)
    kv = SlotKVCache(cfg, 4, 16, shardings=csh, data_shards=2, mesh=view, device="cpu")
    assert kv.rows == (2 * pool, 2 * pool + 2)
    assert tuple(kv.cache[0]["k"].shape) == (2, 16, cfg.n_kv // 2, cfg.head_dim)
    row = kv.empty_row()
    for e in row:
        for k, t in e.items():
            t.fill_(7 if k == "pos" else 1.5)
    mine, other = 2 * pool + 1, 2 * (1 - pool)
    kv.claim(mine)
    kv.insert(mine, row)
    kv.claim(other)
    kv.insert(other, row)
    assert kv.n_free_shard(pool) == 1 and kv.n_free_shard(1 - pool) == 1
    assert kv.shard_occupancy() == [0.5, 0.5]
    for e in kv.cache:
        assert (e["k"][1] == 1.5).all() and (e["pos"][1] == 7).all()
        assert not e["k"][0].any() and (e["pos"][0] == -1).all()
    kv.release(mine)
    kv.reset(mine)
    assert all((e["pos"][1] == -1).all() for e in kv.cache)
    assert kv.shard_occupancy()[pool] == 0.0


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_state_whole_per_data_pool(arch):
    """A rank of a (2, 2) mesh stores its pool's rows of every recurrent
    state at the whole width (the placement names a width cut, which the
    cache does not take: each model rank runs the whole mixer), and its
    rings, where there are any, at its kv-heads."""
    cfg = get_smoke_config(arch)
    view = mesh_lib.ServingMesh.view(2, 2, data_index=1, model_index=1)
    csh = mesh_lib.cache_shardings(cfg, view, 4, 16)
    kv = SlotKVCache(cfg, 4, 16, shardings=csh, data_shards=2, mesh=view, device="cpu")
    whole = lm.init_cache(cfg, 2, 16, device="meta")
    n_states = 0
    for got, want, placement in zip(kv.cache, whole, csh):
        if isinstance(got, dict):
            heads = want["k"].shape[2] // (2 if placement["k"][2] == "model" else 1)
            assert tuple(got["k"].shape) == (2, want["k"].shape[1], heads, cfg.head_dim)
            continue
        assert any("model" in (p or ()) for p in placement)   # a width cut named
        n_states += 1
        for t, w in zip(got, want):
            assert tuple(t.shape) == tuple(w.shape) and not t.any()
    assert n_states > 0
