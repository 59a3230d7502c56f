"""The port's autotune table (``repro_torch/kernels/autotune.py``) against
the reference's lookup, and ``ops``' route and tile choice with and
without a table (CPU: no sweep, no kernel; the card's name and the
library's ``prefill_fits`` are stood in).

    PYTHONPATH=src python -m pytest -q tests/test_torch_autotune.py
"""
import json
import re
from types import SimpleNamespace

import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.configs import get_config
from repro_torch.core import codecs
from repro_torch.core.codecs import DeltaDQSpec
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import delta_spmm as kern
from repro_torch.kernels import ops
from repro_torch.launch.serve import RATIO_SPECS
from repro_torch.models import lm
from repro_torch.utils import iter_leaves, materialize

CARD = "NVIDIA Stand-in Card"
TS = range(1, 301)


def _fits(tb, h_g, keep):
    """A stand-in for the library's answer (a card test holds the real
    one): the 128-row tile takes every packing."""
    return tb in kern.PREFILL_TILES and 1 <= keep <= h_g


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(kern, "prefill_fits", _fits)
    monkeypatch.setattr(tat, "card_name", lambda: CARD)
    tat.invalidate_cache()
    yield
    tat.invalidate_cache()


def _table(tmp_path, monkeypatch, entries, device=CARD, name="table.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"version": 3, "backend": "cuda", "device": device,
                                "power_limit": "700.00 W", "entries": entries}))
    monkeypatch.setenv(tat.TABLE_ENV, str(path))
    tat.invalidate_cache()
    return path


def _d(point, device="cuda", shards=1):
    """What ``ops``' choice reads of a packed delta, on ``device``."""
    h_g, keep, k_bits, h_in, h_out = point
    return SimpleNamespace(h_g=h_g, keep=keep, k_bits=k_bits, h_in=h_in,
                           h_out=h_out // shards, shards=shards,
                           idx=SimpleNamespace(device=torch.device(device)))


def _old_spmm_rule(T, d):
    """``ops.spmm_row_tile`` before the table: 128 rows from 65 where the
    prefill kernel takes the packing, else the decode tile."""
    if T >= 65 and _fits(128, d.h_g, d.keep):
        return 128
    return _old_row_tile(T)


def _old_row_tile(T):
    return next((tb for tb in (1, 2, 4, 8) if T <= tb), 8)


# -- against the reference ---------------------------------------------------
def test_snap_t_matches_reference():
    assert tat.T_GRID == jat.T_GRID
    assert [tat.snap_t(t) for t in range(1, 301)] == [jat.snap_t(t) for t in range(1, 301)]


@pytest.mark.parametrize("point", [(16, 2, 4, 4096, 11008), (4096, 512, None, 4096, 4096),
                                   (128, 128, 2, 4096, 11008)])
def test_envelope_key_matches_reference(point):
    assert tat.envelope_key(*point) == jat.envelope_key(*point)
    for t in (1, 3, 8, 9, 64, 65, 128, 129, 256, 300, 10_000):
        assert tat.envelope_key(*point, t=t) == jat.envelope_key(*point, t=t)
    assert tat.parse_key(tat.envelope_key(*point)) == point


@pytest.mark.parametrize("stored", [0, 1, 31, 32, 500])
def test_lookup_floors_gather_max_t(tmp_path, monkeypatch, stored):
    """Whatever the table holds, gather_max_t is the reference table's
    value floored at MIN_GATHER_T (the reference's floor), on the card
    and off it: it only picks the CPU plain formulation."""
    assert tat.MIN_GATHER_T == jat.MIN_GATHER_T
    points = [(16, 2, 4, 64, 64), (64, 8, 4, 128, 256), (16, 2, 4, 4096, 11008)]
    _table(tmp_path, monkeypatch, {
        **{tat.envelope_key(*p): {"gather_max_t": stored, "tb": 8} for p in points},
        **{tat.envelope_key(*p, t=16): {"gather_max_t": stored, "tb": 2} for p in points}})
    for p in points:
        want = max(tat.GATHER_MAX_T.get(tat.envelope_key(*p), tat.DEFAULTS["gather_max_t"]),
                   tat.MIN_GATHER_T)
        for device in (None, "cpu", "cuda", torch.device("cuda", 0)):
            for t in (None, 16):
                got = tat.lookup(*p, t=t, device=device)["gather_max_t"]
                assert got == want >= jat.MIN_GATHER_T


# -- port-only ----------------------------------------------------------------
def test_overlay_lays_on_tile_keys_only(tmp_path, monkeypatch):
    p = (16, 2, 4, 4096, 11008)
    _table(tmp_path, monkeypatch, {
        tat.envelope_key(*p): {"tb": 4, "ob": 64},
        tat.envelope_key(*p, t=16): {"tb": 2, "kc": 4, "gather_max_t": 7, "rule_tb": 8,
                                     "ms": {"2": 0.1}}})
    got = tat.lookup(*p, t=13, device="cuda")         # snaps to @T16
    assert (got["tb"], got["ob"], got["kc"]) == (2, 64, 4)
    assert "ms" not in got and "rule_tb" not in got
    assert got["gather_max_t"] == tat.lookup(*p)["gather_max_t"]
    base = tat.lookup(*p, t=256, device="cuda")       # no overlay at this bucket
    assert (base["tb"], base["ob"], base["kc"]) == (4, 64, tat.DEFAULTS["kc"])
    assert tat.swept_tb(*p, 13, device="cuda") == 2
    assert tat.swept_tb(*p, 256, device="cuda") is None    # the base entry is no sweep


@pytest.mark.parametrize("kind", ["missing", "corrupt", "not a table", "other card",
                                  "cpu tensor", "other point"])
def test_no_applicable_table_gives_todays_rules(tmp_path, monkeypatch, kind):
    """Without a table that applies, ops' choice is the fixed rules' at
    every T of 1..300 and every committed point, noted as the rule's."""
    entries = {tat.envelope_key(*p, t=t): {"tb": 1} for p in tat.DEFAULT_POINTS
               for t in tat.T_GRID}
    device = "cuda"
    if kind == "missing":
        monkeypatch.setenv(tat.TABLE_ENV, str(tmp_path / "absent.json"))
    elif kind == "corrupt":
        path = tmp_path / "corrupt.json"
        path.write_text('{"version": 3, "entries": {"16/2/4/')
        monkeypatch.setenv(tat.TABLE_ENV, str(path))
    elif kind == "not a table":
        path = tmp_path / "list.json"
        path.write_text(json.dumps([entries]))
        monkeypatch.setenv(tat.TABLE_ENV, str(path))
    elif kind == "other card":
        _table(tmp_path, monkeypatch, entries, device="NVIDIA A100-SXM4-80GB")
    elif kind == "cpu tensor":
        _table(tmp_path, monkeypatch, entries)
        device = "cpu"
    else:
        _table(tmp_path, monkeypatch, {tat.envelope_key(*p[:4], p[4] + 1, t=t): {"tb": 1}
                                       for p in tat.DEFAULT_POINTS for t in tat.T_GRID})
    for p in tat.DEFAULT_POINTS:
        d = _d(p, device)
        assert tat.lookup(*p, t=8, device=device) == tat.lookup(*p)
        assert [ops.spmm_tile(T, d) for T in TS] == [(_old_spmm_rule(T, d), "rule")
                                                      for T in TS]
        assert [ops.spmm_row_tile(T, d) for T in TS] == [ops.rule_spmm_tile(T, d)
                                                          for T in TS]
        assert [ops.segments_tile(T, d) for T in TS] == [(_old_row_tile(T), "rule")
                                                          for T in TS]
        assert [ops.row_tile(T) for T in TS] == [_old_row_tile(T) for T in TS]


def test_ops_honours_the_table_in_every_bucket(tmp_path, monkeypatch):
    """An entry decides delta_spmm's route and tile at every T of its
    bucket (the sweep timed only the bucket's top); the segments kernel
    takes it where it is a decode tile; a column slice keys on the whole
    matrix's width."""
    narrow, wide = (16, 2, 4, 4096, 11008), (4096, 512, None, 4096, 4096)
    tiles = kern.SPMM_TILES
    entries = {}
    for p in (narrow, wide):
        for i, t in enumerate(tat.T_GRID):
            tb = tiles[i % len(tiles)] if p == narrow else kern.ROW_TILES[i % 4]
            entries[tat.envelope_key(*p, t=t)] = {"tb": tb, "rule_tb": 8, "ms": {}}
    _table(tmp_path, monkeypatch, entries)
    for p in (narrow, wide):
        for d in (_d(p), _d(p, shards=2)):
            for T in TS:
                want = entries[tat.envelope_key(*p, t=T)]["tb"]
                assert ops.spmm_tile(T, d) == (want, "table")
                assert ops.segments_tile(T, d) == (
                    (want, "table") if want in kern.ROW_TILES else (_old_row_tile(T), "rule"))
    # a bucket's tile is legal at every T in it: the prefill tile rests on
    # the packing alone, a decode tile above T only caps the rows
    for T in TS:
        tb = ops.spmm_row_tile(T, _d(narrow))
        assert tb in kern.ROW_TILES or _fits(tb, narrow[0], narrow[1])


def test_segments_take_their_own_swept_tile(tmp_path, monkeypatch):
    """Where a bucket holds the segments kernel's own ``seg_tb``, the
    segments kernel takes it (a decode tile) and delta_spmm keeps ``tb``;
    a bucket without one falls back to ``tb``, and a ``seg_tb`` that is no
    decode tile to the rule."""
    p = (1024, 128, 4, 4096, 11008)
    _table(tmp_path, monkeypatch, {
        tat.envelope_key(*p, t=8): {"tb": 8, "seg_tb": 4},
        tat.envelope_key(*p, t=4): {"tb": 2},
        tat.envelope_key(*p, t=1): {"tb": 1, "seg_tb": 128}})
    for d in (_d(p), _d(p, shards=2)):
        assert [ops.spmm_tile(T, d) for T in (1, 4, 8)] == [(1, "table"), (2, "table"),
                                                           (8, "table")]
        assert [ops.segments_tile(T, d) for T in (1, 3, 4, 5, 8)] == [
            (1, "rule"), (2, "table"), (2, "table"), (4, "table"), (4, "table")]
        assert ops.segments_tile(16, d) == (8, "rule")
    assert tat.swept_tb(*p, 8, device="cuda", key="seg_tb") == 4
    assert tat.swept_tb(*p, 4, device="cuda", key="seg_tb") is None
    assert tat.swept_tb(*p, 8, device="cpu", key="seg_tb") is None


def test_table_naming_an_illegal_tile_raises(tmp_path, monkeypatch):
    wide = (4096, 512, None, 4096, 4096)
    # no kernel has a 64-row or a 3-row tile (the 128-row tile takes every packing)
    _table(tmp_path, monkeypatch, {tat.envelope_key(*wide, t=128): {"tb": 64},
                                   tat.envelope_key(*wide, t=8): {"tb": 3}})
    for T in (100, 8):
        with pytest.raises(ValueError, match="autotune table"):
            ops.spmm_tile(T, _d(wide))
    assert ops.segments_tile(8, _d(wide)) == (8, "rule")


def test_invalidate_cache_rereads_the_file(tmp_path, monkeypatch):
    p = (16, 2, 4, 4096, 4096)
    path = _table(tmp_path, monkeypatch, {tat.envelope_key(*p, t=8): {"tb": 2}})
    assert ops.spmm_tile(8, _d(p)) == (2, "table")
    path.write_text(json.dumps({"version": 3, "device": CARD, "entries": {
        tat.envelope_key(*p, t=8): {"tb": 4}}}))
    assert ops.spmm_tile(8, _d(p)) == (2, "table")     # cached
    tat.invalidate_cache()
    assert ops.spmm_tile(8, _d(p)) == (4, "table")
    path.unlink()
    tat.invalidate_cache()
    assert ops.spmm_tile(8, _d(p)) == (8, "rule")


def test_committed_table(monkeypatch):
    """results/autotune_cuda.json loads, names an NVIDIA card and its
    power limit, covers every DEFAULT_POINTS key at every bucket, and
    each entry's tb is a tile, the fastest of its timed candidates (and
    at SEG_T its seg_tb the fastest of the segments kernel's tiles)."""
    monkeypatch.delenv(tat.TABLE_ENV, raising=False)
    tat.invalidate_cache()
    tab = tat.load_table()
    assert tat.table_path() == tat.DEFAULT_TABLE_PATH
    assert tab["version"] == 3 and tab["backend"] == "cuda"
    assert tab["device"].startswith("NVIDIA ")
    assert re.fullmatch(r"\d+(\.\d+)? W", tab["power_limit"])
    entries = tab["entries"]
    for p in tat.DEFAULT_POINTS:
        assert tat.envelope_key(*p) in entries
        for t in tat.T_GRID:
            assert tat.envelope_key(*p, t=t) in entries
    for key, e in entries.items():
        if "@T" not in key:
            continue
        T = int(key.split("@T")[1])
        assert e["tb"] in kern.SPMM_TILES and e["rule_tb"] in kern.SPMM_TILES, key
        assert e["tb"] == min((int(tb) for tb in e["ms"]), key=lambda tb: e["ms"][str(tb)])
        assert str(e["rule_tb"]) in e["ms"], key
        assert e["rule_tb"] == 128 or e["rule_tb"] == _old_row_tile(T), key
        # swept with the 128-row tile at every point: it takes every packing
        assert set(int(tb) for tb in e["ms"]) == set(kern.SPMM_TILES), key
        assert e["rule_tb"] == (128 if T >= ops.PREFILL_MIN_T else _old_row_tile(T)), key
        # the segments kernel's own tile at the decode step's buckets
        assert ("seg_tb" in e) == (T in tat.SEG_T), key
        if T in tat.SEG_T:
            assert set(int(tb) for tb in e["seg_ms"]) == set(kern.ROW_TILES), key
            assert e["seg_tb"] == min(kern.ROW_TILES, key=lambda tb: e["seg_ms"][str(tb)])


def _site_shapes(arch: str, *paths) -> list:
    leaves = dict(iter_leaves(lm.param_specs(get_config(arch))))
    return [leaves[p] for p in paths]


def _deltadq_point(spec, leaf) -> tuple:
    d = codecs.get_codec("deltadq").leaf_spec(leaf, spec)
    return (d.h_g, d.keep, d.k_bits, d.h_in, d.h_out)


def test_default_points_are_the_configs_packings():
    """Every DEFAULT_POINTS key is what a config's site compresses to
    (shapes from the configs' param specs, packings from the codecs'
    specs and runtime lowerings on the meta device), and nothing else."""
    wq, wi, wo = _site_shapes("wizard-llama2-7b", "attn/wq", "mlp/wi", "mlp/wo")
    want = []
    for spec in (RATIO_SPECS[128], DeltaDQSpec(),
                 DeltaDQSpec(alpha=8.0, k_bits=4, m=8, h_g=1024)):
        want += [_deltadq_point(spec, leaf) for leaf in (wq, wi, wo)]
    for name in ("bitdelta", "lowrank"):
        c = codecs.get_codec(name)
        (_, dtype) = wi
        leaf = materialize(c.leaf_spec((wi[0][1:], dtype), c.default_spec()), "meta")
        d = c.runtime_packed(leaf)
        want.append((d.h_g, d.keep, d.k_bits, d.h_in, d.h_out))
    for arch, paths in (("gemma3-1b", ("attn/wk",)), ("recurrentgemma-9b", ("attn/wk",)),
                        ("llama3.2-1b", ("attn/wq", "attn/wk", "mlp/wi"))):
        want += [_deltadq_point(RATIO_SPECS[128], leaf) for leaf in _site_shapes(arch, *paths)]
    assert len(set(tat.DEFAULT_POINTS)) == len(tat.DEFAULT_POINTS)
    assert tat.DEFAULT_POINTS == want
