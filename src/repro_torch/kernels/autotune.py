"""Swept route and row-tile table for the delta correction on the card.

Port of ``repro/kernels/autotune.py``: a lookup that ``kernels/ops.py``
consults on every correction call, and a sweep that times the choices on
the running card and writes them into a versioned table:

    PYTHONPATH=src python -m repro_torch.kernels.autotune --out results/autotune_cuda.json

The port's knob is ``tb``, one for each envelope point
``h_g/keep/k_bits/h_in/h_out`` and token-count bucket (:data:`T_GRID`,
:func:`snap_t`): a decode row tile 1/2/4/8 or the 128-row prefill tile
(``delta_spmm.SPMM_TILES``), so ``tb`` decides both ``delta_spmm``'s
route and its row tile. The segments kernel takes the entry's
``seg_tb`` where the sweep timed it (:data:`SEG_T`: the decode step's
layouts), else its ``tb`` where that is a decode tile. No tile and no
route changes a row's bits
(``ops.py``'s module doc), so the table is a speed choice only: a
missing table, a missing entry, a table swept on another card and the
CPU all give ``ops``' fixed rules (``spmm_row_tile``, ``row_tile``).

What the table does not drive, and why:
- the prefill kernel's column tile (64 or 32 by the SM count,
  ``csrc/prefill.cu``), measured best at every full-width site;
- the fused kernel's row tile: its K-split count follows the tile
  (``csrc/delta_spmm.cu``), so its sums' order, and so its bits, may
  move with it; the reference's sweep times ``delta_spmm`` only;
- ``dequant`` (no row tile) and the MoE expert route (its tile follows
  the capacity C, ``ops.delta_spmm_experts``);
- ``gather_max_t``, the CPU crossover between the gather and dense plain
  formulations: it stays the reference table's value at each point
  (:data:`GATHER_MAX_T`), floored at :data:`MIN_GATHER_T` (the segment
  dispatch always gathers, so the per-tenant path must gather at every
  decode-sized batch too), so the port's CPU results match the
  reference's formulation for formulation. The card has no such
  fallback, and the sweep does not measure it.

Table format (JSON; ``@T`` keys are :func:`envelope_key` with ``t=``)::

    {"version": 3, "backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
     "power_limit": "700.00 W",
     "entries": {"16/2/4/4096/11008": {"sweep_s": 2.1},
                 "16/2/4/4096/11008@T8": {"tb": 8, "rule_tb": 8,
                                          "ms": {"1": 0.05, "2": 0.03},
                                          "seg_tb": 4,
                                          "seg_ms": {"1": 0.09, "4": 0.05}}}}

:func:`lookup` merges :data:`DEFAULTS`, the base entry and the ``@T``
entry's tile keys, as the reference does. Entries apply only where the
table's ``device`` is the running card's name. Set
``REPRO_TORCH_AUTOTUNE_TABLE`` to point at another table.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

DEFAULTS = {"tb": 128, "ob": 128, "kc": 8, "gather_max_t": 64}
TILE_KEYS = ("tb", "ob", "kc")

# floor for the gather/dense crossover (see module doc)
MIN_GATHER_T = 32

# token-count buckets, the reference's: a count snaps to the smallest
# bucket holding it, counts past 256 share the 256 bucket
T_GRID = (1, 4, 8, 16, 32, 64, 128, 256)

# buckets at which the sweep also times the segments kernel, on the
# decode step's layout: T rows over min(4, T) tenants in turn (the mixed
# step's 2-row segments at 8); the segments kernel's best tile there can
# differ from delta_spmm's (a plan's row slab costs shared memory that a
# short segment never fills)
SEG_T = (1, 4, 8)

TABLE_VERSION = 3
TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_TABLE_PATH = os.path.join(_REPO, "results", "autotune_cuda.json")

# The reference table's gather_max_t per base envelope key
# "h_g/keep/k_bits/h_in/h_out" (results/autotune_kernels.json, version 3).
GATHER_MAX_T = {
    "128/16/4/256/256": 64,
    "16/2/4/128/64": 64,
    "16/2/4/64/128": 128,
    "16/2/4/64/32": 128,
    "16/2/4/64/64": 32,
    "16/2/None/64/64": 128,
    "64/8/4/128/128": 128,
    "64/8/4/128/256": 64,
    "64/8/4/128/64": 128,
    "64/8/4/256/128": 128,
    "64/8/4/512/512": 64,
    "64/8/8/128/256": 64,
}

# The points the card's configs hit, by the sites that reach them (each
# checked against the configs' packings in tests/test_torch_autotune.py).
DEFAULT_POINTS = [
    # wizard-llama2-7b at 128x (RATIO_SPECS[128]): attention, wi/wg, MLP wo
    (16, 2, 4, 4096, 4096), (16, 2, 4, 4096, 11008), (16, 2, 4, 11008, 4096),
    # DeltaDQSpec()'s row-wise default (h_g = h_in, f32 codes)
    (4096, 512, None, 4096, 4096), (4096, 512, None, 4096, 11008),
    (11008, 1376, None, 11008, 4096),
    # [envelope]'s h_g 1024 packing (256 at MLP wo, the divisor of 11008)
    (1024, 128, 4, 4096, 4096), (1024, 128, 4, 4096, 11008), (256, 32, 4, 11008, 4096),
    # BitDelta and LowRank at wi, as the codecs lower them (keep = h_g = 128)
    (128, 128, 2, 4096, 11008), (128, 128, None, 4096, 11008),
    # the narrow sites at 128x: gemma3-1b wk, recurrentgemma-9b wk
    (16, 2, 4, 1152, 256), (16, 2, 4, 4096, 256),
    # llama3.2-1b at 128x: wq, wk, wi
    (16, 2, 4, 2048, 2048), (16, 2, 4, 2048, 512), (16, 2, 4, 2048, 8192),
]

_cached_table: Optional[dict] = None
_cached_path: Optional[str] = None
_tb_cache: dict = {}


def table_path() -> str:
    return os.environ.get(TABLE_ENV, DEFAULT_TABLE_PATH)


def snap_t(t: int) -> int:
    """Snap a token count to its :data:`T_GRID` bucket (smallest grid
    point >= t; counts past the grid share the largest bucket)."""
    for g in T_GRID:
        if t <= g:
            return g
    return T_GRID[-1]


def envelope_key(h_g: int, keep: int, k_bits: Optional[int], h_in: int,
                 h_out: int, t: Optional[int] = None) -> str:
    base = f"{h_g}/{keep}/{k_bits}/{h_in}/{h_out}"
    return base if t is None else f"{base}@T{snap_t(t)}"


def parse_key(key: str) -> tuple:
    """``"h_g/keep/k_bits/h_in/h_out"`` -> the point tuple."""
    h_g, keep, k_bits, h_in, h_out = key.split("/")
    return (int(h_g), int(keep), None if k_bits == "None" else int(k_bits), int(h_in),
            int(h_out))


def load_table(path: Optional[str] = None) -> dict:
    """Load (and cache) the table; {} when absent, unreadable or not a
    table (no ``entries`` mapping)."""
    global _cached_table, _cached_path
    path = path or table_path()
    if _cached_table is not None and _cached_path == path:
        return _cached_table
    try:
        with open(path) as f:
            tab = json.load(f)
    except (OSError, ValueError):
        tab = {}
    if not isinstance(tab, dict) or not isinstance(tab.get("entries"), dict):
        tab = {}
    _cached_table, _cached_path = tab, path
    return tab


def invalidate_cache() -> None:
    """Forget the loaded table and every cached choice: the next lookup
    reads the file again."""
    global _cached_table, _cached_path
    _cached_table = _cached_path = None
    _tb_cache.clear()


@functools.cache
def card_name() -> Optional[str]:
    """The running card's name (``torch.cuda.get_device_name()``), read
    once per process; None without CUDA."""
    import torch
    return torch.cuda.get_device_name() if torch.cuda.is_available() else None


def _on_card(device) -> bool:
    return device is not None and str(device).split(":")[0] == "cuda"


def _entries(device) -> dict:
    """The table's entries where they apply to ``device`` (a CUDA device
    on the card the table names), else {}."""
    if not _on_card(device):
        return {}
    tab = load_table()
    if not tab or tab.get("device") != card_name():
        return {}
    return tab["entries"]


def lookup(h_g: int, keep: int, k_bits: Optional[int], h_in: int, h_out: int,
           t: Optional[int] = None, device=None) -> dict:
    """Tile/formulation parameters for an envelope point (always
    complete: missing keys come from :data:`DEFAULTS`).

    ``device`` is where the call runs (a ``torch.device`` or its string);
    only on a CUDA device whose card the table names do its entries apply
    (the base entry, then the ``@T`` entry's tile keys for ``t``), else
    this is :data:`DEFAULTS`. ``gather_max_t`` always comes from
    :data:`GATHER_MAX_T`, floored (see module doc)."""
    entries = _entries(device)
    got = {**DEFAULTS, **entries.get(envelope_key(h_g, keep, k_bits, h_in, h_out), {})}
    if t is not None:
        overlay = entries.get(envelope_key(h_g, keep, k_bits, h_in, h_out, t=t), {})
        got.update({k: v for k, v in overlay.items() if k in TILE_KEYS})
    key = envelope_key(h_g, keep, k_bits, h_in, h_out)
    got["gather_max_t"] = max(GATHER_MAX_T.get(key, DEFAULTS["gather_max_t"]),
                              MIN_GATHER_T)
    return got


def swept_tb(h_g: int, keep: int, k_bits: Optional[int], h_in: int, h_out: int,
             t: int, device=None, key: str = "tb") -> Optional[int]:
    """The ``tb`` (or, with ``key="seg_tb"``, the segments kernel's tile)
    the table holds for this point at ``t``'s bucket, where it applies
    (:func:`lookup`), else None. Cached per (point, bucket, key): ``ops``
    asks on every call, so a call costs a dict hit."""
    if not _on_card(device):
        return None
    ekey = envelope_key(h_g, keep, k_bits, h_in, h_out, t=t)
    try:
        return _tb_cache[ekey, key]
    except KeyError:
        pass
    entry = _entries(device).get(ekey, {})
    tb = int(entry[key]) if key in entry else None
    _tb_cache[ekey, key] = tb
    return tb


# ---------------------------------------------------------------------------
# Sweep (on the card)
# ---------------------------------------------------------------------------
GRAPH_MS = 10.0     # device time one timed graph replay aims at
RING_BYTES = 100e6  # packed bytes a ring of deltas spans: twice the H100's L2
MAX_RING = 8


def _time_ms(torch, fns, iters: int, reps: int = 5) -> float:
    """Median per-call device ms of ``reps`` replays of one CUDA graph
    that cycles ``iters`` times through ``fns`` (a ring of calls on
    distinct deltas, so each finds its delta cold in L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(per)


def _iters_for(torch, fn) -> int:
    """Calls per graph so that a replay takes about :data:`GRAPH_MS`."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return max(2, min(40, int(GRAPH_MS / max(a.elapsed_time(b), 1e-3))))


def lowering_codec(h_g: int, keep: int, k_bits: Optional[int], h_in: int) -> Optional[str]:
    """The codec whose runtime lowering lands on this point, or None: keep
    = h_g = the lowering's group size with BitDelta's 2-bit codes or
    LowRank's f32 values. The key cannot tell such a lowering from a
    DeltaDQ packing at alpha 1; the sweep times the lowering, which is what
    the configs serve there (``DEFAULT_POINTS``)."""
    from repro_torch.core.codecs import _runtime_hg
    if keep != h_g or h_g != _runtime_hg(h_in):
        return None
    return {2: "bitdelta", None: "lowrank"}.get(k_bits)


def pack_lowering(codec: str, h_in: int, h_out: int, *, generator, device="cuda",
                  scale: float = 0.01):
    """The runtime lowering of a random [h_in, h_out] leaf of ``codec``, as
    the serving engines hold it: BitDelta compressed from a ``scale`` N(0,
    1) delta; LowRank lowered from random 4-bit core codes and rank-8
    factors (its compression's host SVD is not what the kernels see)."""
    import torch
    from repro_torch.core import codecs, quant
    c = codecs.get_codec(codec)
    if codec == "bitdelta":
        delta = torch.randn((h_in, h_out), generator=generator, device=device) * scale
        return c.runtime_packed(c.compress_leaf(torch.zeros_like(delta), delta,
                                                codecs.BitDeltaSpec()))
    q = torch.randint(0, 16, (h_in, h_out), generator=generator, device=device)
    return c.runtime_packed(codecs.LowRankLeaf(
        codes=quant.pack_bits(q, 4, axis=0), scale=torch.tensor(0.004, device=device),
        zero=torch.tensor(8, dtype=torch.int32, device=device),
        u=torch.randn((h_in, 8), generator=generator, device=device) * 0.01,
        v=torch.randn((8, h_out), generator=generator, device=device) * 0.01,
        h_in=h_in, h_out=h_out, k_bits=4, rank=8))


def pack_point(h_g: int, keep: int, k_bits: Optional[int], h_in: int, h_out: int, *,
               generator, device="cuda"):
    """A 0.01 N(0, 1) delta packed at the point with the port's packer, or
    a codec's lowering where one lands there (:func:`lowering_codec`);
    raises ``ValueError`` where no packing reaches the point."""
    import torch
    from repro_torch.core import dropout
    if h_in % h_g or not 1 <= keep <= h_g or (k_bits is not None and not 1 <= k_bits <= 8):
        raise ValueError(f"no packing reaches {envelope_key(h_g, keep, k_bits, h_in, h_out)}")
    codec = lowering_codec(h_g, keep, k_bits, h_in)
    if codec is not None:
        return pack_lowering(codec, h_in, h_out, generator=generator, device=device)
    delta = torch.randn((h_in, h_out), generator=generator, device=device) * 0.01
    d = dropout.groupwise_dropout_pack(delta, h_g=h_g, alpha=h_g / keep, k_bits=k_bits,
                                       generator=generator)
    if d.keep != keep:
        raise ValueError(f"no packing reaches {envelope_key(h_g, keep, k_bits, h_in, h_out)}: "
                         f"alpha {h_g / keep} keeps {d.keep}")
    return d


def candidates(h_g: int, keep: int) -> tuple:
    """Every legal ``tb`` for a packing: the decode tiles, and the
    prefill tile where its shared memory fits (a property of the packing
    alone, so a bucket's tile is legal at every T in it)."""
    from repro_torch.kernels import delta_spmm as kern
    return kern.ROW_TILES + tuple(tb for tb in kern.PREFILL_TILES
                                  if kern.prefill_fits(tb, h_g, keep))


def sweep_point(h_g: int, keep: int, k_bits: Optional[int], h_in: int, h_out: int, *,
                seed: int = 0, ts: tuple = T_GRID) -> tuple:
    """Time every legal ``tb`` of one point at each T of ``ts`` on the card.

    Packs a seeded random delta ring at the point, then for each T runs
    every candidate once against the rule's tile (``ops.spmm_row_tile``
    without a table) and raises ``RuntimeError`` unless the outputs are
    bit-equal (a difference is a kernel fault), then times each as
    CUDA-graph replays. At the buckets of :data:`SEG_T` it does the same
    for the segments kernel's decode tiles on the decode step's layout
    over stacks of four tenants. Returns ``(base_entry, {T: overlay})``;
    an overlay holds the fastest ``tb``, the rule's and every candidate's
    ms, and at :data:`SEG_T` the segments kernel's fastest ``seg_tb`` and
    its tiles' ``seg_ms``.
    """
    import numpy as np
    import torch
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import tenant_segments
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_point times the CUDA kernels: it needs a card")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ring = [pack_point(h_g, keep, k_bits, h_in, h_out, generator=gen)]
    n_ring = max(2, min(MAX_RING, int(-(-RING_BYTES // ring[0].nbytes()))))
    ring += [pack_point(h_g, keep, k_bits, h_in, h_out, generator=gen)
             for _ in range(n_ring - 1)]
    cands = candidates(h_g, keep)
    overlays = {}
    for T in ts:
        x = torch.randn((T, h_in), generator=gen, device="cuda")
        rule = ops.rule_spmm_tile(T, ring[0])
        want = kern.delta_spmm_cuda(x, ring[0], tb=rule)
        ms = {}
        for tb in cands:
            got = kern.delta_spmm_cuda(x, ring[0], tb=tb)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"{envelope_key(h_g, keep, k_bits, h_in, h_out, t=T)}: tb={tb} gives "
                    f"other bits than the rule's tb={rule} (max |diff| "
                    f"{(got - want).abs().max().item():.3e}): a kernel fault")
            fns = [lambda d=d, tb=tb: kern.delta_spmm_cuda(x, d, tb=tb) for d in ring]
            ms[str(tb)] = _time_ms(torch, fns, _iters_for(torch, fns[0]))
        best = min(cands, key=lambda tb: ms[str(tb)])
        overlays[T] = {"tb": best, "rule_tb": rule, "ms": ms}
        del x, want
    stacks = [stack_tenant_deltas([{"w": ring[(i + j) % len(ring)]} for j in range(4)])["w"]
              for i in range(2)] if any(T in SEG_T for T in ts) else []
    for T in (T for T in ts if T in SEG_T):
        seg = tenant_segments(np.arange(T, dtype=np.int32) % min(4, T))
        rows, offs = (torch.as_tensor(a, dtype=torch.int32, device="cuda").contiguous()
                      for a in (seg.seg_rows, seg.seg_offsets))
        x = torch.randn((T, h_in), generator=gen, device="cuda")
        rule = ops.row_tile(T)
        want = kern.delta_spmm_segments_cuda(x, stacks[0], rows, offs, tb=rule)
        ms = {}
        for tb in kern.ROW_TILES:
            got = kern.delta_spmm_segments_cuda(x, stacks[0], rows, offs, tb=tb)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"{envelope_key(h_g, keep, k_bits, h_in, h_out, t=T)}: segments tb={tb} "
                    f"gives other bits than tb={rule}: a kernel fault")
            fns = [lambda s=s, tb=tb: kern.delta_spmm_segments_cuda(x, s, rows, offs, tb=tb)
                   for s in stacks]
            ms[str(tb)] = _time_ms(torch, fns, _iters_for(torch, fns[0]))
        overlays[T].update(seg_tb=min(kern.ROW_TILES, key=lambda tb: ms[str(tb)]), seg_ms=ms)
        del x, want
    del ring, stacks
    return {"sweep_s": time.perf_counter() - t0}, overlays


def _smi() -> tuple:
    """(name, power limit) as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in out.rsplit(",", 1))
    return name, power


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_TABLE_PATH)
    ap.add_argument("--points", default=None,
                    help="comma-separated h_g/keep/k_bits/h_in/h_out keys "
                         "(default: the points the card's configs hit)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("autotune: the sweep times the CUDA kernels; no card here", file=sys.stderr)
        return 1
    points = [parse_key(k) for k in args.points.split(",")] if args.points \
        else DEFAULT_POINTS
    name, power = _smi()
    if name != card_name():
        raise SystemExit(f"autotune: nvidia-smi names the card {name!r}, torch "
                         f"{card_name()!r}; a table under that name would never apply")
    print(f"{name}, {power}", flush=True)
    from repro_torch.kernels import delta_spmm as kern
    t0 = time.perf_counter()
    kern.build()
    build_s = time.perf_counter() - t0
    entries = {}
    with torch.inference_mode():
        for point in points:
            key = envelope_key(*point)
            entries[key], overlays = sweep_point(*point)
            for T, ov in overlays.items():
                entries[envelope_key(*point, t=T)] = ov
            print(f"{key}: {entries[key]['sweep_s']:.1f} s; tb by T "
                  f"{ {T: ov['tb'] for T, ov in overlays.items()} }, rule "
                  f"{ {T: ov['rule_tb'] for T, ov in overlays.items()} }, segments "
                  f"{ {T: ov['seg_tb'] for T, ov in overlays.items() if 'seg_tb' in ov} }",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"version": TABLE_VERSION, "backend": "cuda", "device": name,
                   "power_limit": power, "build_s": build_s,
                   "sweep_s": time.perf_counter() - t0 - build_s,
                   "entries": entries}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {args.out} ({len(points)} points, "
          f"{time.perf_counter() - t0:.1f} s with the build)", flush=True)
    invalidate_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
