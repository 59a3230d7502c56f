"""Time single kernels of the port on one H100, outside chip_smoke.py.

Each mode prints one JSON object a measurement (times in ms, CUDA-graph
replays of a ring of distinct deltas, as chip_smoke.py's ``time_ms``) and,
first, the card's name and power limit as nvidia-smi prints them:

    python3 chip_kernel_probe.py --decode [--src DIR]
        wizard-llama2-7b wi (4096 x 11008) at the 128x spec: delta_spmm at
        T = 2 and 8, delta_spmm_segments on the mixed 8-row layout and
        dequant, and dequant at h_g 256 (alpha 8, k_bits 4), through
        ``ops``, and delta_spmm at T = 128 on the 128-row tile; ``--src``
        imports ``repro_torch`` from another tree's ``src`` (its kernels
        build under that tree).
    python3 chip_kernel_probe.py --wide [--src DIR]
        the packings the compressor and the group search emit past the
        128x spec: DeltaDQSpec()'s row-wise default and h_g 1024 (alpha 8,
        k_bits 4; 256 at MLP wo) at wizard wq, wi and MLP wo for T = 8
        and 128, and the BitDelta and LowRank lowerings (keep = h_g =
        128) at wi for T = 8 and 128 and at MLP wo for T = 8 (their
        decode plans to stderr, torch.matmul on the dense delta beside
        T = 8): delta_spmm through ``ops`` (its tile beside it) and on
        each tile the packing takes, and delta_spmm_segments at the mixed
        8-row layout through ``ops``; every row's ``bits`` says whether it
        equals the kernels' oracle (``kernels/ref.py``) bit for bit.
    python3 chip_kernel_probe.py --ab PARENT_SRC
        ``--decode --wide`` in four processes: PARENT_SRC, this tree, this
        tree, PARENT_SRC; prints each side's median and range and whether
        all its rows were bit-equal to the oracle.
    python3 chip_kernel_probe.py --dequant [--src DIR]
        dequant at wi for the 128x spec, h_g 256 and 1024 (alpha 8, k_bits
        4) and the row-wise default (f32 codes), through ``ops``.
    python3 chip_kernel_probe.py --tiles
        the decode route's row tile (1, 2, 4, 8) against time for the wide
        packings at wizard wq, wi and MLP wo, T = 8 and 128, beside the
        tile ``ops.spmm_row_tile`` takes.

Needs a card; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WI = (4096, 11008)
SITES = {"wq": (4096, 4096), "wi": (4096, 11008), "wo": (11008, 4096)}
SPEC_128X = dict(h_g=16, alpha=8.0, k_bits=4)
MIXED_SLOT_ROWS = (0, 1, 2, 3, 1, 0, 3, 2)     # chip_smoke.py's mixed step
RING = 8


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def time_reps(torch, fns, iters: int = 40, reps: int = 7) -> list:
    """Per-call device ms of each of ``reps`` replays of one CUDA graph
    that cycles ``iters`` times through ``fns``."""
    for f in fns:
        f()
    torch.cuda.synchronize()
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
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return out


def pack_ring(torch, h_in, h_out, gen, n=RING, **spec):
    from repro_torch.core import dropout
    ring = []
    for _ in range(n):
        delta = torch.randn((h_in, h_out), generator=gen, device="cuda") * 0.02
        ring.append(dropout.groupwise_dropout_pack(delta, generator=gen, **spec))
        del delta
    return ring


def codec_ring(torch, codec: str, h_in, h_out, gen, n: int) -> list:
    """n runtime lowerings of random [h_in, h_out] leaves of ``codec``
    (keep = h_g = 128 at wizard's sites), built through ``core.codecs``
    alone so that a parent tree builds them too: BitDelta from a 0.02
    N(0, 1) delta, LowRank from random 4-bit core codes and rank-8
    factors, as ``kernels.autotune.pack_lowering`` builds them (a parent
    tree may lack it)."""
    from repro_torch.core import codecs, quant
    c = codecs.get_codec(codec)
    ring = []
    for _ in range(n):
        if codec == "bitdelta":
            delta = torch.randn((h_in, h_out), generator=gen, device="cuda") * 0.02
            ring.append(c.runtime_packed(c.compress_leaf(torch.zeros_like(delta), delta,
                                                         codecs.BitDeltaSpec())))
            continue
        q = torch.randint(0, 16, (h_in, h_out), generator=gen, device="cuda")
        ring.append(c.runtime_packed(codecs.LowRankLeaf(
            codes=quant.pack_bits(q, 4, axis=0), scale=torch.tensor(0.004, device="cuda"),
            zero=torch.tensor(8, dtype=torch.int32, device="cuda"),
            u=torch.randn((h_in, 8), generator=gen, device="cuda") * 0.01,
            v=torch.randn((8, h_out), generator=gen, device="cuda") * 0.01,
            h_in=h_in, h_out=h_out, k_bits=4, rank=8)))
    return ring


def bits_ok(torch, y, want) -> bool:
    """y equals the kernels' oracle bit for bit."""
    return y.shape == want.shape and torch.equal(y.view(torch.int32), want.view(torch.int32))


def decode(torch) -> list:
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.scheduler import tenant_segments
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ring = pack_ring(torch, *WI, gen, **SPEC_128X)
    out = []
    for T in (2, 8):
        x = torch.randn((T, WI[0]), generator=gen, device="cuda")
        out.append({"kernel": "delta_spmm", "T": T, "h_g": 16, "ms": time_reps(
            torch, [lambda d=d: ops.delta_spmm(x, d) for d in ring]),
            "bits": bits_ok(torch, ops.delta_spmm(x, ring[0]),
                            ref.correction_kernel_order(x, ring[0]))})
    rows = np.asarray(MIXED_SLOT_ROWS, np.int32)
    seg = tenant_segments(rows).to("cuda")
    x = torch.randn((len(rows), WI[0]), generator=gen, device="cuda").index_select(0, seg.order)
    stacks = [stack_tenant_deltas([{"w": ring[(i + j) % RING]} for j in range(4)])["w"]
              for i in range(RING)]
    out.append({"kernel": "delta_spmm_segments", "T": len(rows), "h_g": 16, "ms": time_reps(
        torch, [lambda s=s: ops.delta_spmm_segments(x, s, seg.seg_rows, seg.seg_offsets)
                for s in stacks]),
        "bits": bits_ok(torch, ops.delta_spmm_segments(x, stacks[0], seg.seg_rows,
                                                       seg.seg_offsets),
                        ref.segments_kernel_order(x, stacks[0], seg.seg_rows,
                                                  seg.seg_offsets))})
    out.append({"kernel": "dequant", "T": None, "h_g": 16, "ms": time_reps(
        torch, [lambda d=d: ops.dequant(d) for d in ring], iters=16)})
    del ring, stacks
    ring = pack_ring(torch, *WI, gen, n=4, h_g=256, alpha=8.0, k_bits=4)
    out.append({"kernel": "dequant", "T": None, "h_g": 256, "ms": time_reps(
        torch, [lambda d=d: ops.dequant(d) for d in ring], iters=16)})
    del ring
    ring = pack_ring(torch, *WI, gen, n=4, **SPEC_128X)
    x = torch.randn((128, WI[0]), generator=gen, device="cuda")
    out.append({"kernel": "delta_spmm", "T": 128, "h_g": 16, "tile": 128, "ms": time_reps(
        torch, [lambda d=d: kern.delta_spmm_cuda(x, d, tb=128) for d in ring], iters=16),
        "bits": bits_ok(torch, kern.delta_spmm_cuda(x, ring[0], tb=128),
                        ref.correction_kernel_order(x, ring[0]))})
    return out


WIDE_SPECS = {"row-wise": dict(alpha=8.0, k_bits=None),
              "h_g 1024": dict(h_g=1024, alpha=8.0, k_bits=4)}
# the codec lowerings (keep = h_g = 128): wi at T = 8 and 128, MLP wo at
# T = 8, each with the mixed segments row
CODEC_POINTS = {("bitdelta", "wi"): (8, 128), ("lowrank", "wi"): (8, 128),
                ("bitdelta", "wo"): (8,), ("lowrank", "wo"): (8,)}


def wide(torch) -> list:
    """--wide: every row's ms on the packings past the 128x spec, each
    row's bits against the kernels' oracle (``bits``), and the codec
    lowerings' decode plans (printed to stderr: ``walk`` says which)."""
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.serve.scheduler import tenant_segments
    import numpy as np
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for pk, spec in WIDE_SPECS.items():
        for site, (h_in, h_out) in SITES.items():
            h_g = spec.get("h_g", h_in)
            cases.append((pk, site, dict(spec, h_g=h_g if h_in % h_g == 0 else 256), (8, 128)))
    for (codec, site), ts in CODEC_POINTS.items():
        cases.append((codec, site, None, ts))
    rows = np.asarray(MIXED_SLOT_ROWS, np.int32)
    seg = tenant_segments(rows).to("cuda")
    out = []
    for pk, site, kw, ts in cases:
        h_in, h_out = SITES[site]
        if kw is None:
            ring = codec_ring(torch, pk, h_in, h_out, gen, n=2 if pk == "lowrank" else 4)
            for tb in kern.ROW_TILES:
                print(f"decode_plan {pk} {site} tb={tb}: {kern.decode_plan(ring[0], tb)}",
                      file=sys.stderr, flush=True)
        else:
            ring = pack_ring(torch, h_in, h_out, gen, n=2 if kw["k_bits"] is None else 4, **kw)
        d = ring[0]
        tiles = autotune.candidates(d.h_g, d.keep)
        for T in ts:
            x = torch.randn((T, h_in), generator=gen, device="cuda")
            want = ref.correction_kernel_order(x, d)
            iters = 40 if T <= 8 else 8
            base = {"kernel": "delta_spmm", "packing": pk, "site": site, "h_g": d.h_g, "T": T}
            out.append(dict(base, tile="ops", tb=ops.spmm_row_tile(T, d), ms=time_reps(
                torch, [lambda d=d: ops.delta_spmm(x, d) for d in ring], iters=iters, reps=5),
                bits=bits_ok(torch, ops.delta_spmm(x, d), want)))
            for tb in tiles:
                out.append(dict(base, tile=tb, ms=time_reps(
                    torch, [lambda d=d, tb=tb: kern.delta_spmm_cuda(x, d, tb=tb) for d in ring],
                    iters=iters, reps=5), bits=bits_ok(torch, kern.delta_spmm_cuda(x, d, tb=tb),
                                                       want)))
            if kw is None and T == 8:   # torch.matmul on the dense delta, the yardstick
                dense = [ref.dequant_tile_ref(r) for r in ring[:2]]
                out.append(dict(base, tile="torch.matmul", ms=time_reps(
                    torch, [lambda w=w: torch.matmul(x, w) for w in dense], iters=iters,
                    reps=5)))
                del dense
            del want
        if 8 in ts:
            x = torch.randn((len(rows), h_in), generator=gen, device="cuda").index_select(
                0, seg.order)
            stacks = [stack_tenant_deltas([{"w": ring[(i + j) % len(ring)]} for j in range(4)])
                      ["w"] for i in range(2)]
            out.append({"kernel": "delta_spmm_segments", "packing": pk, "site": site,
                        "h_g": d.h_g, "T": len(rows), "tile": "ops", "ms": time_reps(
                            torch, [lambda s=s: ops.delta_spmm_segments(
                                x, s, seg.seg_rows, seg.seg_offsets) for s in stacks],
                            iters=40, reps=5),
                        "bits": bits_ok(torch, ops.delta_spmm_segments(
                            x, stacks[0], seg.seg_rows, seg.seg_offsets),
                            ref.segments_kernel_order(x, stacks[0], seg.seg_rows,
                                                      seg.seg_offsets))})
            del stacks
        del ring, d
        torch.cuda.empty_cache()
    return out


_KEYS = ("kernel", "packing", "site", "h_g", "T", "tile")


def ab(parent_src: str) -> list:
    """--decode --wide in the order parent, change, change, parent."""
    runs = []
    for side, src in (("parent", parent_src), ("change", os.path.join(HERE, "src")),
                      ("change", os.path.join(HERE, "src")), ("parent", parent_src)):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--decode", "--wide",
                            "--src", os.path.abspath(src)], capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"--decode --wide on {src} failed:\n{p.stdout}\n{p.stderr}")
        print(f"# {side} {src}:\n{p.stderr}", file=sys.stderr, flush=True)
        for line in p.stdout.splitlines():
            if line.startswith("{"):
                runs.append(dict(json.loads(line), side=side))
    out = []
    for key in {tuple(r.get(k) for k in _KEYS) for r in runs}:
        row = dict(zip(_KEYS, key))
        for side in ("parent", "change"):
            mine = [r for r in runs if tuple(r.get(k) for k in _KEYS) == key and
                    r["side"] == side]
            ms = [m for r in mine for m in r["ms"]]
            row[side] = {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
                         "n": len(ms), "tb": mine[0].get("tb"),
                         "bits": all(r.get("bits", True) for r in mine)} if ms else None
        if row["parent"] and row["change"]:
            row["change_over_parent"] = row["change"]["median"] / row["parent"]["median"]
        out.append(row)
    return sorted(out, key=lambda r: tuple(str(r[k]) for k in _KEYS))


def dequant(torch) -> list:
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = []
    for h_g, k_bits in ((16, 4), (256, 4), (1024, 4), (WI[0], None)):
        ring = pack_ring(torch, *WI, gen, n=4, h_g=h_g, alpha=8.0, k_bits=k_bits)
        out.append({"kernel": "dequant", "h_g": h_g, "k_bits": k_bits, "ms": time_reps(
            torch, [lambda d=d: ops.dequant(d) for d in ring], iters=16)})
        del ring
    return out


def tiles(torch) -> list:
    from repro_torch.kernels import delta_spmm as kern, ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = []
    for pk, spec in (("row-wise", dict(alpha=8.0, k_bits=None)),
                     ("h_g 1024", dict(h_g=1024, alpha=8.0, k_bits=4))):
        for site, (h_in, h_out) in SITES.items():
            kw = dict(spec, h_g=spec.get("h_g", h_in) if h_in % spec.get("h_g", h_in) == 0
                      else 256)
            ring = pack_ring(torch, h_in, h_out, gen, n=2, **kw)
            for T in (8, 128):
                x = torch.randn((T, h_in), generator=gen, device="cuda")
                row = {"packing": pk, "site": site, "h_g": kw["h_g"], "T": T,
                       "ops_tile": ops.spmm_row_tile(T, ring[0]), "tiles": {}}
                for tb in kern.ROW_TILES:
                    p = kern.decode_plan(ring[0], tb)
                    ms = time_reps(torch, [lambda d=d: kern.delta_spmm_cuda(x, d, tb=tb)
                                           for d in ring], iters=8 if T > 8 else 40, reps=5)
                    row["tiles"][tb] = {"rows": p["rows"], "kc": p["kc"], "steps": p["steps"],
                                        "smem_kb": p["smem_bytes"] // 1024,
                                        "ms": statistics.median(ms)}
                out.append(row)
            del ring
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--ab", metavar="PARENT_SRC")
    ap.add_argument("--dequant", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    args = ap.parse_args()
    modes = [m for m in ("decode", "wide", "dequant", "tiles") if getattr(args, m)]
    if bool(args.ab) == bool(modes):
        ap.error("give --ab PARENT_SRC, or one or more of --decode --wide --dequant --tiles")
    if args.ab:
        rows = ab(args.ab)
    else:
        sys.path.insert(0, os.path.abspath(args.src))
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("chip_kernel_probe: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        run = {"decode": decode, "wide": wide, "dequant": dequant, "tiles": tiles}
        rows = []
        with torch.inference_mode():
            for m in modes:
                rows += run[m](torch)
    print(card_line(), flush=True)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
