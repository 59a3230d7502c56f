#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--src OTHER_CHECKOUT/src]

Builds the port's four CUDA kernels from the sources in this checkout,
holds each kernel against its plain torch version at the full
wizard-llama2-7b widths, then drives each of the port's paths at full
width (32 layers, d_model 4096, bf16 weights, random init from a seed):
the serving path (3 tenants compressed at the 128x DeltaDQ spec,
``Engine.generate`` for the base and each tenant, then the merge of
tenant0's delta into the base weights), one mixed-tenant decode batch of
8 slots through ``lm.decode_step`` with a slot-dispatched delta tree,
the continuous-batching engine (``serve.ContinuousEngine``: a mixed
12-request stream, each tenant's requests alone, ``Engine.generate`` per
request, and the chunked-prefill engine on the same stream against B=1
chunked decode), the codec family (``[codecs]``: a DeltaDQ/BitDelta
fleet in one engine at 16 of the 32 layers, two codec groups, against
each tenant alone; on a 1-layer copy ``compress(codec="auto")``), the
tenant lifecycle (``[lifecycle]``: a tenant table and a
``DeltaRegistry`` registering, rolling out, retiring, evicting and
promoting tenants mid-traffic, against engines built up front), the
pre-decoded residency tier (``[residency]``: the engine with a 4-row
budget, packed on the card, equal to the packed run; resident values
bit-equal to in-step decode), the storage layer (``[storage]``: every matrix of
tenant0's first 8 layers through the m-part parts and back onto the
card), the
group-size search and the baselines (``[groupsearch]``: the card against
the CPU), the packings past the TPU kernels' envelope (``[envelope]``:
``DeltaDQSpec()``'s row-wise default and an h_g 1024 packing at wq, wi
and MLP wo, every kernel against its plain version and the oracle's bits;
a 128x, a row-wise, an h_g 1024 and an h_g* tenant served together at 8
of 32 layers, mixed == alone), the autotune sweep (``[autotune]``:
``kernels/autotune.py::sweep_point`` live at wizard's 128x wi and its
row-wise MLP wo, T = 8 and 128, every tile bit-equal to the rule's, beside
the committed table's choice, which ``ops`` takes on a card the table
names, so every path's route counts come from ``ops``' choice), the
serving mesh (``[mesh]``: ``ContinuousEngine(mesh=)`` on
meshes (1, 2) and (2, 2) whose ranks share the card over gloo, against
the single-card engine's tokens; the sharded correction bit for bit
against the single-card kernels; the cuBLAS column-slice check), the
quickstart (``launch/quickstart.py``: compress, serve
separately and merged), the kernels demo (``launch/kernels_demo.py``: the
four kernels' entry points), the other dense configs at full width
(``[archs]``: gemma3-1b at 6 of its 26 layers, gemma-7b at 7 of 28 and
phi3-medium-14b at 10 of 40, each
with 3 tenants, both correction kernels at its site new to them, and the
engine, mixed == alone; gemma3's prompts wrap its 512-token rings, whole
and chunked) and, last, the MoE family
(``[moe]``: qwen3-moe-30b-a3b at full width and 8 of its 48 layers,
then llama4-scout-17b-a16e at full width and 8 of its 48 layers, 2
tenants each, the expert-stacked route onto the segments kernel against
its plain version and ``torch.bmm``, a tenant's logits against the plain
expert correction, ``Engine.generate`` and ``serve_batch``'s grouped
fallback, the continuous engine without the routed experts' deltas,
mixed == alone) and the remaining families (``[families]``: mamba2-370m,
recurrentgemma-9b, seamless-m4t-medium and llama-3.2-vision-11b at full
width, at the depths ``ARCH_DEPTH`` sets, with
3 tenants each, the correction kernels at their new sites, a tenant's
logits against the plain correction; the recurrent configs through the
continuous engine whole-prompt and chunked, mixed == alone and against
``Engine.generate``; the cross-attention configs through
``Engine.generate`` with encoder frames or image embeddings), and,
outside inference mode, training (``[train]``: llama3.2-1b at full width
and depth through ``launch/train.py``, the gradient of
``loss_fn(deltas=)`` through the kernels against the plain correction's
autograd, the 3m lifecycle of ``launch/train_sft_delta.py`` and a
bit-exact crash-restart). The
correction kernels are also held to their
plain versions on the codec packings (BitDelta and LowRank lowerings,
keep = h_g = 128). It checks the outputs, that each path launched
its kernels, and prints one JSON line of kernel measurements, then the
card's name and power limit, then a final JSON status line. Any failed
check raises: the script exits non-zero and prints no status line. It
needs CUDA, and the checkout's ``src/`` beside it. Details go to
``build/chip_smoke_report.json``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
ARCH = "wizard-llama2-7b"     # served at its full published width
SRC = os.path.join(HERE, "src")

# full-width wizard-llama2-7b sites (h_in, h_out) and the 128x packing
SITES = {"wq": (4096, 4096), "wi": (4096, 11008), "mlp_wo": (11008, 4096)}
H_G, ALPHA = 16, 8.0
K_CASES = (4, 8, None)
# 16 and 64: the [engine] phase's prompt chunks (ENGINE_CHUNK) and its
# bucket-64 prefills, which take delta_spmm's decode route
PARITY_T = (1, 2, 4, 8, 16, 64, 128, 256)
FUSED_T = (1, 2, 8, 128, 256)
PREFILL_T = (128, 256)             # delta_spmm's prefill route (row tile 128)
DECODE_T = (1, 2, 4, 8, 16, 32, 64)   # delta_spmm's decode route, timed
# the mixed decode step's slot layout (0 = base): 4 two-row segments
MIXED_SLOT_ROWS = (0, 1, 2, 3, 1, 0, 3, 2)
# delta_spmm's two routes (the decode route at its 8-row tile and the
# 128-row prefill tile) timed against each other around the edges of
# ops.spmm_row_tile's rule, in alternating rounds for their spread
ROUTE_T = (64, 96, 128, 160, 256)
ROUTE_ROUNDS = 5
ORDER_SITE, ORDER_T = "wi", (1, 8, 128, 256)   # bit-exact kernel-order checks
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)      # tests/test_kernels.py:44, f32
# Random weights plus the launcher's 0.02 tenant noise (larger than the
# 1/64 init std at d_model 4096) make the 32-layer stack chaotic: a
# relative error entering early grows ~100x by the logits. So the merged
# model keeps f32 weights (re-rounding base + delta to bf16 alone moves
# the logits by ~20% on an H100), and only summation order separates the
# two paths.
MERGED_REL_TOL = 1e-2
# chunked against whole-prompt prefill, first-token logits, with the
# ring in f32 so the chunk's K/V are not rounded: summation order only.
# Sound readings on an H100 were 1.8e-6 - 4.6e-5; with the engine's bf16
# ring the base requests (the least chaotic) read 2.4e-3 - 3.2e-3, so a
# bf16 rounding fault in the chunk path lands above this bound.
CHUNK_F32_REL_TOL = 1e-3
# [engine]'s chunked engine is held to B=1 chunked decode and to
# whole-prompt prefill on its first CHUNK_CHECK_REQUESTS requests (one of
# each of base, tenant0..2 in the round-robin stream), a cut made with
# the depths below to keep the script inside its time limit
CHUNK_CHECK_REQUESTS = 4
# mixed (B=8) vs per-tenant (B=2) decode: the base GEMMs and attention
# run at other batch extents (cuBLAS may pick other kernels), and the
# bf16 KV cache can round a slightly different f32 value the other way;
# the same amplification applies. Each row must also sit nearer its own
# tenant's logits than any other tenant's.
MIXED_REL_TOL = 5e-2
# the segments kernel's library yardstick, one torch.bmm over a per-row
# f32 dense delta stack, is timed where that stack fits in this many
# bytes: the decode shapes (1.4 GB at wi, T=8), not prefill (46 GB)
LIBRARY_STACK_MAX_BYTES = 4e9
# the [engine] phase: ContinuousEngine over {base, tenant0..2} at full
# width, 12 requests round-robin with prompts of 33..128 tokens (length
# buckets 64 and 128) from a seeded numpy generator
ENGINE_SLOTS, ENGINE_MAX_SEQ, ENGINE_REQUESTS, ENGINE_NEW = 8, 256, 12, 16
ENGINE_GAP, ENGINE_TICK, ENGINE_SEED, ENGINE_CHUNK = 0.002, 1e-3, 15, 16
# the codec slice: BitDelta (2-bit codes) and LowRank (f32 values)
# lowerings, keep = h_g = 128, held to the plain versions at these T and
# timed at these sites and T
CODEC_T = (1, 8, 16, 64, 128)
CODEC_BITS_T = 16      # rows up to which [parity] holds the dense walk to its twins
CODEC_TIME_SITES = ("wi", "mlp_wo")
CODEC_TIME_T = (8, 128)
# the LowRank tenant beside a DeltaDQ one and compress(codec="auto") run
# on a copy of the model cut to 1 layer at full width: LowRank's f32
# runtime values are 32.4 GB a tenant at full depth, beyond one card beside
# the base. Its factors come from numpy's SVD on the host, 138.9 and 190.9 s
# for one layer's 7 matrices in two runs (H100 80GB HBM3 hosts, 700.00 W
# cards; PERF.md §6), so LowRank compresses one attention and one MLP leaf
# (4096 x 4096 and 11008 x 4096: 15.65 and 24.84 s in the first run) and
# the tenant's other leaves are DeltaDQ 128x of the same fine-tune
LOWRANK_LAYERS = 1
LOWRANK_LEAVES = ("attn/wq", "mlp/wo")
LIFECYCLE_CAPACITY = 4
# [residency]: the tier's budget in rows of f32 values (3.24 GB a row at
# full wizard-llama2-7b width); [storage]: host threads for the m-part
# round trip of tenant0's matrices, and the layers whose 7 matrices go
# (8 of 32: the whole tenant took 50-59 s of host time, the same code
# path per matrix, and [engine]'s chunked alone runs needed the time);
# [groupsearch]: calibration tokens and the card-vs-CPU bound on the
# proxy error (f32, summation order)
RESIDENCY_ROWS = 4
STORAGE_THREADS = 8
STORAGE_LAYERS = 8
GROUPSEARCH_TOKENS = 256
GROUPSEARCH_REL_TOL = 1e-4
# [envelope]: packings past the reference's Pallas envelope (h_g above
# 256 with int32 idx, up to h_in; keep above 128) as the compressor emits
# them, at wizard's full-width SITES: DeltaDQSpec()'s row-wise default
# (h_g = h_in, f32 codes: keep 512 at d_model inputs, 1376 at MLP wo) and a
# 4-bit packing at h_g 1024 (256 at MLP wo, the largest halving dividing
# 11008). Each kernel against its plain version at KERNEL_TOL, rows
# bit-equal to the kernel-order oracle across decode tiles and in their
# segment at ENVELOPE_CHECK_T; times at ENVELOPE_T and the mixed segments
# layout; the merge kernels timed at ENVELOPE_MERGE_SITE. Then a fleet at
# CODECS_DEPTH layers on the [engine] stream, mixed == alone.
ENVELOPE_SPECS = {"rowwise": {}, "h1024": {"alpha": 8.0, "k_bits": 4, "m": 8, "h_g": 1024}}
ENVELOPE_CHECK_T = (1, 8, 65, 128)
ENVELOPE_T = (8, 128)
ENVELOPE_MERGE_SITE = "wi"
# [archs]: each config's site new to the kernels (block, leaf): gemma3's
# wk (1152 x 256), gemma-7b's MLP wo (h_in 24576), phi3's wi (5120 x 17920)
ARCH_SITES = {"gemma3-1b": ("attn", "wk"), "gemma-7b": ("mlp", "wo"),
              "phi3-medium-14b": ("mlp", "wi")}
# depth cuts, widths, windows and streams unchanged, each made to keep
# the script inside its time limit (PERF.md §6 lists each with the time
# it saved): gemma3-1b runs one period of its 5:1 local:global pattern, 6
# of its 26 layers; llama4-scout-17b-a16e (215.5 GB in bf16) 8 of 48;
# qwen3-moe-30b-a3b 8 of its 48 (the MOE_RING slices); [codecs]' fleet
# CODECS_DEPTH 8 of wizard's 32; gemma-7b 7 of 28 and phi3-medium-14b 10
# of 40; mamba2-370m 6 of its 48 SSD layers; recurrentgemma-9b one period
# of its 2 RG-LRU : 1 attention pattern (3 of 38; its gate stacks are
# then [2, 4096], not compressible, so no leaf is left out of its
# tenants); llama-3.2-vision-11b 5 of its 40 self layers, which hold one
# gated cross block; seamless-m4t-medium 6 of its 12 decoder layers (its
# encoder whole)
ARCH_DEPTH = {"gemma3-1b": 6, "mamba2-370m": 6, "recurrentgemma-9b": 3,
              "llama-3.2-vision-11b": 5, "qwen3-moe-30b-a3b": 8,
              "llama4-scout-17b-a16e": 8, "gemma-7b": 7, "phi3-medium-14b": 10,
              "seamless-m4t-medium": 6}
CODECS_DEPTH = 8
# gemma3-1b's stream: prompts longer than its 512-token local window
WINDOW_REQUESTS, WINDOW_MIN, WINDOW_MAX, WINDOW_SEED, WINDOW_CHUNK = 12, 520, 900, 17, 64
# [moe]: qwen3-moe-30b-a3b at its published width (8 of its 48 layers,
# ARCH_DEPTH) with 2 tenants at 128x (at full depth a third did not fit
# beside the 62.3 GB base). The
# expert route is checked and timed at (routed tokens T, capacity C) in
# MOE_CASES: C = 1 at T = 2 (Engine.generate's B=2 decode) and T = 8,
# C = 10 at T = 128 (a 128-token prefill), all three at cf 1.25, and
# C = 64 (cf 8.0 at T = 128), with per-expert counts routed from T
# tokens, on a ring of MOE_RING layer slices. The continuous engine
# serves at cf = E / K, the least at which C >= T, so no row can be
# dropped for another row's routing and mixed serving must equal serving
# alone token for token (the reference's cf 8.0 gives C = 2T at its smoke
# size, C = T / 2 here); one more pass at cf 8.0 counts the requests
# whose tokens change with the batch they were routed in.
# llama4-scout-17b-a16e ([hf:meta-llama/Llama-4-Scout-17B-16E]: 16 experts
# top-1 and a shared expert, d_model 5120, GQA 40/8) runs the same checks
# after qwen3's objects are freed, at full width and ARCH_DEPTH's 8 layers
MOE_ARCHS, MOE_TENANTS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"), 2
MOE_CASES = ((2, 1), (8, 1), (128, 10), (128, 64))
MOE_CF_DROPS = 8.0
MOE_RING = 8
MOE_SITES = ("wi", "wg", "wo")
# first-token logits of a tenant through the kernels against the same
# tenant with the plain expert correction (dense reconstruction and a
# batched product, the reference's formulation): summation order only,
# through qwen3's 8 routed layers. An H100 (80GB HBM3, 700 W) read 6.3e-7
# of max|logit| through all 48 (6.15e-7 through 24, 6.14e-7 through 8;
# 2.5e-6 through llama4-scout's 8); the bound is 16x the first, and a
# control with one expert's correction zeroed (MOE_CONTROL_EXPERT, in
# every layer) must exceed it (it read 3.98e-2 of max|logit| through 8)
MOE_LOGIT_REL_TOL = 1e-5
MOE_CONTROL_EXPERT = 0
# [families]: the SSM, hybrid RG-LRU, enc-dec and VLM configs at full width
# and depth, one after the other, 3 tenants each at 128x. FAMILY_SITES are
# each config's linear sites new to the correction kernels (path, extra T):
# mamba2's wdt has 32 output columns, the fewest of any site; the extra T
# is the rows a memory-side site gets, B * enc_len encoder frames or
# B * 1600 image tokens. The recurrent configs serve the [engine] stream
# whole-prompt and chunked (ENGINE_CHUNK); the cross-attention configs go
# through Engine.generate with FAMILY_B prompts of FAMILY_S tokens and
# their frontend inputs (FAMILY_ENC_LEN frames, n_frontend_tokens image
# embeddings) drawn from a generator seeded FAMILY_SEED.
FAMILY_SITES = {
    "mamba2-370m": (("ssm/wdt", None), ("ssm/wbc", None), ("ssm/wout", None)),
    "recurrentgemma-9b": (("rec/linear_x", None), ("rec/linear_out", None),
                          ("attn/wk", None)),
    "seamless-m4t-medium": (("enc/attn/wq", "memory"), ("dec_cross/wk", "memory")),
    "llama-3.2-vision-11b": (("cross/wk", "memory"), ("cross/wq", None)),
}
FAMILY_B, FAMILY_S, FAMILY_NEW, FAMILY_ENC_LEN, FAMILY_SEED = 2, 64, 16, 256, 19
FAMILY_KERNEL_T = (2, 8, 128)
# the vlm's cross gates (tanh-scaled, initialized to 0 as in the reference)
# are set to this value so the cross blocks contribute to the logits
VLM_GATE = 1.0
# tenant0's first-token logits through the kernels against the same tenant
# with the plain correction (ops.delta_spmm replaced by its plain version),
# relative to max|logit|: summation order only. An H100 read 2.9e-5
# (mamba2) and 4.4e-5 (the vlm); the bound is 23-34x those readings. A
# control with one site's correction dropped in every layer
# (FAMILY_CONTROL) must exceed it. seamless's encoder keeps its residual in
# the param dtype, and in bf16 its random weights amplify a last-bit
# difference of one correction into a rel 8.2e-2 change of the logits (the
# argmax moved; same card): its check runs on an f32 copy of the weights
FAMILY_LOGIT_REL_TOL = 1e-3
FAMILY_CONTROL = {"mamba2-370m": "ssm/wdt", "recurrentgemma-9b": "rec/linear_x",
                  "seamless-m4t-medium": "enc/attn/wq", "llama-3.2-vision-11b": "cross/wk"}
# [train]: llama3.2-1b ([hf:meta-llama/Llama-3.2-1B]) at published width and
# depth through repro_torch.launch.train (remat on, AdamW with the
# launcher's cosine warmup); its 8 x 128 batch is the T = 1024 rows the
# correction kernels get at its sites (TRAIN_SITES, timed there). The
# gradient of loss_fn(deltas=) through the kernels (delta_spmm forward,
# dequant backward) against native autograd through the plain correction,
# per leaf relative to that leaf's max|g|: the stacks' grads are bf16 in
# both, and a last-bit f32 difference moves a bf16 rounding by one
# spacing, at most 2^-7 of the value; the bound is two such spacings. A
# control without every layer's mlp/wi correction must exceed it.
TRAIN_ARCH = "llama3.2-1b"
TRAIN_ARGS = ["--full", "--arch", TRAIN_ARCH, "--steps", "6", "--batch", "8", "--seq", "128",
              "--log-every", "1"]
TRAIN_B, TRAIN_S = 8, 128
TRAIN_SITES = {"wq": (2048, 2048), "wk": (2048, 512), "wi": (2048, 8192)}
TRAIN_GRAD_REL_TOL = 2.0 ** -6
TRAIN_CONTROL = ("mlp", "wi")
# the segments and fused routes' backward at the wi site: two sequences'
# rows (the plain segments version holds [T, G, K, O] per-row copies)
TRAIN_ROUTE_T = 2 * TRAIN_S
# the lifecycle's gates: tests/test_system.py:92-96
SFT_FT_MIN, SFT_BASE_MAX, SFT_TENANT_SHARE = 0.85, 0.6, 0.8
# crash-restart (tests/test_checkpoint.py:25-46) at the smoke config
RESTART_STEPS, RESTART_SEQ, RESTART_BATCH = 3, 16, 4
DEQUANT_LIBRARY_NOTE = "no single PyTorch call decodes the packed codes"
REPLACED_NOTE = ("the kernel this one replaced is gone from this checkout; it is timed "
                 "by the parent commit's chip_smoke.py in the same chip call (PERF.md)")


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fns, iters: int = 20, reps: int = 5, eager: bool = False) -> float:
    """Median per-call device time of cycling through ``fns`` (a ring of
    calls on distinct inputs, so each call finds its inputs cold in L2).

    The calls are captured once in a CUDA graph and the graph is replayed
    between two events, so the time is the card's: a decode-size kernel
    takes less time on the card than one eager call takes to enqueue on
    the host, and timing an eager loop would measure the host. ``eager``
    times an eager loop instead: the plain versions (which read values
    back to the host) and whole model steps (the latency a caller sees)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = None
    if eager:
        def run():
            for i in range(iters):
                fns[i % len(fns)]()
    else:
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
        run = graph.replay
    run()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per)


def _first_layers(cfg, base, trees: list, n: int) -> tuple:
    """A dense config cut to its first ``n`` layers, its params and each
    delta tree in ``trees`` as views of their first ``n`` layer slices
    (nothing copied). -> (cfg, base, trees)."""
    from repro_torch.core.pack import PackedDelta
    from repro_torch.utils import map_with_paths

    def cut(path, leaf):
        if not path.startswith(("attn/", "mlp/")) or leaf is None:
            return leaf
        if isinstance(leaf, PackedDelta):
            return leaf.with_arrays(leaf.idx[:n], leaf.codes[:n], leaf.scale[:n],
                                    leaf.zero[:n])
        return leaf[:n]

    ccfg = dataclasses.replace(cfg, n_layers=n, layer_kinds=cfg.layer_kinds[:n],
                               layer_windows=cfg.layer_windows[:n])
    return ccfg, map_with_paths(cut, base), [map_with_paths(cut, t) for t in trees]


def _at_depth(cfg):
    """``cfg`` cut to ARCH_DEPTH's layers (the first n, with their kinds
    and windows), or as it is."""
    n = ARCH_DEPTH.get(cfg.name)
    if n is None:
        return cfg
    return cfg.replace(n_layers=n, layer_kinds=cfg.layer_kinds[:n],
                       layer_windows=cfg.layer_windows[:n])


def _dryrun_bytes(tag: str, cfg, base, fleet, spec, dropped=()) -> dict:
    """The dry run's predicted params and tenant bytes
    (``launch/dryrun.py``'s specs on the ``meta`` device) beside the built
    trees' bytes; a mismatch fails. ``dropped``: leaves left out of the
    tenants (None in their trees)."""
    from repro_torch.core.compress import delta_specs
    from repro_torch.launch import dryrun
    from repro_torch.utils import materialize, tree_bytes

    def prune(tree, prefix=""):
        return {k: prune(v, f"{prefix}{k}/") if isinstance(v, dict) else v
                for k, v in tree.items() if f"{prefix}{k}" not in dropped}

    p_specs = dryrun.param_specs(cfg)
    want = {"params": tree_bytes(materialize(p_specs)),
            "tenant": tree_bytes(materialize(delta_specs(prune(p_specs), spec)))}
    got = {"params": tree_bytes(base), "tenants": [tree_bytes(d) for _, d, _ in fleet]}
    log(f"[dryrun] {tag} {cfg.name} ({cfg.n_layers} layers): params predicted "
        f"{want['params']} B, built {got['params']} B; a tenant predicted "
        f"{want['tenant']} B, built {got['tenants']} B")
    if got["params"] != want["params"] or any(t != want["tenant"] for t in got["tenants"]):
        fail(f"[dryrun] {tag} {cfg.name}: the dry run's bytes {want} differ from the built "
             f"trees' {got}")
    return {"predicted": want, "built": got}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(kern) -> float:
    t0 = time.perf_counter()
    path = kern.build()
    dt = time.perf_counter() - t0
    log(f"[build] {path} in {dt:.1f} s")
    name, spill = "?", ""
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"[build] ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")
    return dt


def _rand_packed(torch, dropout, h_in, h_out, k_bits, gen):
    delta = torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02
    return dropout.groupwise_dropout_pack(
        delta, h_g=H_G, alpha=ALPHA, k_bits=k_bits, m=8 if k_bits == 4 else 1,
        generator=gen)


def _plain_segments(torch, fb, xs, stack, seg_rows, seg_offsets, gather_max_t=None):
    """The segments kernel's plain version; per-segment gather/dense
    formulation past decode sizes, where the per-row gather would need
    tens of GB (``gather_max_t`` as in ``fb.correction``)."""
    if xs.shape[0] <= 8:
        return fb.segment_correction(xs, stack, seg_rows, seg_offsets)
    y = torch.zeros((xs.shape[0], stack.h_out), device=xs.device)
    offs = seg_offsets.tolist()
    for s, t in enumerate(seg_rows.tolist()):
        # a segment whose tenant row is outside the stack stays zero
        if offs[s + 1] > offs[s] and 0 <= t < stack.idx.shape[0]:
            y[offs[s]:offs[s + 1]] = fb.correction(
                xs[offs[s]:offs[s + 1]], stack.index(t),
                **({} if gather_max_t is None else {"gather_max_t": gather_max_t}))
    return y


def _chunk_segments(T: int, row: int = 1):
    """The segment layout of one prompt chunk of T tokens as the chunked
    engine builds it: ``tenant_segments`` of the chunk row's one tenant
    row, offsets scaled by the T tokens (``core.apply._segment_dispatch``),
    so one segment of T rows. -> (seg_rows, seg_offsets) on the card."""
    import numpy as np
    from repro_torch.serve.scheduler import tenant_segments
    seg = tenant_segments(np.array([row], np.int32)).to(DEVICE)
    return seg.seg_rows, seg.seg_offsets * T


def _mixed_rows(T: int, n_tenants: int = 4):
    import numpy as np
    return np.random.default_rng(T).integers(0, n_tenants, T).astype(np.int32)


def _check_order(torch, kern, ref, x, d, where: str) -> int:
    """Both delta_spmm routes (the decode tile for T and the 128-row
    prefill tile) equal kernels/ref.py's kernel-order oracle bit for bit."""
    from repro_torch.kernels import ops
    want = ref.correction_kernel_order(x, d)
    tiles = (ops.row_tile(x.shape[0]), *kern.PREFILL_TILES)
    for tb in tiles:
        y = kern.delta_spmm_cuda(x, d, tb=tb)
        if not torch.equal(y.view(torch.int32), want.view(torch.int32)):
            n_bad = int((y != want).sum().item())
            fail(f"delta_spmm {where} tb={tb}: {n_bad} elements differ from "
                 f"correction_kernel_order")
    return len(tiles)


def _spmm_routes(ops, kern, deltas, calls: dict, times: int = 1) -> dict:
    """delta_spmm launches by route that ``ops``' choice (the autotune
    table where it applies, else the rules) gives ``times`` runs of ``n``
    calls at each T of ``calls`` ({T: n}) at every layer of every packed
    leaf of ``deltas`` with one leading (layer) axis; expert stacks (two
    leading axes) take the expert route and are left out."""
    from repro_torch.core.pack import PackedDelta
    from repro_torch.utils import iter_leaves
    out = {"delta_spmm_decode": 0, "delta_spmm_prefill": 0}
    for _, leaf in iter_leaves(deltas):
        if not isinstance(leaf, PackedDelta) or len(leaf.stack_shape()) != 1:
            continue
        for layer in range(leaf.stack_shape()[0]):
            for T, n in calls.items():
                tb = ops.spmm_row_tile(T, leaf.index(layer))
                out["delta_spmm_prefill" if tb in kern.PREFILL_TILES
                    else "delta_spmm_decode"] += n * times
    return out


def _check_prefill_bits(torch, kern, ops, x, d, where: str) -> None:
    """delta_spmm at T rows (the prefill route) equals the same rows in
    chunks of 8 (the tb=8 route) bit for bit, and a second call gives the
    same bits."""
    y = ops.delta_spmm(x, d)
    chunks = torch.cat([kern.delta_spmm_cuda(x[i:i + 8], d, tb=8)
                        for i in range(0, x.shape[0], 8)])
    if not torch.equal(y.view(torch.int32), chunks.view(torch.int32)):
        fail(f"delta_spmm {where}: prefill rows != tb=8 rows")
    if not torch.equal(y.view(torch.int32), ops.delta_spmm(x, d).view(torch.int32)):
        fail(f"delta_spmm {where}: two calls differ")


def phase_parity(torch, report: dict) -> dict:
    """The kernels against their plain versions at full widths, the
    bit-identity properties, and device times at decode/prefill shapes."""
    from repro_torch.core import dropout
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.scheduler import tenant_segments

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0, "fused_base_delta": 0.0,
             "dequant": 0.0}
    rows_out = []
    n_fused = n_order = n_chunk = 0
    for site, (h_in, h_out) in SITES.items():
        w = (torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02).to(
            torch.bfloat16)
        w32 = torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02
        for k in K_CASES:
            d = _rand_packed(torch, dropout, h_in, h_out, k, gen)
            # dequant: no reduction, so bit for bit
            dense = ops.dequant(d)
            want = fb.dequant(d)
            torch.cuda.synchronize()
            worst["dequant"] = max(worst["dequant"], (dense - want).abs().max().item())
            if not torch.equal(dense.view(torch.int32), want.view(torch.int32)):
                fail(f"dequant {site} k={k}: not bit-equal to the plain version")
            del dense, want
            for T in FUSED_T:
                x = torch.randn((T, h_in), generator=gen, device=DEVICE)
                for wt in (w, w32):
                    y = ops.fused_base_delta(x, wt, d)
                    want = fb.fused_base_delta(x, wt, d)
                    torch.cuda.synchronize()
                    err = (y - want).abs().max().item()
                    worst["fused_base_delta"] = max(worst["fused_base_delta"], err)
                    if not torch.allclose(y, want, **KERNEL_TOL):
                        fail(f"fused_base_delta {site} k={k} T={T} W {wt.dtype}: max err "
                             f"{err:.3e}")
                    if not torch.equal(y.view(torch.int32),
                                       ops.fused_base_delta(x, wt, d).view(torch.int32)):
                        fail(f"fused_base_delta {site} k={k} T={T}: two calls differ")
                    n_fused += 1
            tenants = [_rand_packed(torch, dropout, h_in, h_out, k, gen) for _ in range(4)]
            stack = stack_tenant_deltas([{"w": t} for t in tenants])["w"]
            for T in PARITY_T:
                x = torch.randn((T, h_in), generator=gen, device=DEVICE)
                y = ops.delta_spmm(x, d)
                want = fb.correction(x, d)
                torch.cuda.synchronize()
                err = (y - want).abs().max().item()
                worst["delta_spmm"] = max(worst["delta_spmm"], err)
                if not torch.allclose(y, want, **KERNEL_TOL):
                    fail(f"delta_spmm {site} k={k} T={T}: max err {err:.3e}")
                seg = tenant_segments(_mixed_rows(T)).to(DEVICE)
                xs = x.index_select(0, seg.order)
                ys = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
                wants = _plain_segments(torch, fb, xs, stack, seg.seg_rows,
                                        seg.seg_offsets)
                torch.cuda.synchronize()
                err_s = (ys - wants).abs().max().item()
                worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"], err_s)
                if not torch.allclose(ys, wants, **KERNEL_TOL):
                    fail(f"delta_spmm_segments {site} k={k} T={T}: max err {err_s:.3e}")
                if T in PREFILL_T:
                    _check_prefill_bits(torch, kern, ops, x, d, f"{site} k={k} T={T}")
                    sorted_rows = torch.as_tensor(_mixed_rows(T), device=DEVICE)[seg.order]
                    for t in range(4):
                        sel = sorted_rows == t
                        if not torch.equal(ys[sel], ops.delta_spmm(xs, stack.index(t))[sel]):
                            fail(f"segments rows != prefill delta_spmm rows ({site} k={k} "
                                 f"T={T} tenant {t})")
                if site == ORDER_SITE and T in ORDER_T:
                    n_order += _check_order(torch, kern, ref, x, d, f"{site} k={k} T={T}")
                rows_out.append({"site": site, "k_bits": k, "T": T,
                                 "spmm_err": err, "segments_err": err_s})
            # a T=1 row has the bits it has inside T=8
            x8 = torch.randn((8, h_in), generator=gen, device=DEVICE)
            y8 = ops.delta_spmm(x8, d)
            for r in range(8):
                if not torch.equal(ops.delta_spmm(x8[r:r + 1], d)[0], y8[r]):
                    fail(f"delta_spmm {site} k={k}: row {r} alone != in T=8")
            # 4-tenant, 8-row mixed batch: segment rows == delta_spmm rows
            rows = _mixed_rows(8)
            seg = tenant_segments(rows).to(DEVICE)
            xs = x8.index_select(0, seg.order)
            ys = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
            sorted_rows = torch.as_tensor(rows, device=DEVICE)[seg.order]
            for t in range(4):
                per = ops.delta_spmm(xs, stack.index(t))
                sel = sorted_rows == t
                if not torch.equal(ys[sel], per[sel]):
                    fail(f"segments rows != delta_spmm rows ({site} k={k} tenant {t})")
            # the engine's layout leaves row 0's segment out: those rows
            # come back zero-filled, the others with the same bits
            seg0 = tenant_segments(rows, skip_zero_row=True).to(DEVICE)
            y0 = ops.delta_spmm_segments(xs, stack, seg0.seg_rows, seg0.seg_offsets)
            z = sorted_rows == 0
            if not z.any() or not torch.equal(y0[~z], ys[~z]) or \
                    not torch.equal(y0[z], torch.zeros_like(y0[z])):
                fail(f"segments without row 0's segment ({site} k={k}): rows differ")
            # one prompt chunk of the chunked engine (one segment of
            # ENGINE_CHUNK rows): within KERNEL_TOL of the plain version and
            # the bits of delta_spmm on that tenant's delta
            xc = torch.randn((ENGINE_CHUNK, h_in), generator=gen, device=DEVICE)
            c_rows, c_offs = _chunk_segments(ENGINE_CHUNK)
            yc = ops.delta_spmm_segments(xc, stack, c_rows, c_offs)
            wantc = _plain_segments(torch, fb, xc, stack, c_rows, c_offs)
            torch.cuda.synchronize()
            err_c = (yc - wantc).abs().max().item()
            worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"], err_c)
            if not torch.allclose(yc, wantc, **KERNEL_TOL):
                fail(f"delta_spmm_segments chunk layout {site} k={k}: max err {err_c:.3e}")
            if not torch.equal(yc, ops.delta_spmm(xc, stack.index(1))):
                fail(f"chunk segment rows != delta_spmm rows ({site} k={k})")
            n_chunk += 1
            # 8 one-row slots (delta_spmm_slots): each row has its delta's bits
            slots = stack_tenant_deltas([{"w": tenants[b % 4]} for b in range(8)])["w"]
            ysl = ops.delta_spmm_slots(x8.reshape(8, 1, h_in), slots)
            for b in range(8):
                if not torch.equal(ysl[b, 0], ops.delta_spmm(x8[b:b + 1], tenants[b % 4])[0]):
                    fail(f"slot row {b} != delta_spmm row ({site} k={k})")
            # rows no segment covers and an out-of-stack tenant row are zero
            yz = ops.delta_spmm_segments(x8, stack, torch.tensor([1, 9], device=DEVICE,
                                                                 dtype=torch.int32),
                                         torch.tensor([1, 3, 5], device=DEVICE,
                                                      dtype=torch.int32))
            if yz[[0, 3, 4, 5, 6, 7]].any() or not torch.equal(
                    yz[1:3], ops.delta_spmm(x8[1:3], stack.index(1))):
                fail(f"segments zero fill ({site} k={k})")
        del w, w32
    torch.cuda.synchronize()
    if ORDER_T and n_order != len(K_CASES) * len(ORDER_T) * (1 + len(kern.PREFILL_TILES)):
        fail(f"the kernel-order checks ran {n_order} times")
    log(f"[parity] {len(rows_out)} cases x 2 kernels within atol/rtol 1e-4 "
        f"(worst |err| spmm {worst['delta_spmm']:.3e}, segments "
        f"{worst['delta_spmm_segments']:.3e}); the chunked engine's one-segment "
        f"{ENGINE_CHUNK}-row chunk layout within atol/rtol 1e-4 in {n_chunk} cases; "
        f"T=1 == row of T=8, segment rows, chunk rows and slot rows == delta_spmm rows "
        f"bit for bit, uncovered and out-of-stack segment rows zero, at all sites and "
        f"k_bits")
    log(f"[parity] delta_spmm at T {list(PREFILL_T)} == the same rows through tb=8, "
        f"bit for bit, and two calls equal, at all sites and k_bits; both routes "
        f"(decode tile, 128 rows) == ref.correction_kernel_order bit for bit at "
        f"{ORDER_SITE}, k_bits {list(K_CASES)}, T {list(ORDER_T)} ({n_order} checks)")
    log(f"[parity] dequant bit-equal to its plain version in "
        f"{len(SITES) * len(K_CASES)} cases; fused_base_delta (bf16 and f32 W) within "
        f"atol/rtol 1e-4 in {n_fused} cases (worst |err| "
        f"{worst['fused_base_delta']:.3e}), two calls bit-equal")
    report["parity"] = rows_out

    # device times at the main path's shapes, 128x spec (k=4), on a ring
    # of 8 distinct deltas per site so each launch reads them from HBM
    times = []
    for site, (h_in, h_out) in SITES.items():
        ring = [_rand_packed(torch, dropout, h_in, h_out, 4, gen) for _ in range(8)]
        dense = [reconstruct_dense(d) for d in ring]
        routes = _time_routes(torch, kern, ops, ring, gen, site, h_in)
        report.setdefault("routes", []).extend(routes.values())
        for T in DECODE_T + PREFILL_T:
            times.append(_time_spmm(torch, ops, fb, ring, dense, gen, site, T,
                                    routes.get(T)))
        for layout, T in (("mixed", 8), ("slots", 8), ("chunk", ENGINE_CHUNK),
                          ("random", 256)):
            times.append(_time_segments(torch, ops, fb, ring, gen, site, layout, T))
        times += _time_merge_kernels(torch, ring, dense, gen, site, h_in, h_out)
        del ring, dense
    report["times"] = times
    return worst


def _ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


def _log_time(t: dict, extra: str = "", tag: str = "time") -> None:
    codec = "" if t.get("codec", "deltadq") == "deltadq" else f" [{t['codec']}]"
    log(f"[{tag}] {t['kernel']:20s} {t['site']:6s} T={t['T']:3d}{codec}"
        f"{'' if 'layout' not in t else ' ' + t['layout']}"
        f"{'' if 'walk' not in t else ' (' + t['walk'] + ' walk)'}: kernel {t['ms']:.4f} ms, "
        f"plain {_ms(t['plain_ms'])} ms, library {_ms(t['library_ms'])} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){extra}")


def _time_spmm(torch, ops, fb, ring, dense, gen, site, T, route, full=True) -> dict:
    """delta_spmm at T rows on the ring: the route ops takes and (full)
    its plain version and one torch.matmul on the dense delta."""
    h_in, h_out = ring[0].h_in, ring[0].h_out
    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
    ms = time_ms(torch, [lambda d=d: ops.delta_spmm(x, d) for d in ring])
    plain = lib = None
    if full:
        plain = time_ms(torch, [lambda d=d: fb.correction(x, d) for d in ring], iters=8,
                        reps=3, eager=True)
        lib = time_ms(torch, [lambda w=w: torch.matmul(x, w) for w in dense])
    from repro_torch.roofline import analysis as rl
    from repro_torch.kernels import delta_spmm as kern
    route_tb = ops.spmm_row_tile(T, ring[0])
    b_ms, b_by = rl.bound_ms(*rl.delta_spmm_work(T, ring[0], route_tb))
    t = {"kernel": "delta_spmm", "site": site, "h_in": h_in, "h_out": h_out, "T": T,
         "codec": ring[0].codec, "tb": route_tb,
         "route": "decode" if route_tb in kern.ROW_TILES else "prefill", "ms": ms,
         "plain_ms": plain,
         "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
    extra = ""
    if route is not None:    # the other route, from the [route] rounds
        other = "decode_ms" if t["route"] == "prefill" else "prefill_ms"
        t["other_route_ms"] = route[other]
        extra = f"; other route ({other[:-3]}, median of the [route] rounds) {route[other]:.4f} ms"
    _log_time(t, extra, "time" if full else "kernel-times")
    return t


def _time_segments(torch, ops, fb, ring, gen, site, layout, T, full=True) -> dict:
    """delta_spmm_segments on 4-tenant stacks of the ring: ``mixed`` is
    the mixed decode step's layout (4 two-row segments, padded to 8),
    ``chunk`` one segment of T rows laid out as the chunked engine lays
    out a prompt chunk, ``random`` T rows over 4 tenants; ``slots`` is
    delta_spmm_slots on 8 distinct deltas (8 one-row segments of a
    row-gathered stack)."""
    import numpy as np
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.serve.scheduler import tenant_segments
    h_in, h_out = ring[0].h_in, ring[0].h_out
    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
    if layout == "slots":
        stacks = [stack_tenant_deltas([{"w": ring[(i + j) % 8]} for j in range(8)])["w"]
                  for i in range(2)]
        x3 = x.reshape(T, 1, h_in)
        n_deltas = T
        ms = time_ms(torch, [lambda s=s: ops.delta_spmm_slots(x3, s) for s in stacks])
        plain = lib = None
        if full:
            plain = time_ms(torch, [lambda s=s: fb.gather_correction_rows(x3, s)
                                    for s in stacks], iters=4, reps=3, eager=True)
            lib = _bmm_library_ms(torch, x, stacks[0], list(range(T)),
                                  ops.delta_spmm_slots(x3, stacks[0])[:, 0])
    else:
        rows = np.asarray(MIXED_SLOT_ROWS if layout == "mixed" else
                          np.ones(T) if layout == "chunk" else _mixed_rows(T), np.int32)
        stacks = [stack_tenant_deltas([{"w": ring[(i + j) % 8]} for j in range(4)])["w"]
                  for i in range(8)]
        if layout == "chunk":
            xs, (seg_rows, seg_offsets) = x, _chunk_segments(T)
        else:
            seg = tenant_segments(rows).to(DEVICE)
            xs, seg_rows, seg_offsets = x.index_select(0, seg.order), seg.seg_rows, seg.seg_offsets
            rows = rows[seg.order.cpu().numpy()]
        n_deltas = len(set(rows.tolist()))
        ms = time_ms(torch, [lambda s=s: ops.delta_spmm_segments(
            xs, s, seg_rows, seg_offsets) for s in stacks])
        plain = lib = None
        if full:
            plain = time_ms(torch, [lambda s=s: _plain_segments(
                torch, fb, xs, s, seg_rows, seg_offsets) for s in stacks],
                iters=4, reps=3, eager=True)
            lib = _bmm_library_ms(torch, xs, stacks[0], rows.tolist(),
                                  ops.delta_spmm_segments(xs, stacks[0], seg_rows,
                                                          seg_offsets))
    from repro_torch.roofline import analysis as rl
    b_ms, b_by = rl.bound_ms(*rl.segments_work(T, ring[0], n_deltas))
    t = {"kernel": "delta_spmm_segments", "layout": layout, "site": site, "h_in": h_in,
         "h_out": h_out, "T": T, "codec": ring[0].codec, "ms": ms, "plain_ms": plain, "library_ms": lib,
         "bound_ms": b_ms, "bound_by": b_by}
    _log_time(t, tag="time" if full else "kernel-times")
    return t


def _time_routes(torch, kern, ops, ring, gen, site, h_in) -> dict:
    """delta_spmm's decode route (its 8-row tile) and its 128-row prefill
    tile at ROUTE_T, timed in ROUTE_ROUNDS alternating rounds on the ring:
    {T: row}, each round's time and the medians."""
    pre, dec = kern.PREFILL_TILES[0], kern.ROW_TILES[-1]
    out = {}
    for T in ROUTE_T:
        x = torch.randn((T, h_in), generator=gen, device=DEVICE)
        rounds = {dec: [], pre: []}
        for _ in range(ROUTE_ROUNDS):
            for tb, per in rounds.items():
                per.append(time_ms(torch, [lambda d=d, tb=tb: kern.delta_spmm_cuda(
                    x, d, tb=tb) for d in ring]))
        row = {"site": site, "T": T, "ops_tile": ops.spmm_row_tile(T, ring[0]),
               "decode_rounds": rounds[dec], "prefill_rounds": rounds[pre],
               "decode_ms": statistics.median(rounds[dec]),
               "prefill_ms": statistics.median(rounds[pre])}
        out[T] = row
        log(f"[route] delta_spmm {site:6s} T={T:3d}: decode tb={dec} {row['decode_ms']:.4f} ms "
            f"({min(rounds[dec]):.4f}-{max(rounds[dec]):.4f}), tb={pre} "
            f"{row['prefill_ms']:.4f} ms ({min(rounds[pre]):.4f}-{max(rounds[pre]):.4f}) "
            f"over {ROUTE_ROUNDS} rounds; ops takes tb={row['ops_tile']}")
    return out


def _time_merge_kernels(torch, ring, dense, gen, site, h_in, h_out) -> list:
    """Device times of dequant and fused_base_delta on the same ring of
    8 deltas (128x spec), with 8 distinct bf16 W for the fused kernel."""
    from repro_torch.core.apply import apply_linear
    from repro_torch.core.pack import decode_values
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops

    from repro_torch.roofline import analysis as rl
    out = []
    # dequant: no single PyTorch call decodes the packed codes. Partial
    # yardstick, the write half only: zero fill + one scatter_ of values
    # decoded beforehand (int64 indices) into the dense matrix.
    G, h_g = ring[0].n_groups, ring[0].h_g
    pre = [(decode_values(d), d.idx.long()) for d in ring]

    def scatter(v, i):
        return torch.zeros((G, h_g, h_out), device=DEVICE).scatter_(1, i, v)

    if not torch.equal(scatter(*pre[0]).view(h_in, h_out), ops.dequant(ring[0])):
        fail("the dequant partial yardstick disagrees with the kernel")
    ms = time_ms(torch, [lambda d=d: ops.dequant(d) for d in ring])
    plain = time_ms(torch, [lambda d=d: fb.dequant(d) for d in ring], iters=8, reps=3,
                    eager=True)
    part = time_ms(torch, [lambda p=p: scatter(*p) for p in pre])
    b_ms, b_by = rl.bound_ms(*rl.dequant_work(ring[0]))
    out.append({"kernel": "dequant", "site": site, "h_in": h_in, "h_out": h_out,
                "T": None, "ms": ms, "plain_ms": plain, "library_ms": None,
                "library_note": DEQUANT_LIBRARY_NOTE, "scatter_partial_ms": part,
                "bound_ms": b_ms, "bound_by": b_by})
    log(f"[time] {'dequant':20s} {site:6s}      : kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, library none ({DEQUANT_LIBRARY_NOTE}); partial yardstick "
        f"(zero fill + scatter_ of pre-decoded values) {part:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del pre

    # fused: library = one torch.matmul on the merged f32 matrix, built
    # beforehand; context = the port's unfused apply_linear (cuBLAS base
    # GEMM on the bf16 W promoted to f32, plus the delta_spmm kernel)
    ws = [(torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02).to(
        torch.bfloat16) for _ in ring]
    merged = [w.float() + dd for w, dd in zip(ws, dense)]
    for T in (2, 128):
        x = torch.randn((T, h_in), generator=gen, device=DEVICE)
        case = list(zip(ws, ring, merged))
        ms = time_ms(torch, [lambda w=w, d=d: ops.fused_base_delta(x, w, d)
                             for w, d, _ in case])
        plain = time_ms(torch, [lambda w=w, d=d: fb.fused_base_delta(x, w, d)
                                for w, d, _ in case], iters=8, reps=3, eager=True)
        lib = time_ms(torch, [lambda m=m: torch.matmul(x, m) for _, _, m in case])
        unfused = time_ms(torch, [lambda w=w, d=d: apply_linear(x, w, d)
                                  for w, d, _ in case])
        b_ms, b_by = rl.bound_ms(*rl.fused_base_delta_work(T, ring[0], ws[0].element_size()))
        out.append({"kernel": "fused_base_delta", "site": site, "h_in": h_in,
                    "h_out": h_out, "T": T, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "apply_linear_ms": unfused, "bound_ms": b_ms,
                    "bound_by": b_by})
        log(f"[time] {'fused_base_delta':20s} {site:6s} T={T:3d}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, library (matmul on merged f32) {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); context, not the yardstick: unfused "
            f"apply_linear {unfused:.4f} ms")
    del ws, merged
    torch.cuda.empty_cache()
    return out


def _bmm_library_ms(torch, xs, stack, row_tenants, want):
    """One torch.bmm of each row against its tenant's dense f32 delta
    (gathered per row before timing), or None where that per-row stack
    exceeds LIBRARY_STACK_MAX_BYTES; checked against the kernel's ``want``.
    The stack is far larger than L2, so one input suffices. Timed only;
    the port never calls it."""
    from repro_torch.core.pack import reconstruct_dense
    T = xs.shape[0]
    if T * stack.h_in * stack.h_out * 4 > LIBRARY_STACK_MAX_BYTES:
        return None
    rows = torch.as_tensor(row_tenants, device=DEVICE).long()
    dense_rows = reconstruct_dense(stack).index_select(0, rows)
    x3 = xs.unsqueeze(1)
    y = torch.bmm(x3, dense_rows)[:, 0]
    if not torch.allclose(y, want, **KERNEL_TOL):
        fail("the segments library yardstick disagrees with the kernel")
    ms = time_ms(torch, [lambda: torch.bmm(x3, dense_rows)])
    del dense_rows
    torch.cuda.empty_cache()
    return ms


def phase_main_path(torch, kern, report: dict) -> dict:
    """Full-width Engine.generate for base + 3 tenants at the 128x spec."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.apply import merge_delta
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.serve import Engine
    from repro_torch.utils import tree_bytes

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    base = lm.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{tree_bytes(base) / 1e9:.2f} GB base params, init "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet = synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)
    torch.cuda.synchronize()
    for name, deltas, rep in fleet:
        log(f"[main] {name}: {tree_bytes(deltas) / 1e9:.3f} GB packed; "
            f"{rep.summary()}")
    log(f"[main] synthesized + compressed 3 tenants in "
        f"{time.perf_counter() - t0:.1f} s")
    report["dryrun"] = {"main": _dryrun_bytes("[main]", cfg, base, fleet, RATIO_SPECS[128])}

    eng = Engine(cfg, base, max_seq=96)
    for name, deltas, rep in fleet:
        eng.register_tenant(name, deltas, rep)
    B, S, NEW = 2, 64, 16
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    outputs, logits = {}, {}
    kern.reset_launches()
    t0 = time.perf_counter()
    for tenant in (None, "tenant0", "tenant1", "tenant2"):
        logits[tenant] = []
        outputs[tenant] = eng.generate(tenant, prompts, max_new_tokens=NEW,
                                       logits_out=logits[tenant])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    prefill_launches = kern.ROUTES["delta_spmm_prefill"]
    decode_launches = kern.ROUTES["delta_spmm_decode"]
    sites = 7 * cfg.n_layers
    expect = 3 * sites * NEW          # prefill + (NEW - 1) decode steps per tenant
    # the T = B * S prefill and the T = B decode steps, each site on the
    # route ops takes for its packing (the swept table where it applies)
    want_routes = _spmm_routes(ops, kern, eng.store.get("tenant0").deltas,
                               {B * S: 1, B: NEW - 1}, times=3)
    log(f"[main] Engine.generate base + 3 tenants, B={B} S={S} new={NEW}: "
        f"{wall:.2f} s; launches {launches} (expected delta_spmm {expect}: "
        f"{sites} sites x {NEW} calls x 3 tenants), of which {prefill_launches} on "
        f"the prefill route and {decode_launches} on the decode route (expected "
        f"{want_routes}: ops' choice at the T={B * S} prefill and the T={B} decode "
        f"steps, site by site)")
    if launches["delta_spmm"] <= 0:
        fail("the main path never launched delta_spmm")
    if launches["delta_spmm"] != expect:
        fail(f"delta_spmm launched {launches['delta_spmm']} times, expected {expect}")
    if dict(kern.ROUTES) != want_routes:
        fail(f"the routes launched {dict(kern.ROUTES)}, expected {want_routes}")
    for tenant, gen in outputs.items():
        if gen.shape != (B, NEW) or gen.min() < 0 or gen.max() >= cfg.vocab:
            fail(f"bad tokens for {tenant}: shape {gen.shape}")
        if not all(bool(torch.isfinite(lg).all()) for lg in logits[tenant]):
            fail(f"non-finite logits for {tenant}")
    for t in ("tenant0", "tenant1", "tenant2"):
        if np.array_equal(outputs[t], outputs[None]):
            fail(f"{t} generated the base model's tokens")
        log(f"[main] {t} tokens[0]: {outputs[t][0].tolist()}")
    log(f"[main] base    tokens[0]: {outputs[None][0].tolist()}")

    # separate computation == merged weights (f32, see MERGED_REL_TOL), on
    # tenant0's prefill logits; the merge runs the dequant kernel per matrix
    kern.reset_launches()
    merged = merge_delta({k: {n: w.float() for n, w in v.items()} for k, v in base.items()},
                         eng.store.get("tenant0").deltas)
    torch.cuda.synchronize()
    merge_launches = dict(kern.LAUNCHES)
    log(f"[main] merge of tenant0: launches {merge_launches} (expected dequant "
        f"{sites}: one per matrix)")
    if merge_launches["dequant"] != sites:
        fail(f"the merge launched dequant {merge_launches['dequant']} times, "
             f"expected {sites}")
    cache = lm.init_cache(cfg, B, 96, device=DEVICE)
    tok = torch.as_tensor(prompts, dtype=torch.int64, device=DEVICE)
    with torch.inference_mode():
        mlog, _ = lm.prefill(cfg, merged, {"tokens": tok}, cache)
    del merged, cache
    sep = logits["tenant0"][0]
    err = (sep - mlog).abs().max().item()
    scale = sep.abs().max().item()
    gap = (sep - logits[None][0]).abs().max().item()
    log(f"[main] separate vs merged (tenant0 prefill logits): max|diff| {err:.4e}, "
        f"max|logit| {scale:.3e} (rel {err / scale:.3e}, bound {MERGED_REL_TOL}); "
        f"tenant-vs-base gap {gap:.3e}")
    if not err <= MERGED_REL_TOL * scale or not err < 0.1 * gap:
        fail("separate computation does not match the merged model")
    # where a step's time goes, after the counted run: the time of one
    # eager step as a caller sees it (host enqueue included),
    # decode step (B=2) and one prefill (B=2, S=64), base vs tenant0
    steps = {}
    for name in (None, "tenant0"):
        d = eng.store.get(name).deltas if name else None
        cache = lm.init_cache(cfg, B, 96, device=DEVICE)
        nxt = torch.as_tensor(outputs[name][:, :1], dtype=torch.int64, device=DEVICE)
        steps[f"prefill_{name}"] = time_ms(torch, [lambda: lm.prefill(
            cfg, base, {"tokens": tok}, cache, deltas=d)], iters=3, reps=3, eager=True)
        steps[f"decode_{name}"] = time_ms(torch, [lambda: lm.decode_step(
            cfg, base, cache, nxt, S, deltas=d)], iters=5, reps=3, eager=True)
    log(f"[steps] B={B}: decode step base {steps['decode_None']:.2f} ms, tenant0 "
        f"{steps['decode_tenant0']:.2f} ms; prefill S={S} base "
        f"{steps['prefill_None']:.2f} ms, tenant0 {steps['prefill_tenant0']:.2f} ms")
    report["main"] = {"launches": launches, "prefill_route_launches": prefill_launches,
                      "decode_route_launches": decode_launches,
                      "merge_launches": merge_launches,
                      "wall_s": wall, "step_ms": steps,
                      "separate_vs_merged_rel": err / scale,
                      "tokens": {str(k): v.tolist() for k, v in outputs.items()}}
    return {"cfg": cfg, "base": base, "eng": eng, "prompts": prompts,
            "outputs": outputs, "logits": logits, "launches": launches,
            "merge_launches": merge_launches}


def phase_mixed_decode(torch, kern, ctx: dict, report: dict) -> dict:
    """One 8-slot decode batch over {base, tenant0..2} with per-slot pos,
    teacher-forced with the tokens the engine generated: the call
    ContinuousEngine._decode_all makes."""
    import numpy as np
    from repro_torch.core.apply import (
        stack_tenant_deltas,
        wrap_slot_deltas,
        zero_delta_like,
    )
    from repro_torch.models import lm
    from repro_torch.serve.scheduler import tenant_segments

    cfg, base, eng = ctx["cfg"], ctx["base"], ctx["eng"]
    prompts, outputs, logits = ctx["prompts"], ctx["outputs"], ctx["logits"]
    names = [None, "tenant0", "tenant1", "tenant2"]
    trees = [eng.store.get(n).deltas for n in names[1:]]
    slot_rows = np.array([0, 1, 2, 3, 1, 0, 3, 2], np.int32)     # 0 = base
    slot_prompt = np.arange(8) % 2                               # row of the prompt batch
    slot_off = np.array([0, 0, 0, 0, 1, 1, 1, 1])                # tokens already decoded
    S, STEPS, max_seq = prompts.shape[1], 8, 96

    # per-tenant caches after prefill (offset 0) and after one more token
    tok = torch.as_tensor(prompts, dtype=torch.int64, device=DEVICE)
    snaps = {}
    with torch.inference_mode():
        for r, name in enumerate(names):
            d = eng.store.get(name).deltas if name else None
            cache = lm.init_cache(cfg, 2, max_seq, device=DEVICE)
            lm.prefill(cfg, base, {"tokens": tok}, cache, deltas=d)
            snaps[(r, 0)] = [{k: v.clone() for k, v in c.items()} for c in cache]
            first = torch.as_tensor(outputs[name][:, :1], dtype=torch.int64, device=DEVICE)
            lm.decode_step(cfg, base, cache, first, S, deltas=d)
            snaps[(r, 1)] = cache
        mixed = [{k: torch.stack([snaps[(slot_rows[b], slot_off[b])][li][k][slot_prompt[b]]
                                  for b in range(8)]) for k in ("k", "v", "pos")}
                 for li in range(cfg.n_layers)]
        del snaps
        stacked = stack_tenant_deltas([zero_delta_like(trees[0])] + trees)
        seg = tenant_segments(slot_rows).to(DEVICE)
        sd = wrap_slot_deltas(stacked, torch.as_tensor(slot_rows, device=DEVICE).long(),
                              segments=seg)
        kern.reset_launches()
        worst, agree, total = 0.0, 0, 0
        t0 = time.perf_counter()
        for j in range(STEPS):
            step = slot_off + j
            toks = torch.as_tensor(
                [[outputs[names[slot_rows[b]]][slot_prompt[b], step[b]]] for b in range(8)],
                dtype=torch.int64, device=DEVICE)
            pos = torch.as_tensor(S + step, dtype=torch.int64, device=DEVICE)
            out, mixed = lm.decode_step(cfg, base, mixed, toks, pos, deltas=sd)
            for b in range(8):
                name = names[slot_rows[b]]
                want = logits[name][step[b] + 1][slot_prompt[b]]
                rel = ((out[b] - want).abs().max() / want.abs().max()).item()
                worst = max(worst, rel)
                # the row must be nearer its own tenant than any other
                own = (out[b] - want).abs().max().item()
                for other in names:
                    if other != name:
                        alt = logits[other][step[b] + 1][slot_prompt[b]]
                        if (out[b] - alt).abs().max().item() <= own:
                            fail(f"slot {b} is no nearer {name} than {other}")
                agree += int(out[b].argmax().item() ==
                             outputs[name][slot_prompt[b], step[b] + 1])
                total += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    log(f"[mixed] 8 slots x {STEPS} steps over base+3 tenants, per-slot pos "
        f"{(S + slot_off).tolist()}: {wall:.2f} s; launches {launches}; worst rel "
        f"logit err vs per-tenant decode {worst:.3e} (bound {MIXED_REL_TOL}); "
        f"greedy agreement {agree}/{total}")
    if launches["delta_spmm_segments"] <= 0:
        fail("mixed decode never launched delta_spmm_segments")
    if worst > MIXED_REL_TOL:
        fail(f"mixed decode logits differ from per-tenant decode by {worst:.3e}")
    # one eager mixed step vs the base model alone at B=8
    with torch.inference_mode():
        step_ms = {"mixed": time_ms(torch, [lambda: lm.decode_step(
            cfg, base, mixed, toks, pos, deltas=sd)], iters=5, reps=3, eager=True),
            "base_b8": time_ms(torch, [lambda: lm.decode_step(
                cfg, base, mixed, toks, pos)], iters=5, reps=3, eager=True)}
    log(f"[steps] B=8 decode step: mixed {step_ms['mixed']:.2f} ms, base alone "
        f"{step_ms['base_b8']:.2f} ms")
    report["mixed"] = {"launches": launches, "worst_rel": worst, "step_ms": step_ms,
                       "greedy_agree": [agree, total], "wall_s": wall}
    return launches


def _engine_stream(cfg, names=(None, "tenant0", "tenant1", "tenant2")) -> list:
    """[(tenant, prompt, arrival)]: round-robin over ``names`` (the base
    and tenant0..2), prompt lengths 33..128 from a seeded generator (both
    buckets)."""
    import numpy as np
    rng = np.random.default_rng(ENGINE_SEED)
    lengths = rng.integers(33, 129, ENGINE_REQUESTS)
    if not (lengths <= 64).any() or not (lengths > 64).any():
        fail(f"the engine stream misses a length bucket: {lengths.tolist()}")
    return [(names[i % len(names)], rng.integers(0, cfg.vocab, int(L)).astype(np.int32),
             ENGINE_GAP * i) for i, L in enumerate(lengths)]


def _timed_steps(ce) -> tuple:
    """Host seconds of each decode step of ``ce`` (each ends in the step's
    device-to-host copy of the next tokens, so the card has finished),
    and the function that takes the timer off again (the timer refers to
    the engine, so it must not outlive the run)."""
    name = "_combined_step" if ce.chunked else "_decode_all"
    inner = getattr(ce, name)
    spent = []

    def timed(now):
        t0 = time.perf_counter()
        worked = inner(now)
        if worked is not False:          # a chunked step with nothing to do
            spent.append(time.perf_counter() - t0)
        return worked

    setattr(ce, name, timed)
    return spent, lambda: delattr(ce, name)


def _engine_run(torch, kern, ce, stream, idx, tag: str) -> dict:
    """Submit ``stream[idx]`` at their arrivals, run the engine once with
    the launch counts set to 0 just before and read just after; wall
    seconds CUDA-synchronized around ``run()``."""
    import numpy as np
    handles = [ce.submit(stream[i][0], stream[i][1], max_new_tokens=ENGINE_NEW,
                         arrival=stream[i][2]) for i in idx]
    spent, untime = _timed_steps(ce)
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    try:
        rep = ce.run().report()
        torch.cuda.synchronize()
    finally:
        untime()
    wall = time.perf_counter() - t0
    launches, routes, walks = dict(kern.LAUNCHES), dict(kern.ROUTES), dict(kern.WALKS)
    for r in handles:
        if not r.done or len(r.tokens) != ENGINE_NEW:
            fail(f"[engine] {tag}: request {r.rid} finished with {len(r.tokens)} tokens")
    toks = np.stack([r.output() for r in handles])
    if toks.min() < 0 or toks.max() >= ce.cfg.vocab:
        fail(f"[engine] {tag}: tokens outside the vocabulary")
    step_ms = 1e3 * sum(spent) / max(len(spent), 1)
    out = {"tokens": {i: r.output() for i, r in zip(idx, handles)}, "report": rep,
           "launches": launches, "routes": routes, "walks": walks, "wall_s": wall,
           "decode_steps": rep["decode_steps"], "ms_per_step": step_ms,
           "step_s_total": sum(spent), "tokens_per_s": rep["total_tokens"] / wall}
    log(f"[engine] {tag}: {len(idx)} requests, {rep['total_tokens']} tokens in "
        f"{wall:.2f} s wall (CUDA-synchronized) = {out['tokens_per_s']:.1f} tokens/s; "
        f"{rep['decode_steps']} decode steps, {step_ms:.1f} ms a step "
        f"({sum(spent):.2f} s in steps, {wall - sum(spent):.2f} s in admission and "
        f"whole-prompt prefill); launches {launches}, routes {routes}")
    return out


def _first_mismatch(a, b):
    import numpy as np
    diff = np.nonzero(np.asarray(a) != np.asarray(b))[0]
    return None if diff.size == 0 else int(diff[0])


def _margin_ok(torch, logits) -> tuple:
    """(top-1 minus top-2 margin, its bound MIXED_REL_TOL * max|logit|)."""
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item(), MIXED_REL_TOL * logits.abs().max().item()


def _greedy_b1(torch, lm, cfg, base, deltas, prompt, n_new: int, chunk: int,
               ring_dtype: str = None, max_seq: int = ENGINE_MAX_SEQ) -> tuple:
    """B=1 greedy decode with the prompt prefilled in ``chunk``-token
    chunks (``lm.prefill_chunk``, the tail right-padded, as the chunked
    engine does) into a ring of ``ring_dtype`` (default the params'):
    (tokens, [logits [V] that chose each token])."""
    import dataclasses
    ring_cfg = cfg if ring_dtype is None else dataclasses.replace(cfg, param_dtype=ring_dtype)
    cache = lm.init_cache(ring_cfg, 1, max_seq, device=DEVICE)
    L = len(prompt)
    for start in range(0, L, chunk):
        n = min(chunk, L - start)
        tok = torch.zeros((1, chunk), dtype=torch.int64, device=DEVICE)
        tok[0, :n] = torch.as_tensor(prompt[start:start + n], device=DEVICE)
        pos = (start + torch.arange(chunk, device=DEVICE))[None]
        clog, _ = lm.prefill_chunk(cfg, base, {"tokens": tok, "positions": pos,
                                               "valid": torch.arange(chunk, device=DEVICE)[None] < n},
                                   cache, deltas=deltas)
    logits, toks, out = clog[0, n - 1], [], []
    for t in range(n_new):
        out.append(logits)
        toks.append(int(torch.argmax(logits)))
        if t + 1 < n_new:
            logits, _ = lm.decode_step(cfg, base, cache,
                                       torch.tensor([[toks[-1]]], device=DEVICE),
                                       L + t, deltas=deltas)
            logits = logits[0]
    return toks, out


def phase_engine(torch, kern, ctx: dict, report: dict) -> dict:
    """The continuous-batching engine at full width, with the launch
    counts of each run: the mixed stream; each tenant's requests alone
    (token-exact: equal extents); every request against Engine.generate
    (tie-aware: other extents); the chunked engine on the same stream
    against B=1 greedy decode through the same chunked prefill
    (tie-aware), and its agreement with the whole-prompt engine measured:
    chunked prefill attends the prompt's own K/V rounded to the ring's
    bf16, whole-prompt prefill attends them in f32 (the reference does
    the same), and the first-token logit gap with an f32 ring shows how
    much of the difference that rounding is."""
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, Engine, VirtualClock
    from repro_torch.kernels import ops

    cfg, base, store = ctx["cfg"], ctx["base"], ctx["eng"].store
    sites = 7 * cfg.n_layers
    stream = _engine_stream(cfg)
    everyone = list(range(len(stream)))

    def engine(**kw):
        return ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                                store=store, clock=VirtualClock(tick=ENGINE_TICK), **kw)

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ce = engine()
    buckets = [ce.buckets.bucket(len(p)) for _, p, _ in stream]
    mixed = _engine_run(torch, kern, ce, stream, everyone, "mixed, whole-prompt prefill")
    mem = {"before_gb": mem0 / 1e9, "engine_gb": (torch.cuda.memory_allocated() - mem0) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stacked_gb": _groups_gb(ce)[0],
           "kv_gb": sum(t.numel() * t.element_size() for c in ce.kv.cache
                        for t in c.values()) / 1e9}
    log(f"[engine] device memory: {mem['before_gb']:.2f} GB allocated before the engine "
        f"(base, 3 tenants' packed deltas, earlier phases' leftovers); the engine holds "
        f"{mem['engine_gb']:.2f} GB ({mem['stacked_gb']:.2f} GB tenant stack with its zero "
        f"row, {mem['kv_gb']:.2f} GB KV cache); peak {mem['peak_gb']:.2f} GB in the mixed run")
    rep, launches, routes = mixed["report"], mixed["launches"], mixed["routes"]
    n_small = sum(b <= 64 for b in buckets)
    want = {"delta_spmm": sites * len(stream), "delta_spmm_segments":
            sites * rep["decode_steps"], "fused_base_delta": 0, "dequant": 0}
    # each prefill (base requests on the zero tree, the same packing) on
    # the route ops takes for its site at its bucket
    want_routes = _spmm_routes(ops, kern, store.get("tenant0").deltas,
                               collections.Counter(buckets))
    log(f"[engine] buckets {sorted(set(buckets))} ({n_small} of 64, "
        f"{len(stream) - n_small} of 128); expected launches {want}, routes {want_routes} "
        f"(ops' choice, site by site)")
    if rep["prefills"] != len(stream) or rep["total_tokens"] != len(stream) * ENGINE_NEW:
        fail(f"[engine] report: {rep['prefills']} prefills, {rep['total_tokens']} tokens")
    if launches != want or routes != want_routes:
        fail(f"[engine] launches {launches} routes {routes}, expected {want} {want_routes}")

    # each tenant's requests, and the base's, alone through the same engine,
    # warm from the mixed run: under a strict CompileGuard no entry may meet
    # a new signature, and a retrace raises where it happens
    from repro_torch.analysis import CompileGuard
    guard = CompileGuard(ce, strict=True, label="engine",
                         max_new={k: 0 for k in ("decode", "prefill")}).attach()
    alone_bad, alone_wall = [], {}
    for name in (None, "tenant0", "tenant1", "tenant2"):
        guard.detach()              # reset_metrics rebuilds the event bus
        ce.reset_metrics()
        guard.attach()
        idx = [i for i, (t, _, _) in enumerate(stream) if t == name]
        run = _engine_run(torch, kern, ce, stream, idx, f"alone {name or 'base'}")
        alone_wall[str(name)] = run["wall_s"]
        for i in idx:
            j = _first_mismatch(run["tokens"][i], mixed["tokens"][i])
            if j is not None:
                alone_bad.append({"request": i, "tenant": name, "step": j})
    guard.detach()
    guard_report = guard.check()
    log(f"[engine] CompileGuard (strict, after the mixed run's warm-up), entries' "
        f"signatures: {guard_report}; retraces {len(guard.retraces)}")
    log(f"[engine] mixed == alone, token for token: "
        f"{len(stream) - len(alone_bad)}/{len(stream)} requests"
        + (f"; differ: {alone_bad}" if alone_bad else ""))
    if alone_bad:
        fail(f"[engine] mixed serving differs from serving alone: {alone_bad}")
    del ce
    torch.cuda.empty_cache()

    # Engine.generate (B=1) per request: other extents, so tie-aware
    ref = Engine(cfg, base, max_seq=ENGINE_MAX_SEQ)
    ref.store = store
    gen_rows, gen_full, gen_logits = [], 0, []
    t0 = time.perf_counter()
    for i, (name, prompt, _) in enumerate(stream):
        lg = []
        toks = ref.generate(name, prompt[None], max_new_tokens=ENGINE_NEW,
                            logits_out=lg)[0]
        if not all(bool(torch.isfinite(x).all()) for x in lg):
            fail(f"[engine] non-finite Engine.generate logits, request {i}")
        gen_logits.append(lg[0][0])
        j = _first_mismatch(mixed["tokens"][i], toks)
        row = {"request": i, "tenant": name, "first_mismatch": j}
        if j is None:
            gen_full += 1
        else:
            row["margin"], row["bound"] = _margin_ok(torch, lg[j][0])
            if row["margin"] > row["bound"]:
                fail(f"[engine] request {i} ({name}) leaves Engine.generate at step "
                     f"{j} with a top-2 margin {row['margin']:.4e} > {row['bound']:.4e}")
        gen_rows.append(row)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    log(f"[engine] vs Engine.generate (B=1, {gen_wall:.1f} s): {gen_full}/{len(stream)} "
        f"requests equal in full; the rest leave it at a near tie "
        f"(margin <= {MIXED_REL_TOL} x max|logit|): "
        f"{[r for r in gen_rows if r['first_mismatch'] is not None]}")

    # the chunked engine on the same stream
    seg_rows = []
    real = kern.delta_spmm_segments_cuda

    def spy(x2, d, rows, offsets, *, tb):
        seg_rows.append(x2.shape[0])
        return real(x2, d, rows, offsets, tb=tb)

    kern.delta_spmm_segments_cuda = spy
    try:
        cc = engine(chunked_prefill=True, chunk_size=ENGINE_CHUNK)
        chunked = _engine_run(torch, kern, cc, stream, everyone,
                              f"mixed, chunked prefill (chunk {ENGINE_CHUNK})")
    finally:
        kern.delta_spmm_segments_cuda = real
    crep = chunked["report"]
    n_chunks = sum(-(-len(p) // ENGINE_CHUNK) for _, p, _ in stream)
    want_c = {ENGINE_CHUNK: sites * n_chunks, ENGINE_SLOTS: sites * crep["decode_steps"]}
    got_c = {T: seg_rows.count(T) for T in sorted(set(seg_rows))}
    log(f"[engine] chunked: delta_spmm_segments launches by rows {got_c} (expected "
        f"{want_c}: {n_chunks} chunks, {crep['decode_steps']} steps)")
    if got_c != want_c or chunked["launches"]["delta_spmm"] != 0 or \
            chunked["launches"]["delta_spmm_segments"] != len(seg_rows):
        fail(f"[engine] chunked launches {chunked['launches']}, by rows {got_c}")
    # each tenant's requests, and the base's, alone through the chunked
    # engine: token-exact, as the whole-prompt runs (the chunk rows' and
    # the decode rows' tiles come from ops' choice, the table's included)
    chunk_alone_bad = []
    for name in (None, "tenant0", "tenant1", "tenant2"):
        cc.reset_metrics()
        idx = [i for i, (t, _, _) in enumerate(stream) if t == name]
        run = _engine_run(torch, kern, cc, stream, idx, f"chunked alone {name or 'base'}")
        for i in idx:
            j = _first_mismatch(run["tokens"][i], chunked["tokens"][i])
            if j is not None:
                chunk_alone_bad.append({"request": i, "tenant": name, "step": j})
    log(f"[engine] chunked: mixed == alone, token for token: "
        f"{len(stream) - len(chunk_alone_bad)}/{len(stream)} requests"
        + (f"; differ: {chunk_alone_bad}" if chunk_alone_bad else ""))
    if chunk_alone_bad:
        fail(f"[engine] chunked mixed serving differs from serving alone: {chunk_alone_bad}")
    # the chunked engine against B=1 greedy decode through the same
    # chunked prefill (other extents: tie-aware, as against generate)
    chunk_rows, chunk_full, whole_full, rel_bf16, rel_f32 = [], 0, 0, [], []
    for i, (name, prompt, _) in enumerate(stream[:CHUNK_CHECK_REQUESTS]):
        deltas = store.get(name).deltas if name else None
        toks, lg = _greedy_b1(torch, lm, cfg, base, deltas, prompt, ENGINE_NEW,
                              ENGINE_CHUNK)
        j = _first_mismatch(chunked["tokens"][i], toks)
        row = {"request": i, "tenant": name, "first_mismatch": j,
               "vs_whole_first_mismatch": _first_mismatch(chunked["tokens"][i],
                                                          mixed["tokens"][i])}
        if j is None:
            chunk_full += 1
        else:
            row["margin"], row["bound"] = _margin_ok(torch, lg[j])
            if row["margin"] > row["bound"]:
                fail(f"[engine] chunked request {i} ({name}) leaves B=1 chunked decode "
                     f"at step {j}, margin {row['margin']:.4e} > {row['bound']:.4e}")
        whole_full += row["vs_whole_first_mismatch"] is None
        # first-token logits of chunked against whole-prompt prefill, with
        # the ring in bf16 (the engine's) and in f32 (chunk K/V unrounded,
        # as whole-prompt prefill attends them)
        whole = gen_logits[i]
        f32_first = _greedy_b1(torch, lm, cfg, base, deltas, prompt, 1, ENGINE_CHUNK,
                               "float32")[1][0]
        scale = whole.abs().max().item()
        row["first_logit_rel"] = {"bf16_ring": (lg[0] - whole).abs().max().item() / scale,
                                  "f32_ring": (f32_first - whole).abs().max().item() / scale}
        rel_bf16.append(row["first_logit_rel"]["bf16_ring"])
        rel_f32.append(row["first_logit_rel"]["f32_ring"])
        chunk_rows.append(row)
        # with the ring's rounding taken away only summation order is left
        if row["first_logit_rel"]["f32_ring"] > CHUNK_F32_REL_TOL:
            fail(f"[engine] request {i}: chunked prefill with an f32 ring is "
                 f"{row['first_logit_rel']['f32_ring']:.3e} (relative) from "
                 f"whole-prompt prefill, bound {CHUNK_F32_REL_TOL}")
    log(f"[engine] chunked vs B=1 chunked decode: {chunk_full}/{len(chunk_rows)} requests "
        f"equal in full; the rest at a near tie: "
        f"{[r for r in chunk_rows if r['first_mismatch'] is not None]}")
    log(f"[engine] chunked vs whole-prompt engine: {whole_full}/{len(chunk_rows)} requests "
        f"equal in full, first mismatches "
        f"{[(r['request'], r['vs_whole_first_mismatch']) for r in chunk_rows if r['vs_whole_first_mismatch'] is not None]}; "
        f"first-token logits chunked vs whole-prompt prefill, max|diff|/max|logit|: "
        f"bf16 ring {min(rel_bf16):.3e}-{max(rel_bf16):.3e}, f32 ring "
        f"{min(rel_f32):.3e}-{max(rel_f32):.3e} (bound {CHUNK_F32_REL_TOL})")
    del cc, ref
    gc.collect()
    torch.cuda.empty_cache()

    def summary(run):
        return {k: run[k] for k in ("wall_s", "decode_steps", "ms_per_step",
                                    "step_s_total", "tokens_per_s", "launches", "routes")}

    report["engine"] = {
        "config": {"n_slots": ENGINE_SLOTS, "max_seq": ENGINE_MAX_SEQ,
                   "requests": ENGINE_REQUESTS, "max_new_tokens": ENGINE_NEW,
                   "arrival_gap_s": ENGINE_GAP, "clock_tick_s": ENGINE_TICK,
                   "prompt_lengths": [len(p) for _, p, _ in stream],
                   "buckets": buckets, "chunk_size": ENGINE_CHUNK},
        "memory": mem,
        "mixed": {**summary(mixed), "report": rep},
        "alone_wall_s": alone_wall, "alone_mismatches": alone_bad,
        "compile_guard": guard_report,
        "generate": {"wall_s": gen_wall, "full_match": gen_full, "rows": gen_rows},
        "chunked": {**summary(chunked), "report": crep, "segment_rows": got_c,
                    "alone_mismatches": chunk_alone_bad,
                    "full_match_b1_chunked": chunk_full, "full_match_whole": whole_full,
                    "rows": chunk_rows},
        "tokens": {str(i): t.tolist() for i, t in mixed["tokens"].items()},
    }
    return launches


# ---------------------------------------------------------------------------
# the codec slice
# ---------------------------------------------------------------------------
def _groups_gb(ce) -> list:
    """GB of each codec group's tenant stack (zero row included)."""
    from repro_torch.utils import iter_leaves
    return [sum(d.nbytes() for _, d in iter_leaves(g.stacked) if d is not None) / 1e9
            for g in ce._groups]


def phase_codec_parity(torch, report: dict) -> dict:
    """Both correction kernels on the codec packings at every full-width
    site: delta_spmm and a two-group segments layout (rows of the other
    group mapped to this group's zero row) against their plain versions
    at KERNEL_TOL; the decode tiles on the dense-group walk (the plan
    says so, the walk's counters count it), bit-equal to its plain twins
    (``ref.dense_groups_kernel_order``, ``dense_segments_kernel_order``)
    at T up to CODEC_BITS_T; a row's bits equal under every tile the
    packing takes (the decode tiles, and the 128-row tile's windowed walk)
    and in its segment; the zero row exactly 0.0; no call reaches the
    out-of-envelope branch."""
    import numpy as np
    from repro_torch.core.apply import stack_tenant_deltas, zero_delta_like
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import fallback as fb
    from repro_torch.serve.scheduler import tenant_segments
    from repro_torch.serve.trace import attribution

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4321)
    walks0 = dict(kern.WALKS)
    n_dense = {"delta_spmm_dense": 0, "delta_spmm_segments_dense": 0}
    pre = kern.PREFILL_TILES[0]
    if not kern.prefill_fits(pre, 128, 128):
        fail(f"prefill_fits({pre}, 128, 128) is false; the windowed walk takes keep = 128")
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0}
    rows_out = []
    with attribution() as notes:
        for site, (h_in, h_out) in SITES.items():
            for codec in ("bitdelta", "lowrank"):
                d = autotune.pack_lowering(codec, h_in, h_out, generator=gen, device=DEVICE,
                                           scale=0.02)
                if ops.envelope_miss(d) is not None or (d.h_g, d.keep, d.alpha, d.m) != \
                        (128, 128, 1.0, 1):
                    fail(f"{codec} {site}: packing h_g={d.h_g} keep={d.keep} outside "
                         f"the kernels' envelope ({ops.envelope_miss(d)})")
                walks = {tb: kern.decode_plan(d, tb)["walk"] for tb in kern.ROW_TILES}
                if set(walks.values()) != {"dense"}:
                    fail(f"{codec} {site}: the decode tiles plan {walks}, not the dense walk")
                stack = stack_tenant_deltas([zero_delta_like({"w": d}), {"w": d}])["w"]
                for T in CODEC_T:
                    where = f"{codec} {site} T={T}"
                    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
                    y = ops.delta_spmm(x, d)
                    # keep = h_g: the gather formulation above 8 rows would
                    # hold T x h_in x h_out floats; the dense one is exact f32
                    want = fb.correction(x, d, gather_max_t=8)
                    torch.cuda.synchronize()
                    err = (y - want).abs().max().item()
                    worst["delta_spmm"] = max(worst["delta_spmm"], err)
                    if not torch.allclose(y, want, **KERNEL_TOL):
                        fail(f"delta_spmm {where}: max err {err:.3e}")
                    for tb in kern.SPMM_TILES:
                        if not torch.equal(kern.delta_spmm_cuda(x, d, tb=tb), y):
                            fail(f"delta_spmm {where}: rows differ at tb={tb}")
                    n_dense["delta_spmm_dense"] += len(kern.ROW_TILES) + \
                        (ops.spmm_row_tile(T, d) in kern.ROW_TILES)
                    if T <= CODEC_BITS_T and not _bits_equal(
                            torch, y, ref.dense_groups_kernel_order(x, d)):
                        fail(f"delta_spmm {where}: the dense walk's rows != "
                             f"dense_groups_kernel_order")
                    rows = (np.arange(T) % 3 == 1).astype(np.int32)
                    seg = tenant_segments(rows).to(DEVICE)
                    xs = x.index_select(0, seg.order)
                    ys = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
                    n_dense["delta_spmm_segments_dense"] += 1
                    if T <= CODEC_BITS_T and not _bits_equal(
                            torch, ys, ref.dense_segments_kernel_order(
                                xs, stack, seg.seg_rows, seg.seg_offsets)):
                        fail(f"delta_spmm_segments {where}: the dense walk's rows != "
                             f"dense_segments_kernel_order")
                    wants = _plain_segments(torch, fb, xs, stack, seg.seg_rows,
                                            seg.seg_offsets, gather_max_t=8)
                    torch.cuda.synchronize()
                    err_s = (ys - wants).abs().max().item()
                    worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"], err_s)
                    if not torch.allclose(ys, wants, **KERNEL_TOL):
                        fail(f"delta_spmm_segments {where}: max err {err_s:.3e}")
                    own = torch.as_tensor(rows, device=DEVICE)[seg.order] == 1
                    if not torch.equal(ys[own], y.index_select(0, seg.order)[own]):
                        fail(f"segments {where}: rows != delta_spmm rows")
                    if not torch.equal(ys[~own], torch.zeros_like(ys[~own])):
                        fail(f"segments {where}: the zero row is not exactly 0.0")
                    rows_out.append({"codec": codec, "site": site, "T": T,
                                     "spmm_err": err, "segments_err": err_s})
                del d, stack
    edge = [n for n in notes if n.get("formulation") == "plain-out-of-envelope"]
    if edge:
        fail(f"codec shapes reached the out-of-envelope branch: {edge}")
    got = {k: kern.WALKS[k] - walks0[k] for k in n_dense}
    if got != n_dense:
        fail(f"codec parity: dense-group walk launches {got}, expected {n_dense}")
    log(f"[parity] codec packings (BitDelta k=2, LowRank f32; h_g = keep = 128): "
        f"{len(rows_out)} cases x 2 kernels within atol/rtol 1e-4 (worst |err| spmm "
        f"{worst['delta_spmm']:.3e}, segments {worst['delta_spmm_segments']:.3e}) at "
        f"T {list(CODEC_T)}, all sites; the decode tiles {list(kern.ROW_TILES)} and the "
        f"segments kernel on the dense-group walk ({got} launches), bit-equal to its "
        f"plain twins at T <= {CODEC_BITS_T}; rows equal under tiles "
        f"{list(kern.SPMM_TILES)} and in their segment, zero row exactly 0.0; "
        f"prefill_fits({pre}, 128, 128) true; no out-of-envelope note")
    report["codec_parity"] = rows_out
    return worst


def _time_codecs(torch, report: dict) -> list:
    """delta_spmm (on the tile ops names: a decode tile's dense-group walk,
    or the 128-row tile's windowed walk, as the table says) and the
    segments kernel's mixed decode layout (the dense walk) on the codec
    packings, on rings of 8 distinct deltas, with bounds and library
    times; each line names its walk."""
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.kernels import fallback as fb

    def walk(d, tb):
        return kern.decode_plan(d, tb)["walk"] if tb in kern.ROW_TILES else "windowed"

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(99)
    times = []
    for site in CODEC_TIME_SITES:
        h_in, h_out = SITES[site]
        for codec in ("bitdelta", "lowrank"):
            ring = [autotune.pack_lowering(codec, h_in, h_out, generator=gen, device=DEVICE,
                                          scale=0.02) for _ in range(8)]
            dense = [reconstruct_dense(d) for d in ring]
            for T in CODEC_TIME_T:
                t = _time_spmm(torch, ops, fb, ring, dense, gen, site, T, None)
                t["walk"] = walk(ring[0], t["tb"])
                log(f"[walk] delta_spmm {site:6s} T={T:3d} [{codec}]: tb={t['tb']}, "
                    f"the {t['walk']} walk")
                times.append(t)
                if T >= PREFILL_T[0]:
                    log(f"[route] delta_spmm {site:6s} T={T:3d} [{codec}]: {t['route']} "
                        f"tb={t['tb']} {t['ms']:.4f} ms (ops' tile)")
            del dense
            times.append(dict(_time_segments(torch, ops, fb, ring, gen, site, "mixed", 8),
                              walk=walk(ring[0], ops.segments_tile(8, ring[0])[0])))
            log(f"[walk] delta_spmm_segments {site:6s} T=  8 [{codec}] mixed: the "
                f"{times[-1]['walk']} walk")
            del ring
            torch.cuda.empty_cache()
    report["codec_times"] = times
    return times


def _alone_tokens(torch, kern, cfg, base, stream, name, deltas, chunked, tag) -> dict:
    """The requests of ``name`` served by an engine holding only that
    tenant (none for the base), at their arrivals."""
    from repro_torch.serve import ContinuousEngine, VirtualClock
    ce = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          clock=VirtualClock(tick=ENGINE_TICK), chunked_prefill=chunked,
                          chunk_size=ENGINE_CHUNK)
    if name is not None:
        ce.register_tenant(name, deltas)
    idx = [i for i, (t, _, _) in enumerate(stream) if t == name]
    run = _engine_run(torch, kern, ce, stream, idx, tag)
    del ce
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _mixed_vs_alone(torch, kern, cfg, base, fleet, stream, tag: str,
                    modes=("whole", "chunked"), phase: str = "codecs") -> dict:
    """The fleet in one engine (whole-prompt, then chunked, as ``modes``
    lists) against each tenant alone, token for token; launch counts of
    the mixed runs; log lines and failures tagged ``[phase]``."""
    from repro_torch.serve import ContinuousEngine, VirtualClock
    sites = 7 * cfg.n_layers
    n_chunks = sum(-(-len(p) // ENGINE_CHUNK) for _, p, _ in stream)
    out = {}
    for chunked in [m == "chunked" for m in modes]:
        mode = "chunked" if chunked else "whole"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        ce = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                              clock=VirtualClock(tick=ENGINE_TICK), chunked_prefill=chunked,
                              chunk_size=ENGINE_CHUNK)
        for name, d in fleet:
            ce.register_tenant(name, d)
        groups = [{"codecs": g.codecs, "tenants": g.names, "gb": gb}
                  for g, gb in zip(ce._groups, _groups_gb(ce))]
        run = _engine_run(torch, kern, ce, stream, list(range(len(stream))),
                          f"{tag} mixed, {mode}")
        G = len(ce._groups)
        run["memory"] = {"before_gb": mem0 / 1e9,
                         "engine_gb": (torch.cuda.memory_allocated() - mem0) / 1e9,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "groups": groups}
        steps = run["decode_steps"]
        want = {"delta_spmm": 0 if chunked else sites * len(stream),
                "delta_spmm_segments": sites * G * (steps + (n_chunks if chunked else 0)),
                "fused_base_delta": 0, "dequant": 0}
        log(f"[{phase}] {tag} {mode}: {G} codec groups "
            f"{[(g['codecs'], g['tenants'], round(g['gb'], 3)) for g in groups]} GB; "
            f"engine {run['memory']['engine_gb']:.2f} GB allocated, peak "
            f"{run['memory']['peak_gb']:.2f} GB; launches {run['launches']} (expected "
            f"{want}: segments {sites} sites x {G} groups x "
            f"{steps} steps{f' + {n_chunks} chunks' if chunked else ''})")
        if run["launches"] != want:
            fail(f"[{phase}] {tag} {mode}: launches {run['launches']}, expected {want}")
        # a group holding a codec lowering runs the dense-group walk (its
        # segments at every decode step, its whole-prompt prefills on the
        # decode tiles the table names), a DeltaDQ-only fleet never
        lowered = any(c != "deltadq" for g in groups for c in g["codecs"])
        log(f"[{phase}] {tag} {mode}: dense-group walk launches {run['walks']}")
        if lowered != (run["walks"]["delta_spmm_segments_dense"] > 0) or \
                (not lowered and any(run["walks"].values())):
            fail(f"[{phase}] {tag} {mode}: dense-group walk launches {run['walks']} with "
                 f"codec groups {[g['codecs'] for g in groups]}")
        edge = [p for p in run["report"]["decode_paths"] or {} if "out-of-envelope" in p]
        if edge:
            fail(f"[{phase}] {tag} {mode}: steps took the out-of-envelope branch: {edge}")
        out[mode] = run
        del ce
    gc.collect()
    torch.cuda.empty_cache()
    for mode in modes:
        bad = []
        for name, d in [(None, None)] + list(fleet):
            alone = _alone_tokens(torch, kern, cfg, base, stream, name, d, mode == "chunked",
                                  f"{tag} alone {name or 'base'}, {mode}")
            for i, toks in alone["tokens"].items():
                j = _first_mismatch(toks, out[mode]["tokens"][i])
                if j is not None:
                    bad.append({"request": i, "tenant": name, "step": j})
        log(f"[{phase}] {tag} {mode}: mixed == alone, token for token: "
            f"{len(stream) - len(bad)}/{len(stream)} requests"
            + (f"; differ: {bad}" if bad else ""))
        if bad:
            fail(f"[{phase}] {tag} {mode}: mixed-codec serving differs from alone: {bad}")
        out[mode]["alone_mismatches"] = bad
    return out


def phase_codecs(torch, kern, ctx: dict, report: dict) -> dict:
    """The reference's ``--codec mixed`` fleet at full width and
    CODECS_DEPTH layers (tenant0 and tenant2 DeltaDQ 128x, tenant1
    BitDelta; the [engine] stream), then a LowRank tenant beside a DeltaDQ one and
    ``compress(codec="auto", budget_bits=2.0)`` on a copy cut to
    LOWRANK_LAYERS layers. The LowRank tenant is LowRank at LOWRANK_LEAVES
    and DeltaDQ 128x at its other sites, so its codec group is
    ('deltadq', 'lowrank')."""
    from repro_torch.core.codecs import BitDeltaSpec, LowRankSpec, runtime_delta_tree
    from repro_torch.core.compress import compress
    from repro_torch.launch.serve import RATIO_SPECS, synth_ft, synth_tenants
    from repro_torch.models import lm
    from repro_torch.utils import map_with_paths, tree_bytes

    store = ctx["eng"].store
    # the fleet at CODECS_DEPTH of the 32 layers (views of the full model)
    cfg, base, (t0_tree, t2_tree) = _first_layers(
        ctx["cfg"], ctx["base"], [store.get("tenant0").deltas, store.get("tenant2").deltas],
        CODECS_DEPTH)
    stream = _engine_stream(cfg)
    t0 = time.perf_counter()
    _, bd, bd_rep = synth_tenants(cfg, base, 1, [BitDeltaSpec()], seed=1)[0]   # noise 8
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bd_rt = runtime_delta_tree(bd)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    log(f"[codecs] tenant1 (BitDelta): compressed in {compress_s:.1f} s, "
        f"{tree_bytes(bd) / 1e9:.3f} GB packed; lowered in {lower_s:.1f} s to "
        f"{tree_bytes(bd_rt) / 1e9:.3f} GB of runtime arrays (h_g = keep = 128, "
        f"2-bit codes); {bd_rep.summary()}")
    fleet = [("tenant0", t0_tree), ("tenant1", bd_rt), ("tenant2", t2_tree)]
    full = _mixed_vs_alone(torch, kern, cfg, base, fleet, stream,
                           f"{CODECS_DEPTH} of {ctx['cfg'].n_layers} layers")
    del fleet, bd, bd_rt
    gc.collect()
    torch.cuda.empty_cache()

    # the depth cut that memory and the host SVD force
    depth = LOWRANK_LAYERS
    ccfg = dataclasses.replace(cfg, n_layers=depth, layer_kinds=cfg.layer_kinds[:depth],
                               layer_windows=cfg.layer_windows[:depth])
    cbase = lm.init_params(ccfg, 0, device=DEVICE)
    leaf_s, t_leaf = {}, [time.perf_counter()]

    def leaf_done(path, codec):
        now = time.perf_counter()
        if codec is not None:
            leaf_s[path] = round(now - t_leaf[0], 2)
        t_leaf[0] = now

    def only(tree):
        """The LOWRANK_LEAVES of ``tree``, at their paths in the whole tree."""
        out = {}
        for path in LOWRANK_LEAVES:
            block, leaf = path.split("/")
            out.setdefault(block, {})[leaf] = tree[block][leaf]
        return out

    lr_ft = synth_ft(cbase, 7)
    lr_dq, _ = compress(cbase, lr_ft, RATIO_SPECS[128])
    torch.cuda.synchronize()
    t0 = t_leaf[0] = time.perf_counter()
    lr, lr_rep = compress(only(cbase), only(lr_ft), LowRankSpec(), progress=leaf_done)
    lr_s = time.perf_counter() - t0
    mixed = map_with_paths(lambda path, d: lr[path.split("/")[0]][path.split("/")[1]]
                           if path in LOWRANK_LEAVES else d, lr_dq)
    _, dq, _ = synth_tenants(ccfg, cbase, 1, [RATIO_SPECS[128]], seed=1)[0]        # noise 8
    lr_rt = runtime_delta_tree(mixed)
    log(f"[codecs] LowRank host time a leaf (one numpy SVD each, nothing else timed "
        f"meanwhile): {leaf_s}")
    log(f"[codecs] LowRank tenant ({depth} layers; LowRank at {list(LOWRANK_LEAVES)}, "
        f"DeltaDQ 128x elsewhere): LowRank compressed in {lr_s:.1f} s, "
        f"{tree_bytes(mixed) / 1e9:.3f} GB packed, {tree_bytes(lr_rt) / 1e9:.3f} GB runtime "
        f"(LowRank as f32 values); {lr_rep.summary()}")
    cstream = [(t if t != "tenant2" else None, p, a_) for t, p, a_ in stream]
    cut = _mixed_vs_alone(torch, kern, ccfg, cbase, [("tenant0", lr_rt), ("tenant1", dq)],
                          cstream, f"{depth}-layer")
    codecs = [g["codecs"] for g in cut["whole"]["memory"]["groups"]]
    if ("deltadq", "lowrank") not in codecs:
        fail(f"[codecs] {depth}-layer: no ('deltadq', 'lowrank') codec group in {codecs}")
    del lr, lr_dq, mixed, lr_rt, lr_ft, dq
    gc.collect()
    torch.cuda.empty_cache()
    ft = synth_ft(cbase, 9)
    t0 = time.perf_counter()
    _, auto = compress(cbase, ft, codec="auto", budget_bits=2.0)
    auto_s = time.perf_counter() - t0
    picks = {p: (c["codec"], round(c["bits_per_element"], 4), round(c["rel_error"], 4))
             for p, c in auto.auto_choices.items()}
    log(f"[codecs] compress(codec='auto', budget_bits=2.0), {depth} layers: {auto_s:.1f} s, "
        f"budget met {auto.budget_met}; per leaf (codec, bits/element, rel. error): {picks}")
    if not auto.budget_met or auto.n_compressed != 7:
        fail(f"[codecs] auto: budget met {auto.budget_met}, {auto.n_compressed} leaves")
    del ft, cbase
    gc.collect()
    torch.cuda.empty_cache()

    def summary(run):
        return {k: run[k] for k in ("wall_s", "decode_steps", "ms_per_step", "step_s_total",
                                    "tokens_per_s", "launches", "walks", "memory",
                                    "alone_mismatches")}

    report["codecs"] = {
        "bitdelta_compress_s": compress_s, "bitdelta_lower_s": lower_s,
        "fleet_depth": CODECS_DEPTH,
        "fleet": {m: summary(r) for m, r in full.items()},
        "lowrank_depth": depth, "lowrank_leaves": list(LOWRANK_LEAVES),
        "lowrank_compress_s": lr_s, "lowrank_leaf_s": leaf_s,
        "lowrank_cut": {m: summary(r) for m, r in cut.items()},
        "auto": {"wall_s": auto_s, "budget_met": auto.budget_met, "picks": picks}}
    return full["whole"]["launches"]


def phase_lifecycle(torch, kern, ctx: dict, report: dict) -> dict:
    """The online lifecycle at full width and depth: a tenant table of
    LIFECYCLE_CAPACITY rows and a DeltaRegistry. tenant0 serves; tenant1
    arrives as a fine-tuned model (compressed on the card) and tenant2 as
    deltas, both registered by ``pump`` between steps; tenant0 rolls out
    to v2 while v1 requests are in flight; tenant1 retires; tenant2 is
    evicted to the warm tier and promoted back by a request. Every
    request must equal an engine built up front with the tenant version
    that served it; no re-stack and no decode-step jit_trace after
    warm-up, under a strict CompileGuard. Then ms per row write against
    one dynamic re-stack."""
    from repro_torch.core.compress import compress
    from repro_torch.launch.serve import RATIO_SPECS, synth_ft
    from repro_torch.serve import ContinuousEngine, DeltaRegistry, VirtualClock

    cfg, base, store = ctx["cfg"], ctx["base"], ctx["eng"].store
    spec = RATIO_SPECS[128]
    stream = _engine_stream(cfg)
    by = {n: [i for i, (t, _, _) in enumerate(stream) if t == n]
          for n in (None, "tenant0", "tenant1", "tenant2")}
    served = []                                 # (stream index, version name, handle)

    def submit(reg, name, i, version):
        served.append((i, version, reg.submit(name, stream[i][1],
                                              max_new_tokens=ENGINE_NEW)))

    t_v2 = time.perf_counter()
    v2 = compress(base, synth_ft(base, 777), spec)[0]       # tenant0's next version
    t_v2 = time.perf_counter() - t_v2
    gc.collect()
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    eng = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                           tenant_capacity=LIFECYCLE_CAPACITY,
                           clock=VirtualClock(tick=ENGINE_TICK))
    reg = DeltaRegistry(eng, base, spec=spec, codec=None)
    reg.ingest("tenant0", deltas=store.get("tenant0").deltas)
    reg.pump()
    for i in by["tenant0"][:2] + by[None][:1]:
        submit(reg, "tenant0" if i in by["tenant0"] else None, i,
               "tenant0" if i in by["tenant0"] else None)
    for _ in range(2):
        eng.step(eng._now())                    # warm-up: decode in flight
    # from here the decode step must meet no new signature (a retrace in
    # the reference): strict, so one raises at the call that made it
    from repro_torch.analysis import CompileGuard
    guard = CompileGuard(eng, max_new={"decode": 0}, strict=True,
                         label="lifecycle").attach()
    restacks0 = eng.restacks
    ft1 = synth_ft(base, 8)                     # tenant1 as a fine-tuned model
    rec1 = reg.ingest("tenant1", ft1)
    del ft1
    reg.pump()
    for i in by["tenant1"]:
        submit(reg, "tenant1", i, "tenant1")
    eng.step(eng._now())
    reg.ingest("tenant2", deltas=store.get("tenant2").deltas)
    reg.pump()
    for i in by["tenant2"][:2]:
        submit(reg, "tenant2", i, "tenant2")
    eng.step(eng._now())
    # rollout while tenant0 v1 still decodes
    if not eng._tenant_in_flight("tenant0"):
        fail("[lifecycle] tenant0 v1 is not in flight at the rollout")
    reg.ingest("tenant0", deltas=v2)
    reg.pump()
    retiring = sorted(eng._retiring)
    for i in by["tenant0"][2:] + by[None][1:]:
        submit(reg, "tenant0" if i in by["tenant0"] else None, i,
               "tenant0v2" if i in by["tenant0"] else None)
    eng.run()
    eng.unregister_tenant("tenant1")
    reg.evict("tenant2")
    evicted = reg._records["tenant2"].state
    submit(reg, "tenant2", by["tenant2"][2], "tenant2")     # promotes it back
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    guard.detach()
    guard_report = guard.check()
    retraces, restacks = guard.new_compiles("decode"), eng.restacks - restacks0
    rep = eng.metrics.report()
    log(f"[lifecycle] {len(served)} requests, {rep['total_tokens']} tokens in {wall:.2f} s "
        f"wall; tenant1 ingested as a model, compressed on the card in "
        f"{rec1.compress_s:.1f} s; ms per registration "
        f"{ {n: round(1e3 * r.register_s, 2) for n, r in reg._records.items()} }; rollout "
        f"left rows {retiring} draining; tenant2 evicted to {evicted} and promoted; "
        f"events {rep['tenant_lifecycle']}; launches {launches}")
    log(f"[lifecycle] after warm-up: {retraces} new decode signatures, {restacks} "
        f"re-stacks; table rows free {eng._table.n_free}/{LIFECYCLE_CAPACITY}; "
        f"CompileGuard (strict) {guard_report}, retraces {len(guard.retraces)}")
    if retraces or restacks:
        fail(f"[lifecycle] {retraces} jit_trace events and {restacks} re-stacks after warm-up")
    if any(r.state == "failed" for r in reg._records.values()):
        fail(f"[lifecycle] a registry record failed: {reg.stats()}")
    if rep["tenant_lifecycle"] != {"tenant_evict": 1, "tenant_promote": 1,
                                   "tenant_ready": 4, "tenant_register": 4,
                                   "tenant_retire": 2, "tenant_rollout": 1}:
        fail(f"[lifecycle] events {rep['tenant_lifecycle']}")
    undone = [h.rid for _, _, h in served if not h.done or len(h.tokens) != ENGINE_NEW]
    if undone:
        fail(f"[lifecycle] requests {undone} unfinished")
    tokens = {(i, v): h.output() for i, v, h in served}
    register_ms = {n: 1e3 * r.register_s for n, r in reg._records.items()}
    t1_host = reg._records["tenant1"].host      # the version tenant1 served with

    # row write against one dynamic re-stack of the same fleet
    fleet = {n: eng.store.get(n).deltas for n in eng.store.names()}
    row = eng._table.alloc()
    write_ms = time_ms(torch, [lambda: eng._table.write(row, fleet["tenant0"])],
                       iters=5, reps=3, eager=True)
    eng._table.free(row)
    reg.close()
    del eng, reg
    gc.collect()
    torch.cuda.empty_cache()
    dyn = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ)
    for n, d in fleet.items():
        dyn.store.register(n, d)

    def restack():
        dyn.store.version += 1
        dyn._refresh_stacked()

    restack_ms = time_ms(torch, [restack], iters=3, reps=3, eager=True)
    del dyn
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lifecycle] one table row write (a tenant: 7 layer-stacked leaves; {len(fleet)}-tenant fleet): "
        f"{write_ms:.2f} ms; one dynamic re-stack of the same fleet: {restack_ms:.2f} ms")

    # engines built up front with the versions that served each request
    up = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          tenant_capacity=LIFECYCLE_CAPACITY, clock=VirtualClock(tick=ENGINE_TICK))
    for n, d in (("tenant0", store.get("tenant0").deltas), ("tenant0v2", v2),
                 ("tenant1", t1_host), ("tenant2", store.get("tenant2").deltas)):
        up.register_tenant(n, d)
    ref = [((i, v), up.submit(v, stream[i][1], max_new_tokens=ENGINE_NEW)) for i, v, _ in served]
    up.run()
    bad = [k for k, h in ref if _first_mismatch(h.output(), tokens[k]) is not None]
    log(f"[lifecycle] == engines built up front with the serving versions: "
        f"{len(ref) - len(bad)}/{len(ref)} requests" + (f"; differ: {bad}" if bad else ""))
    if bad:
        fail(f"[lifecycle] hot lifecycle changed tokens: {bad}")
    del up, v2, t1_host
    gc.collect()
    torch.cuda.empty_cache()
    report["lifecycle"] = {"wall_s": wall, "requests": len(served),
                           "tokens": rep["total_tokens"], "events": rep["tenant_lifecycle"],
                           "launches": launches, "decode_traces_after_warmup": retraces,
                           "compile_guard": guard_report,
                           "restacks_after_warmup": restacks,
                           "tenant1_compress_s": rec1.compress_s, "v2_compress_s": t_v2,
                           "register_ms": register_ms,
                           "row_write_ms": write_ms, "restack_ms": restack_ms,
                           "identity": [len(ref) - len(bad), len(ref)]}
    return launches


def phase_quickstart(torch, kern, report: dict) -> dict:
    """``launch/quickstart.py``'s function at the full width: compress a
    perturbed copy at 128x, serve it separately and merged."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart

    cfg = get_config(ARCH)
    sites = 7 * cfg.n_layers
    kern.reset_launches()
    t0 = time.perf_counter()
    out = quickstart.run(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    log(f"[quickstart] {cfg.name} full width: {wall:.1f} s; launches {launches}; "
        f"separate vs merged rel {out['rel']:.3e} (bound {quickstart.REL_TOL}), the "
        f"delta moves the logits by {out['delta_gap']:.3e}")
    sep = out["separate"]
    if tuple(sep.shape) != (2, 16, cfg.vocab) or not bool(torch.isfinite(sep).all()):
        fail(f"quickstart logits: shape {tuple(sep.shape)} or non-finite")
    if not out["ok"]:
        fail("quickstart: separate computation does not match the merged model")
    if launches["dequant"] != sites or launches["delta_spmm"] != sites:
        fail(f"quickstart launched {launches}, expected dequant and delta_spmm "
             f"{sites} each")
    report["quickstart"] = {"launches": launches, "wall_s": wall, "rel": out["rel"],
                            "delta_gap": out["delta_gap"]}
    return launches


def phase_kernels_demo(torch, kern, report: dict) -> dict:
    """``launch/kernels_demo.py``'s function at the wizard-llama2-7b wi
    site (T=128, bf16 W): each kernel's public entry point once."""
    from repro_torch.launch import kernels_demo

    T, h_in, h_out, h_g = kernels_demo.FULL
    kern.reset_launches()
    out = kernels_demo.run(DEVICE, T=T, h_in=h_in, h_out=h_out, h_g=h_g,
                           w_dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    log(f"[demo] launches {launches}")
    for name, r in out.items():
        if not r["ok"]:
            fail(f"kernels demo: {name} disagrees with its oracle "
                 f"({r['max_abs_err']:.3e})")
        if launches[name] != 1:
            fail(f"kernels demo launched {name} {launches[name]} times, expected 1")
    report["demo"] = {"launches": launches, "errors": out}
    return launches


# ---------------------------------------------------------------------------
# the rest of dense serving and of compression: residency, storage,
# group-size search, and the other dense configs at full width
# ---------------------------------------------------------------------------
def _row_bytes(deltas) -> int:
    """Bytes of one tenant row of the residency tier: f32 values shaped
    like every packed leaf's idx."""
    from repro_torch.core.pack import PackedDelta
    from repro_torch.utils import iter_leaves
    return sum(4 * d.idx.numel() for _, d in iter_leaves(deltas) if isinstance(d, PackedDelta))


def phase_residency(torch, kern, ctx: dict, report: dict) -> dict:
    """``ContinuousEngine(residency_budget_bytes=)`` at full width on the
    [engine] stream, budget RESIDENCY_ROWS rows: the tier is built and
    accounted, never consulted on the card (the values path is plain
    torch, as the reference takes it only with its Pallas backend off),
    so every step is packed and the tokens equal the packed [engine] run.
    Then a direct ``ensure()`` of tenants 1-3: the resident values equal
    ``pack.decode_values`` and the dequant kernel's dense delta at the
    kept positions, bit for bit."""
    import numpy as np
    from repro_torch.core.pack import PackedDelta, decode_values
    from repro_torch.kernels import ops
    from repro_torch.serve import ContinuousEngine, VirtualClock
    from repro_torch.utils import iter_leaves

    cfg, base, store = ctx["cfg"], ctx["base"], ctx["eng"].store
    row_bytes = _row_bytes(store.get("tenant0").deltas)
    budget = RESIDENCY_ROWS * row_bytes
    stream = _engine_stream(cfg)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ce = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          store=store, clock=VirtualClock(tick=ENGINE_TICK),
                          residency_budget_bytes=budget)
    run = _engine_run(torch, kern, ce, stream, list(range(len(stream))),
                      f"residency: mixed, budget {RESIDENCY_ROWS} rows")
    res = run["report"]["residency"]
    mem = {"engine_gb": (torch.cuda.memory_allocated() - mem0) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "values_gb": res["allocated_bytes"] / 1e9}
    packed = report["engine"]["tokens"]
    same = sum(run["tokens"][i].tolist() == packed[str(i)] for i in range(len(stream)))
    log(f"[residency] budget {budget / 1e9:.3f} GB = {RESIDENCY_ROWS} rows of "
        f"{row_bytes / 1e9:.3f} GB f32 values; stats {res}; tokens equal to the packed "
        f"[engine] run: {same}/{len(stream)}; engine {mem['engine_gb']:.2f} GB "
        f"({mem['values_gb']:.2f} GB values), peak {mem['peak_gb']:.2f} GB")
    if same != len(stream):
        fail(f"[residency] {len(stream) - same} requests differ from the packed run")
    if not (res["enabled"] and res["capacity_rows"] == RESIDENCY_ROWS
            and res["value_steps"] == 0 and res["hits"] == 0
            and res["packed_steps"] == run["decode_steps"] > 0):
        fail(f"[residency] stats {res} after {run['decode_steps']} steps")
    want = {"delta_spmm": 7 * cfg.n_layers * len(stream),
            "delta_spmm_segments": 7 * cfg.n_layers * run["decode_steps"],
            "fused_base_delta": 0, "dequant": 0}
    if run["launches"] != want:
        fail(f"[residency] launches {run['launches']}, expected {want}")

    # a direct ensure() on the card: promotions are in-place copies of
    # decode_values; each equals the dequant kernel's dense delta at idx
    t0 = time.perf_counter()
    rm = ce.residency.ensure(np.array([1, 2, 3], np.int32))
    torch.cuda.synchronize()
    ensure_s = time.perf_counter() - t0
    kern.reset_launches()
    n_checked = 0
    for path, d in iter_leaves(ce._groups[0].stacked):
        if not isinstance(d, PackedDelta):
            continue
        vals = ce.residency.values
        for k in path.split("/"):
            vals = vals[k]
        for row in (1, 2, 3):
            v = vals[rm[row]]
            one = d.index(row)
            if not torch.equal(v, decode_values(one)):
                fail(f"[residency] {path} row {row}: resident values != decode_values")
            for layer in range(one.stack_shape()[0]):
                m = one.index(layer)
                dense = ops.dequant(m).reshape(m.n_groups, m.h_g, m.h_out)
                if not torch.equal(dense.gather(1, m.idx.long()), v[layer]):
                    fail(f"[residency] {path} row {row} layer {layer}: resident values "
                         f"!= the dequant kernel's delta at idx")
                n_checked += 1
    torch.cuda.synchronize()
    check_launches = dict(kern.LAUNCHES)
    log(f"[residency] ensure(tenants 1-3) on the card in {ensure_s * 1e3:.1f} ms: "
        f"{n_checked} matrices equal decode_values and the dequant kernel's delta at idx, "
        f"bit for bit (launches {check_launches})")
    report["residency"] = {"budget_bytes": budget, "row_bytes": row_bytes, "stats": res,
                           "tokens_equal_packed": same, "launches": run["launches"],
                           "wall_s": run["wall_s"], "ms_per_step": run["ms_per_step"],
                           "memory": mem, "ensure_ms": ensure_s * 1e3,
                           "matrices_checked": n_checked, "check_launches": check_launches}
    del ce
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def _storage_roundtrip(torch, d):
    """One matrix through to_storage_parts -> from_storage_parts onto the
    card: (storage bits of its parts, packed bytes), or None where a
    reloaded array differs from the packing's."""
    from repro_torch.core.pack import from_storage_parts, to_storage_parts
    from repro_torch.roofline.analysis import packed_bytes
    parts = to_storage_parts(d)
    d2 = from_storage_parts(parts, h_in=d.h_in, h_out=d.h_out, h_g=d.h_g, keep=d.keep,
                            alpha=d.alpha, k_bits=d.k_bits, scale=d.scale, zero=d.zero,
                            device=DEVICE)
    for f in ("idx", "codes", "scale", "zero"):
        a, b = getattr(d2, f), getattr(d, f)
        if a.dtype != b.dtype or not torch.equal(a, b):
            return None
    return sum(p.storage_bits(d.k_bits, d.m, d.h_g) for p in parts), packed_bytes(d)


def phase_storage(torch, kern, ctx: dict, report: dict) -> dict:
    """tenant0 at full width, every matrix of every leaf in its first
    STORAGE_LAYERS layers, through the m-part storage layer (numpy on
    the host, matrices on STORAGE_THREADS threads)
    and back onto the card: idx, codes, scale and zero equal the packing;
    delta_spmm on a reloaded matrix equals the original bit for bit; one
    BitDelta leaf the same way."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.codecs import BitDeltaSpec, get_codec
    from repro_torch.core.pack import PackedDelta, from_storage_parts, to_storage_parts
    from repro_torch.kernels import ops
    from repro_torch.utils import iter_leaves

    base = ctx["base"]
    deltas = ctx["eng"].store.get("tenant0").deltas
    jobs = [(path, layer, d.index(layer)) for path, d in iter_leaves(deltas)
            if isinstance(d, PackedDelta)
            for layer in range(min(STORAGE_LAYERS, d.stack_shape()[0]))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(STORAGE_THREADS) as pool:
        results = list(pool.map(lambda j: _storage_roundtrip(torch, j[2]), jobs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(p, l) for (p, l, _), r in zip(jobs, results) if r is None]
    if bad:
        fail(f"[storage] {len(bad)} matrices differ after the round trip: {bad[:4]}")
    bits = sum(r[0] for r in results)
    nbytes = sum(r[1] for r in results)
    codec = get_codec("deltadq")
    paper = sum(codec.storage_bits(d)["value_bits"] for _, _, d in jobs)
    log(f"[storage] tenant0: {len(jobs)} matrices (its first {STORAGE_LAYERS} layers) "
        f"round-tripped in {wall:.1f} s "
        f"({STORAGE_THREADS} host threads); idx, codes, scale, zero equal; storage parts "
        f"{bits / 8e9:.3f} GB (values + log2(h_g)-bit indices + 64-bit group offsets) "
        f"against {nbytes / 1e9:.3f} GB packed runtime arrays; paper value bits "
        f"{paper / 8e9:.3f} GB")

    # the kernel on a reloaded matrix: the same bits as on the original
    d = deltas["mlp"]["wi"].index(0)
    d2 = from_storage_parts(to_storage_parts(d), h_in=d.h_in, h_out=d.h_out, h_g=d.h_g,
                            keep=d.keep, alpha=d.alpha, k_bits=d.k_bits, scale=d.scale,
                            zero=d.zero, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(17)
    kern.reset_launches()
    for T in (8, 128):
        x = torch.randn((T, d.h_in), generator=gen, device=DEVICE)
        if not torch.equal(ops.delta_spmm(x, d2), ops.delta_spmm(x, d)):
            fail(f"[storage] delta_spmm on the reloaded wi (T={T}) != on the original")
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    log(f"[storage] delta_spmm on reloaded mlp/wi layer 0 == original, bit for bit, "
        f"T=8 and T=128 (launches {launches})")

    # one BitDelta leaf (attention wq, layer 0) through its codec's storage
    c = get_codec("bitdelta")
    w = base["attn"]["wq"][0]
    noise = torch.randn(w.shape, generator=gen, device=DEVICE) * 0.02
    leaf = c.compress_leaf(w, (w.float() + noise).to(w.dtype), BitDeltaSpec())
    parts, meta = c.to_storage_parts(leaf)
    leaf2 = c.from_storage_parts(parts, meta, device=DEVICE)
    if not (torch.equal(leaf2.sign, leaf.sign) and torch.equal(leaf2.scale, leaf.scale)):
        fail("[storage] the BitDelta leaf differs after the round trip")
    bd_bits = c.storage_bits(leaf)
    log(f"[storage] BitDelta attn/wq layer 0: sign and scale equal after the round trip; "
        f"storage {bd_bits['total_bits'] / 8e6:.3f} MB against {leaf.nbytes() / 1e6:.3f} MB "
        f"runtime leaf ({c.runtime_packed(leaf).nbytes() / 1e6:.3f} MB lowered)")
    report["storage"] = {"matrices": len(jobs), "wall_s": wall, "storage_bits": bits,
                         "packed_bytes": nbytes, "paper_value_bits": paper,
                         "launches": launches,
                         "bitdelta": {"storage_bits": bd_bits, "nbytes": leaf.nbytes()}}
    del d2, leaf, leaf2
    torch.cuda.empty_cache()
    return launches


def phase_groupsearch(torch, ctx: dict, report: dict) -> None:
    """The paper's proxy group-size search on layer 0's wq/wk at full width
    (calibration x: the embedded tokens of GROUPSEARCH_TOKENS prompt
    positions; the fine-tuned weights are w + 0.02 N(0, 1), the launcher's
    tenant rule), every candidate from alpha to h_in, on the card; the
    error at h_g = 16 against the same call on the CPU with the same keys;
    each baseline on wq's delta against its CPU result."""
    import numpy as np
    from repro_torch.core import baselines
    from repro_torch.core.codecs import DeltaDQSpec
    from repro_torch.core.groupsearch import (attention_proxy_error, candidate_group_sizes,
                                              search_proxy)
    from repro_torch.models import lm

    cfg, base = ctx["cfg"], ctx["base"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(23)
    toks = np.random.default_rng(23).integers(0, cfg.vocab, GROUPSEARCH_TOKENS)
    x = lm.embed_tokens(cfg, base, torch.as_tensor(toks, device=DEVICE))
    wq_b, wk_b = base["attn"]["wq"][0], base["attn"]["wk"][0]
    wq_f, wk_f = [(w.float() + 0.02 * torch.randn(w.shape, generator=gen, device=DEVICE)
                   ).to(w.dtype) for w in (wq_b, wk_b)]
    spec = DeltaDQSpec(alpha=ALPHA, k_bits=4, m=8)
    cands = candidate_group_sizes(cfg.d_model, spec.alpha)
    res = search_proxy(x, wq_b, wk_b, wq_f, wk_f, spec, generator=gen)
    torch.cuda.synchronize()
    log(f"[groupsearch] {cfg.name} layer 0 wq/wk, {GROUPSEARCH_TOKENS} calibration tokens, "
        f"{len(cands)} candidates {cands}: h_g* = {res.h_g_star} in {res.seconds:.2f} s; "
        f"errors {{{', '.join(f'{k}: {v:.6e}' for k, v in res.errors.items())}}}")
    if sorted(res.errors) != cands or res.errors[res.h_g_star] != min(res.errors.values()):
        fail(f"[groupsearch] candidates {sorted(res.errors)} or h_g* {res.h_g_star}")
    if not all(np.isfinite(v) and v > 0 for v in res.errors.values()):
        fail(f"[groupsearch] errors {res.errors}")

    # the card against the CPU at h_g = 16, with the same keys
    hg = 16
    cpu_gen = torch.Generator().manual_seed(29)
    G = cfg.d_model // hg
    keys = tuple(torch.rand((G, hg, w.shape[1]), generator=cpu_gen) for w in (wq_b, wk_b))
    t0 = time.perf_counter()
    card = float(attention_proxy_error(x, wq_b, wk_b, wq_f, wk_f, hg, spec,
                                       keys=tuple(k.to(DEVICE) for k in keys)))
    t1 = time.perf_counter()
    host = float(attention_proxy_error(*(t.cpu() for t in (x, wq_b, wk_b, wq_f, wk_f)),
                                       hg, spec, keys=keys))
    t2 = time.perf_counter()
    rel = abs(card - host) / abs(host)
    log(f"[groupsearch] h_g=16 with one set of keys: card {card:.8e} ({t1 - t0:.2f} s), "
        f"CPU {host:.8e} ({t2 - t1:.2f} s), relative difference {rel:.3e} (bound "
        f"{GROUPSEARCH_REL_TOL})")
    if not rel <= GROUPSEARCH_REL_TOL:
        fail(f"[groupsearch] the card's proxy error is {rel:.3e} from the CPU's")

    # the baselines on wq's delta: the card against the CPU
    dq = (wq_f - wq_b).float()
    mask = torch.rand(dq.shape, generator=cpu_gen) < 1.0 / ALPHA
    rows = {}
    for name, fn in baselines.METHODS.items():
        extra = {"mask": mask} if name == "dare" else {}
        on_card = fn(dq, alpha=ALPHA, **{k: v.to(DEVICE) for k, v in extra.items()}).cpu()
        on_host = fn(dq.cpu(), alpha=ALPHA, **extra)
        err = (on_card - on_host).abs().max().item()
        exact = torch.equal(on_card, on_host)
        rows[name] = {"exact": exact, "max_abs_err": err,
                      "kept": (on_card != 0).float().mean().item(),
                      "bits": baselines.method_bits(name, tuple(dq.shape), alpha=ALPHA)}
        log(f"[groupsearch] baseline {name} on wq's delta: card == CPU "
            f"{'bit for bit' if exact else f'within {err:.3e}'}; {rows[name]['kept']:.4f} "
            f"kept, {rows[name]['bits'] / 8e6:.3f} MB at 16-bit values")
        # magnitude and dare select and rescale (exact on both); deltazip's
        # quant-dequant may round its q * s + lo once (an FMA) on the card
        ok = exact if name != "deltazip" else torch.allclose(on_card, on_host, **KERNEL_TOL)
        if not ok:
            fail(f"[groupsearch] baseline {name}: the card differs from the CPU ({err:.3e})")
    report["groupsearch"] = {"h_g_star": res.h_g_star, "errors": res.errors,
                             "seconds": res.seconds, "candidates": cands,
                             "card_vs_cpu": {"h_g": hg, "card": card, "cpu": host,
                                             "rel": rel},
                             "baselines": rows}
    del x, dq
    torch.cuda.empty_cache()


def _spec_packed(torch, h_in, h_out, kw: dict, gen):
    """A 0.02 N(0, 1) delta (the launcher's tenant noise) packed as the
    compressor packs it at DeltaDQSpec(**kw) (the group size clamped to a
    divisor of h_in as ``compress()`` clamps it)."""
    from repro_torch.core import dropout
    from repro_torch.core.codecs import DeltaDQSpec, _pick_hg
    spec = DeltaDQSpec(**kw)
    delta = torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02
    return dropout.groupwise_dropout_pack(delta, h_g=_pick_hg(h_in, spec), alpha=spec.alpha,
                                          k_bits=spec.k_bits, m=spec.m, generator=gen)


def _envelope_kernels(torch, kern, report: dict) -> tuple:
    """Each kernel on each ENVELOPE_SPECS packing at each of wizard's
    SITES against its plain version, rows bit-equal to the kernel-order
    oracle on every tile the packing takes (the decode tiles and the
    128-row tile) and in their segment, every call a launch on the route
    ``ops.spmm_tile`` names (the 128-row tile at row-wise wi and MLP wo
    from 65 rows), no plain-out-of-envelope note; then the times. ->
    (worst error by kernel, timed rows)."""
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.scheduler import tenant_segments
    from repro_torch.serve.trace import attribution

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2424)
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0, "fused_base_delta": 0.0,
             "dequant": 0.0}
    times, plans, tiles = [], {}, {}
    kern.reset_launches()
    n_calls = {k: 0 for k in worst}
    n_routes = {"delta_spmm_decode": 0, "delta_spmm_prefill": 0}

    def route(tb):
        n_routes["delta_spmm_prefill" if tb in kern.PREFILL_TILES else "delta_spmm_decode"] += 1

    def close(name, got, want, where):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst[name] = max(worst[name], err)
        if not torch.allclose(got, want, **KERNEL_TOL):
            fail(f"[envelope] {name} {where}: max err {err:.3e}")

    def bits(a, b, what):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"[envelope] {what}: {int((a != b).sum().item())} elements differ")

    for spec_name, kw in ENVELOPE_SPECS.items():
        for site, (h_in, h_out) in SITES.items():
            where = f"{spec_name} {site}"
            ring = [_spec_packed(torch, h_in, h_out, kw, gen) for _ in range(8)]
            d = ring[0]
            if ops.card_envelope_miss(d) is not None or d.idx.dtype != kern.idx_dtype(d.h_g):
                fail(f"[envelope] {where}: h_g={d.h_g} keep={d.keep} idx {d.idx.dtype} is "
                     f"not a packing the kernels take")
            plans[where] = {tb: kern.decode_plan(d, tb) for tb in kern.ROW_TILES}
            p8 = plans[where][8]
            log(f"[envelope] {where}: h_g={d.h_g} (G={d.n_groups}) keep={d.keep} "
                f"k_bits={d.k_bits} idx {str(d.idx.dtype)[6:]}, "
                f"{sum(t.numel() * t.element_size() for t in (d.idx, d.codes)) / 1e6:.1f} MB "
                f"packed; reference envelope: {ops.envelope_miss(d) or 'inside'}; decode "
                f"plan at tb=8: {p8['cluster']} blocks a cluster of {p8['cols']} columns, "
                f"{p8['rows']} rows a block, {p8['sg']} groups x {p8['kc']} "
                f"slots a step, {p8['steps']} steps a class chain, {p8['stages']} stages, "
                f"{p8['smem_bytes']} B shared, x from {'global' if p8['x_global'] else 'a slab'}")
            stack = stack_tenant_deltas([{"w": t} for t in ring[:4]])["w"]
            # every tile the packing takes: the decode tiles and the 128-row tile
            takes = [tb for tb in kern.SPMM_TILES
                     if tb in kern.ROW_TILES or kern.prefill_fits(tb, d.h_g, d.keep)]
            with attribution() as notes:
                for T in ENVELOPE_CHECK_T:
                    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
                    tb_ops, src = ops.spmm_tile(T, d)
                    tiles[f"{where} T={T}"] = {"tb": tb_ops, "from": src}
                    if T >= ops.PREFILL_MIN_T and spec_name == "rowwise" and \
                            site in ("wi", "mlp_wo") and tb_ops not in kern.PREFILL_TILES:
                        fail(f"[envelope] {where} T={T}: ops names tb={tb_ops} ({src}), "
                             f"not the 128-row tile")
                    y = ops.delta_spmm(x, d)
                    n_calls["delta_spmm"] += 1
                    route(tb_ops)
                    close("delta_spmm", y, fb.correction(x, d), f"{where} T={T}")
                    bits(y, ref.correction_kernel_order(x, d), f"delta_spmm {where} T={T} "
                         f"against correction_kernel_order")
                    for tb in takes:
                        bits(kern.delta_spmm_cuda(x, d, tb=tb), y,
                             f"delta_spmm {where} T={T} tb={tb} against ops' tile")
                        route(tb)
                    n_calls["delta_spmm"] += len(takes)
                rows = _mixed_rows(8)
                seg = tenant_segments(rows).to(DEVICE)
                x8 = torch.randn((8, h_in), generator=gen, device=DEVICE)
                xs = x8.index_select(0, seg.order)
                ys = ops.delta_spmm_segments(xs, stack, seg.seg_rows, seg.seg_offsets)
                n_calls["delta_spmm_segments"] += 1
                close("delta_spmm_segments", ys,
                      _plain_segments(torch, fb, xs, stack, seg.seg_rows, seg.seg_offsets),
                      f"{where} mixed T=8")
                bits(ys, ref.segments_kernel_order(xs, stack, seg.seg_rows, seg.seg_offsets),
                     f"segments {where} against segments_kernel_order")
                sorted_rows = torch.as_tensor(rows, device=DEVICE)[seg.order]
                for t in range(4):
                    sel = sorted_rows == t
                    bits(ys[sel], ops.delta_spmm(xs, stack.index(t))[sel],
                         f"segment rows of tenant {t} against delta_spmm rows ({where})")
                    n_calls["delta_spmm"] += 1
                    route(ops.spmm_row_tile(xs.shape[0], d))
                dense = ops.dequant(d)
                n_calls["dequant"] += 1
                bits(dense, fb.dequant(d), f"dequant {where} against its plain version")
                worst["dequant"] = max(worst["dequant"],
                                       (dense - fb.dequant(d)).abs().max().item())
                del dense
                w = (torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02).to(
                    torch.bfloat16)
                for T in ENVELOPE_T:
                    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
                    close("fused_base_delta", ops.fused_base_delta(x, w, d),
                          fb.fused_base_delta(x, w, d), f"{where} T={T}")
                    n_calls["fused_base_delta"] += 1
                del w
            # the entry points' notes (the plain versions called beside them
            # note their own sites)
            edge = [n for n in notes if n.get("formulation") == "plain-out-of-envelope"]
            forms = sorted({n["formulation"] for n in notes if n["site"] in (
                "delta_spmm", "delta_spmm_segments", "fused_base_delta", "dequant")})
            want_forms = {"cuda", "cuda-3xtf32", "segments-cuda"} | (
                {"cuda-prefill"} if any(tiles[f"{where} T={T}"]["tb"] in kern.PREFILL_TILES
                                        for T in ENVELOPE_CHECK_T) else set())
            if edge or forms != sorted(want_forms):
                fail(f"[envelope] {where}: formulations {forms}, out-of-envelope notes {edge}")
            torch.cuda.synchronize()
            if dict(kern.LAUNCHES) != n_calls or dict(kern.ROUTES) != n_routes:
                fail(f"[envelope] {where}: launches {dict(kern.LAUNCHES)} routes "
                     f"{dict(kern.ROUTES)}, expected {n_calls} and {n_routes}")
            log(f"[envelope] {where}: ops' tile " + ", ".join(
                f"T={T} tb={tiles[f'{where} T={T}']['tb']} ({tiles[f'{where} T={T}']['from']})"
                for T in ENVELOPE_CHECK_T) + f"; routes {dict(kern.ROUTES)}")
            # times: delta_spmm at ENVELOPE_T, the mixed segments layout, and
            # at ENVELOPE_MERGE_SITE the merge kernels, on the ring
            dense = [reconstruct_dense(t) for t in ring]
            for T in ENVELOPE_T:
                times.append({"packing": spec_name, **_time_spmm(
                    torch, ops, fb, ring, dense, gen, site, T, None)})
            times.append({"packing": spec_name, **_time_segments(
                torch, ops, fb, ring, gen, site, "mixed", 8)})
            if site == ENVELOPE_MERGE_SITE:
                times += [{"packing": spec_name, **t} for t in _time_merge_kernels(
                    torch, ring, dense, gen, site, h_in, h_out)]
            kern.reset_launches()
            n_calls = {k: 0 for k in worst}
            n_routes = {k: 0 for k in n_routes}
            del ring, dense, stack, d
            gc.collect()
            torch.cuda.empty_cache()
    log(f"[envelope] every kernel within atol/rtol 1e-4 of its plain version at "
        f"{list(ENVELOPE_SPECS)} x {list(SITES)} (worst |err| "
        f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())}); delta_spmm at T "
        f"{list(ENVELOPE_CHECK_T)} == correction_kernel_order on every tile "
        f"{list(kern.SPMM_TILES)}, segment rows == segments_kernel_order == delta_spmm "
        f"rows, dequant bit-equal; every call a launch on the route ops names, no "
        f"plain-out-of-envelope note")
    report["envelope"] = {"plans": {k: {str(tb): p for tb, p in v.items()}
                                    for k, v in plans.items()}, "worst": worst,
                          "times": times, "tiles": tiles}
    return worst, times


# [autotune]: the sweep live at two points the table holds, at two buckets
AUTOTUNE_POINTS = {"wizard 128x wi": (16, 2, 4, 4096, 11008),
                   "row-wise MLP wo": (11008, 1376, None, 11008, 4096)}
AUTOTUNE_T = (8, 128)


def phase_autotune(torch, report: dict) -> float:
    """[autotune]: ``autotune.sweep_point`` live at AUTOTUNE_POINTS and
    AUTOTUNE_T (every candidate tile bit-equal to the rule's, or the sweep
    raises), each bucket's live best beside the committed table's entry
    and the rule's tile, with live times, and whether the table names this
    card (then ``ops`` takes it). -> seconds."""
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    tab = autotune.load_table()
    applies = bool(tab) and tab.get("device") == autotune.card_name()
    log(f"[autotune] table {os.path.relpath(autotune.table_path(), HERE)}: "
        + (f"swept on {tab.get('device')!r} at {tab.get('power_limit')}; this card "
           f"{autotune.card_name()!r}: {'applied' if applies else 'NOT applied (rules)'}"
           if tab else "absent (rules)"))
    rows = []
    for name, point in AUTOTUNE_POINTS.items():
        try:
            _, overlays = autotune.sweep_point(*point, seed=11, ts=AUTOTUNE_T)
        except RuntimeError as e:
            fail(f"[autotune] {name}: {e}")
        for T, ov in overlays.items():
            entry = tab.get("entries", {}).get(autotune.envelope_key(*point, t=T), {})
            live = {int(tb): ms for tb, ms in ov["ms"].items()}
            swept = autotune.swept_tb(*point, T, device=DEVICE)    # what ops takes
            row = {"point": autotune.envelope_key(*point), "site": name, "T": T,
                   "live_tb": ov["tb"], "rule_tb": ov["rule_tb"], "table_tb": entry.get("tb"),
                   "table_ms": entry.get("ms", {}).get(str(entry.get("tb"))),
                   "ops_tb": ov["rule_tb"] if swept is None else swept,
                   "ops_source": "rule" if swept is None else "table", "live_ms": live,
                   "live_seg_tb": ov.get("seg_tb"), "table_seg_tb": entry.get("seg_tb"),
                   "live_seg_ms": ov.get("seg_ms")}
            rows.append(row)
            tb_t = row["table_tb"]
            table = "no entry" if tb_t not in live else \
                f"live {live[tb_t]:.4f} ms, swept {row['table_ms']:.4f} ms"
            log(f"[autotune] {name} T={T}: {len(live)} tiles bit-equal to the rule's; "
                f"live best tb={ov['tb']} {live[ov['tb']]:.4f} ms, table tb={tb_t} ({table}), "
                f"rule tb={ov['rule_tb']} {live[ov['rule_tb']]:.4f} ms; ops takes "
                f"tb={row['ops_tb']} ({row['ops_source']}); all "
                + ", ".join(f"{tb}: {ms:.4f}" for tb, ms in sorted(live.items()))
                + ("" if "seg_tb" not in ov else
                   f"; segments live best tb={ov['seg_tb']}, table tb={row['table_seg_tb']}, "
                   "all " + ", ".join(f"{tb}: {ms:.4f}"
                                      for tb, ms in sorted(ov["seg_ms"].items()))))
    wall = time.perf_counter() - t0
    log(f"[autotune] {len(rows)} buckets, every candidate bit-equal, {wall:.1f} s")
    report["autotune"] = {"applied": applies, "device": tab.get("device"),
                          "power_limit": tab.get("power_limit"), "rows": rows, "wall_s": wall}
    return wall


def phase_envelope(torch, kern, ctx: dict, report: dict) -> dict:
    """[envelope]: packings past the reference's Pallas envelope on the
    card. The kernels at wizard's full-width sites (:func:`_envelope_kernels`);
    then wizard at CODECS_DEPTH layers serving one 128x tenant (h_g 16,
    the [main] fleet's tenant0), one DeltaDQSpec() row-wise tenant, one
    at h_g 1024 and one at [groupsearch]'s h_g*, each its own codec group,
    on the [engine] stream, mixed == alone token for token; and the
    row-wise and h_g 1024 tenants merged (dequant) against their packed
    prefill logits."""
    from repro_torch.core.apply import merge_delta
    from repro_torch.core.codecs import DeltaDQSpec
    from repro_torch.launch.serve import synth_tenants
    from repro_torch.models import lm
    from repro_torch.utils import tree_bytes

    t_phase = time.perf_counter()
    worst, _ = _envelope_kernels(torch, kern, report)
    t_kernels = time.perf_counter() - t_phase
    h_star = report["groupsearch"]["h_g_star"]
    cfg, base, (t128,) = _first_layers(ctx["cfg"], ctx["base"],
                                       [ctx["eng"].store.get("tenant0").deltas], CODECS_DEPTH)
    specs = {"rowwise": DeltaDQSpec(), "h1024": DeltaDQSpec(**ENVELOPE_SPECS["h1024"]),
             "hstar": DeltaDQSpec(alpha=ALPHA, k_bits=4, m=8, h_g=h_star)}
    t0 = time.perf_counter()
    made = synth_tenants(cfg, base, len(specs), list(specs.values()), seed=24)
    torch.cuda.synchronize()
    log(f"[envelope] {len(specs)} tenants at {CODECS_DEPTH} of {ctx['cfg'].n_layers} layers "
        f"compressed in {time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"{n} {tree_bytes(d) / 1e9:.3f} GB ({rep.summary()})"
            for n, (_, d, rep) in zip(specs, made)))
    fleet = [("t128", t128)] + [(n, d) for n, (_, d, _) in zip(specs, made)]
    stream = _engine_stream(cfg, names=(None, *[n for n, _ in fleet]))
    runs = _mixed_vs_alone(torch, kern, cfg, base, fleet, stream,
                           f"{CODECS_DEPTH} of {ctx['cfg'].n_layers} layers", modes=("whole",),
                           phase="envelope")

    # merged (dequant) against packed, prefill logits of a 64-token prompt
    import numpy as np
    prompt = torch.as_tensor(np.random.default_rng(24).integers(0, cfg.vocab, (1, 64)),
                             dtype=torch.int64, device=DEVICE)
    f32 = {k: {n: w.float() for n, w in v.items()} for k, v in base.items()}
    merge = {}
    for name in ("rowwise", "h1024"):
        d = dict(fleet)[name]
        kern.reset_launches()
        merged = merge_delta(f32, d)
        torch.cuda.synchronize()
        n_dq = kern.LAUNCHES["dequant"]
        cache = lm.init_cache(cfg, 1, 96, device=DEVICE)
        sep, _ = lm.prefill(cfg, base, {"tokens": prompt}, cache, deltas=d)
        cache = lm.init_cache(cfg, 1, 96, device=DEVICE)
        mlog, _ = lm.prefill(cfg, merged, {"tokens": prompt}, cache)
        err = (sep - mlog).abs().max().item()
        scale = sep.abs().max().item()
        merge[name] = {"dequant_launches": n_dq, "rel": err / scale}
        log(f"[envelope] {name} merged (dequant, {n_dq} launches) vs packed prefill "
            f"logits: max|diff| {err:.4e}, rel {err / scale:.3e} (bound {MERGED_REL_TOL})")
        if n_dq != 7 * cfg.n_layers or not err <= MERGED_REL_TOL * scale:
            fail(f"[envelope] {name}: merged vs packed rel {err / scale:.3e}, "
                 f"{n_dq} dequant launches")
        del merged, cache
    del f32, fleet, made
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[envelope] phase {secs:.1f} s (kernels {t_kernels:.1f} s)")
    report["envelope"].update({
        "h_g_star": h_star, "engine": {k: runs["whole"][k] for k in (
            "wall_s", "decode_steps", "ms_per_step", "tokens_per_s", "launches", "memory",
            "alone_mismatches")}, "merge": merge, "seconds": secs,
        "kernel_seconds": t_kernels})
    return runs["whole"]["launches"], worst



def _window_stream(cfg) -> list:
    """gemma3-1b's stream: WINDOW_REQUESTS requests round-robin over {base,
    tenant0..2}, prompts of WINDOW_MIN..WINDOW_MAX tokens (every one
    longer than the 512-token local window) from a seeded generator."""
    import numpy as np
    rng = np.random.default_rng(WINDOW_SEED)
    lengths = rng.integers(WINDOW_MIN, WINDOW_MAX + 1, WINDOW_REQUESTS)
    names = (None, "tenant0", "tenant1", "tenant2")
    return [(names[i % 4], rng.integers(0, cfg.vocab, int(L)).astype(np.int32),
             ENGINE_GAP * i) for i, L in enumerate(lengths)]


def _arch_kernels(torch, ops, fb, kern, arch, cfg, fleet, gen) -> dict:
    """Both correction kernels at the config's site new to them, held to
    their plain versions, timed (CUDA-graph replays) against their bound
    and torch.matmul on the dense delta; the decode plans it gets."""
    import numpy as np
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.serve.scheduler import tenant_segments

    block, name = ARCH_SITES[arch]
    leaves = [deltas[block][name] for _, deltas, _ in fleet]
    d0 = leaves[0].index(0)
    site = f"{block}/{name}"
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0}
    for T in (1, 8, 64, 128):
        x = torch.randn((T, d0.h_in), generator=gen, device=DEVICE)
        got, want = ops.delta_spmm(x, d0), fb.correction(x, d0)
        err = (got - want).abs().max().item()
        worst["delta_spmm"] = max(worst["delta_spmm"], err)
        if not torch.allclose(got, want, **KERNEL_TOL):
            fail(f"[archs] {cfg.name} {site} delta_spmm T={T}: {err:.3e} from the plain version")
    stack = stack_tenant_deltas([{"w": leaves[t].index(layer)}
                                 for t, layer in ((0, 0), (1, 0), (2, 0), (0, 1))])["w"]
    seg = tenant_segments(np.asarray(MIXED_SLOT_ROWS, np.int32)).to(DEVICE)
    for T, layout in ((len(MIXED_SLOT_ROWS), "mixed"), (WINDOW_CHUNK, "chunk")):
        x = torch.randn((T, d0.h_in), generator=gen, device=DEVICE)
        if layout == "chunk":
            xs, (sr, so) = x, _chunk_segments(T)
        else:
            xs, sr, so = x.index_select(0, seg.order), seg.seg_rows, seg.seg_offsets
        got = ops.delta_spmm_segments(xs, stack, sr, so)
        want = _plain_segments(torch, fb, xs, stack, sr, so)
        err = (got - want).abs().max().item()
        worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"], err)
        if not torch.allclose(got, want, **KERNEL_TOL):
            fail(f"[archs] {cfg.name} {site} segments {layout} T={T}: {err:.3e} from the "
                 f"plain version")
    del stack
    plans = {tb: kern.decode_plan(d0, tb) for tb in kern.ROW_TILES}
    if any(p is None for p in plans.values()):
        fail(f"[archs] {cfg.name} {site}: no decode plan for {plans}")
    ring = [leaves[i % 3].index((i // 3) % cfg.n_layers) for i in range(8)]
    dense = [reconstruct_dense(d) for d in ring]
    times = [_time_spmm(torch, ops, fb, ring, dense, gen, site, 8, None),
             _time_spmm(torch, ops, fb, ring, dense, gen, site, 128, None)]
    del dense
    times.append(_time_segments(torch, ops, fb, ring, gen, site, "mixed", 8))
    for t in times:
        t["arch"] = arch
    summary = {tb: (p["rows"], p["sg"], p["stages"], p["smem_bytes"]) for tb, p in plans.items()}
    log(f"[archs] {cfg.name} {site} ({d0.h_in} x {d0.h_out}, h_g {d0.h_g}, keep "
        f"{d0.keep}): both kernels within {KERNEL_TOL} of their plain versions (worst "
        f"{worst}); decode plan by row tile {summary} (rows a block, groups a stage, "
        f"stages, shared bytes); delta_spmm T=128 takes row tile "
        f"{ops.spmm_row_tile(128, d0)}")
    del ring
    torch.cuda.empty_cache()
    return {"site": site, "shape": [d0.h_in, d0.h_out], "worst": worst,
            "plans": {str(k): v for k, v in plans.items()}, "times": times}


def _arch_engine(torch, kern, cfg, base, ref, stream, max_seq: int, chunk: int,
                 chunked: bool, tag: str, sites: int = None) -> dict:
    """The fleet in one engine on ``stream`` (launch counts checked, with
    ``sites`` corrections a token, default 7 a layer), then each tenant's
    requests (and the base's) alone through the same engine, token for
    token."""
    from repro_torch.serve import ContinuousEngine, VirtualClock
    sites = 7 * cfg.n_layers if sites is None else sites
    ce = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=max_seq, store=ref.store,
                          clock=VirtualClock(tick=ENGINE_TICK), chunked_prefill=chunked,
                          chunk_size=chunk)
    mixed = _engine_run(torch, kern, ce, stream, list(range(len(stream))), f"{tag} mixed")
    steps = mixed["decode_steps"]
    n_chunks = sum(-(-len(p) // chunk) for _, p, _ in stream)
    want = {"delta_spmm": 0 if chunked else sites * len(stream),
            "delta_spmm_segments": sites * (steps + (n_chunks if chunked else 0)),
            "fused_base_delta": 0, "dequant": 0}
    if mixed["launches"] != want:
        fail(f"[archs] {tag}: launches {mixed['launches']}, expected {want}")
    bad = []
    for name in (None, "tenant0", "tenant1", "tenant2"):
        ce.reset_metrics()
        idx = [i for i, (t, _, _) in enumerate(stream) if t == name]
        run = _engine_run(torch, kern, ce, stream, idx, f"{tag} alone {name or 'base'}")
        for i in idx:
            j = _first_mismatch(run["tokens"][i], mixed["tokens"][i])
            if j is not None:
                bad.append({"request": i, "tenant": name, "step": j})
    log(f"[archs] {tag}: mixed == alone, token for token: "
        f"{len(stream) - len(bad)}/{len(stream)} requests" + (f"; differ: {bad}" if bad else ""))
    if bad:
        fail(f"[archs] {tag}: mixed serving differs from serving alone: {bad}")
    del ce
    gc.collect()
    torch.cuda.empty_cache()
    return mixed


def _arch_generate(torch, ref, stream, mixed, idx, tag: str) -> list:
    """Engine.generate (B=1) on requests ``idx``, tie-aware (other
    extents): equal in full, or a first mismatch at a near tie."""
    rows = []
    for i in idx:
        name, prompt, _ = stream[i]
        lg = []
        toks = ref.generate(name, prompt[None], max_new_tokens=ENGINE_NEW, logits_out=lg)[0]
        j = _first_mismatch(mixed["tokens"][i], toks)
        row = {"request": i, "tenant": name, "first_mismatch": j}
        if j is not None:
            row["margin"], row["bound"] = _margin_ok(torch, lg[j][0])
            if row["margin"] > row["bound"]:
                fail(f"[archs] {tag} request {i} leaves Engine.generate at step {j}, "
                     f"margin {row['margin']:.4e} > {row['bound']:.4e}")
        rows.append(row)
    log(f"[archs] {tag} vs Engine.generate (B=1), requests {list(idx)}: "
        f"{sum(r['first_mismatch'] is None for r in rows)}/{len(rows)} equal in full; {rows}")
    return rows


def _window_chunked_checks(torch, lm, cfg, base, ref, stream, chunked, max_seq) -> dict:
    """gemma3-1b's chunked engine against B=1 chunked decode (tie-aware),
    and the first-token logits of chunked prefill with an f32 ring against
    whole-prompt prefill (gated at CHUNK_F32_REL_TOL)."""
    rows, full, rel_f32 = [], 0, []
    for i, (name, prompt, _) in enumerate(stream):
        deltas = ref.store.get(name).deltas if name else None
        toks, lg = _greedy_b1(torch, lm, cfg, base, deltas, prompt, ENGINE_NEW,
                              WINDOW_CHUNK, max_seq=max_seq)
        j = _first_mismatch(chunked["tokens"][i], toks)
        row = {"request": i, "tenant": name, "first_mismatch": j}
        if j is None:
            full += 1
        else:
            row["margin"], row["bound"] = _margin_ok(torch, lg[j])
            if row["margin"] > row["bound"]:
                fail(f"[archs] {cfg.name} chunked request {i} leaves B=1 chunked decode "
                     f"at step {j}, margin {row['margin']:.4e} > {row['bound']:.4e}")
        whole = []
        ref.generate(name, prompt[None], max_new_tokens=1, logits_out=whole)
        f32_first = _greedy_b1(torch, lm, cfg, base, deltas, prompt, 1, WINDOW_CHUNK,
                               "float32", max_seq=max_seq)[1][0]
        w0 = whole[0][0]
        row["first_logit_rel_f32_ring"] = \
            (f32_first - w0).abs().max().item() / w0.abs().max().item()
        rel_f32.append(row["first_logit_rel_f32_ring"])
        if row["first_logit_rel_f32_ring"] > CHUNK_F32_REL_TOL:
            fail(f"[archs] {cfg.name} request {i}: chunked prefill with an f32 ring is "
                 f"{row['first_logit_rel_f32_ring']:.3e} from whole-prompt prefill")
        rows.append(row)
    log(f"[archs] {cfg.name} chunked engine vs B=1 chunked decode: {full}/{len(stream)} "
        f"equal in full, the rest at a near tie: "
        f"{[r for r in rows if r['first_mismatch'] is not None]}; first-token logits, "
        f"chunked (f32 ring) vs whole-prompt prefill: {min(rel_f32):.3e}-{max(rel_f32):.3e} "
        f"(bound {CHUNK_F32_REL_TOL})")
    return {"full_match_b1_chunked": full, "rows": rows}


def phase_archs(torch, kern, report: dict) -> dict:
    """gemma3-1b, gemma-7b and phi3-medium-14b at full width and the
    depths ARCH_DEPTH cuts them to, one after the other (each
    freed before the next): random init from seed 0,
    3 tenants at the 128x spec compressed on the card, both correction
    kernels at the site new to them, and the engine: gemma-7b and phi3 on
    the [engine] stream, whole-prompt, two requests against
    Engine.generate; gemma3-1b on prompts longer than its 512-token local
    window (its rings wrap in prefill and in decode), whole-prompt and
    chunked, the chunked engine against B=1 chunked decode.
    -> launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.serve import Engine
    from repro_torch.serve.scheduler import LengthBuckets
    from repro_torch.utils import tree_bytes

    out, by_path = {}, {}
    for arch in ARCH_SITES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        cfg = _at_depth(get_config(arch))
        base = lm.init_params(cfg, 0, device=DEVICE)
        fleet = synth_tenants(cfg, base, 3, RATIO_SPECS[128], seed=0)
        torch.cuda.synchronize()
        report["dryrun"][arch] = _dryrun_bytes("[archs]", cfg, base, fleet, RATIO_SPECS[128])
        t_init = time.perf_counter() - t_arch
        mem = {"params_gb": tree_bytes(base) / 1e9,
               "tenants_gb": sum(tree_bytes(d) for _, d, _ in fleet) / 1e9}
        log(f"[archs] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}; {mem['params_gb']:.2f} GB params, 3 tenants "
            f"{mem['tenants_gb']:.3f} GB packed ({fleet[0][2].summary()}); init and "
            f"compression {t_init:.1f} s")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(31)
        row = {"memory": mem, "init_s": t_init,
               "kernels": _arch_kernels(torch, ops, fb, kern, arch, cfg, fleet, gen)}
        windowed = any(cfg.layer_windows or ())
        if windowed:
            stream = _window_stream(cfg)
            top = max(LengthBuckets(min_bucket=8, max_bucket=1 << 20, exact=False).bucket(
                len(p)) for _, p, _ in stream)
            max_seq, modes = top + ENGINE_NEW, (False, True)
        else:
            stream, max_seq, modes = _engine_stream(cfg), ENGINE_MAX_SEQ, (False,)
        ref = Engine(cfg, base, max_seq=max_seq)
        for name, d, rep in fleet:
            ref.register_tenant(name, d, rep)
        del fleet
        row["stream"] = {"prompt_lengths": [len(p) for _, p, _ in stream],
                         "max_seq": max_seq, "chunk": WINDOW_CHUNK if windowed else None}
        mem0 = torch.cuda.memory_allocated()
        for chunked in modes:
            mode = "chunked" if chunked else "whole"
            run = _arch_engine(torch, kern, cfg, base, ref, stream, max_seq, WINDOW_CHUNK,
                               chunked, f"{arch} {mode}")
            by_path[f"archs:{arch}:{mode}"] = run["launches"]
            row[mode] = {k: run[k] for k in ("wall_s", "decode_steps", "ms_per_step",
                                             "tokens_per_s", "launches")}
            if chunked:
                row[mode].update(_window_chunked_checks(torch, lm, cfg, base, ref, stream,
                                                        run, max_seq))
            elif not windowed:
                row["generate"] = _arch_generate(torch, ref, stream, run, (0, 1), arch)
        mem.update(engine_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        row["wall_s"] = time.perf_counter() - t_arch
        log(f"[archs] {arch} memory: params {mem['params_gb']:.2f} GB, tenants "
            f"{mem['tenants_gb']:.3f} GB, engine up to {mem['engine_gb']:.2f} GB more, peak "
            f"{mem['peak_gb']:.2f} GB; {row['wall_s']:.1f} s")
        out[arch] = row
        del ref, base
    gc.collect()
    torch.cuda.empty_cache()
    report["archs"] = out
    return by_path


def _routed_counts(torch, n_experts: int, top_k: int, n_tokens: int, cap: int, gen):
    """Per-expert live rows [E] when ``n_tokens`` tokens each pick
    ``top_k`` distinct experts uniformly: their assignments counted per
    expert and capped at ``cap`` (the drops)."""
    pick = torch.rand((n_tokens, n_experts), generator=gen, device=DEVICE).argsort(dim=1)
    counts = torch.bincount(pick[:, :top_k].reshape(-1), minlength=n_experts)
    return counts.clamp(max=cap).to(torch.int32)


def _zero_past(torch, x, counts):
    """x [E, C, h] with each expert's rows past its count zeroed (an
    expert buffer's layout)."""
    C = x.shape[1]
    return x.masked_fill(torch.arange(C, device=x.device)[None, :, None]
                         >= counts[:, None, None].to(x.device), 0.0)


def _moe_kernels(torch, ops, fb, cfg, fleet, gen) -> tuple:
    """The expert-stacked route (``ops.delta_spmm_experts``: the segments
    kernel, one segment an expert) at wi, wg and wo for each (T, C) in
    MOE_CASES: held to its plain version within KERNEL_TOL on the all-C
    layout; the routed-counts layout and a random-counts one bit-equal to
    all-C; both layouts timed (CUDA-graph replays over MOE_RING layer
    slices) against the bound, the plain version and one torch.bmm on the
    dense f32 expert stack, beside the layout ops.expert_counts_pay takes
    for that T and C. -> (rows, worst error)."""
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.roofline import analysis as rl
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    rows, worst = [], 0.0
    for site in MOE_SITES:
        leaves = [deltas["moe"][site] for _, deltas, _ in fleet]
        ring = [leaves[i % len(leaves)].index((i // len(leaves)) % cfg.n_layers)
                for i in range(MOE_RING)]
        d0 = ring[0]
        h_in, h_out = d0.h_in, d0.h_out
        for T, C in MOE_CASES:
            x = torch.randn((E, C, h_in), generator=gen, device=DEVICE)
            seg_rows, offs = ops.expert_segments(E, C, None, DEVICE)
            got = ops.delta_spmm_experts(x, d0)
            want = _plain_segments(torch, fb, x.reshape(E * C, h_in), d0, seg_rows,
                                   offs).reshape(E, C, h_out)
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got, want, **KERNEL_TOL):
                fail(f"[moe] delta_spmm_experts {site} T={T} C={C}: {err:.3e} from the "
                     f"plain version")
            routed = _routed_counts(torch, E, K, T, C, gen)
            rand = torch.randint(0, C + 1, (E,), generator=gen, device=DEVICE,
                                 dtype=torch.int32)
            for name, counts in (("routed", routed), ("random", rand)):
                xz = _zero_past(torch, x, counts)
                full = ops.delta_spmm_experts(xz, d0)
                part = ops.delta_spmm_experts(xz, d0, counts)
                if not torch.equal(full.view(torch.int32), part.view(torch.int32)):
                    fail(f"[moe] delta_spmm_experts {site} T={T} C={C}: the {name} "
                         f"counts layout is not bit-equal to all-C")
            xr = _zero_past(torch, x, routed)
            live, read = int(routed.sum().item()), int((routed > 0).sum().item())
            counts_ms = time_ms(torch, [lambda d=d: ops.delta_spmm_experts(xr, d, routed)
                                        for d in ring])
            full_ms = time_ms(torch, [lambda d=d: ops.delta_spmm_experts(xr, d)
                                      for d in ring])
            takes = "counts" if ops.expert_counts_pay(T * K, E, C) else "all-C"
            ms = counts_ms if takes == "counts" else full_ms
            seg_r, offs_r = ops.expert_segments(E, C, routed, DEVICE)
            plain = time_ms(torch, [lambda: _plain_segments(
                torch, fb, xr.reshape(E * C, h_in), d0, seg_r, offs_r)], iters=2, reps=3,
                eager=True)
            dense = reconstruct_dense(d0)                 # [E, h_in, h_out] f32
            lib_y = torch.bmm(xr, dense)
            if not torch.allclose(lib_y, ops.delta_spmm_experts(xr, d0, routed),
                                  **KERNEL_TOL):
                fail(f"[moe] {site} T={T} C={C}: torch.bmm on the dense stack disagrees "
                     f"with the kernel")
            lib = time_ms(torch, [lambda: torch.bmm(xr, dense)])
            del dense, lib_y
            torch.cuda.empty_cache()
            b_ms, b_by = rl.bound_ms(*rl.experts_work(d0.index(0), live, read, E, C))
            t = {"kernel": "delta_spmm_segments", "layout": "experts", "site": f"moe/{site}",
                 "h_in": h_in, "h_out": h_out, "T": E * C, "C": C, "E": E,
                 "routed_tokens": T, "live_rows": live, "experts_read": read,
                 "tb": ops.row_tile(C), "ops_layout": takes, "ms": ms,
                 "counts_ms": counts_ms, "all_c_ms": full_ms, "plain_ms": plain,
                 "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                 "all_experts_bound_ms": rl.bound_ms(*rl.experts_work(
                     d0.index(0), E * C, E, E, C))[0]}
            log(f"[moe] {cfg.name} delta_spmm_experts moe/{site} ({h_in} x {h_out}) T={T:3d} "
                f"C={C:2d} "
                f"({live} live rows, {read} of {E} experts read): counts layout "
                f"{counts_ms:.4f} ms, all {E * C} rows {full_ms:.4f} ms, ops takes {takes} "
                f"(T*K/(E*C) = {T * K / (E * C):.3f}); plain {plain:.4f} ms, library "
                f"(torch.bmm, dense f32 stack) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"all experts {t['all_experts_bound_ms']:.4f} ms); row tile {t['tb']}; "
                f"within {KERNEL_TOL} of plain (err {err:.3e}), counts bit-equal to all-C")
            rows.append(t)
        del ring
    return rows, worst


def _moe_attention_times(torch, ops, fb, cfg, fleet, gen) -> list:
    """delta_spmm at the config's attention sites wq and wo (qwen3: 2048 x
    4096 and 4096 x 2048; llama4-scout: 5120 x 5120 both), at the shapes
    Engine.generate gives it (T=2 decode, T=128 prefill): held to the
    plain version, timed on a ring of MOE_RING layer slices against its
    bound and torch.matmul on the dense delta."""
    from repro_torch.core.pack import reconstruct_dense
    out = []
    for site in ("wq", "wo"):
        leaves = [deltas["attn"][site] for _, deltas, _ in fleet]
        ring = [leaves[i % len(leaves)].index((i // len(leaves)) % cfg.n_layers)
                for i in range(MOE_RING)]
        for T in (2, 128):
            x = torch.randn((T, ring[0].h_in), generator=gen, device=DEVICE)
            got, want = ops.delta_spmm(x, ring[0]), fb.correction(x, ring[0])
            if not torch.allclose(got, want, **KERNEL_TOL):
                fail(f"[moe] delta_spmm attn/{site} T={T}: "
                     f"{(got - want).abs().max().item():.3e} from the plain version")
        dense = [reconstruct_dense(d) for d in ring]
        for T in (2, 128):
            t = _time_spmm(torch, ops, fb, ring, dense, gen, f"attn/{site}", T, None)
            t["arch"] = cfg.name
            out.append(t)
        del dense, ring
    torch.cuda.empty_cache()
    return out


def _moe_dense_sites(cfg) -> int:
    """delta_spmm sites of a MoE layer: attention's four and, with a
    shared expert, its GLU's three (the routed experts take the expert
    route)."""
    return 4 + (3 if cfg.moe.shared_expert else 0)


def _expert_notes_ok(notes: list, where: str) -> int:
    """The expert sites' notes of a run on the card: every one the kernel
    route, none a plain formulation or the out-of-envelope branch.
    -> the number of expert-route notes."""
    plain = [n for n in notes if n.get("formulation") in (
        "experts-torch", "experts-dense", "plain-out-of-envelope", "segments-torch",
        "torch-gather", "torch-dense")]
    if plain:
        fail(f"[moe] {where}: a plain formulation ran on the card: {plain}")
    experts = [n for n in notes if n["site"] == "delta_spmm_experts"]
    if not experts or any(n["formulation"] != "experts-cuda" for n in experts):
        fail(f"[moe] {where}: expert sites took {experts}")
    return len(experts)


def _moe_logits(torch, lm, ops, cfg, base, deltas) -> dict:
    """Tenant0's first-token logits on one 64-token prompt through the
    kernels, against the same tenant with the plain expert correction
    (``ops.delta_spmm_experts`` replaced by the dense reconstruction and
    a batched product), within MOE_LOGIT_REL_TOL of max|logit|; a control
    (the kernels with MOE_CONTROL_EXPERT's correction zeroed) must exceed
    that bound; and the gap to the base."""
    import numpy as np
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.serve.trace import attribution
    tok = torch.as_tensor(np.random.default_rng(18).integers(0, cfg.vocab, (1, 64)),
                          dtype=torch.int64, device=DEVICE)

    def first(d):
        cache = lm.init_cache(cfg, 1, 64, device=DEVICE)
        return lm.prefill(cfg, base, {"tokens": tok}, cache, deltas=d)[0][0]

    with attribution() as notes:
        got = first(deltas)
    _expert_notes_ok(notes, "model-level logits")
    real = ops.delta_spmm_experts

    def one_expert_zeroed(x, d, counts=None):
        y = real(x, d, counts)
        y[MOE_CONTROL_EXPERT] = 0.0
        return y

    runs = {}
    for name, route in (("plain", lambda x, d, counts=None: torch.matmul(
            x, reconstruct_dense(d))), ("control", one_expert_zeroed)):
        ops.delta_spmm_experts = route
        try:
            runs[name] = first(deltas)
        finally:
            ops.delta_spmm_experts = real
    want = runs["plain"]
    base_lg = first(None)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ctl = (runs["control"] - want).abs().max().item()
    gap = (want - base_lg).abs().max().item()
    log(f"[moe] {cfg.name} tenant0 first-token logits, kernels vs the plain expert "
        f"correction: "
        f"max|diff| {err:.4e}, max|logit| {scale:.3e} (rel {err / scale:.3e}, bound "
        f"{MOE_LOGIT_REL_TOL}); control with expert {MOE_CONTROL_EXPERT}'s correction "
        f"zeroed: max|diff| {ctl:.4e} (rel {ctl / scale:.3e}, must exceed the bound); "
        f"tenant-vs-base gap {gap:.3e}; argmax {int(got.argmax())} vs {int(want.argmax())}")
    if not err <= MOE_LOGIT_REL_TOL * scale or not err < 0.1 * gap:
        fail("[moe] the kernels' logits differ from the plain expert correction's")
    if not ctl > MOE_LOGIT_REL_TOL * scale:
        fail("[moe] the logit bound does not see one expert's correction missing")
    return {"max_abs": err, "rel": err / scale, "control_rel": ctl / scale, "gap": gap,
            "bound_rel": MOE_LOGIT_REL_TOL}


def _moe_grouped(torch, kern, cfg, base, fleet) -> dict:
    """Engine.generate, B=2 prompts of 64 tokens and 16 new, for the base
    and each tenant at cf 1.25 (counts read just after); then
    Engine.serve_batch on the same requests, which falls back to
    per-tenant grouping and must equal generate token for token."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine
    from repro_torch.serve.trace import attribution
    B, S, NEW = 2, 64, 16
    L = cfg.n_layers
    eng = Engine(cfg, base, max_seq=96)
    for name, d, rep in fleet:
        eng.register_tenant(name, d, rep)
    names = [None] + [n for n, _, _ in fleet]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    outputs, walls = {}, {}
    torch.cuda.synchronize()
    kern.reset_launches()
    with attribution() as notes:
        for name in names:
            lg = []
            t0 = time.perf_counter()
            outputs[name] = eng.generate(name, prompts, max_new_tokens=NEW, logits_out=lg)
            torch.cuda.synchronize()
            walls[str(name)] = time.perf_counter() - t0
            if outputs[name].shape != (B, NEW) or not all(bool(torch.isfinite(x).all())
                                                          for x in lg):
                fail(f"[moe] generate {name}: shape {outputs[name].shape} or non-finite")
    launches, routes = dict(kern.LAUNCHES), dict(kern.ROUTES)
    n_notes = _expert_notes_ok(notes, "Engine.generate")
    n_t, dense = len(fleet), _moe_dense_sites(cfg)
    want = {"delta_spmm": n_t * NEW * dense * L, "delta_spmm_segments": n_t * NEW * 3 * L,
            "fused_base_delta": 0, "dequant": 0}
    want_routes = _spmm_routes(ops, kern, fleet[0][1], {B * S: 1, B: NEW - 1}, times=n_t)
    if sum(want_routes.values()) != n_t * NEW * dense * L:
        fail(f"[moe] {want_routes}: not {dense} dense sites x {L} layers")
    log(f"[moe] {cfg.name} Engine.generate base + {n_t} tenants, B={B} S={S} new={NEW}, cf "
        f"{cfg.moe.capacity_factor}: {sum(walls.values()):.2f} s ({walls}); "
        f"{B * NEW / walls[str(names[1])]:.1f} tokens per wall s a tenant; launches "
        f"{launches}, routes {routes} (expected {want}, {want_routes}: {dense} attention "
        f"and shared-expert sites and 3 expert sites x {L} layers x {NEW} calls x {n_t} "
        f"tenants); expert sites noted {n_notes} distinct calls, all experts-cuda")
    if launches != want or routes != want_routes:
        fail(f"[moe] generate launches {launches} routes {routes}, expected {want} "
             f"{want_routes}")
    for name in names[1:]:
        if np.array_equal(outputs[name], outputs[None]):
            fail(f"[moe] {name} generated the base model's tokens")
    # serve_batch: expert deltas cannot slot-dispatch, so it falls back to
    # per-tenant grouping: the same generate calls, the same launches
    reqs = [(name, prompts[i]) for name in names for i in range(B)]
    kern.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve_batch(reqs, max_new_tokens=NEW)
    torch.cuda.synchronize()
    sb_wall = time.perf_counter() - t0
    sb_launches = dict(kern.LAUNCHES)
    bad = [(name, i) for (name, _), i, o in zip(reqs, [i for _ in names for i in range(B)],
                                                outs)
           if not np.array_equal(o, outputs[name][i])]
    log(f"[moe] Engine.serve_batch ({len(reqs)} requests with expert deltas): falls back "
        f"to per-tenant grouping, {sb_wall:.2f} s; launches {sb_launches}; equal to "
        f"generate token for token: {len(reqs) - len(bad)}/{len(reqs)}")
    if bad or sb_launches != want:
        fail(f"[moe] serve_batch differs from generate: {bad}, launches {sb_launches}")
    # one eager decode step (B=2), base vs tenant0, as a caller sees it
    from repro_torch.models import lm
    steps = {}
    tok = torch.as_tensor(prompts, dtype=torch.int64, device=DEVICE)
    for name in names[:2]:
        d = eng.store.get(name).deltas if name else None
        cache = lm.init_cache(cfg, B, 96, device=DEVICE)
        lm.prefill(cfg, base, {"tokens": tok}, cache, deltas=d)
        nxt = torch.as_tensor(outputs[name][:, :1], dtype=torch.int64, device=DEVICE)
        steps[str(name)] = time_ms(torch, [lambda: lm.decode_step(
            cfg, base, cache, nxt, S, deltas=d)], iters=5, reps=3, eager=True)
        del cache
    log(f"[moe] decode step B={B} (eager, host enqueue included): base "
        f"{steps['None']:.2f} ms, tenant0 {steps[str(names[1])]:.2f} ms")
    return {"launches": launches, "routes": routes, "wall_s": walls,
            "serve_batch": {"wall_s": sb_wall, "launches": sb_launches, "equal": len(reqs)},
            "decode_step_ms": steps,
            "tokens": {str(k): v.tolist() for k, v in outputs.items()}}


def _moe_stream_run(torch, kern, cfg, base, fleet, stream, cf: float) -> tuple:
    """ContinuousEngine(n_slots=8, max_seq=256) at capacity factor ``cf``
    on ``stream`` (launch counts and the envelope checked), each tenant
    with its routed experts' deltas left out (a shared expert's stay: its
    sites are dense sites); then each tenant's requests alone through the
    same engine. -> (the mixed run, the requests whose tokens differ from
    serving alone)."""
    from repro_torch.serve import ContinuousEngine, VirtualClock
    ccfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    names = [None] + [n for n, _, _ in fleet]
    sites = _moe_dense_sites(cfg) * cfg.n_layers
    ce = ContinuousEngine(ccfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                          clock=VirtualClock(tick=ENGINE_TICK))
    for name, d, rep in fleet:
        ce.register_tenant(name, dict(d, moe=dict(d["moe"], wi=None, wg=None, wo=None)), rep)
    mixed = _engine_run(torch, kern, ce, stream, list(range(len(stream))),
                        f"[moe] mixed, cf {cf}")
    want = {"delta_spmm": sites * len(stream),
            "delta_spmm_segments": sites * mixed["decode_steps"],
            "fused_base_delta": 0, "dequant": 0}
    if mixed["launches"] != want:
        fail(f"[moe] continuous cf {cf} launches {mixed['launches']}, expected {want}")
    edge = [p for p in mixed["report"]["decode_paths"] or {} if "out-of-envelope" in p]
    if edge:
        fail(f"[moe] continuous steps took the out-of-envelope branch: {edge}")
    bad = []
    for name in names:
        ce.reset_metrics()
        idx = [i for i, (t, _, _) in enumerate(stream) if t == name]
        run = _engine_run(torch, kern, ce, stream, idx, f"[moe] alone {name or 'base'}, cf {cf}")
        for i in idx:
            j = _first_mismatch(run["tokens"][i], mixed["tokens"][i])
            if j is not None:
                bad.append({"request": i, "tenant": name, "step": j})
    del ce
    gc.collect()
    torch.cuda.empty_cache()
    return mixed, bad


def _moe_continuous(torch, kern, cfg, base, fleet) -> dict:
    """The continuous engine on the [engine] stream's prompts round-robin
    over {base, tenants} (no routed experts' deltas: slot dispatch refuses
    them) at cf = E / K, where mixed must equal each tenant alone token
    for token; then at MOE_CF_DROPS, where capacity drops depend on the
    batch, the requests that differ are counted."""
    names = [None] + [n for n, _, _ in fleet]
    stream = _engine_stream(cfg, tuple(names))
    cf = cfg.moe.n_experts / cfg.moe.top_k
    mixed, bad = _moe_stream_run(torch, kern, cfg, base, fleet, stream, cf)
    log(f"[moe] continuous: mixed == alone, token for token: "
        f"{len(stream) - len(bad)}/{len(stream)} requests" + (f"; differ: {bad}" if bad
                                                              else ""))
    if bad:
        fail(f"[moe] mixed serving differs from serving alone: {bad}")
    log(f"[moe] continuous, cf {cf}: {mixed['decode_steps']} decode "
        f"steps of {mixed['ms_per_step']:.1f} ms, {mixed['tokens_per_s']:.1f} tokens per "
        f"wall s ({mixed['wall_s']:.2f} s for {len(stream)} requests); launches "
        f"{mixed['launches']}")
    drops, differ = _moe_stream_run(torch, kern, cfg, base, fleet, stream, MOE_CF_DROPS)
    log(f"[moe] continuous, cf {MOE_CF_DROPS} (capacity drops depend on the batch; "
        f"counted, not checked): mixed == alone in full for "
        f"{len(stream) - len(differ)}/{len(stream)} requests; differ: {differ}; "
        f"{drops['decode_steps']} decode steps of {drops['ms_per_step']:.1f} ms")
    keys = ("wall_s", "decode_steps", "ms_per_step", "tokens_per_s", "launches")
    return {k: mixed[k] for k in keys} | {
        "capacity_factor": cf,
        "drops": {k: drops[k] for k in keys} | {"capacity_factor": MOE_CF_DROPS,
                                               "requests": len(stream), "differ": differ}}


def _moe_config(torch, kern, arch: str, report: dict) -> dict:
    """One MoE config at full width and ARCH_DEPTH's depth, random init
    from seed 0, MOE_TENANTS tenants at 128x compressed on the card one
    matrix at a time: the dry run's bytes, the expert route's kernels, the
    attention sites, a tenant's logits against the plain expert
    correction, grouped serving (Engine.generate, serve_batch's fallback)
    and the continuous engine without the routed experts' deltas. The
    config's objects are freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.utils import tree_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = _at_depth(get_config(arch))
    m = cfg.moe
    base = lm.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    fleet = synth_tenants(cfg, base, MOE_TENANTS, RATIO_SPECS[128], seed=0)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    mem = {"params_gb": tree_bytes(base) / 1e9,
           "tenant_gb": [tree_bytes(d) / 1e9 for _, d, _ in fleet],
           "after_init_gb": torch.cuda.memory_allocated() / 1e9}
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv}, {m.n_experts} experts top-{m.top_k}"
        f"{' + a shared expert' if m.shared_expert else ''}, d_expert {m.d_expert}, vocab "
        f"{cfg.vocab}; {mem['params_gb']:.2f} GB params, init {t_init:.1f} s; {MOE_TENANTS} "
        f"tenants {[round(g, 3) for g in mem['tenant_gb']]} GB packed "
        f"({fleet[0][2].summary()}), synthesized and compressed in {t_comp:.1f} s; "
        f"{mem['after_init_gb']:.2f} GB allocated")
    report["dryrun"][arch] = _dryrun_bytes("[moe]", cfg, base, fleet, RATIO_SPECS[128])
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(18)
    out = {"n_layers": cfg.n_layers, "init_s": t_init, "compress_s": t_comp}
    out["kernels"], worst = _moe_kernels(torch, ops, fb, cfg, fleet, gen)
    out["attention_times"] = _moe_attention_times(torch, ops, fb, cfg, fleet, gen)
    out["logits"] = _moe_logits(torch, lm, ops, cfg, base, fleet[0][1])
    out["grouped"] = _moe_grouped(torch, kern, cfg, base, fleet)
    out["continuous"] = _moe_continuous(torch, kern, cfg, base, fleet)
    mem["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["memory"] = mem
    out["wall_s"] = time.perf_counter() - t_phase
    out["worst"] = worst
    log(f"[moe] {cfg.name} memory: params {mem['params_gb']:.2f} GB, tenants "
        f"{sum(mem['tenant_gb']):.3f} GB, peak {mem['peak_gb']:.2f} GB; "
        f"{out['wall_s']:.1f} s")
    del fleet, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(torch, kern, report: dict) -> dict:
    """qwen3-moe-30b-a3b at full width and 8 of its 48 layers (128
    experts top-8), then llama4-scout-17b-a16e at full width and 8 of its
    48 layers (16 experts top-1 and a shared expert), each freed before
    the next (:func:`_moe_config`). -> launches by path."""
    report["moe"] = {}
    by_path = {}
    for arch in MOE_ARCHS:
        out = report["moe"][arch] = _moe_config(torch, kern, arch, report)
        by_path.update({f"moe:{arch}:generate": out["grouped"]["launches"],
                        f"moe:{arch}:serve_batch": out["grouped"]["serve_batch"]["launches"],
                        f"moe:{arch}:continuous": out["continuous"]["launches"]})
    return by_path


def _leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _family_sites(cfg, deltas) -> tuple:
    """Corrections a token runs through with ``deltas``: (at decode, at
    prefill), counting the compressed leaves of each block. An attn layer
    runs its attention's and its MLP's, an ssm layer its mixer's, a rec
    layer its mixer's and its MLP's; a vlm cross block wq, wo and its MLP's
    at decode, wk, wv too at prefill; an encdec decoder layer's cross
    block wq, wo (wk, wv at prefill) and, at prefill, the encoder's."""
    def n(stack, names):
        node = deltas
        for k in stack.split("/"):
            node = node.get(k) if isinstance(node, dict) else None
        return sum(isinstance(node, dict) and node.get(k) is not None for k in names)

    qkvo = ("wq", "wk", "wv", "wo")
    mlp = n("mlp", ("wi", "wg", "wo"))
    per = {"attn": n("attn", qkvo) + mlp, "ssm": n("ssm", ("wz", "wx", "wbc", "wdt", "wout")),
           "rec": n("rec", ("linear_x", "linear_y", "linear_out")) + mlp}
    dec = pre = sum(per[k] for k in cfg.layer_kinds)
    if cfg.family == "vlm":
        nc = len(range(cfg.cross_attn_every - 1, cfg.n_layers, cfg.cross_attn_every))
        q_o, k_v = n("cross", ("wq", "wo")), n("cross", ("wk", "wv"))
        dec, pre = dec + nc * (q_o + mlp), pre + nc * (q_o + k_v + mlp)
    if cfg.family == "encdec":
        q_o, k_v = n("dec_cross", ("wq", "wo")), n("dec_cross", ("wk", "wv"))
        enc = n("enc/attn", qkvo) + n("enc/mlp", ("wi", "wg", "wo"))
        dec = dec + cfg.n_layers * q_o
        pre = pre + cfg.n_layers * (q_o + k_v) + cfg.n_enc_layers * enc
    return dec, pre


def _family_kernels(torch, ops, fb, cfg, fleet, gen, recurrent: bool) -> tuple:
    """Both serving kernels at the config's sites new to them (delta_spmm
    at FAMILY_KERNEL_T and a memory-side site's T; for the recurrent
    configs, whose continuous engine runs it, the segments kernel at the
    mixed decode layout and the chunk layout), held to their plain
    versions and timed against their bound and torch.matmul on the dense
    delta. -> (times, worst error by kernel)."""
    import numpy as np
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.core.pack import reconstruct_dense
    from repro_torch.serve.scheduler import tenant_segments
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0}
    times = []
    mem_T = FAMILY_B * (FAMILY_ENC_LEN if cfg.family == "encdec" else cfg.n_frontend_tokens)
    for path, extra in FAMILY_SITES[cfg.name]:
        leaves = [_leaf(deltas, path) for _, deltas, _ in fleet]
        n_l = leaves[0].stack_shape()[0]
        d0 = leaves[0].index(0)
        Ts = FAMILY_KERNEL_T + ((mem_T,) if extra == "memory" else ())
        for T in Ts:
            x = torch.randn((T, d0.h_in), generator=gen, device=DEVICE)
            got, want = ops.delta_spmm(x, d0), fb.correction(x, d0)
            err = (got - want).abs().max().item()
            worst["delta_spmm"] = max(worst["delta_spmm"], err)
            if not torch.allclose(got, want, **KERNEL_TOL):
                fail(f"[families] {cfg.name} {path} delta_spmm T={T}: {err:.3e} from the "
                     f"plain version")
        if recurrent:
            stack = stack_tenant_deltas([{"w": leaves[t].index(layer)} for t, layer in
                                         ((0, 0), (1, 0), (2, 0), (0, 1 % n_l))])["w"]
            seg = tenant_segments(np.asarray(MIXED_SLOT_ROWS, np.int32)).to(DEVICE)
            for T, layout in ((len(MIXED_SLOT_ROWS), "mixed"), (ENGINE_CHUNK, "chunk")):
                x = torch.randn((T, d0.h_in), generator=gen, device=DEVICE)
                if layout == "chunk":
                    xs, (sr, so) = x, _chunk_segments(T)
                else:
                    xs, sr, so = x.index_select(0, seg.order), seg.seg_rows, seg.seg_offsets
                got = ops.delta_spmm_segments(xs, stack, sr, so)
                want = _plain_segments(torch, fb, xs, stack, sr, so)
                err = (got - want).abs().max().item()
                worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"], err)
                if not torch.allclose(got, want, **KERNEL_TOL):
                    fail(f"[families] {cfg.name} {path} segments {layout} T={T}: {err:.3e} "
                         f"from the plain version")
            del stack
        ring = [leaves[i % 3].index((i // 3) % n_l) for i in range(8)]
        dense = [reconstruct_dense(d) for d in ring]
        for T in (8, 128) + ((mem_T,) if extra == "memory" else ()):
            times.append(_time_spmm(torch, ops, fb, ring, dense, gen, path, T, None))
        del dense
        if recurrent:
            times.append(_time_segments(torch, ops, fb, ring, gen, path, "mixed", 8))
        del ring
        log(f"[families] {cfg.name} {path} ({d0.h_in} x {d0.h_out}, h_g {d0.h_g}, keep "
            f"{d0.keep}): delta_spmm within {KERNEL_TOL} of its plain version at T={Ts}"
            + (", the segments kernel at the mixed and chunk layouts" if recurrent else ""))
    for t in times:
        t["arch"] = cfg.name
    torch.cuda.empty_cache()
    return times, worst


def _family_logits(torch, lm, ops, fb, cfg, base, deltas, extra) -> dict:
    """Tenant0's first-token logits on one FAMILY_S-token prompt through
    the kernels against the same tenant with the plain correction
    (``ops.delta_spmm`` replaced by ``fallback.correction_nd``), within
    FAMILY_LOGIT_REL_TOL of max|logit|; a control (the kernels, with the
    FAMILY_CONTROL site's correction dropped in every layer) must exceed
    that bound; and the gap to the base. seamless runs on an f32 copy of
    its weights (FAMILY_LOGIT_REL_TOL)."""
    import numpy as np
    if cfg.family == "encdec":     # an f32 copy: see FAMILY_LOGIT_REL_TOL
        from repro_torch.utils import map_with_paths
        cfg = cfg.replace(param_dtype="float32")
        base = map_with_paths(lambda _p, w: w.float(), base)
    tok = torch.as_tensor(np.random.default_rng(18).integers(0, cfg.vocab, (1, FAMILY_S)),
                          dtype=torch.int64, device=DEVICE)
    batch = {"tokens": tok, **{k: v[:1] for k, v in extra.items()}}
    enc_len = extra["enc_feats"].shape[1] if "enc_feats" in extra else 0

    def first(d):
        cache = lm.init_cache(cfg, 1, FAMILY_S + 8, enc_len, device=DEVICE)
        return lm.prefill(cfg, base, batch, cache, deltas=d)[0][0]

    got = first(deltas)
    real = ops.delta_spmm
    ops.delta_spmm = lambda x, d: fb.correction_nd(x.to(torch.float32), d)
    try:
        want = first(deltas)
    finally:
        ops.delta_spmm = real
    site = FAMILY_CONTROL[cfg.name]
    ctl_deltas = dict(deltas)
    node, *rest = site.split("/")
    sub = ctl_deltas[node] = dict(deltas[node])
    for k in rest[:-1]:
        sub[k] = dict(sub[k])
        sub = sub[k]
    sub[rest[-1]] = None
    ctl = (first(ctl_deltas) - want).abs().max().item()
    base_lg = first(None)
    tol = FAMILY_LOGIT_REL_TOL
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    gap = (want - base_lg).abs().max().item()
    log(f"[families] {cfg.name} tenant0 first-token logits, kernels vs the plain "
        f"correction: max|diff| {err:.4e}, max|logit| {scale:.3e} (rel {err / scale:.3e}, "
        f"bound {tol}); control without {site}'s correction: max|diff| {ctl:.4e} (rel "
        f"{ctl / scale:.3e}, must exceed the bound); tenant-vs-base gap {gap:.3e}; argmax "
        f"{int(got.argmax())} vs {int(want.argmax())}")
    if not err <= tol * scale or not err < 0.1 * gap:
        fail(f"[families] {cfg.name}: the kernels' logits differ from the plain correction's")
    if not ctl > tol * scale:
        fail(f"[families] {cfg.name}: the logit bound does not see {site}'s correction missing")
    return {"max_abs": err, "rel": err / scale, "control_site": site,
            "control_rel": ctl / scale, "gap": gap, "bound_rel": tol}


def _family_fleet(cfg, base, synth_tenants, spec) -> tuple:
    """3 tenants of ``cfg`` at ``spec`` from ``synth_tenants``, with the
    compressible leaves whose h_in no group size of the spec divides left
    out of the compression and None in the trees. -> (fleet, their paths)."""
    from repro_torch.core.codecs import _pick_hg
    from repro_torch.core.compress import is_compressible
    from repro_torch.utils import iter_leaves
    dropped = []
    for path, leaf in iter_leaves(base):
        if is_compressible(path, leaf):
            try:
                _pick_hg(leaf.shape[-2], spec)
            except ValueError:
                dropped.append(path)

    def prune(tree, prefix=""):
        return {k: prune(v, f"{prefix}{k}/") if isinstance(v, dict) else v
                for k, v in tree.items() if f"{prefix}{k}" not in dropped}

    fleet = synth_tenants(cfg, prune(base), 3, spec, seed=0)
    for _, deltas, _ in fleet:
        for path in dropped:
            *parents, name = path.split("/")
            node = deltas
            for k in parents:
                node = node[k]
            node[name] = None
    return fleet, dropped


def _family_extra(torch, cfg) -> dict:
    """The cross blocks' inputs for FAMILY_B rows, from a seeded generator."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(FAMILY_SEED)
    if cfg.family == "encdec":
        return {"enc_feats": torch.randn((FAMILY_B, FAMILY_ENC_LEN, cfg.d_model),
                                         generator=gen, device=DEVICE)}
    if cfg.family == "vlm":
        return {"image_embeds": torch.randn((FAMILY_B, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=gen, device=DEVICE)}
    return {}


def _family_generate(torch, kern, cfg, base, fleet, extra) -> dict:
    """Engine.generate, FAMILY_B prompts of FAMILY_S tokens and FAMILY_NEW
    new, with the frontend inputs, for the base and each tenant (counts
    read just after: one prefill and FAMILY_NEW - 1 decode steps a
    tenant); every tenant's tokens differ from the base's; the continuous
    engine refuses the config with the reference's error."""
    import numpy as np
    from repro_torch.serve import ContinuousEngine, Engine
    eng = Engine(cfg, base, max_seq=FAMILY_S + FAMILY_NEW)
    for name, d, rep in fleet:
        eng.register_tenant(name, d, rep)
    names = [None] + [n for n, _, _ in fleet]
    prompts = np.random.default_rng(FAMILY_SEED).integers(
        0, cfg.vocab, (FAMILY_B, FAMILY_S)).astype(np.int32)
    outputs, walls = {}, {}
    torch.cuda.synchronize()
    kern.reset_launches()
    for name in names:
        lg = []
        t0 = time.perf_counter()
        outputs[name] = eng.generate(name, prompts, max_new_tokens=FAMILY_NEW,
                                     extra_inputs=extra, logits_out=lg)
        torch.cuda.synchronize()
        walls[str(name)] = time.perf_counter() - t0
        if outputs[name].shape != (FAMILY_B, FAMILY_NEW) or not all(
                bool(torch.isfinite(x).all()) for x in lg):
            fail(f"[families] {cfg.name} generate {name}: shape {outputs[name].shape} or "
                 f"non-finite logits")
    launches, routes = dict(kern.LAUNCHES), dict(kern.ROUTES)
    dec, pre = _family_sites(cfg, fleet[0][1])
    n_t = len(fleet)
    want = {"delta_spmm": n_t * (pre + (FAMILY_NEW - 1) * dec), "delta_spmm_segments": 0,
            "fused_base_delta": 0, "dequant": 0}
    log(f"[families] {cfg.name} Engine.generate base + {n_t} tenants, B={FAMILY_B} "
        f"S={FAMILY_S} new={FAMILY_NEW}, inputs {[tuple(v.shape) for v in extra.values()]}: "
        f"{sum(walls.values()):.2f} s ({walls}); {FAMILY_B * FAMILY_NEW / walls[names[1]]:.1f} "
        f"tokens per wall s a tenant; launches {launches}, routes {routes} (expected {want}: "
        f"{pre} sites at prefill, {dec} at decode)")
    if launches != want:
        fail(f"[families] {cfg.name} generate launches {launches}, expected {want}")
    for name in names[1:]:
        if np.array_equal(outputs[name], outputs[None]):
            fail(f"[families] {cfg.name} {name} generated the base model's tokens")
    try:
        ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ)
    except ValueError as e:
        if "continuous batching does not support" not in str(e):
            fail(f"[families] {cfg.name}: the continuous engine refused with {e}")
        refusal = str(e)
    else:
        fail(f"[families] {cfg.name}: the continuous engine did not refuse the config")
    log(f"[families] {cfg.name} ContinuousEngine refuses: {refusal}")
    return {"launches": launches, "routes": routes, "wall_s": walls, "refusal": refusal,
            "tokens": {str(k): v.tolist() for k, v in outputs.items()}}


def _family_engine(torch, kern, lm, cfg, base, fleet) -> tuple:
    """The [engine] stream through ContinuousEngine(n_slots=8, max_seq=256)
    whole-prompt and chunked (ENGINE_CHUNK, exact tail chunks): mixed ==
    alone in both modes; whole-prompt == Engine.generate (B=1) on every
    request by the tie rule; the requests whose chunked tokens differ from
    the whole-prompt engine's are counted (the conv rings are stored in
    bf16 between chunks and the SSD chunk length changes with the chunk).
    -> (the row, launches by mode)."""
    from repro_torch.serve import Engine
    stream = _engine_stream(cfg)
    ref = Engine(cfg, base, max_seq=ENGINE_MAX_SEQ)
    for name, d, rep in fleet:
        ref.register_tenant(name, d, rep)
    dec, _ = _family_sites(cfg, fleet[0][1])
    row, by_mode, runs = {}, {}, {}
    for chunked in (False, True):
        mode = "chunked" if chunked else "whole"
        run = _arch_engine(torch, kern, cfg, base, ref, stream, ENGINE_MAX_SEQ, ENGINE_CHUNK,
                           chunked, f"{cfg.name} {mode}", sites=dec)
        runs[mode] = run
        by_mode[mode] = run["launches"]
        row[mode] = {k: run[k] for k in ("wall_s", "decode_steps", "ms_per_step",
                                         "tokens_per_s", "launches")}
    rows = _arch_generate(torch, ref, stream, runs["whole"], range(len(stream)), cfg.name)
    row["generate"] = rows
    row["generate_equal"] = sum(r["first_mismatch"] is None for r in rows)
    differ = [i for i in range(len(stream)) if _first_mismatch(
        runs["chunked"]["tokens"][i], runs["whole"]["tokens"][i]) is not None]
    row["chunked_vs_whole_differ"] = differ
    log(f"[families] {cfg.name}: chunked (chunk {ENGINE_CHUNK}) vs whole-prompt engine: "
        f"{len(stream) - len(differ)}/{len(stream)} requests equal in full; differ: {differ}")
    row["stream"] = {"prompt_lengths": [len(p) for _, p, _ in stream],
                     "max_seq": ENGINE_MAX_SEQ, "chunk": ENGINE_CHUNK}
    del ref
    return row, by_mode


def phase_families(torch, kern, report: dict) -> tuple:
    """mamba2-370m, recurrentgemma-9b, seamless-m4t-medium and
    llama-3.2-vision-11b at full width, at the depths ARCH_DEPTH cuts them
    to, one after the other
    (each freed before the next): random init from seed 0 (the vlm's cross
    gates set to VLM_GATE), 3 tenants at the 128x spec compressed on the
    card, the correction kernels at each config's new sites, tenant0's
    logits against the plain correction; the recurrent configs through the
    continuous engine (whole-prompt and chunked), the cross-attention
    configs through Engine.generate with their frontend inputs.
    -> (launches by path, worst error by kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.utils import tree_bytes

    out, by_path = {}, {}
    worst = {"delta_spmm": 0.0, "delta_spmm_segments": 0.0}
    for arch in FAMILY_SITES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        cfg = _at_depth(get_config(arch))
        base = lm.init_params(cfg, 0, device=DEVICE)
        if cfg.family == "vlm":
            base["cross"]["gate_attn"].fill_(VLM_GATE)
            base["cross"]["gate_mlp"].fill_(VLM_GATE)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t_arch
        t0 = time.perf_counter()
        fleet, dropped = _family_fleet(cfg, base, synth_tenants, RATIO_SPECS[128])
        torch.cuda.synchronize()
        t_comp = time.perf_counter() - t0
        report["dryrun"][arch] = _dryrun_bytes("[families]", cfg, base, fleet,
                                               RATIO_SPECS[128], dropped)
        mem = {"params_gb": tree_bytes(base) / 1e9,
               "tenants_gb": [tree_bytes(d) / 1e9 for _, d, _ in fleet]}
        if dropped:
            log(f"[families] {arch}: {dropped} pass the reference's compressible rule, but no "
                f"group size of the 128x spec divides their h_in: the reference's compress "
                f"raises on a full-depth tenant, as the port's does; the block never applies "
                f"them, so the tenants are compressed without them")
        log(f"[families] {arch} ({cfg.family}): {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab}; {mem['params_gb']:.2f} GB params, init "
            f"{t_init:.1f} s; 3 tenants {[round(g, 3) for g in mem['tenants_gb']]} GB packed "
            f"({fleet[0][2].summary()}), synthesized and compressed in {t_comp:.1f} s")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(41)
        recurrent = cfg.family in ("ssm", "hybrid")
        row = {"family": cfg.family, "memory": mem, "init_s": t_init, "compress_s": t_comp}
        row["times"], w = _family_kernels(torch, ops, fb, cfg, fleet, gen, recurrent)
        for k, v in w.items():
            worst[k] = max(worst[k], v)
        extra = _family_extra(torch, cfg)
        row["logits"] = _family_logits(torch, lm, ops, fb, cfg, base, fleet[0][1], extra)
        mem0 = torch.cuda.memory_allocated()
        if recurrent:
            eng_row, by_mode = _family_engine(torch, kern, lm, cfg, base, fleet)
            row.update(eng_row)
            for mode, launches in by_mode.items():
                by_path[f"families:{arch}:{mode}"] = launches
        else:
            row["generate"] = _family_generate(torch, kern, cfg, base, fleet, extra)
            by_path[f"families:{arch}:generate"] = row["generate"]["launches"]
        mem.update(engine_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        row["wall_s"] = time.perf_counter() - t_arch
        log(f"[families] {arch} memory: params {mem['params_gb']:.2f} GB, tenants "
            f"{sum(mem['tenants_gb']):.3f} GB, serving up to {mem['engine_gb']:.2f} GB more, "
            f"peak {mem['peak_gb']:.2f} GB; {row['wall_s']:.1f} s")
        out[arch] = row
        del fleet, base, extra
    gc.collect()
    torch.cuda.empty_cache()
    report["families"] = out
    return by_path, worst


def _bits_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8), b.detach().reshape(-1).view(torch.uint8))


def _train_full(torch) -> dict:
    """llama3.2-1b at published width and depth through the training
    launcher: per-step ms (synchronized), tokens/s, peak memory; every
    loss finite and the last below the first."""
    import math
    from repro_torch.launch import train as train_cli
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_cli.main(TRAIN_ARGS + ["--device", DEVICE])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, step_ms = out["losses"], out["step_ms"]
    steady = statistics.median(step_ms[1:])
    tok_s = TRAIN_B * TRAIN_S / (steady / 1e3)
    log(f"[train] {TRAIN_ARCH} full width and depth, {TRAIN_B}x{TRAIN_S} tokens a step, "
        f"remat, AdamW: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]} (first includes warm-up), steady median "
        f"{steady:.1f} ms = {tok_s:.0f} tokens/s; the launcher's tok/s over the run "
        f"{out['tokens_per_s']:.0f}; peak memory {peak:.2f} GB; {wall:.1f} s")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"[train] {TRAIN_ARCH}: losses {losses} are not finite and falling")
    return {"losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
            "tokens_per_s": tok_s, "launcher_tokens_per_s": out["tokens_per_s"],
            "peak_gb": peak, "wall_s": wall}


def _train_grads(torch, kern) -> tuple:
    """The gradient of loss_fn(deltas=) for one llama3.2-1b tenant at the
    128x spec on one 8 x 128 batch, remat on: through the kernels
    (delta_spmm forward and recompute, dequant backward) against native
    autograd through the plain correction (ops.delta_spmm replaced by
    fallback.correction_nd); a control without every layer's mlp/wi
    correction. -> (row, launches of the kernel run)."""
    from repro_torch.configs import get_config
    from repro_torch.data import PretrainMixture
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RATIO_SPECS, synth_tenants
    from repro_torch.models import lm
    from repro_torch.train.train_step import batch_to_device
    from repro_torch.utils import iter_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    sites = 7 * cfg.n_layers
    base = lm.init_params(cfg, 0, device=DEVICE)
    [(_, deltas, rep)] = synth_tenants(cfg, base, 1, RATIO_SPECS[128], seed=0)
    batch = batch_to_device(PretrainMixture(vocab=cfg.vocab, seq_len=TRAIN_S,
                                            batch=TRAIN_B).batch_at(0), DEVICE)

    def grads(d):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), base)
        kern.reset_launches()
        loss, _ = lm.loss_fn(cfg, ps, batch, deltas=d, remat=True)
        fwd = dict(kern.LAUNCHES)
        paths, xs = zip(*iter_leaves(ps))
        gs = torch.autograd.grad(loss, xs)
        torch.cuda.synchronize()
        return loss.item(), dict(zip(paths, gs)), fwd, dict(kern.LAUNCHES)

    real = ops.delta_spmm
    ops.delta_spmm = lambda x, d: fb.correction_nd(x.to(torch.float32), d)
    try:
        plain_loss, want, _, plain_launches = grads(deltas)
    finally:
        ops.delta_spmm = real
    if any(plain_launches.values()):
        fail(f"[train] the plain correction launched kernels: {plain_launches}")
    scale = {k: w.abs().max().float().item() for k, w in want.items()}

    def rel(got):
        return {k: (got[k].float() - w.float()).abs().max().item() / max(scale[k], 1e-30)
                for k, w in want.items()}

    t0 = time.perf_counter()
    loss, got, fwd, launches = grads(deltas)
    kern_s = time.perf_counter() - t0
    err = rel(got)
    del got
    ctl_deltas = {**deltas, TRAIN_CONTROL[0]: {**deltas[TRAIN_CONTROL[0]],
                                               TRAIN_CONTROL[1]: None}}
    _, ctl, _, _ = grads(ctl_deltas)
    ctl_err = rel(ctl)
    del ctl
    worst = max(err, key=err.get)
    ctl_worst = max(ctl_err, key=ctl_err.get)
    log(f"[train] {TRAIN_ARCH} tenant at {rep.summary()}: loss through the kernels "
        f"{loss:.6f}, plain {plain_loss:.6f}; grads through the kernels vs the plain "
        f"correction's autograd, per leaf max|diff| / max|g|: worst {err[worst]:.3e} at "
        f"{worst} (bound {TRAIN_GRAD_REL_TOL:.3e}); control without every layer's "
        f"{'/'.join(TRAIN_CONTROL)} correction: {ctl_err[ctl_worst]:.3e} at {ctl_worst} "
        f"(must exceed the bound); launches: forward {fwd['delta_spmm']} delta_spmm, "
        f"forward + backward (remat recomputes each block up to its wo) "
        f"LAUNCHES['delta_spmm'] "
        f"{launches['delta_spmm']}, LAUNCHES['dequant'] {launches['dequant']} "
        f"({sites} sites); kernel run {kern_s:.2f} s")
    if err[worst] > TRAIN_GRAD_REL_TOL:
        fail(f"[train] grads through the kernels differ from the plain correction's at "
             f"{worst}: {err[worst]:.3e}")
    if not ctl_err[ctl_worst] > TRAIN_GRAD_REL_TOL:
        fail("[train] the gradient bound does not see the mlp/wi correction missing")
    # remat recomputes each block in backward up to the last tensor backward
    # needs (torch.utils.checkpoint stops early there), so the two output
    # projections' corrections, attention's and the MLP's wo, are not run
    # again: nothing after them is saved
    recomputed = sites - 2 * cfg.n_layers
    if fwd["delta_spmm"] != sites or launches["delta_spmm"] != sites + recomputed or \
            launches["dequant"] != sites:
        fail(f"[train] launches {fwd} / {launches}, expected {sites} delta_spmm forward, "
             f"{sites + recomputed} with the recompute and {sites} dequant")
    del base, deltas, want
    return ({"rel_err": err, "worst_leaf": worst, "control_rel": ctl_err[ctl_worst],
             "control_leaf": ctl_worst, "bound_rel": TRAIN_GRAD_REL_TOL, "loss": loss,
             "plain_loss": plain_loss, "forward_launches": fwd, "launches": launches},
            launches)


def _train_route_grads(torch, kern) -> tuple:
    """Input gradients through the segments and fused kernels at
    llama3.2-1b's wi site (2048 x 8192, 128x spec), TRAIN_ROUTE_T rows:
    ``delta_spmm_segments`` with two tenants' rows (the kernel
    forward, one dequant a tenant backward) and ``fused_base_delta`` with
    a bf16 weight that requires grad (x's and W's gradients), each against
    native autograd through its plain version, per input max|diff| /
    max|g| under TRAIN_GRAD_REL_TOL; a control (one tenant's correction
    dropped; the fused product without its delta) must exceed it.
    -> (row, launches)."""
    from repro_torch.core import dropout
    from repro_torch.core.apply import stack_tenant_deltas
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(53)
    h_in, h_out = TRAIN_SITES["wi"]
    T = TRAIN_ROUTE_T
    tenants = [_rand_packed(torch, dropout, h_in, h_out, 4, gen) for _ in range(2)]
    stack = stack_tenant_deltas([{"w": d} for d in tenants])["w"]
    rows = torch.tensor([1, 0], dtype=torch.int32, device=DEVICE)
    offs = torch.tensor([0, T // 2, T], dtype=torch.int32, device=DEVICE)
    x = torch.randn((T, h_in), generator=gen, device=DEVICE)
    w = (torch.randn((h_in, h_out), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
    gy = torch.randn((T, h_out), generator=gen, device=DEVICE)

    def grads(fn, *inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, gy)

    def rel(got, want):
        return max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                   for a, b in zip(got, want))

    cases = {
        "delta_spmm_segments": (
            lambda x: ops.delta_spmm_segments(x, stack, rows, offs),
            lambda x: fb.segment_correction(x, stack, rows, offs),
            lambda x: fb.segment_correction(x, stack, rows[:1], offs[:2]), (x,)),
        "fused_base_delta": (
            lambda x, w: ops.fused_base_delta(x, w, tenants[0]),
            lambda x, w: fb.fused_base_delta(x, w, tenants[0]),
            lambda x, w: x @ w.float(), (x, w)),
    }
    out, launches = {}, {}
    for name, (kernel, plain, control, inputs) in cases.items():
        kern.reset_launches()
        got = grads(kernel, *inputs)
        torch.cuda.synchronize()
        launched = dict(kern.LAUNCHES)
        want = grads(plain, *inputs)
        err, ctl = rel(got, want), rel(grads(control, *inputs), want)
        want_launches = {"delta_spmm_segments": {"delta_spmm_segments": 1, "dequant": 2},
                         "fused_base_delta": {"fused_base_delta": 1, "dequant": 1}}[name]
        log(f"[train] {name} backward at {TRAIN_ARCH} wi ({h_in} x {h_out}), T={T}: input "
            f"grads vs native autograd through the plain version, max|diff| / max|g| "
            f"{err:.3e} (bound {TRAIN_GRAD_REL_TOL:.3e}); control {ctl:.3e} (must exceed); "
            f"launches {launched}")
        if err > TRAIN_GRAD_REL_TOL or not ctl > TRAIN_GRAD_REL_TOL:
            fail(f"[train] {name}'s backward: {err:.3e} from the plain autograd, control "
                 f"{ctl:.3e}, bound {TRAIN_GRAD_REL_TOL}")
        if any(launched[k] != v for k, v in want_launches.items()):
            fail(f"[train] {name} under grad launched {launched}, expected {want_launches}")
        out[name] = {"rel_err": err, "control_rel": ctl, "launches": launched}
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
    del tenants, stack, x, w, gy
    torch.cuda.empty_cache()
    return out, launches


def _train_kernel_times(torch) -> list:
    """delta_spmm at llama3.2-1b's wq, wk and wi for the training batch's
    T = 1024 rows, and dequant at wi (the correction's backward, with the
    whole backward g @ dequant(d)^T as context)."""
    from repro_torch.core import dropout
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops
    from repro_torch.roofline import analysis as rl

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(51)
    T = TRAIN_B * TRAIN_S
    rows = []
    for site, (h_in, h_out) in TRAIN_SITES.items():
        ring = [_rand_packed(torch, dropout, h_in, h_out, 4, gen) for _ in range(8)]
        dense = [fb.dequant(d) for d in ring]
        t = _time_spmm(torch, ops, fb, ring, dense, gen, site, T, None)
        rows.append({**t, "arch": TRAIN_ARCH})
        if site == "wi":
            ms = time_ms(torch, [lambda d=d: ops.dequant(d) for d in ring])
            plain = time_ms(torch, [lambda d=d: fb.dequant(d) for d in ring], iters=8,
                            reps=3, eager=True)
            g = torch.randn((T, h_out), generator=gen, device=DEVICE)
            bwd = time_ms(torch, [lambda d=d: g @ ops.dequant(d).T for d in ring])
            b_ms, b_by = rl.bound_ms(*rl.dequant_work(ring[0]))
            rows.append({"kernel": "dequant", "arch": TRAIN_ARCH, "site": site, "h_in": h_in,
                         "h_out": h_out, "T": None, "ms": ms, "plain_ms": plain,
                         "library_ms": None, "library_note": DEQUANT_LIBRARY_NOTE,
                         "backward_ms": bwd, "bound_ms": b_ms, "bound_by": b_by})
            log(f"[time] {'dequant':20s} {site:6s} {TRAIN_ARCH}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, library none, bound {b_ms:.4f} ms ({b_by}); the whole "
                f"correction backward at T={T} (dequant + g @ D^T) {bwd:.4f} ms")
        del ring, dense
    torch.cuda.empty_cache()
    return rows


def _train_lifecycle(torch, kern) -> tuple:
    """``launch/train_sft_delta.py`` at the 3m preset: pretrain, SFT,
    compress at 16x/64x/128x, serve through Engine.generate; the gates of
    tests/test_system.py:92-96."""
    from repro_torch.launch import train_sft_delta
    kern.reset_launches()
    t0 = time.perf_counter()
    out = train_sft_delta.main(["--preset", "3m", "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    acc, mem = out["accuracy"], out["memory"]
    log(f"[train] lifecycle (3m preset): fine-tuned {acc['fine_tuned']:.3f}, base "
        f"{acc['base']:.3f}, tenants 16x {acc['16x']:.3f}, 64x {acc['64x']:.3f}, 128x "
        f"{acc['128x']:.3f}; memory: base {mem['base_bytes'] / 1e6:.1f} MB, "
        f"{mem['n_tenants']} tenants {mem['delta_bytes_total'] / 1e6:.2f} MB; launches "
        f"{launches}; {wall:.1f} s")
    if not (acc["fine_tuned"] > SFT_FT_MIN and acc["base"] < SFT_BASE_MAX and
            acc["16x"] > SFT_TENANT_SHARE * acc["fine_tuned"]):
        fail(f"[train] the lifecycle misses its gates: {acc}")
    if launches["delta_spmm"] == 0:
        fail("[train] the lifecycle's tenants did not run the delta_spmm kernel")
    return {"accuracy": acc, "memory": mem, "launches": launches, "wall_s": wall}, launches


def _train_restart(torch) -> dict:
    """Crash-restart at the llama3.2-1b smoke config on the card, as
    tests/test_checkpoint.py:25-46: 6 steps against 3, save, drop, restore,
    3 more; params and optimizer state equal to the bit. Runs under
    torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG is set
    before the script's first cuBLAS call, in main)."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import PretrainMixture
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.utils import flatten_with_paths

    cfg = get_smoke_config(TRAIN_ARCH)
    data = PretrainMixture(vocab=cfg.vocab, seq_len=RESTART_SEQ, batch=RESTART_BATCH)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3))
    d = os.path.join(HERE, "build", "train_restart")
    shutil.rmtree(d, ignore_errors=True)

    def fresh():
        p = lm.init_params(cfg, 0, device=DEVICE)
        return p, adamw.init(p)

    def run(p, o, start, n):
        for i in range(start, start + n):
            p, o, _ = step_fn(p, o, data.batch_at(i), i)
        return p, o

    torch.use_deterministic_algorithms(True)
    try:
        ref = dict(zip(("params", "opt"), run(*fresh(), 0, 2 * RESTART_STEPS)))
        ck = Checkpointer(d)
        p1, o1 = run(*fresh(), 0, RESTART_STEPS)
        ck.save(RESTART_STEPS, {"params": p1, "opt": o1},
                extra={"data_step": RESTART_STEPS})
        del p1, o1
        p0, o0 = fresh()
        state, man = ck.restore({"params": p0, "opt": o0})
        got = dict(zip(("params", "opt"),
                       run(state["params"], state["opt"], man["extra"]["data_step"],
                           RESTART_STEPS)))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(d, ignore_errors=True)
    flat_ref, flat_got = flatten_with_paths(ref), flatten_with_paths(got)
    bad = [k for k in flat_ref if not _bits_equal(torch, flat_got[k], flat_ref[k])]
    log(f"[train] crash-restart at the {TRAIN_ARCH} smoke config on the card, under "
        f"deterministic algorithms: {2 * RESTART_STEPS} steps vs {RESTART_STEPS} + save + "
        f"restore + {RESTART_STEPS}: {len(flat_ref) - len(bad)}/{len(flat_ref)} leaves of "
        f"params and optimizer state equal to the bit")
    if bad:
        fail(f"[train] crash-restart is not bit-exact at {bad[:4]}")
    return {"leaves": len(flat_ref), "bit_equal": len(flat_ref) - len(bad)}


def phase_train(torch, kern, report: dict) -> dict:
    """Training and the paper's lifecycle, outside inference mode: the full
    llama3.2-1b through the training launcher, gradients through the
    correction kernels at full width, the kernels at the training batch's
    shapes, the 3m lifecycle, crash-restart. -> launches by path."""
    out = {"full": _train_full(torch)}
    out["grads"], grad_launches = _train_grads(torch, kern)
    out["route_grads"], route_launches = _train_route_grads(torch, kern)
    out["times"] = _train_kernel_times(torch)
    out["lifecycle"], lc_launches = _train_lifecycle(torch, kern)
    out["restart"] = _train_restart(torch)
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = out
    return {"train:grads": grad_launches, "train:route_grads": route_launches,
            "train:lifecycle": lc_launches}


# ---------------------------------------------------------------------------
# [mesh]: the serving mesh, its ranks sharing the one card
# ---------------------------------------------------------------------------
# (data, model) layouts the engine serves on; every wizard site's h_out
# (4096, 11008) divides at model 2, so no site takes the replicated path
MESH_LAYOUTS = ((1, 2), (2, 2))
# the correction kernels' sites and rows: both delta_spmm routes (T = 2, 8
# decode; 128 prefill) and the mixed step's segments layout
MESH_SITES = {"wq": ("attn", "wq"), "wi": ("mlp", "wi"), "mlp_wo": ("mlp", "wo")}
MESH_T = (2, 8, 128)
# the rows the base GEMMs see on a rank: a decode step's 8 (data 1) or 4
# (data 2) slots and the prefill buckets 64 and 128
MESH_SLICE_T = (4, 8, 64, 128)
# where cuBLAS gives a column slice other bits than the whole product, the
# engine is held to this many of the 12 requests equal, and its logits,
# as a share of max|logit|, to the single-card engine's: the static
# prefill logits of every request to MESH_LOGITS_REL_TOL (each also nearer
# its own tenant's than any other's), and every decode row that chose a
# token, up to and including a request's first differing one (the same
# history up to there; past it the two runs decode different sequences),
# to MESH_DECODE_REL_TOL. Decode attends the bf16 ring, where K/V that
# differ in their last f32 bits can round one bf16 step (2^-8) apart;
# prefill attends them in f32. Readings on an H100 80GB HBM3 (700 W):
# prefill 4.550e-5, decode 4.302e-3 at (1, 2). The phase's control, each
# tenant's delta slice swapped between the two model ranks, read 1.594
# and must land above both bounds.
MESH_MIN_EQUAL = 10
MESH_LOGITS_REL_TOL = 1e-3
MESH_DECODE_REL_TOL = 2e-2
# each world's deadline; a rank's collectives time out after RANK_TIMEOUT_S
MESH_WORLD_TIMEOUT_S = 420.0


def _mesh_slice_check(torch, base) -> list:
    """cuBLAS on a column slice: ``x @ W[:, cols]`` against ``(x @ W)[:,
    cols]`` at the wizard sites and the rows a rank's base GEMMs see, under
    the engine's dtype rule (f32 activations against the bf16 weight)."""
    from repro_torch.core.apply import _matmul
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(77)
    out = []
    for site, (stack, name) in MESH_SITES.items():
        w = base[stack][name][0]
        h_in, h_out = w.shape
        n = h_out // 2
        for T in MESH_SLICE_T:
            x = torch.randn(T, h_in, generator=gen, device=DEVICE)
            full = _matmul(x, w)
            parts = torch.cat([_matmul(x, w[:, m * n:(m + 1) * n].contiguous())
                               for m in range(2)], dim=-1)
            eq = torch.equal(parts, full)
            diff = (parts - full).abs().max().item()
            out.append({"site": site, "T": T, "equal": eq, "max_abs_diff": diff})
            log(f"[mesh] cuBLAS column slice {site} {h_in}x{h_out} T={T}: halves "
                f"{'bit-equal to' if eq else 'DIFFER from'} the whole product "
                f"(max |diff| {diff:.3e})")
    return out


def _mesh_correction_check(torch, ops, store) -> dict:
    """The sharded correction (``ops.delta_correction_sharded`` on each
    rank's column slice, the kernels on the card) against the single-card
    kernel, bit for bit: a shared delta at every MESH_SITES site and T,
    and the mixed step's segments layout, global and per data shard."""
    import numpy as np
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.core.apply import dget, stack_tenant_deltas, zero_delta_like
    from repro_torch.launch.mesh import ServingMesh, shard_delta
    from repro_torch.serve.scheduler import tenant_segments, tenant_segments_sharded

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(78)
    views = [ServingMesh.view(1, 2, model_index=m) for m in range(2)]
    rows_out, worst = [], 0.0
    for site, (stack, name) in MESH_SITES.items():
        d = dget(store.get("tenant0").deltas, stack, name).index(0)
        cuts = [shard_delta(d, v) for v in views]
        for T in MESH_T:
            x = torch.randn(T, d.h_in, generator=gen, device=DEVICE)
            want = ops.delta_spmm(x, d)
            got = torch.cat([ops.delta_correction_sharded(x, c, v)
                             for c, v in zip(cuts, views)], dim=-1)
            eq = torch.equal(got, want)
            worst = max(worst, (got - want).abs().max().item())
            route = "decode" if ops.spmm_row_tile(T, d) in kern.ROW_TILES else "prefill"
            log(f"[mesh] sharded correction {site} T={T} ({route} route): 2 column "
                f"slices {'bit-equal to' if eq else 'DIFFER from'} the single-card kernel")
            rows_out.append({"site": site, "T": T, "route": route, "layout": "shared",
                             "equal": eq})
            if not eq:
                fail(f"[mesh] sharded correction at {site} T={T} differs from the "
                     "single-card kernel")
    # the mixed step: rows over {base, tenant0..2}, segments per tenant
    trees = [dget(store.get(f"tenant{i}").deltas, "mlp", "wi") for i in range(3)]
    layer0 = [t.index(0) for t in trees]
    stk = stack_tenant_deltas([zero_delta_like(layer0[0])] + layer0)
    rows = np.asarray(MIXED_SLOT_ROWS, np.int32)
    x = torch.randn(len(rows), stk.h_in, generator=gen, device=DEVICE)
    seg = tenant_segments(rows, skip_zero_row=True).to(DEVICE)
    xs = x[seg.order]
    want = ops.delta_spmm_segments(xs, stk, seg.seg_rows, seg.seg_offsets)
    cuts = [shard_delta(stk, v) for v in views]
    got = torch.cat([ops.delta_correction_sharded(xs, c, v,
                                                  segments=(seg.seg_rows, seg.seg_offsets))
                     for c, v in zip(cuts, views)], dim=-1)
    eq_g = torch.equal(got, want)
    seg2 = tenant_segments_sharded(rows, 2, skip_zero_row=True).to(DEVICE)
    order, _ = seg2.global_order()
    want2 = ops.delta_spmm_segments(x[order], stk, *seg2.global_segments())
    eq_p = True
    for dpool in range(2):
        vs = [ServingMesh.view(2, 2, data_index=dpool, model_index=m) for m in range(2)]
        xp = x[dpool * 4:(dpool + 1) * 4][seg2.order[dpool]]
        gp = torch.cat([ops.delta_correction_sharded(
            xp, shard_delta(stk, v), v, segments=(seg2.seg_rows, seg2.seg_offsets))
            for v in vs], dim=-1)
        eq_p &= torch.equal(gp, want2[dpool * 4:(dpool + 1) * 4])
    rows_out += [{"site": "wi", "T": len(rows), "layout": "mixed, global", "equal": eq_g},
                 {"site": "wi", "T": len(rows), "layout": "mixed, per data shard",
                  "equal": eq_p}]
    log(f"[mesh] sharded segments at wi, the mixed step's 8 rows over base+3 tenants: "
        f"global layout {'bit-equal' if eq_g else 'DIFFERS'}, per-data-shard layout "
        f"(2 pools x 2 column slices) {'bit-equal' if eq_p else 'DIFFERS'}")
    if not (eq_g and eq_p):
        fail("[mesh] the sharded segments correction differs from the single-card kernel")
    return {"checks": rows_out, "worst_abs": worst}


def _capture_decode_logits(eng, lm) -> tuple:
    """Record, at each of ``eng``'s decode steps, the logits row that
    chooses each active slot's next token on this process's rows, keyed
    by (request id, token index); -> (records, the function that takes
    the recorder off again)."""
    real = lm.decode_step
    records = {}

    def recorded(*args, **kw):
        logits, cache = real(*args, **kw)
        lo, hi = eng._here
        for slot in eng.sched.active_slots():
            if lo <= slot < hi:
                req = eng.sched.slots[slot].request
                records[(req.rid, len(req.tokens))] = logits[slot - lo].float().cpu().numpy()
        return logits, cache

    lm.decode_step = recorded
    return records, lambda: setattr(lm, "decode_step", real)


def _rel(a, b) -> float:
    """max|a - b| as a share of max|b|."""
    import numpy as np
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mesh_rank(rank: int, world: int, device: str, data: int, cfg, base, tenants,
               stream, control_idx) -> dict:
    """One rank of a [mesh] world: the continuous engine on a (data,
    world/data) mesh over the [engine] stream, with the launch counts set
    to 0 just before its run and read just after, its peak memory, the
    decode logits that chose each token (ranks of model index 0, their
    pool's rows), the static prefill logits of every request, and those
    of ``control_idx``'s requests with each tenant's delta slice swapped
    for the next model rank's (the control)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.apply import ColumnShard
    from repro_torch.core.compress import is_compressible
    from repro_torch.core.pack import PackedDelta
    from repro_torch.kernels import delta_spmm as kern
    from repro_torch.launch.mesh import ServingMesh, make_serving_mesh, shard_delta_tree
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, VirtualClock
    from repro_torch.utils import iter_leaves, materialize

    cuda = device == "cuda"
    mesh = make_serving_mesh(world, data=data, device=device)
    # does this build's gloo gather CUDA tensors itself? (the mesh stages
    # them through host memory either way)
    probe = "not gloo on CUDA tensors"
    if mesh.backend == "gloo" and cuda:
        # gloo's all_gather on CUDA tensors, which the mesh's gathers use:
        # each model rank's index comes back in order
        t = torch.full((2,), float(mesh.index("model")), device=device)
        parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, t, group=mesh.device_mesh.get_group("model"))
        got = [p.tolist() for p in parts]
        ok = got == [[float(m)] * 2 for m in range(mesh.shape["model"])]
        probe = f"gloo all_gather on CUDA tensors {'right' if ok else f'WRONG: {got}'}"
    if cuda:
        kern.build()
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        eng = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                               clock=VirtualClock(tick=ENGINE_TICK), mesh=mesh)
        for name, deltas in tenants:
            eng.register_tenant(name, deltas)
        held_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
        # no site on the replicated fallback: every compressible weight is
        # this rank's column slice, every stacked delta leaf its slice too
        sites = [p for p, s in iter_leaves(lm.param_specs(cfg))
                 if is_compressible(p, materialize({"w": s})["w"])]
        cut = {"weights": sum(isinstance(l, ColumnShard) for _, l in iter_leaves(eng.base)),
               "sites": len(sites),
               "delta_leaves": [l.shards for g in eng._groups
                                for _, l in iter_leaves(g.stacked)
                                if isinstance(l, PackedDelta)]}
        handles = [eng.submit(t, p, max_new_tokens=ENGINE_NEW, arrival=a)
                   for t, p, a in stream]
        decoded, uncapture = _capture_decode_logits(eng, lm)
        if cuda:
            torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        try:
            rep = eng.run().report()
            if cuda:
                torch.cuda.synchronize()
        finally:
            uncapture()
        wall = time.perf_counter() - t0
        launches, routes = dict(kern.LAUNCHES), dict(kern.ROUTES)
        of_rid = {h.rid: i for i, h in enumerate(handles)}
        decoded = {(of_rid[rid], j): v for (rid, j), v in decoded.items()}

        # static prefill logits through the sharded model (every rank, so
        # each model group's gathers pair up)
        def prefill(i, deltas):
            row = eng.kv.empty_row()
            out, _ = lm.prefill(cfg, eng.base, {"tokens": torch.as_tensor(
                stream[i][1], dtype=torch.int64, device=device)[None]}, row, deltas=deltas)
            return out[0].float().cpu().numpy()

        eng._install_mesh()
        logits = {i: prefill(i, eng._prefill_deltas(stream[i][0]))
                  for i in range(len(stream))}
        m, n_model = mesh.index("model"), mesh.shape["model"]
        other = ServingMesh.view(data, n_model, data_index=mesh.index("data"),
                                 model_index=(m + 1) % n_model)
        full = dict(tenants)
        control = {i: prefill(i, shard_delta_tree(full[stream[i][0]], other))
                   for i in control_idx}
    return {"coords": mesh.coords, "backend": mesh.backend, "transport": mesh.transport,
            "probe": probe, "tokens": {i: np.asarray(h.output()) for i, h in enumerate(handles)},
            "done": all(h.done for h in handles), "launches": launches, "routes": routes,
            "cut": cut,
            "decode_steps": rep["decode_steps"], "prefills": rep["prefills"],
            "wall_s": wall, "held_gb": held_gb,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
            "decoded": decoded if m == 0 else None,
            "logits": logits if rank == 0 else None,
            "control": control if rank == 0 else None}


def phase_mesh(torch, kern, ctx: dict, report: dict) -> dict:
    """The serving mesh at full wizard-llama2-7b width with ranks that
    share the one card (gloo; NCCL refuses two ranks on one device): the
    cuBLAS column-slice check, the sharded correction against the
    single-card kernel, then the continuous engine on meshes (1, 2) and
    (2, 2) over the [engine] stream against the single-card [engine]
    tokens. The ranks get the base and the tenants from this process by
    CUDA IPC and cut their slices once. No time here measures a mesh: the
    ranks share one card and gloo moves their gathers through host
    memory."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import RANK_TIMEOUT_S, run_ranks
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, VirtualClock

    cfg, base, store = ctx["cfg"], ctx["base"], ctx["eng"].store
    sites = 7 * cfg.n_layers
    slices = _mesh_slice_check(torch, base)
    bits_equal = all(s["equal"] for s in slices)
    corr = _mesh_correction_check(torch, ops, store)
    stream = _engine_stream(cfg)
    names = (None, "tenant0", "tenant1", "tenant2")
    single = {int(i): np.asarray(t) for i, t in report["engine"]["tokens"].items()}
    tenants = [(t.name, t.deltas) for t in store.ordered()]
    control_idx = [i for i in range(len(names)) if stream[i][0] is not None]
    # the single-card references: every request's static prefill logits
    # under each of base, tenant0..2, and the [engine] stream served again
    # with the decode logits that chose each token recorded
    want = {}
    with torch.inference_mode():
        for i, (_, prompt, _) in enumerate(stream):
            for name in names:
                row = lm.init_cache(cfg, 1, ENGINE_MAX_SEQ, device=DEVICE)
                out, _ = lm.prefill(cfg, base, {"tokens": torch.as_tensor(
                    prompt, dtype=torch.int64, device=DEVICE)[None]}, row,
                    deltas=store.get(name).deltas if name else None)
                want[i, name] = out[0].float().cpu().numpy()
        ce = ContinuousEngine(cfg, base, n_slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                              store=store, clock=VirtualClock(tick=ENGINE_TICK))
        handles = [ce.submit(t, p, max_new_tokens=ENGINE_NEW, arrival=a) for t, p, a in stream]
        single_dec, uncapture = _capture_decode_logits(ce, lm)
        try:
            ce.run()
        finally:
            uncapture()
    of_rid = {h.rid: i for i, h in enumerate(handles)}
    single_dec = {(of_rid[rid], j): v for (rid, j), v in single_dec.items()}
    if any(not np.array_equal(h.output(), single[i]) for i, h in enumerate(handles)):
        fail("[mesh] the single-card engine served again differs from its [engine] run")
    del ce, handles
    gc.collect()
    torch.cuda.empty_cache()
    out = {"slice_check": slices, "correction": corr, "layouts": {}}
    launches_by = {}
    for data, model in MESH_LAYOUTS:
        world = data * model
        tag = f"({data}, {model})"
        t0 = time.perf_counter()
        ranks = run_ranks(_mesh_rank, world,
                          (DEVICE, data, cfg, base, tenants, stream, control_idx),
                          device=DEVICE, timeout_s=MESH_WORLD_TIMEOUT_S,
                          rank_timeout_s=RANK_TIMEOUT_S)
        spawn_wall = time.perf_counter() - t0
        if DEVICE == "cuda":
            torch.cuda.ipc_collect()  # the ranks are gone: free their IPC handles
        r0 = ranks[0]
        log(f"[mesh] {tag}: {world} ranks on one card, backend {r0['backend']}, "
            f"transport: {r0['transport']} ({r0['probe']})")
        if "WRONG" in r0["probe"]:
            fail(f"[mesh] {tag}: {r0['probe']}")
        for r in ranks:
            if not r["done"]:
                fail(f"[mesh] {tag}: rank {r['coords']} left requests unfinished")
            for i in range(len(stream)):
                if not np.array_equal(r["tokens"][i], r0["tokens"][i]):
                    fail(f"[mesh] {tag}: rank {r['coords']} disagrees with rank 0 "
                         f"on request {i}")
        cut = r0["cut"]
        log(f"[mesh] {tag}: {cut['weights']} of {cut['sites']} compressible weights are "
            f"column slices, {sum(s == model for s in cut['delta_leaves'])} of "
            f"{len(cut['delta_leaves'])} stacked delta leaves cut in {model}")
        if cut["weights"] != cut["sites"] or any(s != model for s in cut["delta_leaves"]):
            fail(f"[mesh] {tag}: a site took the replicated fallback: {cut}")
        equal = [i for i in range(len(stream)) if np.array_equal(r0["tokens"][i], single[i])]
        own = {i: stream[i][0] for i in range(len(stream))}
        rel = max(_rel(r0["logits"][i], want[i, own[i]]) for i in own)
        # each request's prefill logits nearer its own tenant's than any other's
        astray = [(i, other) for i in own for other in names if other != own[i] and
                  np.abs(r0["logits"][i] - want[i, other]).max() <=
                  np.abs(r0["logits"][i] - want[i, own[i]]).max()]
        # the decode rows up to and including each request's first differing
        # token, from the pools' ranks of model index 0
        mesh_dec = {k: v for r in ranks if r["decoded"] is not None
                    for k, v in r["decoded"].items()}
        dec = {}
        for i in own:
            j = _first_mismatch(r0["tokens"][i], single[i])
            for step in range(1, ENGINE_NEW if j is None else j + 1):
                dec[i, step] = _rel(mesh_dec[i, step], single_dec[i, step])
        dec_rows = len(dec)
        dec_worst = max(dec, key=dec.get) if dec else None
        dec_rel = dec[dec_worst] if dec else 0.0
        dec_median = float(np.median(list(dec.values()))) if dec else 0.0
        differ = {i: _first_mismatch(r0["tokens"][i], single[i])
                  for i in own if i not in equal}
        ctl_rel = max(_rel(r0["control"][i], want[i, own[i]]) for i in control_idx)
        ctl_astray = [(i, other) for i in control_idx for other in names
                      if other != own[i] and np.abs(r0["control"][i] - want[i, other]).max()
                      <= np.abs(r0["control"][i] - want[i, own[i]]).max()]
        ctl_caught = ctl_rel > max(MESH_LOGITS_REL_TOL, MESH_DECODE_REL_TOL) or \
            bool(ctl_astray)
        summed = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
        routes = {k: sum(r["routes"][k] for r in ranks) for k in r0["routes"]}
        steps = r0["decode_steps"]
        want_launches = {"delta_spmm": model * sites * len(stream),
                         "delta_spmm_segments": world * sites * steps,
                         "fused_base_delta": 0, "dequant": 0}
        log(f"[mesh] {tag}: tokens equal to the single-card engine for {len(equal)}/"
            f"{len(stream)} requests (the rest differ first at token {differ}); logits "
            f"rel of max|logit|: static prefill {rel:.3e} (bound {MESH_LOGITS_REL_TOL}; "
            f"all {len(stream)} requests; nearer another tenant: {astray or 'none'}), "
            f"decode {dec_rel:.3e} at (request, token) {dec_worst}, median {dec_median:.3e} "
            f"(bound {MESH_DECODE_REL_TOL}; {dec_rows} rows up to each request's first "
            f"differing token); control, "
            f"each tenant's delta slice swapped between the model ranks: {ctl_rel:.3e}, "
            f"nearer another tenant {len(ctl_astray)}/{3 * len(control_idx)} "
            f"({'caught' if ctl_caught else 'NOT CAUGHT'} by the gate); launches summed "
            f"over ranks {summed} (expected {want_launches}), routes {routes}; "
            f"{steps} decode steps")
        log(f"[mesh] {tag}: peak memory by rank " + ", ".join(
            f"{r['coords']}: {r['peak_gb']:.2f} GB ({r['held_gb']:.2f} GB held after "
            "registration)" for r in ranks) + "; the base and the tenants' full trees "
            "stay in this process, shared by IPC")
        log(f"[mesh] {tag}: engine wall {r0['wall_s']:.2f} s on rank 0, world "
            f"{spawn_wall:.1f} s with spawn — ranks sharing one card, gathers through "
            "host memory: no measure of a mesh's speed")
        if summed != want_launches:
            fail(f"[mesh] {tag}: launches {summed}, expected {want_launches}")
        if not ctl_caught:
            fail(f"[mesh] {tag}: the control (swapped delta slices) passes the gate: "
                 f"logits rel {ctl_rel:.3e}")
        if astray:
            fail(f"[mesh] {tag}: prefill logits nearer another tenant's: {astray}")
        if bits_equal:
            if len(equal) != len(stream) or rel != 0.0 or dec_rel != 0.0:
                fail(f"[mesh] {tag}: {len(equal)}/{len(stream)} requests equal, logits "
                     f"rel {rel:.3e} / {dec_rel:.3e}; the column slices are bit-equal, "
                     "so all must be")
        elif (len(equal) < MESH_MIN_EQUAL or rel > MESH_LOGITS_REL_TOL
              or dec_rel > MESH_DECODE_REL_TOL):
            fail(f"[mesh] {tag}: {len(equal)}/{len(stream)} requests equal (floor "
                 f"{MESH_MIN_EQUAL}), logits rel prefill {rel:.3e} (bound "
                 f"{MESH_LOGITS_REL_TOL}), decode {dec_rel:.3e} (bound {MESH_DECODE_REL_TOL})")
        out["layouts"][tag] = {
            "backend": r0["backend"], "transport": r0["transport"], "probe": r0["probe"],
            "equal_requests": len(equal), "logits_rel": rel, "decode_logits_rel": dec_rel,
            "decode_rows": dec_rows, "decode_logits_median": dec_median,
            "decode_worst_at": dec_worst, "first_differing_token": differ,
            "control_logits_rel": ctl_rel,
            "control_astray": len(ctl_astray), "launches": summed,
            "routes": routes, "decode_steps": steps, "wall_s": r0["wall_s"],
            "world_s": spawn_wall,
            "peak_gb": {str(r["coords"]): r["peak_gb"] for r in ranks}}
        launches_by[f"mesh:{data}x{model}"] = summed
    report["mesh"] = out
    return launches_by


# ---------------------------------------------------------------------------
# [train-mesh]: the training mesh, its ranks sharing the one card
# ---------------------------------------------------------------------------
# llama3.2-1b at full width and depth through the training launcher: 3
# steps (the cosine schedule is set by --steps, so the single-card runs
# it is held to are made here, not read off [train]'s 6) on (data, model)
# (2, 1) with --grad-compress and on (1, 2), both ranks on the card over
# gloo. At (2, 1) the single-card run applies the same compressed
# transform to its grads, so both round the same reduced grads.
TRAIN_MESH_STEPS = 3
TRAIN_MESH_ARGS = ["--full", "--arch", TRAIN_ARCH, "--steps", str(TRAIN_MESH_STEPS),
                   "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "1"]
TRAIN_MESH_LAYOUTS = (((2, 1), True), ((1, 2), False))   # (data, model), --grad-compress
# the mesh's losses against one card's: a rank sums its rows' f32 grads
# over data and rounds them to bf16 once, where the card rounds the whole
# batch's (the f32 summation order differs, and at data 2 cuBLAS runs
# 4-row products where the card runs 8-row ones); AdamW's m / sqrt(v) and
# the mean over 1024 tokens average that down. The CPU tests' LOSS_RTOL
# (tests/test_torch_train_mesh.py), which the mesh meets there. Its
# control: the (2, 1) --grad-compress run held to the uncompressed card
# run must leave it.
TRAIN_MESH_LOSS_REL_TOL = 1e-4


def _rel_err(a: list, b: list) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def _train_mesh_resume(rank: int, world: int, data: int, model: int, ckpt_dir: str,
                       device: str, full: bool, seq: int) -> dict:
    """One step from ``ckpt_dir``'s checkpoint on a (data, model) mesh of
    ``world`` ranks, or on one device (``world`` 1): the launcher's
    ``--resume`` with ``--steps`` one more than the saved run, without its
    final save. -> the step's loss, the restore's seconds, peak memory."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import PretrainMixture
    from repro_torch.launch.mesh import make_mesh, train_shardings
    from repro_torch.models import lm
    from repro_torch.optim import adamw, schedule
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.utils import materialize

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = (get_config if full else get_smoke_config)(TRAIN_ARCH)
    mesh = make_mesh(data, model, device=device) if world > 1 else None
    steps = TRAIN_MESH_STEPS + 1
    opt_cfg = AdamWConfig(lr=3e-4, schedule=schedule.cosine_with_warmup(
        max(steps // 20, 1), steps))
    specs = lm.param_specs(cfg)
    # a template on meta: restore reads dtypes and the tree, not the shapes
    template = {"params": materialize(specs), "opt": materialize(adamw.state_specs(specs))}
    kw = {"shardings": train_shardings(cfg, mesh), "mesh": mesh} if mesh else {}
    t0 = time.perf_counter()
    state, man = Checkpointer(ckpt_dir).restore(
        template, device=torch.cuda.current_device() if cuda else device, **kw)
    restore_s = time.perf_counter() - t0
    step = make_train_step(cfg, opt_cfg, remat=True, mesh=mesh)
    i = man["extra"]["data_step"]
    batch = PretrainMixture(vocab=cfg.vocab, seq_len=seq, batch=TRAIN_B).batch_at(i)
    _, _, m = step(state["params"], state["opt"], batch, i)
    return {"step": i, "loss": float(m["loss"]), "restore_s": restore_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def _train_mesh_run(torch, train_cli, extra: list, grad_transform=None) -> dict:
    """The launcher at TRAIN_MESH_ARGS + ``extra``; ``grad_transform``
    stands in the single-card run's step (the launcher applies
    --grad-compress only at data > 1). -> its result and wall seconds."""
    real = train_cli.make_train_step
    if grad_transform is not None:
        train_cli.make_train_step = lambda *a, **k: real(
            *a, **{**k, "grad_transform": grad_transform})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(TRAIN_MESH_ARGS + ["--device", DEVICE] + extra)
    finally:
        train_cli.make_train_step = real
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_train_mesh(torch, kern, report: dict) -> dict:
    """The training mesh on the card, after [train]: llama3.2-1b at full
    width and depth through ``launch/train.py`` on (2, 1) with
    --grad-compress and on (1, 2), ranks sharing the card over gloo, each
    held to a single-card run with the same arguments; a checkpoint saved
    at (2, 1) restored at (1, 2) and on one card, one more step from each
    with the same loss. Per-rank peak memory beside the dry run's
    per-device bytes for the layout. No correction kernel runs (the path
    has no tenant). -> launches by path."""
    import shutil
    from repro_torch.dist import make_compressed_allreduce
    from repro_torch.dist.sharding import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import run_ranks

    cfg = train_cli.get_config(TRAIN_ARCH)
    kern.reset_launches()
    ckpt = os.path.join(HERE, "build", "train_mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out: dict = {"layouts": {}}
    single = {False: _train_mesh_run(torch, train_cli, []),
              True: _train_mesh_run(torch, train_cli, [], make_compressed_allreduce(
                  mesh_lib.ServingMesh.view(data=2), "data"))}
    for compress, r in single.items():
        log(f"[train-mesh] one card{' + the (2, 1) compressed transform' if compress else ''}: "
            f"losses {r['losses']}, step ms {[round(x, 1) for x in r['step_ms']]}, peak "
            f"{r['peak_bytes'][0] / 1e9:.2f} GB, {r['wall_s']:.1f} s")
    out["single"] = {str(k): v for k, v in single.items()}
    try:
        for (data, model), compress in TRAIN_MESH_LAYOUTS:
            tag = f"{data}x{model}"
            extra = ["--data", str(data), "--model", str(model)]
            if compress:
                extra += ["--grad-compress", "--ckpt-dir", ckpt]
            r = _train_mesh_run(torch, train_cli, extra)
            want = single[compress]["losses"]
            rel = _rel_err(r["losses"], want)
            mem = dryrun.mesh_cell_memory(cfg, AbstractMesh((data, model), ("data", "model")),
                                          dict(kind="train", seq=TRAIN_S, batch=TRAIN_B))
            resident = mem["param_bytes"] + mem["optimizer_bytes"] + mem["grad_bytes"]
            # the control: the compressed run against the uncompressed card
            # run must leave the bound (the transform moves the later losses)
            ctrl = _rel_err(r["losses"], single[False]["losses"]) if compress else None
            log(f"[train-mesh] {tag}{' --grad-compress' if compress else ''}: mesh "
                f"{r['mesh']}, backend {r['backend']}; losses {r['losses']} vs one card "
                f"{want}: rel {rel:.3e} (bound {TRAIN_MESH_LOSS_REL_TOL:g})"
                + (f"; control, vs the uncompressed card run: rel {ctrl:.3e}"
                   if compress else ""))
            log(f"[train-mesh] {tag}: step ms {[round(x, 1) for x in r['step_ms']]} "
                f"(two ranks sharing one card over gloo through host memory: this measures "
                f"no mesh); per-rank peak memory "
                f"{[round(b / 1e9, 2) for b in r['peak_bytes']]} GB vs the dry run's "
                f"per-device bytes {mem['total_bytes'] / 1e9:.2f} GB (params "
                f"{mem['param_bytes'] / 1e9:.2f}, ZeRO-1 AdamW {mem['optimizer_bytes'] / 1e9:.2f}, "
                f"grads {mem['grad_bytes'] / 1e9:.2f}: the ZeRO-1 slice and the largest "
                f"block's whole, batch "
                f"{mem['batch_bytes'] / 1e9:.4f}); {r['wall_s']:.1f} s")
            if not rel <= TRAIN_MESH_LOSS_REL_TOL:
                fail(f"[train-mesh] {tag}: losses {r['losses']} off one card's {want} "
                     f"(rel {rel:.3e} > {TRAIN_MESH_LOSS_REL_TOL})")
            if compress and not ctrl > TRAIN_MESH_LOSS_REL_TOL:
                fail(f"[train-mesh] {tag}: the control (vs the uncompressed card run, rel "
                     f"{ctrl:.3e}) is inside the bound, which then cannot catch a fault")
            if r["backend"] != "gloo" or min(r["peak_bytes"]) < resident:
                fail(f"[train-mesh] {tag}: backend {r['backend']}, peaks {r['peak_bytes']} "
                     f"below the resident {resident} bytes the layout gives")
            out["layouts"][tag] = {"losses": r["losses"], "rel": rel, "control_rel": ctrl,
                                   "step_ms": r["step_ms"],
                                   "peak_bytes": r["peak_bytes"], "dryrun": mem,
                                   "backend": r["backend"], "wall_s": r["wall_s"],
                                   "grad_compress": compress}
        # the (2, 1) checkpoint, restored at (1, 2) and on one card
        t0 = time.perf_counter()
        full = "--full" in TRAIN_MESH_ARGS
        meshed = run_ranks(_train_mesh_resume, 2, (1, 2, ckpt, DEVICE, full, TRAIN_S),
                           device=DEVICE, timeout_s=MESH_WORLD_TIMEOUT_S)
        alone = _train_mesh_resume(0, 1, 1, 1, ckpt, DEVICE, full, TRAIN_S)
        rel = _rel_err([meshed[0]["loss"]], [alone["loss"]])
        log(f"[train-mesh] the (2, 1) checkpoint of step {alone['step']} restored at (1, 2) "
            f"(restore {meshed[0]['restore_s']:.1f} s, peaks "
            f"{[m['peak_gb'] for m in meshed]} GB) and on one card (restore "
            f"{alone['restore_s']:.1f} s, peak {alone['peak_gb']} GB): one more step's "
            f"loss {meshed[0]['loss']:.6f} vs {alone['loss']:.6f}, rel {rel:.3e}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not rel <= TRAIN_MESH_LOSS_REL_TOL or any(m["loss"] != meshed[0]["loss"]
                                                    for m in meshed):
            fail(f"[train-mesh] elastic restore: {[m['loss'] for m in meshed]} vs "
                 f"{alone['loss']} (rel {rel:.3e})")
        out["restore"] = {"mesh_1x2": meshed, "one_card": alone, "rel": rel}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = dict(kern.LAUNCHES)
    log(f"[train-mesh] correction-kernel launches in this process: {launches} (the training "
        f"path has no tenant; the ranks run the same code)")
    if any(launches.values()):
        fail(f"[train-mesh] correction kernels launched on the training path: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    report["train_mesh"] = out
    return {"train:mesh": launches}


def kernel_times(torch) -> list:
    """``--kernel-times``: device times of the decode-side correction
    kernels alone (delta_spmm at DECODE_T, the three segments layouts) at
    every site, on the same seeded deltas as a full run; no checks, no
    plain versions, no library calls. Run with ``--src`` pointing at
    another checkout's ``src/``, it times that checkout's kernels with
    this script's method, so two commits compare in one chip call."""
    from repro_torch.core import dropout
    from repro_torch.kernels import fallback as fb
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1234)
    out = []
    for site, (h_in, h_out) in SITES.items():
        ring = [_rand_packed(torch, dropout, h_in, h_out, 4, gen) for _ in range(8)]
        for T in DECODE_T:
            out.append(_time_spmm(torch, ops, fb, ring, None, gen, site, T, None, full=False))
        for layout, T in (("mixed", 8), ("slots", 8), ("random", 256)):
            out.append(_time_segments(torch, ops, fb, ring, gen, site, layout, T, full=False))
        del ring
    return out


# each kernel's translation units under src/repro_torch/kernels/csrc (all
# include common.cuh; delta_spmm.cu holds the C interface)
KERNEL_SOURCES = {
    "delta_spmm": ("decode.cuh", "decode_spmm_u8.cu", "decode_spmm_i32.cu", "dense.cuh",
                   "dense_spmm.cu", "prefill.cuh", "prefill.cu", "prefill_i32.cu"),
    "delta_spmm_segments": ("decode.cuh", "decode_segments_u8.cu", "decode_segments_i32.cu",
                            "dense.cuh", "dense_segments.cu"),
    "fused_base_delta": ("fused.cu",),
    "dequant": ("delta_spmm.cu",),
}


def kernel_entries(report: dict, worst: dict, main: dict, by_path: dict) -> list:
    """The ``kernels`` JSON line: each kernel at the wi site and at a
    shape its main path gives it, with ``launches`` from that path
    (``main[name]``, the counts read right after it: the continuous
    engine's mixed run for the serving kernels) and the launches of
    every other path that ran it (``by_path``)."""
    by = {(t["kernel"], t["site"], t["T"], t.get("layout")): t for t in report["times"]}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    eng_routes = report["engine"]["mixed"]["routes"]
    entries = []
    for name, line, T, layout in (("delta_spmm", 122, 128, None),
                                  ("delta_spmm_segments", 240, 8, "mixed"),
                                  ("fused_base_delta", 173, 128, None),
                                  ("dequant", 311, None, None)):
        t = by[(name, "wi", T, layout)]
        extra = {k: t[k] for k in ("layout", "library_note", "scatter_partial_ms",
                                   "apply_linear_ms") if k in t}
        if name in ("delta_spmm", "delta_spmm_segments"):
            extra.update(replaced_ms=None, replaced_note=REPLACED_NOTE)
        if name == "delta_spmm":   # both routes, at the engine's prefill buckets
            d64, d2 = by[(name, "wi", 64, None)], by[(name, "wi", 2, None)]
            extra["ops_route"] = f"{t['route']} (tb {t['tb']})"
            extra["decode_route"] = {
                "T": 64, "launches": eng_routes["delta_spmm_decode"],
                **{k: d64[k] for k in keys}, "prefill_route_ms": d64.get("other_route_ms")}
            extra["prefill_route"] = {"T": 128, "launches": eng_routes["delta_spmm_prefill"]}
            extra["generate_decode"] = {
                "T": 2, "launches": report["main"]["decode_route_launches"],
                **{k: d2[k] for k in keys}}
        if name in ("delta_spmm", "delta_spmm_segments"):   # the codec packings
            # their dense-group walk (dense.cuh), launched by this wrapper:
            # its launches in [codecs]' mixed fleet (whole-prompt, chunked)
            extra["dense_walk"] = {
                "source": "src/repro_torch/kernels/csrc/dense.cuh",
                "launches": {m: r["walks"][f"{name}_dense"]
                             for m, r in report["codecs"]["fleet"].items()}}
            extra["codec_shapes"] = [
                {k: c[k] for k in ("codec", "site", "T", "layout", "tb", "walk", *keys)
                 if k in c}
                for c in report["codec_times"] if c["kernel"] == name]
        if name in ("delta_spmm", "delta_spmm_segments"):   # the other configs' sites
            extra["arch_sites"] = [
                {k: a[k] for k in ("arch", "site", "h_in", "h_out", "T", "layout", "tb",
                                   *keys) if k in a}
                for r in report["archs"].values() for a in r["kernels"]["times"]
                if a["kernel"] == name]
        if name in ("delta_spmm", "delta_spmm_segments"):   # [families]' new sites
            extra["family_sites"] = [
                {k: a[k] for k in ("arch", "site", "h_in", "h_out", "T", "layout", "tb",
                                   *keys) if k in a}
                for r in report["families"].values() for a in r["times"]
                if a["kernel"] == name]
            extra["family_launches"] = {p: l[name] for p, l in by_path.items()
                                        if p.startswith("families:")}
        if name == "delta_spmm":   # the MoE configs' attention sites, [moe]
            extra["arch_sites"] += [
                {k: a[k] for k in ("arch", "site", "h_in", "h_out", "T", "tb", *keys)}
                for r in report["moe"].values() for a in r["attention_times"]]
        if name == "delta_spmm_segments":   # the MoE expert stacks, [moe]
            extra["expert_sites"] = [
                {"arch": arch, **{k: e[k] for k in (
                    "site", "h_in", "h_out", "E", "C", "T", "routed_tokens", "live_rows",
                    "experts_read", "tb", "ops_layout", "counts_ms", "all_c_ms", *keys)}}
                for arch, r in report["moe"].items() for e in r["kernels"]]
            extra["expert_launches"] = {p: l[name] for p, l in by_path.items()
                                        if p.startswith("moe:")}
        if name in ("delta_spmm", "dequant"):   # [train]'s sites at T = 1024
            extra["train_sites"] = [
                {k: a[k] for k in ("arch", "site", "h_in", "h_out", "T", "tb", "backward_ms",
                                   *keys) if k in a}
                for a in report["train"]["times"] if a["kernel"] == name]
            extra["train_launches"] = {p: l[name] for p, l in by_path.items()
                                       if p.startswith("train:")}
        # [envelope]: the packings past the reference's envelope
        extra["envelope_sites"] = [
            {k: a[k] for k in ("packing", "site", "h_in", "h_out", "T", "layout", "tb",
                               *keys) if k in a}
            for a in report["envelope"]["times"] if a["kernel"] == name]
        if name == "delta_spmm_segments":   # the chunked engine's prompt chunks
            c = by[(name, "wi", ENGINE_CHUNK, "chunk")]
            extra["chunk_layout"] = {
                "T": ENGINE_CHUNK,
                "launches": report["engine"]["chunked"]["segment_rows"][ENGINE_CHUNK],
                **{k: c[k] for k in keys}}
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{KERNEL_SOURCES[name][0]}",
            "sources": [f"src/repro_torch/kernels/csrc/{f}" for f in KERNEL_SOURCES[name]],
            "replaces": f"src/repro/kernels/delta_spmm.py:{line}",
            "launches": main[name][name],
            "launches_by_path": {p: l[name] for p, l in by_path.items() if l.get(name)},
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": f"wi 4096x11008{'' if T is None else f', T={T}'}, 128x spec",
            **extra})
    return entries


def _write_report(report: dict, t_start: float) -> None:
    """Everything measured so far, also when a check failed."""
    report["wall_s"] = time.perf_counter() - t_start
    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


def main(argv: list) -> int:
    """No arguments: the full smoke run. ``--kernel-times [--src DIR]``:
    only :func:`kernel_times`, importing ``repro_torch`` from DIR (default
    this checkout's ``src/``)."""
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    times_only = "--kernel-times" in argv
    src = argv[argv.index("--src") + 1] if "--src" in argv else SRC
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        log(f"chip_smoke: no repro_torch under {src}; run it from a checkout")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
        return 1
    # before the first cuBLAS call: [train]'s crash-restart runs under
    # torch.use_deterministic_algorithms, which needs a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.kernels import delta_spmm as kern

    if times_only:
        with torch.inference_mode():
            smi = phase_device(torch)
            log(f"[kernel-times] repro_torch from {os.path.abspath(src)}")
            kern.build()
            times = kernel_times(torch)
        print(json.dumps({"kernel_times": times, "device": smi}), flush=True)
        return 0

    t_start = time.perf_counter()
    report: dict = {"phase_s": {}}
    t_phase = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        report["phase_s"][name] = now - t_phase[0]
        log(f"[phase] {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    try:
        with torch.inference_mode():
            smi = phase_device(torch)
            report["device"] = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0)}
            report["build_s"] = phase_build(kern)
            phase_done("device and build")
            worst = phase_parity(torch, report)
            phase_done("parity and times")
            codec_worst = phase_codec_parity(torch, report)
            _time_codecs(torch, report)
            phase_done("codec parity and times")
            ctx = phase_main_path(torch, kern, report)
            mixed_launches = phase_mixed_decode(torch, kern, ctx, report)
            phase_done("main path and mixed step")
            engine_launches = phase_engine(torch, kern, ctx, report)
            phase_done("engine")
            codecs_launches = phase_codecs(torch, kern, ctx, report)
            phase_done("codecs")
            lifecycle_launches = phase_lifecycle(torch, kern, ctx, report)
            phase_done("lifecycle")
            residency_launches = phase_residency(torch, kern, ctx, report)
            phase_done("residency")
            storage_launches = phase_storage(torch, kern, ctx, report)
            phase_done("storage")
            phase_groupsearch(torch, ctx, report)
            phase_done("groupsearch")
            envelope_launches, envelope_worst = phase_envelope(torch, kern, ctx, report)
            phase_done("envelope")
            phase_autotune(torch, report)
            phase_done("autotune")
            mesh_launches = phase_mesh(torch, kern, ctx, report)
            phase_done("mesh")
            main_launches, merge_launches = ctx["launches"], ctx["merge_launches"]
            ctx.clear()          # frees the base, the engine and the tenants
            torch.cuda.empty_cache()
            quickstart_launches = phase_quickstart(torch, kern, report)
            demo_launches = phase_kernels_demo(torch, kern, report)
            phase_done("quickstart and demo")
            arch_launches = phase_archs(torch, kern, report)
            phase_done("archs")
            moe_launches = phase_moe(torch, kern, report)
            phase_done("moe")
            families_launches, families_worst = phase_families(torch, kern, report)
            phase_done("families")
        # training needs autograd: outside inference mode
        train_launches = phase_train(torch, kern, report)
        phase_done("train")
        train_launches.update(phase_train_mesh(torch, kern, report))
        phase_done("train-mesh")
    finally:
        _write_report(report, t_start)

    for k, v in (list(codec_worst.items()) + list(families_worst.items()) +
                 list(envelope_worst.items())):
        worst[k] = max(worst[k], v)
    worst["delta_spmm_segments"] = max(worst["delta_spmm_segments"],
                                       *(r["worst"] for r in report["moe"].values()))
    entries = kernel_entries(report, worst, {
        "delta_spmm": engine_launches, "delta_spmm_segments": engine_launches,
        "fused_base_delta": demo_launches, "dequant": merge_launches}, {
        "engine": engine_launches, "codecs": codecs_launches,
        "lifecycle": lifecycle_launches, "residency": residency_launches,
        "storage": storage_launches, "envelope": envelope_launches,
        "generate": main_launches,
        "mixed_step": mixed_launches, "merge": merge_launches,
        "quickstart": quickstart_launches, "demo": demo_launches, **arch_launches,
        **moe_launches, **families_launches, **train_launches, **mesh_launches})
    report["kernels"] = entries
    _write_report(report, t_start)
    log(f"[done] {report['wall_s']:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
