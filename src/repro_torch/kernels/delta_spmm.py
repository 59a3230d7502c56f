"""CUDA kernels for the DeltaDQ hot path: build, binding and wrappers.

Kernels (sources under ``csrc/``, CUDA C++ for ``sm_90a``; the design
notes and the C interface are in ``csrc/delta_spmm.cu``):

    delta_spmm           y = x @ dequant(delta)
                         (replaces repro/kernels/delta_spmm.py:122); the
                         decode route (up to 8 rows a cluster of 8 blocks,
                         columns in lanes) and, at prefill, the 128-row
                         tile (rows in lanes), with the same bits
    delta_spmm_segments  mixed-tenant decode: rows sorted by tenant, the
                         segments' row tiles computed in parallel on the
                         decode route's routine
                         (replaces repro/kernels/delta_spmm.py:240)
    fused_base_delta     y = x @ (W + dequant(delta)), W bf16 or f32, on
                         tensor cores in 3xTF32
                         (replaces repro/kernels/delta_spmm.py:173)
    dequant              the dense delta [h_in, h_out] f32, merge path
                         (replaces repro/kernels/delta_spmm.py:311)

The sources have a plain C interface: each translation unit
(:data:`SOURCES`) is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library at first
use, under ``build/kernels/<sources hash>/`` at the repo root, and
loaded with ``ctypes``. Nothing is compiled or loaded
at import, so CPU-only hosts import this module freely. A failed build
or launch raises; there is no fallback to the plain version here — the
plain versions live in ``kernels/fallback.py`` and ``kernels/ops.py``
takes them only for tensors on the CPU.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches
its kernel, and nowhere else.

The kernels take every packing the compressor emits: any ``h_g``
dividing ``h_in`` up to ``h_in`` itself (the row-wise default), any
``keep`` up to ``h_g``, ``idx`` uint8 up to ``h_g = 256`` and int32 above
(the packer's rule, ``core.pack.idx_dtype``), codes at widths 1/2/4/8 or raw
f32 — on every tile: the 128-row prefill tile walks whole groups where
they fit and windows of x indices elsewhere (:func:`prefill_fits`), and
the decode tiles take a narrow 32-column tile at G < 8
(:func:`decode_plan`). The codecs' lowerings (``core.pack.dense_groups``:
keep = h_g, idx = arange) take a dense-group walk on the decode tiles and
in the segments kernel, which reads no idx; the wrappers tell the
library so, which never infers it from shapes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

from repro_torch.core.pack import PackedDelta, dense_groups, idx_dtype

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
# the translation units (the C interface in delta_spmm.cu) and the
# headers they include; all of them key the build
SOURCES = tuple(sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")))
HEADERS = tuple(sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_ROOT = os.path.join(_REPO, "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# row tiles of the decode route (delta_spmm up to 64 rows) and of the
# segments kernel: the most rows one block computes; a block computes
# only real rows, so a tile is a cap, not a padding
ROW_TILES = (1, 2, 4, 8)
# row tile of delta_spmm's prefill kernel (rows in lanes), delta_spmm only
PREFILL_TILES = (128,)
SPMM_TILES = ROW_TILES + PREFILL_TILES
# caps on the fused kernel's own row tile (16, 32 or 64 rows)
FUSED_TILES = (8, 16, 32)

# launch counters: one per kernel, bumped by its wrapper at each launch;
# ROUTES splits the delta_spmm launches by route
LAUNCHES = {"delta_spmm": 0, "delta_spmm_segments": 0, "fused_base_delta": 0,
            "dequant": 0}
ROUTES = {"delta_spmm_decode": 0, "delta_spmm_prefill": 0}
# launches of the dense-group walk (``dense_groups`` packings on a decode
# tile), a share of the two correction kernels' counts above
WALKS = {"delta_spmm_dense": 0, "delta_spmm_segments_dense": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, WALKS):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the delta_spmm "
                           "kernels are built from source at first use")
    return found


def library_path() -> str:
    """Where the shared library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libdelta_spmm.so")


def build() -> str:
    """Compile the kernels if these sources have no library yet; returns
    its path. One ``nvcc`` process a translation unit, all at once, then
    one link. The compiler's register/spill report goes to ``build.log``
    beside the library. Raises on a failed build."""
    path = library_path()
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(src)[:-3]}.{tag}.o") for src in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [(src, p.communicate()[0], p.returncode) for src, p in zip(SOURCES, procs)]
    tmp = f"{path}.{tag}"
    if all(rc == 0 for _, _, rc in logs):
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(("link", link.stdout + link.stderr, link.returncode))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("".join(f"== {os.path.basename(src)}\n{out}" for src, out, _ in logs))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    bad = [(src, out, rc) for src, out, rc in logs if rc != 0]
    if bad:
        src, out, rc = bad[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n{out[-4000:]}")
    os.replace(tmp, path)   # atomic: concurrent builders agree on one file
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.delta_spmm_launch.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
            lib.delta_spmm_launch.restype = i
            ll = ctypes.c_longlong
            lib.delta_spmm_segments_launch.argtypes = [
                p, p, p, p, p, i, ll, ll, ll, ll, p, p, i, p,
                i, i, i, i, i, i, i, i, i, i, p]
            lib.delta_spmm_segments_launch.restype = i
            lib.fused_base_delta_launch.argtypes = [
                p, p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
            lib.fused_base_delta_launch.restype = i
            lib.delta_spmm_prefill_ok.argtypes = [i, i, i]
            lib.delta_spmm_prefill_ok.restype = i
            lib.delta_spmm_decode_plan.argtypes = [i, i, i, i, i, i, i, i, i,
                                                   ctypes.POINTER(i)]
            lib.delta_spmm_decode_plan.restype = i
            lib.fused_base_delta_splits.argtypes = [i, i, i, i]
            lib.fused_base_delta_splits.restype = i
            lib.dequant_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            lib.dequant_launch.restype = i
            _lib = lib
    return _lib


def prefill_fits(tb: int, h_g: int, keep: int) -> bool:
    """Whether the prefill kernel takes row tile ``tb`` for groups of
    ``h_g`` rows with ``keep`` kept values: every packing (1 <= keep <=
    h_g) since the windowed walk; asks the library."""
    return tb in PREFILL_TILES and bool(_load().delta_spmm_prefill_ok(tb, h_g, keep))


def decode_plan(d: PackedDelta, tb: int) -> dict | None:
    """The decode route's launch plan for ``d`` at row tile ``tb`` (as
    ``delta_spmm`` and the segments kernel take it): groups a step holds
    (``sg``), kept slots a step holds of each (``kc``: ``keep``, or a run
    of a group's slots where a whole group does not fit), ring depth
    (``stages``), rows a block computes at most (``rows``; below ``tb``
    where the shared memory does not fit), its dynamic shared memory
    bytes, the steps of a class chain (``steps``), whether x is read
    from global memory (``x_global``), the blocks of a cluster
    (``cluster``: min(G, 8), one a class chain that has a group) and the
    columns of a tile (``cols``: 128, or 32 for the narrow tile at G < 8,
    a warp a row) and the walk it planned (``walk``: ``"dense"`` for a
    :func:`dense_groups` packing, which stages no idx, ``"narrow"``, or
    ``"general"``); None for a packing the kernels do not take. Host
    arithmetic in the library: launches nothing."""
    from repro_torch.core.quant import pack_width, packed_len
    kp, wbits = (d.keep, 0) if d.k_bits is None else (packed_len(d.keep, d.k_bits),
                                                      pack_width(d.k_bits))
    out = (ctypes.c_int * 10)()
    if not _load().delta_spmm_decode_plan(d.h_in, d.h_out, d.h_g, d.keep, kp, wbits,
                                          idx_dtype(d.h_g).itemsize, tb,
                                          int(dense_groups(d)), out):
        return None
    return {"tb": tb, "sg": out[0], "kc": out[1], "stages": out[2], "rows": out[3],
            "smem_bytes": out[4], "steps": out[5], "x_global": bool(out[6]),
            "cluster": out[7], "cols": out[8],
            "walk": ("general", "narrow", "dense")[out[9]]}


def check_inputs(x2: torch.Tensor, d: PackedDelta, stacked: bool) -> tuple[int, int]:
    """Validate dtypes, shapes and layout for a launch; returns (kp, wbits).

    ``stacked``: ``d`` carries a leading tenant axis [R, ...], which may
    be strided (a layer slice of a [R, L, ...] stack); each tenant's
    [G, keep|kp, O] block must be contiguous. Device placement is the
    wrappers' check."""
    if x2.dtype != torch.float32:
        raise TypeError(f"x dtype {x2.dtype} is not float32")
    if x2.ndim != 2 or x2.shape[1] != d.h_in or not x2.is_contiguous():
        raise ValueError(f"x must be contiguous [T, {d.h_in}], got "
                         f"{tuple(x2.shape)}")
    return check_delta(d, x2.device, stacked)


def check_delta(d: PackedDelta, device: torch.device, stacked: bool) -> tuple[int, int]:
    """The packed-delta half of :func:`check_inputs`: every array of ``d``
    on ``device``, ``idx`` of the packer's dtype for its ``h_g``
    (:func:`idx_dtype`); returns (kp, wbits)."""
    G, keep, O = d.n_groups, d.keep, d.h_out
    stack = (d.idx.shape[0],) if stacked else ()
    idt = idx_dtype(d.h_g)
    if d.idx.dtype != idt or tuple(d.idx.shape) != (*stack, G, keep, O):
        raise ValueError(f"idx must be {idt} {(*stack, G, keep, O)} at h_g={d.h_g}, got "
                         f"{d.idx.dtype} {tuple(d.idx.shape)}")
    if d.h_g * G != d.h_in or not 1 <= keep <= d.h_g:
        raise ValueError(f"packing h_in={d.h_in} h_g={d.h_g} keep={keep}: h_g must "
                         "divide h_in and keep lie in 1..h_g")
    if d.k_bits is None:
        kp, wbits, cdt = keep, 0, torch.float32
    else:
        from repro_torch.core.quant import pack_width, packed_len
        kp, wbits, cdt = packed_len(keep, d.k_bits), pack_width(d.k_bits), torch.uint8
    if d.codes.dtype != cdt or tuple(d.codes.shape) != (*stack, G, kp, O):
        raise ValueError(f"codes must be {cdt} {(*stack, G, kp, O)}, got "
                         f"{d.codes.dtype} {tuple(d.codes.shape)}")
    if d.scale.dtype != torch.float32 or d.zero.dtype != torch.int32 or \
            tuple(d.scale.shape) != stack or tuple(d.zero.shape) != stack:
        raise ValueError(f"scale/zero must be float32/int32 {stack}")
    for name, t in (("idx", d.idx), ("codes", d.codes)):
        block = t[0] if stacked else t
        if not block.is_contiguous() or (stacked and t.stride(0) < 0):
            raise ValueError(f"{name} must be contiguous per tenant")
    for name, t in (("idx", d.idx), ("codes", d.codes), ("scale", d.scale),
                    ("zero", d.zero)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    return kp, wbits


def _require_cuda(t: torch.Tensor, name: str = "x") -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def delta_spmm_cuda(x2: torch.Tensor, d: PackedDelta, *, tb: int) -> torch.Tensor:
    """y [T, h_out] f32 = x2 [T, h_in] @ dequant(d), on the card.

    ``tb`` in :data:`ROW_TILES` takes the decode route (at most ``tb``
    rows a block; the library lowers it where its shared memory would not
    fit), in :data:`PREFILL_TILES` the rows-in-lanes prefill kernel (every
    packing, :func:`prefill_fits`); a row has the same bits under every
    tile. On a decode tile a :func:`dense_groups` packing takes the
    dense-group walk, which reads no idx (:data:`WALKS`)."""
    if tb not in SPMM_TILES:
        raise ValueError(f"tb={tb} not in {SPMM_TILES}")
    _require_cuda(x2)
    kp, wbits = check_inputs(x2, d, stacked=False)
    if tb in PREFILL_TILES and not prefill_fits(tb, d.h_g, d.keep):
        raise ValueError(f"tb={tb}: the prefill kernel does not take "
                         f"h_g={d.h_g}, keep={d.keep}")
    lib = _load()
    T = x2.shape[0]
    y = torch.empty((T, d.h_out), dtype=torch.float32, device=x2.device)
    if T == 0:
        return y
    # the prefill kernel stages x transposed, blocked by tb rows:
    # [ceil(T / tb), h_in, tb]
    xT = torch.empty((-(-T // tb), d.h_in, tb), dtype=torch.float32, device=x2.device) \
        if tb in PREFILL_TILES else None
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    dense = dense_groups(d)
    err = lib.delta_spmm_launch(
        x2.data_ptr(), d.idx.data_ptr(),
        d.codes.data_ptr(), d.scale.data_ptr(), d.zero.data_ptr(), y.data_ptr(),
        None if xT is None else xT.data_ptr(),
        T, d.h_in, d.h_out, d.h_g, d.keep, kp, wbits, d.idx.element_size(), tb, int(dense),
        stream)
    _raise_on(err, "delta_spmm")
    LAUNCHES["delta_spmm"] += 1
    ROUTES["delta_spmm_prefill" if tb in PREFILL_TILES else "delta_spmm_decode"] += 1
    if dense and tb in ROW_TILES:
        WALKS["delta_spmm_dense"] += 1
    return y


def delta_spmm_segments_cuda(x2: torch.Tensor, d: PackedDelta,
                             seg_rows: torch.Tensor, seg_offsets: torch.Tensor,
                             *, tb: int) -> torch.Tensor:
    """Row r of tenant-sorted x2 gets x2[r] @ dequant(d[seg_rows[seg(r)]]).

    Rows that no segment covers, and rows of a segment whose tenant row is
    outside the stack, come back zero (the reference kernel zero-fills its
    output). ``seg_offsets`` must be non-decreasing (the layout of
    ``serve.scheduler.tenant_segments``); ``tb`` in :data:`ROW_TILES` caps
    the rows one block computes, and a segment's tile computes only its
    segment's rows. A :func:`dense_groups` stack takes the dense-group
    walk, which reads no idx (:data:`WALKS`)."""
    if tb not in ROW_TILES:
        raise ValueError(f"tb={tb} not in {ROW_TILES}")
    _require_cuda(x2)
    kp, wbits = check_inputs(x2, d, stacked=True)
    S = seg_rows.shape[0]
    for name, t, n in (("seg_rows", seg_rows, S), ("seg_offsets", seg_offsets, S + 1)):
        if t.dtype != torch.int32 or t.device != x2.device or t.ndim != 1 or \
                t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{n}] on "
                             f"{x2.device}")
    lib = _load()
    T = x2.shape[0]
    y = torch.empty((T, d.h_out), dtype=torch.float32, device=x2.device)
    if T == 0:
        return y
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    dense = dense_groups(d)
    err = lib.delta_spmm_segments_launch(
        x2.data_ptr(), d.idx.data_ptr(),
        d.codes.data_ptr(), d.scale.data_ptr(), d.zero.data_ptr(),
        d.idx.shape[0], d.idx.stride(0) * d.idx.element_size(),
        d.codes.stride(0) * d.codes.element_size(),
        d.scale.stride(0), d.zero.stride(0),
        seg_rows.data_ptr(), seg_offsets.data_ptr(), S, y.data_ptr(),
        T, d.h_in, d.h_out, d.h_g, d.keep, kp, wbits, d.idx.element_size(), tb, int(dense),
        stream)
    _raise_on(err, "delta_spmm_segments")
    LAUNCHES["delta_spmm_segments"] += 1
    if dense:
        WALKS["delta_spmm_segments_dense"] += 1
    return y


def fused_base_delta_cuda(x2: torch.Tensor, w: torch.Tensor, d: PackedDelta, *,
                          tb: int) -> torch.Tensor:
    """y [T, h_out] f32 = x2 [T, h_in] @ (w + dequant(d)), on the card;
    ``w`` [h_in, h_out] contiguous bf16 or f32.

    ``tb`` in :data:`FUSED_TILES` caps the kernel's row tile: 16 rows for
    tb <= 16, else 32 rows for T <= 32 and 64 above. Where the tiles leave
    SMs idle the kernel splits K over blocks into a workspace allocated
    here, then adds the splits in a fixed order (the same bits from call
    to call)."""
    if tb not in FUSED_TILES:
        raise ValueError(f"tb={tb} not in {FUSED_TILES}")
    _require_cuda(x2)
    kp, wbits = check_inputs(x2, d, stacked=False)
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w dtype {w.dtype} is neither bfloat16 nor float32")
    if tuple(w.shape) != (d.h_in, d.h_out) or not w.is_contiguous() or \
            w.device != x2.device:
        raise ValueError(f"w must be contiguous [{d.h_in}, {d.h_out}] on {x2.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    lib = _load()
    T = x2.shape[0]
    y = torch.empty((T, d.h_out), dtype=torch.float32, device=x2.device)
    if T == 0:
        return y
    splits = lib.fused_base_delta_splits(T, d.h_in, d.h_out, tb)
    ws = torch.empty((splits, T, d.h_out), dtype=torch.float32, device=x2.device) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = lib.fused_base_delta_launch(
        x2.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), d.idx.data_ptr(),
        d.codes.data_ptr(), d.scale.data_ptr(), d.zero.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), splits,
        T, d.h_in, d.h_out, d.h_g, d.keep, kp, wbits, d.idx.element_size(), tb, stream)
    _raise_on(err, "fused_base_delta")
    LAUNCHES["fused_base_delta"] += 1
    return y


def dequant_cuda(d: PackedDelta) -> torch.Tensor:
    """The dense delta [h_in, h_out] f32 of one unstacked matrix, on the
    card."""
    _require_cuda(d.idx, "idx")
    kp, wbits = check_delta(d, d.idx.device, stacked=False)
    lib = _load()
    out = torch.empty((d.h_in, d.h_out), dtype=torch.float32, device=d.idx.device)
    stream = torch.cuda.current_stream(d.idx.device).cuda_stream
    err = lib.dequant_launch(
        d.idx.data_ptr(), d.codes.data_ptr(), d.scale.data_ptr(), d.zero.data_ptr(),
        out.data_ptr(), d.h_in, d.h_out, d.h_g, d.keep, kp, wbits, d.idx.element_size(),
        stream)
    _raise_on(err, "dequant")
    LAUNCHES["dequant"] += 1
    return out
