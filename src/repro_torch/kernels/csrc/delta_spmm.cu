// DeltaDQ delta kernels for Hopper (sm_90a).
//
// Four kernels; the two correction kernels share one device routine
// (cluster_correction; dense_correction for the codecs' lowerings), and
// all four share the code decode (decode_value, decode_raw):
//
//   delta_spmm           y[T, O] = x[T, h_in] @ dequant(delta)
//                        replaces repro/kernels/delta_spmm.py:122
//                        delta_spmm_kernel (body _spmm_body, :108);
//                        spmm_decode_kernel up to 64 rows,
//                        spmm_prefill_kernel (same bits) above, for
//                        every packing
//   delta_spmm_segments  row r of tenant-sorted x gets
//                        x[r] @ dequant(delta[seg_rows[seg(r)]])
//                        replaces repro/kernels/delta_spmm.py:240
//                        delta_spmm_segments_kernel (body _segments_body, :211);
//                        segments_decode_kernel
//   fused_base_delta     y[T, O] = x[T, h_in] @ (W + dequant(delta)), W bf16
//                        or f32 [h_in, O]
//                        replaces repro/kernels/delta_spmm.py:173
//                        fused_base_delta_kernel (body _fused_body, :158)
//   dequant              the dense delta [h_in, O] f32 (merge path)
//                        replaces repro/kernels/delta_spmm.py:311
//                        dequant_kernel (body _dequant_body, :305)
//
// The packed delta (repro_torch/core/pack.py) holds, per (group g, kept
// slot k, output column o), a local index idx[g, k, o] < h_g (uint8 up to
// h_g = 256, int32 above: the packer's rule) and a k-bit code packed
// LSB-first along k at a physical width w in {1,2,4,8} (codes[g, k /
// (8/w), o]); the value is (q - zero) * scale. With k_bits = None the
// codes are raw f32 values [G, keep, O]. Every kernel takes every packing
// the compressor emits: any h_g dividing h_in (up to h_in itself, one
// group a row), any keep from 1 to h_g, any G, either idx width.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): the work is T * nnz multiply-adds on data that is mostly the
// compressed bytes. At decode (T <= 8) each call must read idx + codes
// once -- 1.5 bytes per kept value at the 128x spec (nnz = h_in*h_out/8)
// -- plus x and y, so a 4096 x 11008 site moves ~8.5 MB: ~2.5 us. That
// is a memory bound. At prefill (T = 256) the 2 * T * nnz f32
// operations (~2.9 GFLOP for the same site, ~43 us) bound it instead.
//
// The bit contract of the correction kernels: every y[r, o] is eight
// class chains P_c (c = 0..7), each over the groups g = c (mod 8) in
// increasing g and inside a group the kept slots k = 0..keep-1, with each
// product and each sum rounded on its own (__fmul_rn, __fadd_rn: no FMA,
// no tensor cores), then ((P0 + P1) + P2) + ... + P7. The order is fixed
// by (G, keep) alone -- never by T, the row tile, the route or the
// segment layout -- so a row has the same bits alone, in a batch, on
// either route and in any segment (kernels/ref.py::correction_kernel_order
// is its CPU oracle).
//
// delta_spmm at decode (spmm_decode_kernel, up to 64 rows) and
// delta_spmm_segments (segments_decode_kernel). Bound: reading the packed
// bytes once (~2.5 us at a 4096 x 11008 site); T * nnz terms then cost
// one shared-memory gather of x each, 32 a clock an SM (~1.5 us at T = 2,
// ~6 us at T = 8 there). So both are latency-bound unless each SM keeps
// tens of KB of loads in flight and every SM has work. Design:
//  * A cluster of 8 blocks owns a (row range of at most 8 rows, tile of
//    128 columns); block c runs class chain P_c, so a cluster holds all
//    eight chains side by side and the grid has 8x the blocks of one
//    block a tile (>= 256 blocks at every full-width site, T <= 8). It
//    needs only its class's eighth of x: the rows' x columns of groups
//    c, c + 8, ... are staged once (16-byte cp.async) as a dense slab.
//  * Each of a block's 64 threads owns two adjacent columns (two
//    independent chains, 2-byte idx/code loads); a warp's lanes read one
//    group's x slab at the same kept slot, so their gathers fall in h_g
//    consecutive words (conflict-free for h_g <= 32). Each kept value is
//    decoded once per (block, column, slot) and applied to every row.
//    Two columns a thread keep wi's 688 blocks in one wave.
//  * All threads start the class's [keep, 128] idx/code rows as 16-byte
//    cp.async copies, one copy group a step: a class share up to 48 KB
//    (12 KB at wi at the 128x spec) is one step, all of it in flight from
//    the start and one barrier in all; a larger one streams through a
//    ring of 4 stages of ~12 KB, one barrier a step. Not bulk copies: a
//    128-byte row is too small for the TMA engine's fixed cost a copy.
//    Each thread copies one fixed 16-byte column of every 8th row, so
//    issuing takes no division. Shapes off the main path (rows that are
//    not 16-byte aligned, a ragged last tile) take plain loads.
//  * Wide packings (h_g above 256 with int32 idx, up to h_in: the
//    row-wise default; keep up to h_g; f32 codes): a thread reads its two
//    columns' idx as one 8-byte word, and where a group's [keep, 128]
//    tile does not fit (1.4 MB at keep = 1376 with int32 idx and f32
//    codes) a step holds a run of kc of its kept slots (a multiple of 8),
//    in slot order, so the chain and its bits are those of whole groups.
//    The slab is rt x nq x h_g floats, h_in a row at G = 1: the plan
//    lowers rt until it and the ring fit, and where one row's slab would
//    not, x is read from global memory, one row a block.
//  * G < 8 (the row-wise default, G = 1; h_g 1024 at wizard, G = 4): each
//    class holds one group, so a 128-column tile would be G blocks of 64
//    threads each walking all keep slots of its group alone (32 blocks of
//    two warps at wq, T = 8: 0.1109 ms against a 0.0051 bound on an H100).
//    Bound there: the same packed bytes, but only G chains a (row,
//    column). The narrow tile (narrow_correction, its own plan nar_plan,
//    so the G >= 8 instances are unchanged) spreads that work
//    without splitting a chain: 32 columns a tile (one a lane: 4x the
//    blocks) and a warp a row (blocks of 32 * rt threads, rt <= T), each
//    thread one (row, column) chain in slot order over the group's [keep,
//    32] tile, staged whole or in runs of kc slots as above. The cluster
//    has G blocks (a launch attribute) and the combine adds +0.0 for
//    classes G..7, as the oracle's empty chains do (a chain starts at +0.0
//    and, rounding to nearest, never sums to -0.0, so those zeros carry no
//    sign). 128 blocks of 8 warps at wq, T = 8 (one an SM: the 128 KB x
//    slab); row-wise wq / wi / MLP wo at T = 8 0.0218 / 0.0621 / 0.1001
//    ms, under torch.matmul on the dense delta (PERF.md). The segments
//    kernel takes the same tile; a segment tile has the plan's rt warps
//    whatever its length, so mixed 2-row segments gain less.
//  * The codecs' lowerings (BitDelta's 2-bit codes, LowRank's f32 values,
//    keep = h_g, idx[g, k, o] = k by construction; the host says so with
//    `dense`) take the dense-group walk (dense.cuh: dense_correction,
//    dense_spmm_kernel, dense_segments_kernel). The general walk staged
//    their idx next to the codes (45 MB of BitDelta's 56 MB at wizard wi,
//    which carry no information) and gathered x per column where every
//    column wants the same x[r, g * h_g + k]. Bound at wi, T = 8: BitDelta
//    11.3 MB of codes, ~0.003 ms, against 2 * T * h_in * O = 0.72 G FP32
//    operations, 0.0108 ms, and 0.0215 ms at the two instructions a term
//    the order allows (no FMA, no tensor cores); LowRank 180 MB, 0.054 ms
//    of bytes. Design: the same clusters of min(G, 8) blocks (one a class
//    chain), 128 columns a tile, two adjacent columns a thread and the
//    same combine, so every row has the general walk's bits; the ring
//    holds code rows only (16-byte cp.async); x of the class's groups is
//    staged as before and read as a broadcast, 16 bytes (four slots) a
//    row, so a term costs its two FP32 instructions plus a share of the
//    decode (once a (slot, column) for all the tile's rows). A class
//    share of codes up to 48 KB (BitDelta at every wizard site) is one
//    step; LowRank's 64 KB groups stream in runs of 24 slots through a
//    ring of 4 stages of 12 KB, so an SM holds several blocks. The grid
//    launches a column tile's row tiles one after the other (row tiles
//    in y, column tiles in z), so above 8 rows its codes come from L2
//    after the first. A segment's tile computes and stages only its
//    segment's rows (the R instance), so a 2-row segment pays for 2.
//    The 128-row tile reads idx either way (its windowed walk).
//  * Rows: a block computes only real rows -- the count (1..8) selects
//    an instance of the routine -- so T = 2 costs 2 rows, not a padded
//    tile; T = 9..64 takes row tiles of 8 (the last one shorter).
//  * Combine: each block writes its partial [rows][128] to its shared
//    memory; after a cluster barrier block c reads columns c * 16 .. + 15
//    of all eight partials over distributed shared memory and adds them
//    in class order. No workspace, no second pass, no atomics.
//  * Segments run in parallel: the grid's second axis enumerates the
//    segments' row tiles (each block finds its own by a warp prefix sum
//    over seg_offsets; the host bounds their count without reading the
//    device), so each block computes only its segment's rows with its
//    tenant's bytes. Empty segments get no tile; blocks past the last
//    tile leave at once. Rows that no segment covers and segments whose
//    tenant row is outside the stack are zero-filled by the blocks.
//
// delta_spmm at prefill (row tile 128, taken by ops.spmm_row_tile above
// 64 rows): the same function and the same reduction order as the decode
// route, so its rows equal the decode route's bit for bit. Bound: at the 128x spec 2 * T * nnz f32
// CUDA-core operations (~0.02 ms at wi, T = 128); but every term needs one
// 4-byte shared-memory load of x (the order forbids tensor cores and
// FMA), so 128 B/clk/SM caps it at 32 terms/clk/SM: ~0.10 ms there.
// Design: rows in lanes, not columns in lanes. A block of 512 threads
// owns CB = 8 * C columns and RB = 128 rows, in two row halves of 8
// warps; lane l of a half owns 2 consecutive rows and warp w of a half
// the C consecutive columns from w * C, so every lane of a warp works on
// the same (column, kept slot) at once: the decoded (x offset, value) of
// each is read from a shared-memory table as a broadcast, and x[r][id]
// for the lane's 2 rows is one conflict-free float2 load from x staged
// transposed, [i][r]. A first kernel writes x
// transposed and blocked by RB rows, so a row tile's slab of a group is
// contiguous; bulk copies (the TMA engine, completion on an mbarrier)
// bring each step's slabs and the raw idx/code rows of its [keep, CB]
// tiles into a ring of 3 stages; warp 0's lanes start them. The block
// walks the groups class by class (c = 0..7, g = c, c + 8, ...), up to 8
// groups of one class a step: one barrier a step, the next step's tables
// decoded while this step computes. Each thread keeps the current class
// partial in registers and folds it into a running total in shared
// memory at each class's end: P0, then ((P0 + P1) + P2) + ..., exactly
// the eight class chains and the class-order combine of the decode route.
// Columns narrow from 64 to 32 when the 64-column grid would give SMs
// fewer than 4 blocks (wq, MLP wo and wi at T = 128). A step's fixed cost
// (barrier, copies, tables) set the speed on the card, hence the many
// groups a step (PERF.md). That whole-group walk takes uint8 idx where two
// 128-row slabs of a group fit (h_g <= 64, or 128 with keep <= 41).
//
// Every other packing (int32 idx up to h_g = h_in, keep up to h_g, the
// codec lowerings' keep = h_g = 128) takes the windowed walk (win_walk in
// prefill.cuh): a step is a window of 64 consecutive x indices of one
// group, its [64][128] slab of xT one bulk copy into a ring of 4 windows.
// Bound: the same 2 * T * nnz operations and one 16-byte shared-memory
// load of x per (kept value, 4 rows); and each block reads all of x from
// L2 (32 columns a block: 344 blocks x 2 MB at wi, T = 128, ~0.25 ms of
// L2 reads on an H100, measured with everything else switched off).
// Design: warp specialised. A producer warp starts each window and the
// ring runs (8 kept slots of the block's 32 columns: idx rows, then code
// rows, padded so 16 rows of one column spread over the banks) as 16-byte
// cp.async, as far ahead as 4 windows and the ring allow, all landing on
// the window's full barrier. Each of 16 consumer warps owns 2 columns end
// to end and meets the others only at the windows' full/empty barriers,
// so warps drift instead of waiting each step for the column with the
// most slots. Per window a warp finds each column's kept slots inside it
// from its cursor (half a warp a column, a lane a slot; the in-window
// slots are a prefix because every producer sorts them, checked once per
// (group, column) as the warp enters the group), tabulates (x offset,
// value) in slot order, and applies them to its lanes' 4 rows with float4
// loads, both columns side by side. Windows go in increasing index, so a
// sorted column's chain is in slot order: the bits of
// correction_kernel_order. An unsorted column is walked in slot order
// with x from xT in global memory instead (slow, and only for data no
// producer emits). Bytes of idx and codes a block reads beyond its
// columns' own kept values: the sortedness pass over its columns' idx as
// it enters each group (once more than its own idx, from L2), plus the
// slots past a window's end that a round reads from shared memory; a run
// is copied into the ring once, and a slot whose run has not landed is
// read from global memory (none at wizard's sites: the ring holds 256
// slots at int32 idx and f32 codes, against a spread of about 100 slots
// between the block's cursors at keep 1376). At T = 128 on an H100:
// row-wise wq / wi / MLP wo 0.1326 / 0.3852 / 0.3099 ms (the decode tiles'
// 0.43 / 1.18 / 2.36 before it), h_g 1024 wi 0.3942, LowRank wi 1.9472
// (PERF.md).
//
// fused_base_delta: the TPU kernel's function, y = x @ (W + dense(delta))
// with the merged weight formed per element in f32 as (W + 0) + (0 + v),
// not a copy of its blocks. No bit contract rests on it. Bound: reading W
// once (90 MB of bf16 at a 4096 x 11008 site, ~0.027 ms) at decode; at
// T = 128 the same bytes against 2 * T * h_in * O operations on TF32
// tensor cores (495 TFLOP/s: ~0.023 ms there), three passes of which
// (3xTF32) cap the kernel at ~1/3 of that rate. Design: tensor cores with
// f32-grade accuracy. A block of 4 warps owns BM = 16, 32 or 64 rows and
// 128 columns and walks K in chunks of 32 rows: W's tile as stored (bf16
// or f32), x's tile and the raw idx/code rows of the groups the chunk
// overlaps arrive by 16-byte cp.async copies in a ring of 3 stages.
// Thread n forms column n of the merged f32 tile in shared memory (W + 0,
// then + (0 + v) at the kept rows); after a barrier the warps split x and
// the merged tile into tf32 hi/lo parts on the fly and accumulate
// lo*hi + hi*lo + hi*hi with mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32
// into per-chunk f32 registers, which are added to the running sum with
// round-to-nearest (the tensor cores' own adds truncate: over a whole K at
// h_in = 4096 the bias reached 3e-4 on the card). mma.sync, not wgmma: T
// runs from 1 to 256 and wgmma's 64-row tile would waste 32x at T = 2.
// Where the row and column tiles leave SMs idle (decode, wq, MLP wo), K
// is split over blocks into a workspace the wrapper allocates, then a
// second pass adds the splits in split order: no atomics, the same bits
// from call to call. Shapes whose rows are not 16-byte aligned take plain
// loads instead of cp.async. A wide group (h_g a multiple of 32 above it,
// raw bytes too large for the ring) holds every chunk's kept rows: a
// thread walks its column's kept slots with a cursor across the chunks,
// once it has checked they are sorted by index (every producer sorts
// them), so a block reads them about once instead of once a chunk;
// unsorted slots are scanned whole for each chunk.
//
// dequant: the dense delta, (q - z) * s placed at each kept index, 0
// elsewhere. Bound: writing h_in * O * 4 bytes (180 MB at 4096 x 11008,
// ~54 us) plus reading the packed delta. Design: a block owns a [rows, 32]
// tile of the output (rows 256 up to h_g = 256, a tile then spanning
// 256 / h_g groups; h_g up to 1024 above, so a wide group is 1 to
// h_g / 1024 tiles), assembles it in shared memory (zero, place 0 + v at
// each kept index in its rows, one barrier) and writes it out in whole
// 128-byte lines: scattering straight into the output costs a partial
// sector write a kept value in a column h_g rows tall, and one warp a
// (group, 32 columns) leaves too few warps at h_g = 256 (0.3906 ms there
// against the tile's 0.0889 at wizard wi on an H100, chip_kernel_probe.py
// --ab).
// Kept indices are distinct within a (group, column), so one thread
// writes each address; there is no reduction, so the result equals the
// plain version (a scatter-add into zeros) bit for bit.
//
// Plain C interface (loaded with ctypes). Every pointer is a device
// pointer; the kernels launch on the given stream, allocate nothing and
// return cudaGetLastError() after the launch.
//
// Sources: this file (the dequant kernel and the C interface),
// common.cuh (layout, decode, helpers, the decode plans), decode.cuh (the
// decode route) instantiated by decode_{spmm,segments}_{u8,i32}.cu,
// dense.cuh (the dense-group walk) instantiated by
// dense_{spmm,segments}.cu,
// prefill.cuh (the 128-row tile) instantiated by prefill.cu (uint8 idx,
// with the transpose and the dispatch) and prefill_i32.cu, and fused.cu:
// one translation unit each, compiled by parallel nvcc processes and
// linked into one library (kernels/delta_spmm.py::build).

#include "common.cuh"

namespace dq {

// most rows of the tile a dequant block assembles in shared memory
// (128 KB)
constexpr int kDequantTileRows = 1024;

// (group, slot) pairs a dequant warp loads before it places them
constexpr int kDequantBatch = 8;

// the tile's rows for groups of h_g rows in a matrix of h_in
inline int dequant_tile_rows(int h_g, int h_in) {
  return std::min(h_g <= 256 ? 256 : std::min(h_g, kDequantTileRows), h_in);
}

// block (x, y) owns rows [x * tile_rows, + tile_rows) of the output and
// 32 columns from y * 32: it zero-fills the tile in shared memory, places
// 0 + v at each kept index of the groups it meets that falls in its rows
// (warp w the (group, slot) pairs w, w + 8, ..., lane the column), then
// writes the tile out a row a warp at a time
__global__ void __launch_bounds__(kThreads)
dequant_kernel(Delta d, Shape s, int tile_rows, float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];  // [rows][kCols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, s.h_in - i0);
  const int o = blockIdx.y * kCols + lane;
  for (int e = threadIdx.x; e < rows * kCols; e += kThreads) tile[e] = 0.f;
  __syncthreads();
  if (o < s.O) {
    const Decode dc = decode_consts(d, s);
    const int g0 = i0 / s.h_g, n = ((i0 + rows - 1) / s.h_g - g0 + 1) * s.keep;
    // pair j is slot k = j % keep of group g0 + j / keep, kept as a
    // running (q, k). A warp takes kDequantBatch pairs at a time: their
    // (group, slot), then all their idx loads, then the codes of those
    // that fall in the tile's rows (each tile of a wide group sees all
    // its slots, a quarter of them its own at h_g = 4096), then the
    // stores: straight-line rounds of loads, so a warp has that many in
    // flight
    int q = warp / s.keep, k = warp - q * s.keep;
    for (int j = warp; j < n; j += kDequantBatch * kWarps) {
      int gs[kDequantBatch], ks[kDequantBatch];
      unsigned r[kDequantBatch];
#pragma unroll
      for (int u = 0; u < kDequantBatch; ++u) {
        gs[u] = j + u * kWarps < n ? g0 + q : -1;
        ks[u] = k;
        for (k += kWarps; k >= s.keep; k -= s.keep) ++q;
      }
#pragma unroll
      for (int u = 0; u < kDequantBatch; ++u)
        r[u] = gs[u] >= 0
                   ? load_idx(d, s, (static_cast<size_t>(gs[u]) * s.keep + ks[u]) * s.O + o)
                   : ~0u;
      float v[kDequantBatch];
#pragma unroll
      for (int u = 0; u < kDequantBatch; ++u) {
        // a kept index past h_g places nothing
        r[u] = r[u] < static_cast<unsigned>(s.h_g) ? static_cast<unsigned>(gs[u] * s.h_g - i0) + r[u]
                                                    : ~0u;
        v[u] = r[u] < static_cast<unsigned>(rows) ? decode_value(d, s, dc, gs[u], ks[u], o) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kDequantBatch; ++u)
        if (r[u] < static_cast<unsigned>(rows)) tile[r[u] * kCols + lane] = __fadd_rn(0.f, v[u]);
    }
  }
  __syncthreads();
  if (o < s.O)
    for (int r = warp; r < rows; r += kWarps)
      out[(static_cast<size_t>(i0) + r) * s.O + o] = tile[r * kCols + lane];
}

}  // namespace dq

using namespace dq;

extern "C" {

// x: [T, h_in] f32; idx [G, keep, O] uint8 (idx_bytes = 1) or int32
// (idx_bytes = 4); codes [G, kp, O] uint8 or f32 [G, keep, O] (wbits =
// 0); scale f32 and zero int32 device scalars; y [T, O] f32. Row tiles 1,
// 2, 4 and 8 take the decode kernel (tb caps the rows a block computes),
// 128 the prefill kernel (same bits; every packing,
// delta_spmm_prefill_ok), which needs xT: f32 scratch of h_in * Tp
// elements, Tp = T rounded up to 128 (unused for the other tiles).
// dense = 1 says that every group keeps all h_g slots with idx[g, k, o] =
// k (the codecs' lowerings; keep must equal h_g): the decode tiles then
// take the dense-group walk, which reads no idx (same bits); the 128-row
// tile reads idx either way.
int delta_spmm_launch(const void* x, const void* idx,
                      const void* codes, const void* scale, const void* zero,
                      void* y, void* xT, int T, int h_in, int O, int h_g, int keep, int kp,
                      int wbits, int idx_bytes, int tb, int dense, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits, idx_bytes};
  const bool prefill = tb == kPrefillRows;
  if (!shape_ok(s) || (dense && keep != h_g) ||
      (prefill ? !prefill_fits(tb, h_g, keep) : !dec_tile(tb)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  const float* xp = static_cast<const float*>(x);
  if (prefill && xT == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (prefill) return static_cast<int>(launch_prefill(xp, static_cast<float*>(xT), d, s, yp, st));
  if (dense) return static_cast<int>(launch_dense_decode(xp, d, s, yp, tb, st));
  return static_cast<int>(idx_bytes == 1 ? launch_spmm_decode_u8(xp, d, s, yp, tb, st)
                                         : launch_spmm_decode_i32(xp, d, s, yp, tb, st));
}

// 1 where delta_spmm_launch takes row tile tb (128) on its prefill kernel
// for groups of h_g rows with keep kept values: every packing (1 <= keep
// <= h_g), the whole-group walk where it fits, the windowed walk else.
int delta_spmm_prefill_ok(int tb, int h_g, int keep) {
  return prefill_fits(tb, h_g, keep) ? 1 : 0;
}

// The decode route's plan (delta_spmm at row tile tb, and the segments
// kernel) for one matrix, dense as for delta_spmm_launch: out[0..9] =
// groups a step holds, kept slots a step holds of each, ring depth, rows
// a block computes at most, dynamic shared memory bytes, steps a class's
// chain takes at most, whether x is read from global memory, blocks a
// cluster, columns a tile (128, or 32 for the narrow tile at G < 8), the
// walk (0 the general walk, 1 the narrow tile, 2 the dense-group walk).
// 1 where the packing is one the kernels take (a plan then always
// exists), 0 otherwise. Host only: launches nothing.
int delta_spmm_decode_plan(int h_in, int O, int h_g, int keep, int kp, int wbits,
                           int idx_bytes, int tb, int dense, int* out) {
  const Shape s{tb, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits, idx_bytes};
  DecPlan p;
  if (!shape_ok(s) || !dec_tile(tb) || (dense ? !dense_plan(s, tb, p) : !dec_plan(s, tb, p)))
    return 0;
  const int nq = class_count(0, s.G), nch = (keep + p.kc - 1) / p.kc;
  out[0] = p.sg;
  out[1] = p.kc;
  out[2] = p.ns;
  out[3] = p.rt;
  out[4] = static_cast<int>(dense ? dense_smem_bytes(s, p) : dec_smem_bytes(s, p));
  out[5] = nch == 1 ? (nq + p.sg - 1) / p.sg : nq * nch;
  out[6] = p.xg;
  out[7] = p.cb;
  out[8] = p.nc;
  out[9] = dense ? 2 : p.nc == kNarCols ? 1 : 0;
  return 1;
}

// As delta_spmm_launch, with a tenant-stacked delta: idx [R, G, keep, O],
// codes [R, G, kp, O] (or f32 [R, G, keep, O]), scale/zero [R], each
// tenant's block contiguous and the tenant axis strided by idx_stride /
// codes_stride bytes and scale_stride / zero_stride elements; seg_rows
// [n_seg] int32 tenant row per segment, seg_offsets [n_seg + 1] int32
// half-open row ranges over the tenant-sorted rows of x. Every row of y
// is written: rows no segment covers, and rows of a segment whose
// tenant row is outside [0, R), are zero. seg_offsets must be
// non-decreasing; tb (1, 2, 4 or 8) caps the rows a block computes;
// dense as for delta_spmm_launch (every tenant's groups dense).
int delta_spmm_segments_launch(const void* x, const void* idx,
                               const void* codes, const void* scale,
                               const void* zero, int n_tenants, long long idx_stride,
                               long long codes_stride, long long scale_stride,
                               long long zero_stride, const void* seg_rows,
                               const void* seg_offsets, int n_seg, void* y, int T,
                               int h_in, int O, int h_g, int keep, int kp,
                               int wbits, int idx_bytes, int tb, int dense, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits, idx_bytes};
  if (!shape_ok(s) || !dec_tile(tb) || n_seg < 1 || n_tenants < 1 || idx_stride < 0 ||
      codes_stride < 0 || scale_stride < 0 || zero_stride < 0 || (dense && keep != h_g))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides strides{static_cast<size_t>(idx_stride), static_cast<size_t>(codes_stride),
                        static_cast<size_t>(scale_stride), static_cast<size_t>(zero_stride)};
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  const float* xp = static_cast<const float*>(x);
  const int* sr = static_cast<const int*>(seg_rows);
  const int* so = static_cast<const int*>(seg_offsets);
  if (dense)
    return static_cast<int>(
        launch_dense_segments(xp, d, s, strides, n_tenants, sr, so, n_seg, yp, tb, st));
  return static_cast<int>(
      idx_bytes == 1
          ? launch_segments_u8(xp, d, s, strides, n_tenants, sr, so, n_seg, yp, tb, st)
          : launch_segments_i32(xp, d, s, strides, n_tenants, sr, so, n_seg, yp, tb, st));
}

// How many K splits fused_base_delta_launch takes for this shape: the
// caller allocates the workspace [splits, T, O] f32 when it is above 1.
int fused_base_delta_splits(int T, int h_in, int O, int tb) {
  return T > 0 && O > 0 && h_in > 0 ? fused_splits_for(T, h_in, O, tb) : 0;
}

// x [T, h_in] f32; w [h_in, O] bf16 (w_bf16 = 1) or f32 (w_bf16 = 0); the
// packed delta as for delta_spmm_launch; y [T, O] f32 = x @ (w + dense);
// ws [splits, T, O] f32 scratch when splits > 1 (else unused), splits as
// fused_base_delta_splits gives it; tb 8, 16 or 32 caps the row tile
// (fused_bm).
int fused_base_delta_launch(const void* x, const void* w, int w_bf16, const void* idx,
                            const void* codes, const void* scale, const void* zero,
                            void* y, void* ws, int splits, int T, int h_in, int O, int h_g,
                            int keep, int kp, int wbits, int idx_bytes, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits, idx_bytes};
  if ((tb != 8 && tb != 16 && tb != 32) || !shape_ok(s) ||
      splits != fused_splits_for(T, h_in, O, tb) || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* wsp = static_cast<float*>(ws);
  return static_cast<int>(launch_fused_any(xp, w, w_bf16, d, s, yp, wsp, splits, tb, st));
}

// The packed delta as for delta_spmm_launch -> out [h_in, O] f32, every
// element written.
int dequant_launch(const void* idx, const void* codes, const void* scale,
                   const void* zero, void* out, int h_in, int O, int h_g, int keep,
                   int kp, int wbits, int idx_bytes, void* stream) {
  const Shape s{1, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits, idx_bytes};
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = dequant_tile_rows(s.h_g, s.h_in);
  const size_t smem = static_cast<size_t>(rows) * kCols * sizeof(float);
  const cudaError_t err = allow_smem(dequant_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.h_in + rows - 1) / rows, (s.O + kCols - 1) / kCols);
  dequant_kernel<<<grid, kThreads, smem, st>>>(d, s, rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
