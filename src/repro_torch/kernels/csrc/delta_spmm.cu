// DeltaDQ delta kernels for Hopper (sm_90a).
//
// Four kernels; the two correction kernels share one device routine
// (cluster_correction), and all four share the code decode (decode_value,
// decode_raw):
//
//   delta_spmm           y[T, O] = x[T, h_in] @ dequant(delta)
//                        replaces repro/kernels/delta_spmm.py:122
//                        delta_spmm_kernel (body _spmm_body, :108);
//                        spmm_decode_kernel up to 64 rows,
//                        spmm_prefill_kernel (same bits) above
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
// slot k, output column o), a uint8 local index idx[g, k, o] < h_g and a
// k-bit code packed LSB-first along k at a physical width w in {1,2,4,8}
// (codes[g, k / (8/w), o]); the value is (q - zero) * scale. With
// k_bits = None the codes are raw f32 values [G, keep, O].
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
//    not 16-byte aligned, a ragged last tile, f32 codes) take plain loads.
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
// groups a step (PERF.md).
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
// loads instead of cp.async.
//
// dequant: the dense delta, (q - z) * s placed at each kept index, 0
// elsewhere. Bound: writing h_in * O * 4 bytes (180 MB at 4096 x 11008,
// ~54 us) plus reading the packed delta. Design: each warp owns one
// (group, 32-column) tile; each lane zero-fills its column's h_g rows of
// the output, then writes 0 + v at each kept row (the plain version's
// scatter-add into zeros, bit for bit). Kept indices are distinct within
// a (group, column) and one thread writes both stores of an address, so
// no atomics and no barrier; there is no reduction, so the result equals
// the plain version bit for bit.
//
// Plain C interface (loaded with ctypes). Every pointer is a device
// pointer; the kernels launch on the given stream, allocate nothing and
// return cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;              // class chains; warps of a prefill row half
constexpr int kThreads = kWarps * 32;  // threads per block (dequant, prefill row half)
constexpr int kCols = 32;              // output columns per dequant block (one per lane)
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a block may opt into

struct Delta {
  const uint8_t* idx;    // [G, keep, O]
  const uint8_t* codes;  // [G, Kp, O] uint8, or f32 [G, keep, O] when wbits == 0
  const float* scale;    // this matrix's scale
  const int* zero;       // this matrix's zero point
};

struct Shape {
  int T, h_in, O, G, h_g, keep, kp, wbits;
};

// Tenant-axis strides of a stacked delta: idx and codes in bytes, scale
// and zero in elements. A layer slice of a [R, L, ...] stack is strided
// along R; each tenant's [G, keep|kp, O] block must be contiguous.
struct Strides {
  size_t idx, codes, scale, zero;
};

// The per-matrix constants of the code decode.
struct Decode {
  float scale, zf;  // scale, zero point as f32
  int per;          // codes per byte
  unsigned mask;    // one code's bits
};

__device__ __forceinline__ Decode decode_consts(const Delta& d, const Shape& s) {
  return {*d.scale, static_cast<float>(*d.zero), s.wbits ? 8 / s.wbits : 1,
          s.wbits ? (1u << s.wbits) - 1u : 0u};
}

// Kept value k of group g in column o: (q - zero) * scale with explicit
// round-to-nearest (the plain version's subtract, then multiply), or the
// raw f32 value when wbits == 0.
__device__ __forceinline__ float decode_value(const Delta& d, const Shape& s,
                                              const Decode& c, int g, int k, int o) {
  if (s.wbits == 0)
    return reinterpret_cast<const float*>(d.codes)[
        (static_cast<size_t>(g) * s.keep + k) * s.O + o];
  const unsigned byte = d.codes[(static_cast<size_t>(g) * s.kp + k / c.per) * s.O + o];
  const unsigned q = (byte >> ((k % c.per) * s.wbits)) & c.mask;
  return __fmul_rn(__fsub_rn(static_cast<float>(q), c.zf), c.scale);
}

// ---------------------------------------------------------------------------
// Shared helpers of the two redesigned kernels
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier and bulk-copy (TMA engine) helpers: one thread arms a barrier
// with the bytes a stage expects, starts the copies, and every thread
// waits for the barrier's phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy reads of a buffer before async-proxy (bulk copy) writes to it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) -> shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0..6) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// The raw code word of kept value k of group g in column o: the packed
// byte, or the f32 value's bits when wbits == 0.
__device__ __forceinline__ unsigned load_code(const Delta& d, const Shape& s,
                                              const Decode& c, int g, int k, int o) {
  if (s.wbits == 0)
    return __float_as_uint(reinterpret_cast<const float*>(d.codes)[
        (static_cast<size_t>(g) * s.keep + k) * s.O + o]);
  return d.codes[(static_cast<size_t>(g) * s.kp + k / c.per) * s.O + o];
}

// decode_value's arithmetic on a code word already loaded (same bits)
// float(q) for q < 2^23, exactly, without the conversion unit: the bits
// of 2^23 + q, minus 2^23 (full-rate integer and f32 operations)
__device__ __forceinline__ float small_u2f(unsigned q) {
  return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.f);
}

__device__ __forceinline__ float decode_raw(const Shape& s, const Decode& c,
                                            unsigned raw, int k) {
  if (s.wbits == 0) return __uint_as_float(raw);
  const unsigned q = (raw >> ((k & (c.per - 1)) * s.wbits)) & c.mask;
  return __fmul_rn(__fsub_rn(small_u2f(q), c.zf), c.scale);
}

// groups of class c (g = c, c + 8, ...) among G
__host__ __device__ __forceinline__ int class_count(int c, int G) {
  return c < G ? (G - c + kWarps - 1) / kWarps : 0;
}

// ---------------------------------------------------------------------------
// delta_spmm at decode and delta_spmm_segments: one cluster of 8 blocks a
// (row range, column tile), block c running class chain P_c (see the note
// at the top)
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 64;                     // two adjacent output columns a thread
constexpr int kDecCols = 2 * kDecThreads;           // columns of a tile
constexpr int kDecMaxRows = 8;                      // rows a block computes at most
constexpr int kDecCombineCols = kDecCols / kWarps;  // columns each block of a cluster writes
constexpr int kDecStages = 4;                       // ring depth for a large class share
constexpr size_t kDecShareMax = 48 * 1024;          // a class share this small is one step
constexpr size_t kDecStageBytes = 12 * 1024;        // else a ring of stages about this large

// The launch plan of a decode tile: groups a step holds (sg), ring depth
// (ns), rows a block computes at most (rt), whether the idx/code rows of
// full tiles ride 16-byte cp.async (vec: 1-byte codes in 16-byte aligned
// rows) and whether x does (xvec).
struct DecPlan {
  int sg, ns, rt, vec, xvec;
};

// raw bytes of one group's [keep, kDecCols] tile: idx rows, then code rows
__host__ __device__ __forceinline__ int dec_group_bytes(const Shape& s) {
  const int code_bytes = s.wbits ? s.kp * kDecCols : s.keep * kDecCols * 4;
  return (s.keep * kDecCols + code_bytes + 15) / 16 * 16;
}

// Shared memory: the ring [ns][sg groups], the class's x slab
// [rt][nq * h_g] f32 and the class partial [rt][kDecCols] f32.
size_t dec_smem_bytes(const Shape& s, int sg, int ns, int rt) {
  const size_t nq = class_count(0, s.G);
  return static_cast<size_t>(ns) * sg * dec_group_bytes(s) +
         static_cast<size_t>(rt) * nq * s.h_g * sizeof(float) +
         static_cast<size_t>(rt) * kDecCols * sizeof(float);
}

// The largest row tile <= tb (at most 8) whose stages fit: a class share of
// at most kDecShareMax bytes is staged whole as one step (one wait, one
// barrier; splitting it into 4 or 8 steps measured slower on the card), a
// larger one streams through a ring of kDecStages (or 2) stages of about
// kDecStageBytes.
bool dec_plan(const Shape& s, int tb, DecPlan& p) {
  const int nq = class_count(0, s.G);
  const size_t gb = dec_group_bytes(s);
  int sg, ns;
  if (nq * gb <= kDecShareMax) {
    sg = nq;
    ns = 1;
  } else {
    sg = std::max<int>(1, static_cast<int>(kDecStageBytes / gb));
    ns = kDecStages;
  }
  for (int rt = std::min(tb, kDecMaxRows); rt >= 1; rt /= 2)
    for (int n = ns; n >= std::min(ns, 2); n /= 2)
      if (dec_smem_bytes(s, sg, n, rt) <= kSmemMax) {
        p.sg = sg;
        p.ns = n;
        p.rt = rt;
        return true;
      }
  return false;
}

// Rows [row0, row0 + R) x columns [col0, col0 + kDecCols) of x @
// dequant(d). Called by all 8 blocks of a cluster with the same arguments
// (it synchronises the cluster). Block c (its rank) stages x's columns of
// the groups of class c and streams their [keep, kDecCols] idx/code tiles,
// each thread running P_c of its two columns for the R rows; then block c
// writes columns c * 16 .. c * 16 + 15 of the tile as ((P0 + P1) + ...) +
// P7, reading the other blocks' partials from their shared memory.
template <int R>
__device__ void cluster_correction(const float* __restrict__ x, const Delta& d,
                                   const Shape& s, const DecPlan& p, int row0, int col0,
                                   float* __restrict__ y, unsigned char* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int keep = s.keep, h_g = s.h_g;
  const int nq = class_count(c, s.G);  // this class's groups
  const int SW = nq * h_g;             // x slab row stride
  const int gb = dec_group_bytes(s);
  const int stage_n = p.sg * gb;
  const int ncol = min(kDecCols, s.O - col0);
  const int code_rows = s.wbits ? s.kp : keep;
  const int nsteps = (nq + p.sg - 1) / p.sg;
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(ring + p.ns * stage_n);
  float* part = slab + p.rt * class_count(0, s.G) * h_g;
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;  // codes per byte is a power of two

  // step n (groups q0 .. q0 + ng - 1 of the class) -> stage n % ns, one
  // cp.async group a step: 16-byte copies spread over all threads for a
  // full tile of 1-byte codes in 16-byte aligned rows, else plain loads
  // by each thread of its own columns (zero past O)
  auto issue = [&](int n) {
    if (n < nsteps) {
      unsigned char* st = ring + (n % p.ns) * stage_n;
      const int q0 = n * p.sg, ng = min(p.sg, nq - q0);
      if (p.vec && ncol == kDecCols) {
        // every row is 8 chunks, so thread t copies chunk t % 8 of the
        // step's rows t / 8, t / 8 + 8, ...: no division a copy, since
        // issuing the copies is a large share of a decode call
        const int rpg = keep + code_rows, v = tid & 7;
        int qq = (tid >> 3) / rpg, rr = (tid >> 3) - qq * rpg;
        while (qq < ng) {
          const size_t g = c + kWarps * (q0 + qq);
          const unsigned char* src = rr < keep ? d.idx + (g * keep + rr) * s.O
                                               : d.codes + (g * code_rows + rr - keep) * s.O;
          cp_async16(st + qq * gb + rr * kDecCols + v * 16, src + col0 + v * 16, 16);
          for (rr += kDecThreads / 8; rr >= rpg; rr -= rpg) ++qq;
        }
      } else {
        for (int j = 2 * tid; j < 2 * tid + 2; ++j) {
          const bool live = j < ncol;
          const size_t o = col0 + j;
          for (int qq = 0; qq < ng; ++qq) {
            const size_t g = c + kWarps * (q0 + qq);
            unsigned char* gs = st + qq * gb;
            for (int k = 0; k < keep; ++k)
              gs[k * kDecCols + j] = live ? d.idx[(g * keep + k) * s.O + o] : 0;
            for (int r = 0; r < code_rows; ++r) {
              if (s.wbits)
                gs[(keep + r) * kDecCols + j] =
                    live ? d.codes[(g * code_rows + r) * s.O + o] : 0;
              else
                reinterpret_cast<float*>(gs + keep * kDecCols)[r * kDecCols + j] =
                    live ? reinterpret_cast<const float*>(d.codes)[(g * keep + r) * s.O + o]
                         : 0.f;
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  // x[row0 + r][g * h_g + i] of the class's groups -> slab[r][q * h_g + i]
  // (the first cp.async group), then every stage, all free at the start;
  // a later step goes into the stage that the step before it freed
  if (p.xvec) {
    // 16-byte chunk e of a slab row: group q = e / v4, chunk e % v4 of it
    // (a shift where h_g is a power of two)
    const int v4 = h_g / 4, lv = (v4 & (v4 - 1)) ? -1 : __ffs(v4) - 1;
    for (int r = 0; r < R; ++r)
      for (int e = tid; e < nq * v4; e += kDecThreads) {
        const int q = lv >= 0 ? e >> lv : e / v4, i4 = e - q * v4;
        cp_async16(slab + r * SW + q * h_g + i4 * 4,
                   x + static_cast<size_t>(row0 + r) * s.h_in +
                       static_cast<size_t>(c + kWarps * q) * h_g + i4 * 4,
                   16);
      }
  } else {
    for (int e = tid; e < R * SW; e += kDecThreads) {
      const int r = e / SW, rem = e - r * SW;
      const int q = rem / h_g, i = rem - q * h_g;
      slab[e] = x[static_cast<size_t>(row0 + r) * s.h_in +
                  static_cast<size_t>(c + kWarps * q) * h_g + i];
    }
  }
  cp_async_commit();
  for (int n = 0; n < p.ns; ++n) issue(n);
  int committed = 1 + p.ns;  // cp.async groups: the slab, then one a step

  float acc[2][R];  // columns 2 tid and 2 tid + 1
#pragma unroll
  for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.f;
  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait(max(committed - (n + 2), 0));  // the slab and steps <= n
    __syncthreads();  // step n and the slab are in for all; step n - 1 is done
    if (n > 0) {
      issue(n + p.ns - 1);
      ++committed;
    }
    if (2 * tid < ncol) {
      const unsigned char* st = ring + (n % p.ns) * stage_n;
      const int q0 = n * p.sg, nterms = min(p.sg, nq - q0) * keep;
      // P_c: the class's groups in increasing g, each group's kept slots
      // in order, one rounded product and one rounded sum a term
      int qq = 0, k = 0;
#pragma unroll 4
      for (int j = 0; j < nterms; ++j) {
        const unsigned char* gs = st + qq * gb;
        const unsigned ids = *reinterpret_cast<const unsigned short*>(gs + k * kDecCols + 2 * tid);
        unsigned raw0, raw1;
        if (s.wbits) {
          const unsigned cw = *reinterpret_cast<const unsigned short*>(
              gs + (keep + (k >> pshift)) * kDecCols + 2 * tid);
          raw0 = cw & 0xffu;
          raw1 = cw >> 8;
        } else {
          const uint2 cw = *reinterpret_cast<const uint2*>(gs + keep * kDecCols +
                                                           k * kDecCols * 4 + 8 * tid);
          raw0 = cw.x;
          raw1 = cw.y;
        }
        const float v0 = decode_raw(s, dc, raw0, k), v1 = decode_raw(s, dc, raw1, k);
        const float* xq = slab + (q0 + qq) * h_g;
        const float* x0 = xq + (ids & 0xffu);
        const float* x1 = xq + (ids >> 8);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[0][r] = __fadd_rn(acc[0][r], __fmul_rn(x0[r * SW], v0));
          acc[1][r] = __fadd_rn(acc[1][r], __fmul_rn(x1[r * SW], v1));
        }
        if (++k == keep) {
          k = 0;
          ++qq;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float2*>(part + r * kDecCols + 2 * tid) = make_float2(acc[0][r], acc[1][r]);
  cluster.sync();  // every class partial of the tile is in
  for (int e = tid; e < R * kDecCombineCols; e += kDecThreads) {
    const int r = e / kDecCombineCols;
    const int cc = c * kDecCombineCols + e % kDecCombineCols;
    if (col0 + cc < s.O) {
      float t = cluster.map_shared_rank(part, 0)[r * kDecCols + cc];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        t = __fadd_rn(t, cluster.map_shared_rank(part, w)[r * kDecCols + cc]);
      y[static_cast<size_t>(row0 + r) * s.O + col0 + cc] = t;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// cluster_correction at R = rows (1..8), one instance per count, so a
// block computes only real rows
__device__ __forceinline__ void rows_correction(int rows, const float* x, const Delta& d,
                                                const Shape& s, const DecPlan& p, int row0,
                                                int col0, float* y, unsigned char* smem) {
  switch (rows) {
    case 1: cluster_correction<1>(x, d, s, p, row0, col0, y, smem); break;
    case 2: cluster_correction<2>(x, d, s, p, row0, col0, y, smem); break;
    case 3: cluster_correction<3>(x, d, s, p, row0, col0, y, smem); break;
    case 4: cluster_correction<4>(x, d, s, p, row0, col0, y, smem); break;
    case 5: cluster_correction<5>(x, d, s, p, row0, col0, y, smem); break;
    case 6: cluster_correction<6>(x, d, s, p, row0, col0, y, smem); break;
    case 7: cluster_correction<7>(x, d, s, p, row0, col0, y, smem); break;
    default: cluster_correction<8>(x, d, s, p, row0, col0, y, smem); break;
  }
}

// grid (8 * column tiles, row tiles of p.rt rows); the last row tile holds
// what is left of T. __maxnreg__: left to itself ptxas took 64 registers
// and spilled in the 8-row instance.
__global__ void __cluster_dims__(kWarps, 1, 1) __maxnreg__(128)
spmm_decode_kernel(const float* __restrict__ x, Delta d, Shape s, DecPlan p,
                   float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int row0 = blockIdx.y * p.rt;
  rows_correction(min(p.rt, s.T - row0), x, d, s, p, row0, (blockIdx.x / kWarps) * kDecCols,
                  y, dsmem);
}

// Rows [r0, r1) x this cluster block's kDecCombineCols columns of the tile
// at col0 <- 0.
__device__ __forceinline__ void zero_rows(float* __restrict__ y, const Shape& s, int r0,
                                          int r1, int col0) {
  const int c = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  for (int e = threadIdx.x; e < (r1 - r0) * kDecCombineCols; e += kDecThreads) {
    const int o = col0 + c * kDecCombineCols + e % kDecCombineCols;
    if (o < s.O) y[static_cast<size_t>(r0 + e / kDecCombineCols) * s.O + o] = 0.f;
  }
}

// grid (8 * column tiles, tiles + 1): blockIdx.y enumerates the row tiles
// of the segments in segment order, each tile p.rt rows from its
// segment's start (gridDim.y - 1 bounds their count from above; the
// blocks past the last tile leave at once). The last y zero-fills the
// rows before the first segment and after the last; a segment whose
// tenant row lies outside the stack is zero-filled by its own tiles.
// seg_offsets must be non-decreasing (tenant_segments' layout).
__global__ void __cluster_dims__(kWarps, 1, 1) __maxnreg__(128)
segments_decode_kernel(const float* __restrict__ x, Delta stack, Shape s, Strides st,
                       int n_tenants, const int* __restrict__ seg_rows,
                       const int* __restrict__ seg_offsets, int n_seg, DecPlan p,
                       float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int col0 = (blockIdx.x / kWarps) * kDecCols;
  auto offset = [&](int i) { return min(max(seg_offsets[i], 0), s.T); };
  if (blockIdx.y == gridDim.y - 1) {
    zero_rows(y, s, 0, offset(0), col0);
    zero_rows(y, s, max(offset(0), offset(n_seg)), s.T, col0);
    return;
  }
  // the segment of tile blockIdx.y: each warp scans the segments 32 at a
  // time (a prefix sum of their tile counts), all warps alike
  const int lane = threadIdx.x & 31;
  int want = blockIdx.y, seg = -1, tile = 0;
  for (int base = 0; base < n_seg && seg < 0; base += 32) {
    const int i = base + lane;
    const int n_tiles = i < n_seg ? (max(offset(i + 1) - offset(i), 0) + p.rt - 1) / p.rt : 0;
    int incl = n_tiles;
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, sh);
      if (lane >= sh) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (want < total) {
      const int f = __ffs(__ballot_sync(0xffffffffu, incl > want)) - 1;
      seg = base + f;
      tile = want - (__shfl_sync(0xffffffffu, incl, f) - __shfl_sync(0xffffffffu, n_tiles, f));
    } else {
      want -= total;
    }
  }
  if (seg < 0) return;  // past the last tile: the whole cluster leaves
  const int row0 = offset(seg) + tile * p.rt;
  const int rows = min(p.rt, offset(seg + 1) - row0);
  const int t = seg_rows[seg];
  if (t < 0 || t >= n_tenants) {
    zero_rows(y, s, row0, row0 + rows, col0);
    return;
  }
  const Delta d{stack.idx + t * st.idx, stack.codes + t * st.codes, stack.scale + t * st.scale,
                stack.zero + t * st.zero};
  rows_correction(rows, x, d, s, p, row0, col0, y, dsmem);
}

// ---------------------------------------------------------------------------
// delta_spmm at prefill: rows in lanes (see the note at the top)
// ---------------------------------------------------------------------------

// Raw idx/code bytes of a [rows, width] tile of a [.., O] byte array (or
// f32 array, elem = 4), row r0.., columns c0.. -> smem rows of width *
// elem bytes. 16-byte cp.async where `vec` (O * elem and the base pointer
// 16-byte aligned, width * elem a multiple of 16), else plain loads.
// Columns past O read as 0.
__device__ __forceinline__ void stage_bytes(unsigned char* dst, const unsigned char* src,
                                            int rows, size_t row0, int c0, int width,
                                            int O, int elem, bool vec, int tid, int nthreads) {
  const int wb = width * elem;
  if (vec) {
    const int vpr = wb / 16;
    for (int v = tid; v < rows * vpr; v += nthreads) {
      const int r = v / vpr, cv = v - r * vpr;
      const int col = c0 + cv * (16 / elem);
      const bool ok = col < O;
      cp_async16(dst + r * wb + cv * 16,
                 src + (ok ? ((row0 + r) * O + col) * elem : 0), ok ? 16 : 0);
    }
  } else {
    for (int v = tid; v < rows * wb; v += nthreads) {
      const int r = v / wb, cb = v - r * wb;
      const int col = c0 + cb / elem;
      dst[v] = col < O ? src[((row0 + r) * O + col) * elem + cb % elem] : 0;
    }
  }
}

constexpr int kPrefillMaxGroups = 8;  // groups of one class a step may hold
constexpr int kPrefillRows = 128;     // the prefill kernel's row tile
constexpr int kPrefillThreads = 2 * kThreads;  // two row halves of 8 warps, 2 rows a lane

// Shared memory of the prefill kernel: per stage sg x slabs [h_g][rb] f32
// and their raw idx + codes (at most 5 bytes a kept value) and its
// barrier, two tables of sg [keep][cb] (offset, value) entries, and the
// running totals [rb][cb] f32.
size_t prefill_stage_bytes(int rb, int cb, int h_g, int keep, int sg) {
  return static_cast<size_t>(sg) * (static_cast<size_t>(h_g) * rb * sizeof(float) +
                                    (static_cast<size_t>(keep) * cb * 5 + 15) / 16 * 16);
}

size_t prefill_smem_bytes(int rb, int cb, int h_g, int keep, int sg, int stages) {
  return stages * (prefill_stage_bytes(rb, cb, h_g, keep, sg) + sizeof(uint64_t)) +
         2 * static_cast<size_t>(sg) * keep * cb * sizeof(int2) +
         static_cast<size_t>(rb) * cb * sizeof(float);
}

// xT = x^T blocked by row tile: xT[t / rb][i][t % rb] = x[t][i], rows
// t >= T zero, so a row tile's slab of a group is contiguous. 32 x 32
// tiles through shared memory.
__global__ void transpose_pad_kernel(const float* __restrict__ x, int T, int h_in, int Tp,
                                     int rb, float* __restrict__ xT) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.x * 32, t0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int t = t0 + r, i = i0 + threadIdx.x;
    tile[r][threadIdx.x] = t < T && i < h_in ? x[static_cast<size_t>(t) * h_in + i] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int i = i0 + r, t = t0 + threadIdx.x;
    if (i < h_in && t < Tp)
      xT[(static_cast<size_t>(t / rb) * h_in + i) * rb + t % rb] = tile[threadIdx.x][r];
  }
}

__device__ __forceinline__ void prefill_terms(float (&part)[2], const float* xp, float v) {
  const float2 xv = *reinterpret_cast<const float2*>(xp);
  part[0] = __fadd_rn(part[0], __fmul_rn(xv.x, v));
  part[1] = __fadd_rn(part[1], __fmul_rn(xv.y, v));
}

// A step of the class-major walk: class c, groups c + 8 j for j in
// [j0, j0 + ng). Each class's groups are split into steps of at most sg.
struct Step {
  int c, j0, ng;
};

__device__ __forceinline__ Step first_step(int G, int sg) {
  return {0, 0, min(sg, class_count(0, G))};
}

// the step after t; past the last step, ng = 0
__device__ __forceinline__ Step next_step(Step t, int G, int sg) {
  if (t.ng == 0) return t;
  int c = t.c, j0 = t.j0 + t.ng;
  if (j0 >= class_count(c, G)) {
    ++c;
    j0 = 0;
  }
  const int left = c < kWarps ? class_count(c, G) - j0 : 0;
  return {c, j0, left < sg ? left : sg};
}

// xT: x transposed and blocked by RB rows (transpose_pad_kernel), Tp =
// gridDim.x * RB; vec: the idx/codes rows of a tile are 16-byte aligned
// and ride the bulk copies, else the tables read them from global memory;
// sg: groups a step holds; stages: ring depth (2 builds each step's table
// behind a second barrier, 3 builds it a step ahead).
template <int C>
__global__ void __launch_bounds__(kPrefillThreads, 1)
spmm_prefill_kernel(const float* __restrict__ xT, int Tp, Delta d, Shape s, int sg,
                    int stages, int vec, float* __restrict__ y) {
  static_assert(C % 2 == 0, "table entries are read in pairs");
  constexpr int NT = kPrefillThreads, RB = kPrefillRows, RPL = 2;  // RPL rows a lane
  static_assert(RB == 32 * RPL * (NT / kThreads), "lanes cover the row tile");
  constexpr int CB = kWarps * C;
  extern __shared__ __align__(16) float psmem[];
  const int G = s.G, keep = s.keep;
  const int xs_floats = s.h_g * RB;                      // one group's x slab
  const int raw_bytes = (keep * CB * 5 + 15) / 16 * 16;  // one group's raw bytes
  const int idx_bytes = keep * CB;
  const int code_elem = s.wbits ? 1 : 4;
  const int code_rows = s.wbits ? s.kp : keep;
  const int stage_n = sg * (xs_floats * 4 + raw_bytes);  // [sg][x] then [sg][raw]
  const int tbl_n = keep * CB;                           // one group's table
  unsigned char* ring = reinterpret_cast<unsigned char*>(psmem);      // [stages][stage_n]
  int2* tbl = reinterpret_cast<int2*>(ring + stages * stage_n);      // [2][sg][keep][CB]
  float* tot = reinterpret_cast<float*>(tbl + 2 * sg * tbl_n);       // [CB][RB] (by column)
  uint64_t* bars = reinterpret_cast<uint64_t*>(tot + RB * CB);       // [stages]
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & (kWarps - 1);
  const int rlo = (tid >> 8) * 32 * RPL + lane * RPL;  // this thread's first row in the tile
  const int r0 = blockIdx.x * RB;
  const int col0 = blockIdx.y * CB;
  const int ncol = min(CB, s.O - col0);  // columns of this tile that exist
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;  // codes per byte is a power of two

  // step n (descriptor t) -> stage n % stages, by warp 0: lane 0 arms the
  // stage's barrier with the bytes it expects, then the lanes start one
  // bulk copy each: per group its x slab and (vec) the raw idx/code rows of
  // its [keep, CB] tile
  auto stage = [&](int n, Step t) {
    if (tid >= 32 || t.ng == 0) return;
    unsigned char* st = ring + (n % stages) * stage_n;
    uint64_t* bar = bars + n % stages;
    const unsigned xbytes = xs_floats * 4;
    const int rrows = vec ? keep + code_rows : 0;  // raw rows a group
    if (lane == 0) {
      fence_proxy_async();
      mbar_expect(bar, t.ng * (xbytes + (vec ? (keep + code_rows * code_elem) * ncol : 0)));
    }
    __syncwarp();
    for (int c = lane; c < t.ng * (1 + rrows); c += 32) {
      const int q = c / (1 + rrows), r = c - q * (1 + rrows);
      const int g = t.c + kWarps * (t.j0 + q);
      unsigned char* rs = st + sg * xbytes + q * raw_bytes;
      if (r == 0)
        bulk_copy(st + q * xbytes, xT + (static_cast<size_t>(blockIdx.x) * s.h_in +
                                         static_cast<size_t>(g) * s.h_g) * RB,
                  xbytes, bar);
      else if (r <= keep)
        bulk_copy(rs + (r - 1) * CB, d.idx + (static_cast<size_t>(g) * keep + r - 1) * s.O + col0,
                  ncol, bar);
      else
        bulk_copy(rs + idx_bytes + (r - 1 - keep) * CB * code_elem,
                  d.codes + ((static_cast<size_t>(g) * code_rows + r - 1 - keep) * s.O + col0) *
                                code_elem,
                  ncol * code_elem, bar);
    }
  };
  auto wait_step = [&](int n) { mbar_wait(bars + n % stages, (n / stages) & 1); };

  // step n's tables: entry (q, k, column) = (x offset (q * h_g + id) * RB,
  // value); columns past O get (0, 0) and are never written
  auto build = [&](int n, Step t) {
    const unsigned char* raw = ring + (n % stages) * stage_n + sg * xs_floats * 4;
    int2* tb = tbl + (n & 1) * sg * tbl_n;
    for (int e = tid; e < t.ng * tbl_n; e += NT) {
      const int q = e / tbl_n, r = e - q * tbl_n;
      const int k = r / CB, cc = r % CB;
      const int g = t.c + kWarps * (t.j0 + q);
      const bool live = cc < ncol;
      unsigned id = 0xffffffffu, code = 0u;
      if (vec) {
        const unsigned char* rs = raw + q * raw_bytes;
        id = rs[r];
        if (s.wbits)
          code = rs[idx_bytes + (k >> pshift) * CB + cc];
        else
          code = reinterpret_cast<const unsigned*>(rs + idx_bytes)[r];
      } else if (live) {
        id = d.idx[(static_cast<size_t>(g) * keep + k) * s.O + col0 + cc];
        code = load_code(d, s, dc, g, k, col0 + cc);
      }
      const bool ok = live && id < static_cast<unsigned>(s.h_g);
      const float v = ok ? decode_raw(s, dc, code, k) : 0.f;
      tb[e] = make_int2(ok ? (q * xs_floats + static_cast<int>(id) * RB) : 0,
                        __float_as_int(v));
    }
  };

  float part[C][RPL];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int m = 0; m < RPL; ++m) part[j][m] = 0.f;

  // With 3 or more stages, one barrier a step: at step n, steps <= n + 1
  // have landed; the block starts step n + stages - 1 into the stage step
  // n - 1 used, builds step n + 1's tables into the buffer step n - 1
  // read, and computes step n. With 2 stages (large groups) step n's
  // tables are built behind a second barrier.
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const bool ahead = stages >= 3;
  Step cur = first_step(G, sg), nxt = cur, far = cur;  // steps n, n + 1, n + stages - 1
  for (int p = 0; p + 1 < stages; ++p) {
    stage(p, far);
    far = next_step(far, G, sg);
  }
  if (ahead) {
    wait_step(0);
    build(0, cur);
    nxt = next_step(cur, G, sg);
  }
  for (int n = 0; cur.ng > 0; ++n) {
    if (ahead) {
      if (nxt.ng > 0) wait_step(n + 1);
    } else {
      wait_step(n);
    }
    __syncthreads();  // tables n are built (ahead); step n - 1 is done
    stage(n + stages - 1, far);
    far = next_step(far, G, sg);
    if (ahead) {
      build(n + 1, nxt);
      nxt = next_step(nxt, G, sg);
    } else {
      build(n, cur);
      __syncthreads();
    }
    const float* xb = reinterpret_cast<const float*>(ring + (n % stages) * stage_n) + rlo;
    const int2* tb = tbl + (n & 1) * sg * tbl_n + warp * C;
    // the step's groups in increasing g, each group's kept slots in order
    for (int qk = 0; qk < cur.ng * keep; ++qk) {
#pragma unroll
      for (int j = 0; j < C; j += 2) {
        const int4 e = *reinterpret_cast<const int4*>(tb + qk * CB + j);  // broadcast
        prefill_terms(part[j], xb + e.x, __int_as_float(e.y));
        prefill_terms(part[j + 1], xb + e.z, __int_as_float(e.w));
      }
    }
    // at the end of a class, fold its partial into the total: P0, then
    // ((P0 + P1) + P2) + ..., the class-order combine
    if (cur.j0 + cur.ng >= class_count(cur.c, G)) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float* tp = tot + (warp * C + j) * RB + rlo;
#pragma unroll
        for (int m = 0; m < RPL; ++m) {
          tp[m] = cur.c == 0 ? part[j][m] : __fadd_rn(tp[m], part[j][m]);
          part[j][m] = 0.f;
        }
      }
    }
    cur = next_step(cur, G, sg);
  }

  // classes with no group (G < 8) add their zero partial, as on the decode route
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int o = col0 + warp * C + j;
    const float* tp = tot + (warp * C + j) * RB + rlo;
#pragma unroll
    for (int m = 0; m < RPL; ++m) {
      float v = tp[m];
      for (int c = G; c < kWarps; ++c) v = __fadd_rn(v, 0.f);
      const int row = r0 + rlo + m;
      if (row < s.T && o < s.O) y[static_cast<size_t>(row) * s.O + o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// fused_base_delta: 3xTF32 on tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kFusedThreads = 128;          // 4 warps
constexpr int kFusedBN = 128;               // columns per block: thread n forms column n
constexpr int kFusedBK = 32;                // K rows per chunk
constexpr int kFusedStages = 3;
constexpr int kMergedPitch = kFusedBN + 8;  // conflict-free B fragment reads
constexpr int kXPitch = kFusedBK + 4;       // conflict-free A fragment reads, 16-byte rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
}

// v = hi + lo, each a tf32 value (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Groups a chunk of kFusedBK rows can overlap, and the raw idx/codes
// bytes of their [keep, BN] tiles (at most 5 bytes a kept value).
int fused_chunk_groups(int h_g) {
  if (h_g % kFusedBK == 0) return 1;
  return kFusedBK % h_g == 0 ? kFusedBK / h_g : kFusedBK / h_g + 2;
}

size_t fused_raw_bytes(int h_g, int keep) {
  return (static_cast<size_t>(fused_chunk_groups(h_g)) * keep * kFusedBN * 5 + 15) / 16 * 16;
}

// Shared memory: per stage W's tile as stored, x's tile and (staged mode)
// the raw delta bytes; then the merged f32 tile.
template <typename WT>
size_t fused_smem_bytes(int bm, size_t raw) {
  return kFusedStages * (static_cast<size_t>(kFusedBK) * kFusedBN * sizeof(WT) +
                         static_cast<size_t>(bm) * kXPitch * sizeof(float) + raw) +
         static_cast<size_t>(kFusedBK) * kMergedPitch * sizeof(float);
}

// Row tile: tb (8, 16 or 32) caps it: 16 rows (one m16 fragment) for tb
// <= 16, else 32 rows for T <= 32 and 64 above.
int fused_bm(int T, int tb) { return tb <= 16 ? 16 : (T <= 32 ? 32 : 64); }

// out: y [T, O] when gridDim.z == 1, else the workspace [splits, T, O];
// block z covers chunks [z * cps, min((z + 1) * cps, n_chunks)).
// raw > 0: the idx/codes bytes of each chunk's groups ride the cp.async
// ring (raw bytes a stage); raw == 0: they are read from global memory
// when the merged tile is formed (shapes whose rows are not 16-byte
// aligned, or whose tiles would not fit).
template <int MT, typename WT>
__global__ void __launch_bounds__(kFusedThreads)
fused_tc_kernel(const float* __restrict__ x, const WT* __restrict__ w, Delta d, Shape s,
                int cps, int aligned, int raw, float* __restrict__ out) {
  constexpr int BM = 16 * MT;
  constexpr int BK = kFusedBK, BN = kFusedBN, NS = kFusedStages;
  constexpr int W_BYTES = BK * BN * sizeof(WT), X_BYTES = BM * kXPitch * sizeof(float);
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int stage_n = W_BYTES + X_BYTES + raw;  // [NS][W | x | idx | codes]
  float* mt = reinterpret_cast<float*>(fsmem + NS * stage_n);  // [BK][kMergedPitch]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int n_chunks = (s.h_in + BK - 1) / BK;
  const int c_begin = blockIdx.z * cps;
  const int nc = min(n_chunks, c_begin + cps) - c_begin;
  float* dst = out + static_cast<size_t>(blockIdx.z) * s.T * s.O;
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;
  const int code_rows = s.wbits ? s.kp : s.keep;
  const int o = col0 + tid;  // this thread's column of the merged tile
  const bool live = o < s.O;

  // the groups chunk ci overlaps: g_lo .. g_lo + ng - 1
  auto chunk_groups = [&](int ci, int& g_lo, int& ng) {
    const int k0 = (c_begin + ci) * BK;
    g_lo = k0 / s.h_g;
    ng = min(s.G - 1, (k0 + BK - 1) / s.h_g) - g_lo + 1;
  };

  // chunk ci's W and x tiles (and raw delta bytes) -> stage ci % NS, zero
  // past h_in, T and O
  auto load_chunk = [&](int ci) {
    if (ci < nc) {
      const int k0 = (c_begin + ci) * BK;
      unsigned char* st = fsmem + (ci % NS) * stage_n;
      WT* ws = reinterpret_cast<WT*>(st);
      float* xs = reinterpret_cast<float*>(st + W_BYTES);
      if (aligned) {
        constexpr int EPV = 16 / sizeof(WT);  // W elements per 16-byte copy
        constexpr int VPR = BN / EPV;
        for (int v = tid; v < BK * VPR; v += kFusedThreads) {
          const int r = v / VPR, cv = v % VPR;
          const int k = k0 + r, col = col0 + cv * EPV;
          const bool ok = k < s.h_in && col < s.O;
          cp_async16(ws + r * BN + cv * EPV, w + (ok ? static_cast<size_t>(k) * s.O + col : 0),
                     ok ? 16 : 0);
        }
        for (int v = tid; v < BM * (BK / 4); v += kFusedThreads) {
          const int r = v / (BK / 4), cv = v % (BK / 4);
          const int row = r0 + r, k = k0 + cv * 4;
          const bool ok = row < s.T && k < s.h_in;
          cp_async16(xs + r * kXPitch + cv * 4,
                     x + (ok ? static_cast<size_t>(row) * s.h_in + k : 0), ok ? 16 : 0);
        }
      } else {
        for (int v = tid; v < BK * BN; v += kFusedThreads) {
          const int r = v / BN, c = v % BN;
          const int k = k0 + r, col = col0 + c;
          ws[v] = k < s.h_in && col < s.O ? w[static_cast<size_t>(k) * s.O + col] : zero_of(w);
        }
        for (int v = tid; v < BM * BK; v += kFusedThreads) {
          const int r = v / BK, c = v % BK;
          const int row = r0 + r, k = k0 + c;
          xs[r * kXPitch + c] =
              row < s.T && k < s.h_in ? x[static_cast<size_t>(row) * s.h_in + k] : 0.f;
        }
      }
      if (raw) {
        int g_lo, ng;
        chunk_groups(ci, g_lo, ng);
        unsigned char* rs = st + W_BYTES + X_BYTES;
        stage_bytes(rs, d.idx, ng * s.keep, static_cast<size_t>(g_lo) * s.keep, col0, BN,
                    s.O, 1, true, tid, kFusedThreads);
        stage_bytes(rs + ng * s.keep * BN, d.codes, ng * code_rows,
                    static_cast<size_t>(g_lo) * code_rows, col0, BN, s.O, s.wbits ? 1 : 4,
                    true, tid, kFusedThreads);
      }
    }
    cp_async_commit();
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int p = 0; p + 1 < NS; ++p) load_chunk(p);
  for (int ci = 0; ci < nc; ++ci) {
    cp_async_wait(NS - 2);
    __syncthreads();  // chunk ci has landed; chunk ci - 1's readers are done
    load_chunk(ci + NS - 1);
    const unsigned char* st = fsmem + (ci % NS) * stage_n;
    // column tid of the merged tile: (W + 0), then + (0 + v) at kept rows
    {
      const WT* wc = reinterpret_cast<const WT*>(st) + tid;
#pragma unroll 8
      for (int r = 0; r < BK; ++r)
        mt[r * kMergedPitch + tid] = __fadd_rn(to_f32(wc[r * BN]), 0.f);
      if (live) {
        int g_lo, ng;
        chunk_groups(ci, g_lo, ng);
        const int k0 = (c_begin + ci) * BK;
        const unsigned char* ri = st + W_BYTES + X_BYTES;
        const unsigned char* rc = ri + ng * s.keep * BN;
        for (int gg = 0; gg < ng; ++gg) {
          const int g = g_lo + gg;
          for (int k = 0; k < s.keep; ++k) {
            unsigned id, code;
            if (raw) {
              id = ri[(gg * s.keep + k) * BN + tid];
              code = s.wbits ? rc[(gg * code_rows + (k >> pshift)) * BN + tid]
                             : reinterpret_cast<const unsigned*>(rc)[(gg * s.keep + k) * BN + tid];
            } else {
              id = d.idx[(static_cast<size_t>(g) * s.keep + k) * s.O + o];
              code = load_code(d, s, dc, g, k, o);
            }
            const int row = g * s.h_g + static_cast<int>(id) - k0;
            if (id < static_cast<unsigned>(s.h_g) && row >= 0 && row < BK) {
              float* m = mt + row * kMergedPitch + tid;
              *m = __fadd_rn(*m, __fadd_rn(0.f, decode_raw(s, dc, code, k)));
            }
          }
        }
      }
    }
    __syncthreads();  // the merged tile is complete
    const float* xa = reinterpret_cast<const float*>(st + W_BYTES);
    // the chunk's products accumulate in fresh registers: the tensor
    // cores' f32 adds truncate, and over a whole K that bias would reach
    // ~1e-4 of |y|; the chunk sums are added with round-to-nearest
    float part[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* xp = xa + (i * 16 + gid) * kXPitch + kk + tig;
        split_tf32(xp[0], ahi[i][0], alo[i][0]);
        split_tf32(xp[8 * kXPitch], ahi[i][1], alo[i][1]);
        split_tf32(xp[4], ahi[i][2], alo[i][2]);
        split_tf32(xp[8 * kXPitch + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bp = mt + (kk + tig) * kMergedPitch + warp * 32 + j * 8 + gid;
        unsigned b0h, b0l, b1h, b1l;
        split_tf32(bp[0], b0h, b0l);
        split_tf32(bp[4 * kMergedPitch], b1h, b1l);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_tf32(part[i][j], alo[i], b0h, b1h);
          mma_tf32(part[i][j], ahi[i], b0l, b1l);
          mma_tf32(part[i][j], ahi[i], b0h, b1h);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = __fadd_rn(acc[i][j][q], part[i][j][q]);
  }
  cp_async_wait(0);

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + warp * 32 + j * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + i * 16 + gid + 8 * h;
        if (row >= s.T) continue;
        float* yr = dst + static_cast<size_t>(row) * s.O;
        if (col < s.O) yr[col] = acc[i][j][2 * h];
        if (col + 1 < s.O) yr[col + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// y = ((ws[0] + ws[1]) + ws[2]) + ..., the K splits in split order
__global__ void split_combine_kernel(const float* __restrict__ ws, int splits, size_t n,
                                     float* __restrict__ y) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float t = ws[i];
    for (int z = 1; z < splits; ++z) t = __fadd_rn(t, ws[z * n + i]);
    y[i] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(Delta d, Shape s, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int o = blockIdx.y * kCols + lane;
  if (g >= s.G || o >= s.O) return;
  const Decode dc = decode_consts(d, s);
  float* col = out + static_cast<size_t>(g) * s.h_g * s.O + o;
  for (int i = 0; i < s.h_g; ++i) col[static_cast<size_t>(i) * s.O] = 0.f;
  const uint8_t* ip = d.idx + static_cast<size_t>(g) * s.keep * s.O + o;
  for (int k = 0; k < s.keep; ++k) {
    const int id = ip[static_cast<size_t>(k) * s.O];
    if (id < s.h_g)
      col[static_cast<size_t>(id) * s.O] = __fadd_rn(0.f, decode_value(d, s, dc, g, k, o));
  }
}

bool dec_tile(int tb) { return tb == 1 || tb == 2 || tb == 4 || tb == kDecMaxRows; }

bool shape_ok(const Shape& s) {
  return s.T > 0 && s.O > 0 && s.h_g > 0 && s.keep > 0 && s.keep <= s.h_g &&
         s.h_g <= 256 && s.h_in == s.G * s.h_g &&
         (s.wbits == 0 || s.wbits == 1 || s.wbits == 2 || s.wbits == 4 ||
          s.wbits == 8);
}

// The decode route's plan for row tile tb (1, 2, 4 or 8 rows at most a
// block); vec and xvec from the row alignments. False where even one row
// does not fit (an h_in far beyond the envelope's models).
bool dec_launch_plan(const float* x, const Delta& d, const Shape& s, int tb, bool strides_ok,
                     DecPlan& p, size_t& smem) {
  if (!dec_plan(s, tb, p)) return false;
  p.vec = strides_ok && s.wbits && s.O % 16 == 0 && reinterpret_cast<uintptr_t>(d.idx) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  p.xvec = s.h_g % 4 == 0 && s.h_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  smem = dec_smem_bytes(s, p.sg, p.ns, p.rt);
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem))
                          : cudaSuccess;
}

cudaError_t launch_spmm_decode(const float* x, Delta d, Shape s, float* y, int tb,
                               cudaStream_t st) {
  DecPlan p;
  size_t smem;
  if (!dec_launch_plan(x, d, s, tb, true, p, smem)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(spmm_decode_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kWarps * ((s.O + kDecCols - 1) / kDecCols), (s.T + p.rt - 1) / p.rt);
  spmm_decode_kernel<<<grid, kDecThreads, smem, st>>>(x, d, s, p, y);
  return cudaGetLastError();
}

cudaError_t launch_segments(const float* x, Delta d, Shape s, Strides strides,
                            int n_tenants, const int* seg_rows, const int* seg_offsets,
                            int n_seg, float* y, int tb, cudaStream_t st) {
  DecPlan p;
  size_t smem;
  const bool strides_ok = strides.idx % 16 == 0 && strides.codes % 16 == 0;
  if (!dec_launch_plan(x, d, s, tb, strides_ok, p, smem)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(segments_decode_kernel, smem);
  if (err != cudaSuccess) return err;
  // segments' tiles: m nonempty segments (m <= min(n_seg, T)) of T rows in
  // all need at most m + (T - m) / rt tiles, largest at m = min(n_seg, T);
  // one more y zero-fills the rows outside the segments
  const int m = std::min(n_seg, s.T);
  const dim3 grid(kWarps * ((s.O + kDecCols - 1) / kDecCols), m + (s.T - m) / p.rt + 1);
  segments_decode_kernel<<<grid, kDecThreads, smem, st>>>(
      x, d, s, strides, n_tenants, seg_rows, seg_offsets, n_seg, p, y);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

// the prefill route's row tile where two stages of one group fit at 64
// columns (delta_spmm_prefill_ok)
bool prefill_fits(int tb, int h_g, int keep) {
  return tb == kPrefillRows && h_g > 0 && keep > 0 && keep <= h_g && h_g <= 256 &&
         prefill_smem_bytes(tb, kWarps * 8, h_g, keep, 1, 2) <= kSmemMax;
}

// Groups a step holds and ring depth. A step's fixed cost (its barrier,
// its bulk copies, its table) is paid per step, so a step holds as many
// groups (up to 8) as 3 stages fit in the whole shared memory (an SM holds
// one 512-thread block by its registers); where one group does not fit
// that way, one group a step in 2 stages.
template <int C>
cudaError_t launch_prefill_t(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                             cudaStream_t st) {
  constexpr int RB = kPrefillRows, CB = kWarps * C;
  auto bytes = [&](int sg, int stages) {
    return prefill_smem_bytes(RB, CB, s.h_g, s.keep, sg, stages);
  };
  int sg = kPrefillMaxGroups, stages = 3;
  while (sg > 1 && bytes(sg, 3) > kSmemMax) sg /= 2;
  if (bytes(sg, 3) > kSmemMax) stages = 2;
  const size_t smem = bytes(sg, stages);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      spmm_prefill_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Tp / RB, (s.O + CB - 1) / CB);
  spmm_prefill_kernel<C><<<grid, kPrefillThreads, smem, st>>>(xT, Tp, d, s, sg, stages, vec, y);
  return cudaGetLastError();
}

// x -> xT [Tp / 128][h_in][128] (Tp = T rounded up to 128), then the
// prefill kernel at 64 columns a block, or 32 where the 64-column grid
// would give SMs fewer than 4 blocks (the better of 1, 2 and 4 at every
// full-width site on an H100, PERF.md)
cudaError_t launch_prefill(const float* x, float* xT, Delta d, Shape s, float* y,
                           cudaStream_t st) {
  const int Tp = (s.T + kPrefillRows - 1) / kPrefillRows * kPrefillRows;
  transpose_pad_kernel<<<dim3((s.h_in + 31) / 32, Tp / 32), dim3(32, 8), 0, st>>>(
      x, s.T, s.h_in, Tp, kPrefillRows, xT);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = s.O % 16 == 0 && reinterpret_cast<uintptr_t>(d.idx) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  const bool narrow = (Tp / kPrefillRows) * ((s.O + 63) / 64) < 4 * sm_count();
  return narrow ? launch_prefill_t<4>(xT, Tp, d, s, vec, y, st)
                : launch_prefill_t<8>(xT, Tp, d, s, vec, y, st);
}

// K splits of the fused kernel: enough blocks for two per SM, at least 4
// chunks a split, at most 16 splits; every split non-empty
int fused_splits_for(int T, int h_in, int O, int tb) {
  const int bm = fused_bm(T, tb);
  const int blocks = ((T + bm - 1) / bm) * ((O + kFusedBN - 1) / kFusedBN);
  const int n_chunks = (h_in + kFusedBK - 1) / kFusedBK;
  const int target = 2 * sm_count();
  if (blocks >= target) return 1;
  int want = (target + blocks - 1) / blocks;
  want = std::min(want, std::max(1, n_chunks / 4));
  want = std::min(want, 16);
  const int cps = (n_chunks + want - 1) / want;
  return (n_chunks + cps - 1) / cps;
}

template <int MT, typename WT>
cudaError_t launch_fused_t(const float* x, const WT* w, Delta d, Shape s, float* out,
                           int splits, int aligned, cudaStream_t st) {
  // the raw delta bytes ride the ring where their rows take 16-byte copies
  // and the stages still fit
  const bool vec = aligned && s.O % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d.idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  size_t raw = vec ? fused_raw_bytes(s.h_g, s.keep) : 0;
  if (fused_smem_bytes<WT>(16 * MT, raw) > kSmemMax) raw = 0;
  const size_t smem = fused_smem_bytes<WT>(16 * MT, raw);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_tc_kernel<MT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_chunks = (s.h_in + kFusedBK - 1) / kFusedBK;
  const int cps = (n_chunks + splits - 1) / splits;
  const dim3 grid((s.T + 16 * MT - 1) / (16 * MT), (s.O + kFusedBN - 1) / kFusedBN, splits);
  fused_tc_kernel<MT, WT><<<grid, kFusedThreads, smem, st>>>(
      x, w, d, s, cps, aligned, static_cast<int>(raw), out);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_fused(const float* x, const void* w, Delta d, Shape s, float* y,
                         float* ws, int splits, int tb, cudaStream_t st) {
  const WT* wp = static_cast<const WT*>(w);
  const int aligned = (static_cast<size_t>(s.O) * sizeof(WT)) % 16 == 0 && s.h_in % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* out = splits > 1 ? ws : y;
  cudaError_t err;
  switch (fused_bm(s.T, tb)) {
    case 16: err = launch_fused_t<1, WT>(x, wp, d, s, out, splits, aligned, st); break;
    case 32: err = launch_fused_t<2, WT>(x, wp, d, s, out, splits, aligned, st); break;
    default: err = launch_fused_t<4, WT>(x, wp, d, s, out, splits, aligned, st); break;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(s.T) * s.O;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  split_combine_kernel<<<blocks, 256, 0, st>>>(ws, splits, n, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [T, h_in] f32; idx [G, keep, O] uint8; codes [G, kp, O] uint8 or
// f32 [G, keep, O] (wbits = 0); scale f32 and zero int32 device scalars;
// y [T, O] f32. Row tiles 1, 2, 4 and 8 take the decode kernel (tb caps
// the rows a block computes), 128 the prefill kernel (same bits) where
// delta_spmm_prefill_ok, which needs xT: f32 scratch of h_in * Tp
// elements, Tp = T rounded up to 128 (unused for the other tiles).
int delta_spmm_launch(const void* x, const void* idx,
                      const void* codes, const void* scale, const void* zero,
                      void* y, void* xT, int T, int h_in, int O, int h_g, int keep, int kp,
                      int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  const bool prefill = tb == kPrefillRows;
  if (!shape_ok(s) || (prefill ? !prefill_fits(tb, h_g, keep) : !dec_tile(tb)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  const float* xp = static_cast<const float*>(x);
  if (prefill && xT == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(prefill ? launch_prefill(xp, static_cast<float*>(xT), d, s, yp, st)
                                  : launch_spmm_decode(xp, d, s, yp, tb, st));
}

// 1 where delta_spmm_launch takes row tile tb (128) on its prefill kernel
// for groups of h_g rows with keep kept values: its shared memory fits.
int delta_spmm_prefill_ok(int tb, int h_g, int keep) {
  return prefill_fits(tb, h_g, keep) ? 1 : 0;
}

// The decode route's plan (delta_spmm at row tile tb, and the segments
// kernel) for one matrix: out[0..3] = groups a step holds, ring depth,
// rows a block computes at most, dynamic shared memory bytes. 1 where a
// plan fits, 0 otherwise. Host only: launches nothing.
int delta_spmm_decode_plan(int h_in, int O, int h_g, int keep, int kp, int wbits, int tb,
                           int* out) {
  const Shape s{1, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  DecPlan p;
  if (!shape_ok(s) || !dec_tile(tb) || !dec_plan(s, tb, p)) return 0;
  out[0] = p.sg;
  out[1] = p.ns;
  out[2] = p.rt;
  out[3] = static_cast<int>(dec_smem_bytes(s, p.sg, p.ns, p.rt));
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
// non-decreasing; tb (1, 2, 4 or 8) caps the rows a block computes.
int delta_spmm_segments_launch(const void* x, const void* idx,
                               const void* codes, const void* scale,
                               const void* zero, int n_tenants, long long idx_stride,
                               long long codes_stride, long long scale_stride,
                               long long zero_stride, const void* seg_rows,
                               const void* seg_offsets, int n_seg, void* y, int T,
                               int h_in, int O, int h_g, int keep, int kp,
                               int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s) || !dec_tile(tb) || n_seg < 1 || n_tenants < 1 || idx_stride < 0 ||
      codes_stride < 0 || scale_stride < 0 || zero_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides strides{static_cast<size_t>(idx_stride), static_cast<size_t>(codes_stride),
                        static_cast<size_t>(scale_stride), static_cast<size_t>(zero_stride)};
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  const int* sr = static_cast<const int*>(seg_rows);
  const int* so = static_cast<const int*>(seg_offsets);
  return static_cast<int>(launch_segments(static_cast<const float*>(x), d, s, strides,
                                          n_tenants, sr, so, n_seg, yp, tb, st));
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
                            int keep, int kp, int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if ((tb != 8 && tb != 16 && tb != 32) || !shape_ok(s) ||
      splits != fused_splits_for(T, h_in, O, tb) || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  float* wsp = static_cast<float*>(ws);
  return static_cast<int>(
      w_bf16 ? launch_fused<__nv_bfloat16>(xp, w, d, s, yp, wsp, splits, tb, st)
             : launch_fused<float>(xp, w, d, s, yp, wsp, splits, tb, st));
}

// The packed delta as for delta_spmm_launch -> out [h_in, O] f32, every
// element written.
int dequant_launch(const void* idx, const void* codes, const void* scale,
                   const void* zero, void* out, int h_in, int O, int h_g, int keep,
                   int kp, int wbits, void* stream) {
  const Shape s{1, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  const dim3 grid((s.G + kWarps - 1) / kWarps, (s.O + kCols - 1) / kCols);
  dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, s, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
