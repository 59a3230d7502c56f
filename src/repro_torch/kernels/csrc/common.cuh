// Declarations shared by the delta kernels' translation units (see
// delta_spmm.cu for the kernels' design and the C interface): the packed
// delta's layout, the code decode, the copy and barrier helpers, the
// decode route's launch plan and the launchers each unit defines. Every
// function here is inline, so each unit may include it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace dq {


constexpr int kWarps = 8;              // class chains; warps of a prefill row half
constexpr int kThreads = kWarps * 32;  // threads per block (dequant, prefill row half)
constexpr int kCols = 32;              // output columns per dequant block (one per lane)
constexpr size_t kSmemMax = 232448;    // dynamic shared memory a block may opt into

struct Delta {
  const uint8_t* idx;    // [G, keep, O] uint8, or int32 (isz == 4), as bytes
  const uint8_t* codes;  // [G, Kp, O] uint8, or f32 [G, keep, O] when wbits == 0
  const float* scale;    // this matrix's scale
  const int* zero;       // this matrix's zero point
};

// isz: bytes of one idx entry (1: uint8, 4: int32)
struct Shape {
  int T, h_in, O, G, h_g, keep, kp, wbits, isz;
};

// idx[g, k, o] of either width, as unsigned
__device__ __forceinline__ unsigned load_idx(const Delta& d, const Shape& s, size_t i) {
  return s.isz == 1 ? d.idx[i] : reinterpret_cast<const unsigned*>(d.idx)[i];
}

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
constexpr int kDecStages = 4;                       // ring depth for a large class share
constexpr size_t kDecShareMax = 48 * 1024;          // a class share this small is one step
constexpr size_t kDecStageBytes = 12 * 1024;        // else a ring of stages about this large
constexpr int kDecMinSlots = 8;                     // kept slots a step holds at least

// The launch plan of a decode tile: groups a step holds (sg), kept slots
// a step holds of each of its groups (kc: keep, or a multiple of 8 below
// it, and then sg = 1: the step is a run of one group's slots), ring
// depth (ns), rows a block computes at most (rt), whether the idx/code
// rows of full tiles ride 16-byte cp.async (vec: 16-byte aligned rows)
// and whether x does (xvec), whether x is read from global memory instead
// of a shared-memory slab (xg: where one row's slab does not fit; rt =
// 1), the blocks of a cluster (cb = min(G, 8): one a class that has a
// group; the classes past G add their zero partial in the combine) and
// the columns of a tile (nc: kDecCols, or kNarCols at G < 8, the narrow
// tile of narrow_correction).
struct DecPlan {
  int sg, kc, ns, rt, vec, xvec, xg, cb, nc;
};

// code rows of kc kept slots from a multiple of 8 (codes per byte or 1)
__host__ __device__ __forceinline__ int dec_code_rows(const Shape& s, int kc) {
  return s.wbits ? (kc * s.wbits + 7) / 8 : kc;
}

// raw bytes of kc kept slots of one group's [., kDecCols] tile: idx rows
// (kDecCols * isz bytes each), then code rows
__host__ __device__ __forceinline__ int dec_group_bytes(const Shape& s, int kc) {
  const int code_bytes = dec_code_rows(s, kc) * kDecCols * (s.wbits ? 1 : 4);
  return (kc * kDecCols * s.isz + code_bytes + 15) / 16 * 16;
}

// G < 8: each class holds one group, so a cluster of G blocks has G
// chains a (row, column) and a 128-column tile is G blocks of 64 threads.
// The narrow tile spreads that work: 32 columns a tile (one a lane), and
// a warp a row (blocks of 32 * rt threads).
constexpr int kNarCols = 32;

// raw bytes of kc kept slots of one group's [., kNarCols] tile: idx rows,
// then code rows
__host__ __device__ __forceinline__ int nar_group_bytes(const Shape& s, int kc) {
  const int code_bytes = dec_code_rows(s, kc) * kNarCols * (s.wbits ? 1 : 4);
  return (kc * kNarCols * s.isz + code_bytes + 15) / 16 * 16;
}

// Shared memory of a narrow tile: the ring [ns][kc slots], the group's x
// slab [rt][h_g] f32 (none where xg) and the partial [rt][kNarCols] f32.
inline size_t nar_smem_bytes(const Shape& s, const DecPlan& p) {
  return static_cast<size_t>(p.ns) * nar_group_bytes(s, p.kc) +
         (p.xg ? 0 : static_cast<size_t>(p.rt) * s.h_g * sizeof(float)) +
         static_cast<size_t>(p.rt) * kNarCols * sizeof(float);
}

// The narrow tile's plan (G < 8): the largest row tile <= tb (and <= T:
// a block's warps and slab rows are the rows it can have) whose x slab
// and stages fit; the group's [keep, 32] tile whole as one step where it
// is at most kDecShareMax bytes, else runs of kc slots (a multiple of 8)
// through a ring of kDecStages (or 2) stages; x from global memory, one
// row a block, where one row's slab does not fit.
inline bool nar_plan(const Shape& s, int tb, DecPlan& p) {
  p.cb = s.G;
  p.nc = kNarCols;
  p.sg = 1;
  p.xg = 0;
  const int rt0 = std::min(std::min(tb, kDecMaxRows), std::max(s.T, 1));
  if (nar_group_bytes(s, s.keep) <= static_cast<int>(kDecShareMax)) {
    p.kc = s.keep;
    p.ns = 1;
    for (p.rt = rt0; p.rt >= 1; p.rt /= 2)
      if (nar_smem_bytes(s, p) <= kSmemMax) return true;
  }
  const size_t run8 = nar_group_bytes(s, kDecMinSlots);
  for (int xg = 0; xg <= 1; ++xg) {
    p.xg = xg;
    for (p.rt = xg ? 1 : rt0; p.rt >= 1; p.rt /= 2)
      for (p.ns = kDecStages; p.ns >= 2; p.ns /= 2) {
        p.kc = 0;
        const size_t fixed = nar_smem_bytes(s, p);
        if (fixed >= kSmemMax) continue;
        p.kc = static_cast<int>((kSmemMax - fixed) / p.ns / run8) * kDecMinSlots;
        if (p.kc >= s.keep) p.kc = s.keep;
        if (p.kc >= std::min(s.keep, kDecMinSlots) && nar_smem_bytes(s, p) <= kSmemMax)
          return true;
      }
  }
  return false;
}

// Shared memory: the ring [ns][sg groups of kc slots], the class's x slab
// [rt][nq * h_g] f32 (none where xg) and the class partial [rt][kDecCols]
// f32.
inline size_t dec_smem_bytes(const Shape& s, const DecPlan& p) {
  if (p.nc == kNarCols) return nar_smem_bytes(s, p);
  const size_t nq = class_count(0, s.G);
  return static_cast<size_t>(p.ns) * p.sg * dec_group_bytes(s, p.kc) +
         (p.xg ? 0 : static_cast<size_t>(p.rt) * nq * s.h_g * sizeof(float)) +
         static_cast<size_t>(p.rt) * kDecCols * sizeof(float);
}

// The largest row tile <= tb (at most 8) whose stages fit. Whole groups
// first: a class share of at most kDecShareMax bytes is staged whole as
// one step (one wait, one barrier; splitting it into 4 or 8 steps
// measured slower on the card), a larger one streams through a ring of
// kDecStages (or 2) stages of about kDecStageBytes. Where no whole group
// fits (large keep, int32 idx, f32 codes), each group's kept slots stream
// in runs of kc (a multiple of 8, so a run starts on a code byte), as
// many as kDecStages (or 2) stages beside the slab hold. Where not even
// one row's slab fits beside them (nq * h_g near h_in at G < 8 and h_in
// past ~50k), x is read from global memory, one row a block. So a plan
// exists for every packing shape_ok takes. At G < 8 the narrow tile's
// plan (nar_plan).
inline bool dec_plan(const Shape& s, int tb, DecPlan& p) {
  if (s.G < kWarps) return nar_plan(s, tb, p);
  const int nq = class_count(0, s.G);
  const size_t gb = dec_group_bytes(s, s.keep);
  p.nc = kDecCols;
  p.cb = std::min(s.G, kWarps);
  p.xg = 0;
  p.kc = s.keep;
  int ns;
  if (nq * gb <= kDecShareMax) {
    p.sg = nq;
    ns = 1;
  } else {
    p.sg = std::max<int>(1, static_cast<int>(kDecStageBytes / gb));
    ns = kDecStages;
  }
  for (p.rt = std::min(tb, kDecMaxRows); p.rt >= 1; p.rt /= 2)
    for (p.ns = ns; p.ns >= std::min(ns, 2); p.ns /= 2)
      if (dec_smem_bytes(s, p) <= kSmemMax) return true;
  // runs of kc slots of one group a step
  p.sg = 1;
  const size_t run8 = dec_group_bytes(s, kDecMinSlots);  // linear in runs of 8 slots
  for (int xg = 0; xg <= 1; ++xg) {
    p.xg = xg;
    for (p.rt = xg ? 1 : std::min(tb, kDecMaxRows); p.rt >= 1; p.rt /= 2)
      for (p.ns = kDecStages; p.ns >= 2; p.ns /= 2) {
        p.kc = 0;
        const size_t fixed = dec_smem_bytes(s, p);
        if (fixed >= kSmemMax) continue;
        const size_t per_stage = (kSmemMax - fixed) / p.ns;
        p.kc = static_cast<int>(per_stage / run8) * kDecMinSlots;
        if (p.kc >= s.keep) p.kc = s.keep;
        if (p.kc >= std::min(s.keep, kDecMinSlots) && dec_smem_bytes(s, p) <= kSmemMax)
          return true;
      }
  }
  return false;
}

// ---------------------------------------------------------------------------
// The dense-group walk (dense.cuh): the decode tiles and the segments
// kernel on a packing whose every group keeps all h_g slots with idx =
// arange(h_g) (the codecs' lowerings), which the host says; no idx is
// staged or read, x is a broadcast. Same clusters of min(G, 8) blocks of
// kDecThreads threads, 128 columns a tile, as cluster_correction.
// ---------------------------------------------------------------------------
constexpr size_t kDenseStageBytes = 12 * 1024;  // a ring stage of a large class share

// raw bytes of kc slots of one group's [., kDecCols] code tile (no idx rows)
__host__ __device__ __forceinline__ int dense_group_bytes(const Shape& s, int kc) {
  return (dec_code_rows(s, kc) * kDecCols * (s.wbits ? 1 : 4) + 15) / 16 * 16;
}

// Shared memory: the ring [ns][sg groups of kc slots], the class's x slab
// [rt][nq * h_g] f32 (none where xg) and the class partial [rt][kDecCols].
inline size_t dense_smem_bytes(const Shape& s, const DecPlan& p) {
  const size_t nq = class_count(0, s.G);
  return static_cast<size_t>(p.ns) * p.sg * dense_group_bytes(s, p.kc) +
         (p.xg ? 0 : static_cast<size_t>(p.rt) * nq * s.h_g * sizeof(float)) +
         static_cast<size_t>(p.rt) * kDecCols * sizeof(float);
}

// The dense walk's plan for row tile tb: a class share of at most
// kDecShareMax bytes of codes is one step (BitDelta's 2-bit codes at
// every wizard site); otherwise whole groups a step where a group is at
// most kDenseStageBytes, else runs of kc slots (a multiple of 8, about
// kDenseStageBytes: LowRank's f32 codes, 64 KB a 128-slot group) through
// a ring of kDecStages (or 2) stages, so a block holds tens of KB and an
// SM several blocks; the largest row tile <= tb whose slab fits beside
// them; x from global memory, one row a block, where none does. Only for
// keep = h_g.
inline bool dense_plan(const Shape& s, int tb, DecPlan& p) {
  if (s.keep != s.h_g) return false;
  const int nq = class_count(0, s.G);
  const size_t gb = dense_group_bytes(s, s.keep), run8 = dense_group_bytes(s, kDecMinSlots);
  p.nc = kDecCols;
  p.cb = std::min(s.G, kWarps);
  p.xg = 0;
  p.kc = s.keep;
  int ns = kDecStages;
  if (nq * gb <= kDecShareMax) {
    p.sg = nq;
    ns = 1;
  } else if (gb <= kDenseStageBytes) {
    p.sg = static_cast<int>(kDenseStageBytes / gb);
  } else {
    p.sg = 1;
    p.kc = std::min(s.keep, std::max(1, static_cast<int>(kDenseStageBytes / run8)) * kDecMinSlots);
  }
  for (int xg = 0; xg <= 1; ++xg) {
    p.xg = xg;
    for (p.rt = xg ? 1 : std::min(tb, kDecMaxRows); p.rt >= 1; p.rt /= 2)
      for (p.ns = ns; p.ns >= std::min(ns, 2); p.ns /= 2)
        if (dense_smem_bytes(s, p) <= kSmemMax) return true;
  }
  return false;
}

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

constexpr int kPrefillRows = 128;  // the prefill kernel's row tile

inline bool dec_tile(int tb) { return tb == 1 || tb == 2 || tb == 4 || tb == kDecMaxRows; }

// Every packing the compressor emits: idx uint8 (h_g up to 256) or
// int32 (any h_g), any keep up to h_g, any G, codes at a width of 1, 2,
// 4 or 8 bits or raw f32.
inline bool shape_ok(const Shape& s) {
  return s.T > 0 && s.O > 0 && s.h_g > 0 && s.keep > 0 && s.keep <= s.h_g &&
         (s.isz == 4 || (s.isz == 1 && s.h_g <= 256)) && s.h_in == s.G * s.h_g &&
         s.kp == dec_code_rows(s, s.keep) &&
         (s.wbits == 0 || s.wbits == 1 || s.wbits == 2 || s.wbits == 4 ||
          s.wbits == 8);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem))
                          : cudaSuccess;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 132;
  return n;
}

// launchers, one translation unit each (compiled in parallel)
cudaError_t launch_spmm_decode_u8(const float* x, Delta d, Shape s, float* y, int tb,
                                  cudaStream_t st);
cudaError_t launch_spmm_decode_i32(const float* x, Delta d, Shape s, float* y, int tb,
                                   cudaStream_t st);
cudaError_t launch_segments_u8(const float* x, Delta d, Shape s, Strides strides,
                               int n_tenants, const int* seg_rows, const int* seg_offsets,
                               int n_seg, float* y, int tb, cudaStream_t st);
cudaError_t launch_segments_i32(const float* x, Delta d, Shape s, Strides strides,
                                int n_tenants, const int* seg_rows, const int* seg_offsets,
                                int n_seg, float* y, int tb, cudaStream_t st);
cudaError_t launch_dense_decode(const float* x, Delta d, Shape s, float* y, int tb,
                                cudaStream_t st);
cudaError_t launch_dense_segments(const float* x, Delta d, Shape s, Strides strides,
                                  int n_tenants, const int* seg_rows, const int* seg_offsets,
                                  int n_seg, float* y, int tb, cudaStream_t st);
bool prefill_fits(int tb, int h_g, int keep);
cudaError_t launch_prefill(const float* x, float* xT, Delta d, Shape s, float* y,
                           cudaStream_t st);
cudaError_t launch_prefill_win_u8(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                                  cudaStream_t st);
cudaError_t launch_prefill_win_i32(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                                   cudaStream_t st);
int fused_splits_for(int T, int h_in, int O, int tb);
cudaError_t launch_fused_any(const float* x, const void* w, int w_bf16, Delta d, Shape s,
                             float* y, float* ws, int splits, int tb, cudaStream_t st);

}  // namespace dq
