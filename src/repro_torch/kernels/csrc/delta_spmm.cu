// DeltaDQ delta kernels for Hopper (sm_90a).
//
// Four kernels; the two correction kernels share one device routine, and
// all four share the code decode (decode_value):
//
//   delta_spmm           y[T, O] = x[T, h_in] @ dequant(delta)
//                        replaces repro/kernels/delta_spmm.py:122
//                        delta_spmm_kernel (body _spmm_body, :108)
//   delta_spmm_segments  row r of tenant-sorted x gets
//                        x[r] @ dequant(delta[seg_rows[seg(r)]])
//                        replaces repro/kernels/delta_spmm.py:240
//                        delta_spmm_segments_kernel (body _segments_body, :211)
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
// Design (a simple, correct first version; wgmma/TMA/persistent blocks
// are later work):
//  * Grid: one block per (row block of TB rows, tile of 32 columns).
//    Blocks carry nothing between each other; a loop over groups inside
//    the block takes the place of the TPU's sequential G grid axis.
//  * x[rows, chunk of groups] is staged in shared memory as f32; each
//    lane owns one output column, reads its column of the [keep, 32]
//    idx/codes tile straight from global memory (32 consecutive bytes a
//    warp, coalesced) and decodes each kept value ONCE per (block,
//    group) into a register, then applies it to all TB staged rows.
//    The TPU's one-hot scatter to a dense [h_g, Ob] tile has no meaning
//    here: a register gather from the staged x row replaces it.
//  * The 8 warps of a block split the groups: warp w owns every group
//    g with g % 8 == w, visited in increasing g; the 8 partial sums are
//    then added in warp order 0..7. The reduction order of every output
//    element is therefore fixed by (G, keep) alone -- never by T, the
//    row tile, the block layout or the segment layout -- so a row's
//    correction has the same bits alone, in a batch, or in any segment,
//    and delta_spmm_segments rows equal delta_spmm rows bit for bit.
//    No atomics, no split over blocks. Multiplies and adds are explicit
//    round-to-nearest (no FMA contraction), matching the plain torch
//    version's multiply-then-sum up to summation order.
//  * Segments: a block walks the segments that overlap its row block,
//    skips empty ones, and decodes each tenant's tile once per
//    (segment, row block, column tile, group) -- the invariant
//    ops.segment_decode_tiles counts. Rows outside the segment are
//    computed on the staged zeros/other rows and never written. Rows
//    that no segment covers, and segments whose tenant row lies outside
//    the stack, get zeros, as the TPU kernel's zero-filled output does.
//
// fused_base_delta: the TPU kernel's function, y = x @ (W + dense(delta))
// with the merged weight formed per element in f32 (one rounding, as
// _fused_body's `w + dense`), not a copy of its blocks. Bound: at decode
// (T <= 8) it must read W once (2 bytes a weight in bf16: 90 MB at a
// 4096 x 11008 site, ~27 us) plus the packed delta; at T = 128 the
// 2 * T * h_in * O f32 operations (~11.5 GFLOP there, ~0.17 ms) bound it.
// Design: one block per (row block of TB rows, 32 columns), as
// delta_spmm. The loop over chunks of whole groups stages x[rows, chunk]
// as block_correction does, and the merged tile W[chunk, 32] + 0 in f32
// (W read as stored and converted in registers, so bf16 W moves half the
// bytes). Warp w then owns the chunk's groups g with g % 8 == w: each
// lane adds (0 + v) at its column's kept rows -- the plain version's
// w + (zeros scatter-added with v), bit for bit, signed zeros included --
// and accumulates x[r, i] * merged[i] over the group's rows in increasing
// i, groups in increasing g; the 8 partials are added in warp order.
// The lane reads back only what it wrote, so adding needs no barrier.
// The accumulate is an FMA (as a GEMM's); no bit-identity contract rests
// on this kernel. Shared memory is sized per (TB, h_g) within 64 KB
// (dynamic): a chunk holds at least one group at h_g = 256, TB = 32.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps per block
constexpr int kThreads = kWarps * 32;  // threads per block
constexpr int kCols = 32;              // output columns per block (one per lane)
constexpr int kSmemFloats = 8192;      // 32 KB: x chunk [TB][CH], then partials
constexpr int kFusedSmemFloats = 16384;  // 64 KB (dynamic): x chunk + merged tile

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

// Corrections of rows [r0, r0 + TB) x columns [col0, col0 + 32) for one
// packed delta. On return, lane l of warp 0 holds out[r] for column
// col0 + l. Every thread of the block must call it (it synchronises).
template <int TB>
__device__ void block_correction(const float* __restrict__ x, const Delta& d,
                                 const Shape& s, int r0, int col0,
                                 float* smem, float (&out)[TB]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = col0 + lane;
  const bool live = o < s.O;
  constexpr int CH = kSmemFloats / TB;   // staged x columns per row
  const int CG = CH / s.h_g;             // whole groups per chunk
  const Decode dc = decode_consts(d, s);

  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;

  for (int g0 = 0; g0 < s.G; g0 += CG) {
    const int cg = min(CG, s.G - g0);
    const int width = cg * s.h_g;
    __syncthreads();  // the previous chunk's readers are done
    const size_t xcol = static_cast<size_t>(g0) * s.h_g;
    for (int i = threadIdx.x; i < TB * width; i += kThreads) {
      const int r = i / width;
      const int c = i - r * width;
      const int row = r0 + r;
      smem[r * CH + c] =
          row < s.T ? x[static_cast<size_t>(row) * s.h_in + xcol + c] : 0.f;
    }
    __syncthreads();
    if (live) {
      // warp w owns every group g with g % kWarps == w, in increasing g
      for (int g = g0 + ((warp - g0 % kWarps) + kWarps) % kWarps; g < g0 + cg;
           g += kWarps) {
        const float* xs = smem + (g - g0) * s.h_g;
        const uint8_t* ip = d.idx + static_cast<size_t>(g) * s.keep * s.O + o;
        for (int k = 0; k < s.keep; ++k) {
          const int id = ip[static_cast<size_t>(k) * s.O];
          const float v = decode_value(d, s, dc, g, k, o);
#pragma unroll
          for (int r = 0; r < TB; ++r)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[r * CH + id], v));
        }
      }
    }
  }

  // fixed-order combine of the per-warp partials: ((w0 + w1) + w2) + ...
  __syncthreads();  // all warps are done reading the staged x
#pragma unroll
  for (int r = 0; r < TB; ++r) smem[(warp * TB + r) * 32 + lane] = acc[r];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      float t = smem[r * 32 + lane];
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, smem[(w * TB + r) * 32 + lane]);
      out[r] = t;
    }
  }
}

template <int TB>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ x, Delta d, Shape s, float* __restrict__ y) {
  __shared__ float smem[kSmemFloats];
  const int r0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * kCols;
  float out[TB];
  block_correction<TB>(x, d, s, r0, col0, smem, out);
  const int o = col0 + threadIdx.x;
  if (threadIdx.x < 32 && o < s.O) {
#pragma unroll
    for (int r = 0; r < TB; ++r)
      if (r0 + r < s.T) y[static_cast<size_t>(r0 + r) * s.O + o] = out[r];
  }
}

template <int TB>
__global__ void __launch_bounds__(kThreads)
segments_kernel(const float* __restrict__ x, Delta stack, Shape s, Strides st,
                int n_tenants, const int* __restrict__ seg_rows,
                const int* __restrict__ seg_offsets, int n_seg,
                float* __restrict__ y) {
  static_assert(TB <= 32, "one written-row bit per row of the block");
  __shared__ float smem[kSmemFloats];
  const int r0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * kCols;
  const int o = col0 + threadIdx.x;
  unsigned written = 0u;  // bit r: row r0 + r was written (warp 0's lanes)
  for (int seg = 0; seg < n_seg; ++seg) {
    const int start = seg_offsets[seg];
    const int end = seg_offsets[seg + 1];
    const int t = seg_rows[seg];
    // block-uniform: empty segments, segments disjoint from this row
    // block and tenant rows outside the stack are skipped, so each
    // tenant tile is decoded once per segment
    if (end <= start || start >= r0 + TB || end <= r0 || t < 0 || t >= n_tenants)
      continue;
    Delta d{stack.idx + t * st.idx, stack.codes + t * st.codes,
            stack.scale + t * st.scale, stack.zero + t * st.zero};
    float out[TB];
    block_correction<TB>(x, d, s, r0, col0, smem, out);
    if (threadIdx.x < 32 && o < s.O) {
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const int row = r0 + r;
        if (row >= start && row < end && row < s.T) {
          y[static_cast<size_t>(row) * s.O + o] = out[r];
          written |= 1u << r;
        }
      }
    }
  }
  if (threadIdx.x < 32 && o < s.O) {
#pragma unroll
    for (int r = 0; r < TB; ++r)
      if (!(written >> r & 1u) && r0 + r < s.T) y[static_cast<size_t>(r0 + r) * s.O + o] = 0.f;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Staged x columns (whole groups) per chunk of the fused kernel: the x
// chunk [TB][ch] and the merged tile [ch][32] share kFusedSmemFloats.
int fused_chunk(int tb, const Shape& s) {
  const int ch = kFusedSmemFloats / (tb + kCols) / s.h_g * s.h_g;
  return ch < s.h_in ? ch : s.h_in;
}

size_t fused_smem_bytes(int tb, int ch) {
  const int stage = (tb + kCols) * ch;
  const int partials = kWarps * tb * kCols;
  return static_cast<size_t>(stage > partials ? stage : partials) * sizeof(float);
}

template <int TB, typename WT>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ x, const WT* __restrict__ w, Delta d, Shape s,
             int ch, float* __restrict__ y) {
  extern __shared__ float smem[];
  float* xs = smem;             // [TB][ch]
  float* tile = smem + TB * ch;  // [ch][32] merged W + delta, f32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * kCols;
  const int o = col0 + lane;
  const bool live = o < s.O;
  const int CG = ch / s.h_g;
  const Decode dc = decode_consts(d, s);

  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;

  for (int g0 = 0; g0 < s.G; g0 += CG) {
    const int cg = min(CG, s.G - g0);
    const int width = cg * s.h_g;
    const size_t xcol = static_cast<size_t>(g0) * s.h_g;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < TB * width; i += kThreads) {
      const int r = i / width;
      const int c = i - r * width;
      const int row = r0 + r;
      xs[r * ch + c] = row < s.T ? x[static_cast<size_t>(row) * s.h_in + xcol + c] : 0.f;
    }
    for (int i = threadIdx.x; i < width * kCols; i += kThreads) {
      const int c = i & (kCols - 1);
      const int oc = col0 + c;
      tile[i] = oc < s.O
          ? __fadd_rn(to_f32(w[(xcol + (i >> 5)) * s.O + oc]), 0.f)
          : 0.f;
    }
    __syncthreads();
    if (live) {
      // warp w owns every group g with g % kWarps == w, in increasing g
      for (int g = g0 + ((warp - g0 % kWarps) + kWarps) % kWarps; g < g0 + cg;
           g += kWarps) {
        float* col = tile + (g - g0) * s.h_g * kCols + lane;
        const uint8_t* ip = d.idx + static_cast<size_t>(g) * s.keep * s.O + o;
        for (int k = 0; k < s.keep; ++k) {
          const int id = ip[static_cast<size_t>(k) * s.O];
          if (id < s.h_g)
            col[id * kCols] = __fadd_rn(col[id * kCols],
                                        __fadd_rn(0.f, decode_value(d, s, dc, g, k, o)));
        }
        const float* xg = xs + (g - g0) * s.h_g;
        for (int i = 0; i < s.h_g; ++i) {
          const float m = col[i * kCols];
#pragma unroll
          for (int r = 0; r < TB; ++r) acc[r] = __fmaf_rn(xg[r * ch + i], m, acc[r]);
        }
      }
    }
  }

  // fixed-order combine of the per-warp partials: ((w0 + w1) + w2) + ...
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TB; ++r) smem[(warp * TB + r) * kCols + lane] = acc[r];
  __syncthreads();
  if (warp == 0 && live) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      float t = smem[r * kCols + lane];
      for (int v = 1; v < kWarps; ++v) t = __fadd_rn(t, smem[(v * TB + r) * kCols + lane]);
      if (r0 + r < s.T) y[static_cast<size_t>(r0 + r) * s.O + o] = t;
    }
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

bool shape_ok(const Shape& s, int tb) {
  return s.T > 0 && s.O > 0 && s.h_g > 0 && s.keep > 0 && s.keep <= s.h_g &&
         s.h_g <= 256 && s.h_g <= kSmemFloats / tb && s.h_in == s.G * s.h_g &&
         (s.wbits == 0 || s.wbits == 1 || s.wbits == 2 || s.wbits == 4 ||
          s.wbits == 8);
}

cudaError_t launch_spmm(const float* x, Delta d, Shape s, float* y, int tb,
                        cudaStream_t st) {
  const dim3 block(kThreads);
  const dim3 grid((s.T + tb - 1) / tb, (s.O + kCols - 1) / kCols);
  switch (tb) {
    case 8: spmm_kernel<8><<<grid, block, 0, st>>>(x, d, s, y); break;
    case 16: spmm_kernel<16><<<grid, block, 0, st>>>(x, d, s, y); break;
    case 32: spmm_kernel<32><<<grid, block, 0, st>>>(x, d, s, y); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_segments(const float* x, Delta d, Shape s, Strides strides,
                            int n_tenants, const int* seg_rows, const int* seg_offsets,
                            int n_seg, float* y, int tb, cudaStream_t st) {
  const dim3 block(kThreads);
  const dim3 grid((s.T + tb - 1) / tb, (s.O + kCols - 1) / kCols);
  switch (tb) {
    case 8:
      segments_kernel<8><<<grid, block, 0, st>>>(
          x, d, s, strides, n_tenants, seg_rows, seg_offsets, n_seg, y);
      break;
    case 16:
      segments_kernel<16><<<grid, block, 0, st>>>(
          x, d, s, strides, n_tenants, seg_rows, seg_offsets, n_seg, y);
      break;
    case 32:
      segments_kernel<32><<<grid, block, 0, st>>>(
          x, d, s, strides, n_tenants, seg_rows, seg_offsets, n_seg, y);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int TB, typename WT>
cudaError_t launch_fused_tb(const float* x, const void* w, Delta d, Shape s, int ch,
                            float* y, cudaStream_t st) {
  const size_t smem = fused_smem_bytes(TB, ch);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<TB, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFusedSmemFloats * sizeof(float)));
  if (err != cudaSuccess) return err;
  const dim3 grid((s.T + TB - 1) / TB, (s.O + kCols - 1) / kCols);
  fused_kernel<TB, WT><<<grid, kThreads, smem, st>>>(
      x, static_cast<const WT*>(w), d, s, ch, y);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_fused(const float* x, const void* w, Delta d, Shape s, float* y,
                         int tb, cudaStream_t st) {
  const int ch = fused_chunk(tb, s);
  switch (tb) {
    case 8: return launch_fused_tb<8, WT>(x, w, d, s, ch, y, st);
    case 16: return launch_fused_tb<16, WT>(x, w, d, s, ch, y, st);
    case 32: return launch_fused_tb<32, WT>(x, w, d, s, ch, y, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [T, h_in] f32; idx [G, keep, O] uint8; codes [G, kp, O] uint8 or
// f32 [G, keep, O] (wbits = 0); scale f32 and zero int32 device scalars;
// y [T, O] f32.
int delta_spmm_launch(const void* x, const void* idx,
                      const void* codes, const void* scale, const void* zero,
                      void* y, int T, int h_in, int O, int h_g, int keep, int kp,
                      int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s, tb)) return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  return static_cast<int>(launch_spmm(static_cast<const float*>(x), d, s, yp, tb, st));
}

// As delta_spmm_launch, with a tenant-stacked delta: idx [R, G, keep, O],
// codes [R, G, kp, O] (or f32 [R, G, keep, O]), scale/zero [R], each
// tenant's block contiguous and the tenant axis strided by idx_stride /
// codes_stride bytes and scale_stride / zero_stride elements; seg_rows
// [n_seg] int32 tenant row per segment, seg_offsets [n_seg + 1] int32
// half-open row ranges over the tenant-sorted rows of x. Every row of y
// is written: rows no segment covers, and rows of a segment whose
// tenant row is outside [0, R), are zero.
int delta_spmm_segments_launch(const void* x, const void* idx,
                               const void* codes, const void* scale,
                               const void* zero, int n_tenants, long long idx_stride,
                               long long codes_stride, long long scale_stride,
                               long long zero_stride, const void* seg_rows,
                               const void* seg_offsets, int n_seg, void* y, int T,
                               int h_in, int O, int h_g, int keep, int kp,
                               int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s, tb) || n_seg < 1 || n_tenants < 1 || idx_stride < 0 ||
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

// x [T, h_in] f32; w [h_in, O] bf16 (w_bf16 = 1) or f32 (w_bf16 = 0); the
// packed delta as for delta_spmm_launch; y [T, O] f32 = x @ (w + dense).
int fused_base_delta_launch(const void* x, const void* w, int w_bf16, const void* idx,
                            const void* codes, const void* scale, const void* zero,
                            void* y, int T, int h_in, int O, int h_g, int keep, int kp,
                            int wbits, int tb, void* stream) {
  const Shape s{T, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s, tb) || fused_chunk(tb, s) < h_g)
    return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  return static_cast<int>(w_bf16 ? launch_fused<__nv_bfloat16>(xp, w, d, s, yp, tb, st)
                                 : launch_fused<float>(xp, w, d, s, yp, tb, st));
}

// The packed delta as for delta_spmm_launch -> out [h_in, O] f32, every
// element written.
int dequant_launch(const void* idx, const void* codes, const void* scale,
                   const void* zero, void* out, int h_in, int O, int h_g, int keep,
                   int kp, int wbits, void* stream) {
  const Shape s{1, h_in, O, h_g > 0 ? h_in / h_g : 0, h_g, keep, kp, wbits};
  if (!shape_ok(s, 8)) return static_cast<int>(cudaErrorInvalidValue);
  const Delta d{static_cast<const uint8_t*>(idx), static_cast<const uint8_t*>(codes),
                static_cast<const float*>(scale), static_cast<const int*>(zero)};
  const dim3 grid((s.G + kWarps - 1) / kWarps, (s.O + kCols - 1) / kCols);
  dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, s, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
