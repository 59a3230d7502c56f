// The dense-group walk: the decode route's and the segments kernel's
// correction (dense_correction, dense_spmm_kernel, dense_segments_kernel)
// for a packing whose every group keeps all h_g slots with idx[g, k, o] =
// k: the codecs' keep-everything lowerings (BitDelta's 2-bit codes,
// LowRank's f32 values; repro_torch/core/codecs.py::_dense_as_structured).
// The host says so (delta_spmm_launch's `dense`); the library never infers
// it from shapes. dense_{spmm,segments}.cu instantiate one kernel each, so
// nvcc compiles them in parallel with the other units. The design is
// described in delta_spmm.cu.
#pragma once

#include "decode.cuh"

namespace dq {

// Rows [row0, row0 + R) x columns [col0, col0 + kDecCols) of x @
// dequant(d), d a dense packing (keep = h_g, idx = arange). Called by all
// blocks of a cluster of p.cb = min(G, 8) blocks with the same arguments
// (it synchronises the cluster). Block c (its rank) stages the R rows' x
// columns of the groups of class c (XG: reads them from global memory)
// and streams their code rows only -- no idx -- each thread running P_c
// of its two columns for the R rows: at slot k of group g every column
// multiplies the same x[r, g * h_g + k], one shared-memory broadcast a
// row (16 bytes, four slots, where x is 16-byte aligned). Then block c
// writes its share of the tile's columns as ((P0 + P1) + ...) + P7,
// reading the other blocks' partials from their shared memory; a class
// with no group (c >= G) adds its zero partial, as the oracle does. The
// chain, each product and each sum are cluster_correction's on the same
// packing with its idx read, bit for bit. RUNS: a step holds a run of kc
// of one group's slots (kc < keep), or x is read from global memory (XG);
// where it is false each step holds whole groups. F32: codes are raw f32
// values (wbits == 0), else bit-packed codes decoded as decode_raw.
template <int R, bool RUNS, bool XG, bool F32>
__device__ void dense_correction(const float* __restrict__ x, const Delta& d, const Shape& s,
                                 const DecPlan& p, int row0, int col0, float* __restrict__ y,
                                 unsigned char* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int h_g = s.h_g;                // == keep
  const int nq = class_count(c, s.G);   // this class's groups
  const int SW = nq * h_g;              // x slab row stride
  const int gb = dense_group_bytes(s, p.kc);
  const int stage_n = p.sg * gb;
  const int ncol = min(kDecCols, s.O - col0);
  const int code_rows = F32 ? h_g : s.kp;  // a group's code rows in device memory
  constexpr int CW = F32 ? 4 : 1;          // bytes of a code entry
  const int nch = RUNS ? (h_g + p.kc - 1) / p.kc : 1;  // runs of slots a group (1: whole groups)
  const int nsteps = nch == 1 ? (nq + p.sg - 1) / p.sg : nq * nch;
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(ring + p.ns * stage_n);
  float* part = slab + (XG ? 0 : p.rt * class_count(0, s.G) * h_g);
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;  // codes per byte is a power of two

  // step n: groups q0 .. q0 + ng - 1 of the class, slots k0 .. k0 + nk - 1
  auto step_of = [&](int n, int& q0, int& ng, int& k0, int& nk) {
    if (nch == 1) {
      q0 = n * p.sg;
      ng = min(p.sg, nq - q0);
      k0 = 0;
      nk = h_g;
    } else {
      q0 = n / nch;
      ng = 1;
      k0 = (n - q0 * nch) * p.kc;
      nk = min(p.kc, h_g - k0);
    }
  };

  // step n -> stage n % ns, one cp.async group a step: the step's code
  // rows as 16-byte copies spread over all threads for a full tile in
  // 16-byte aligned rows (a row is 8 chunks of bytes or 32 of f32, so
  // thread t copies chunk t % (8|32) of every 8th (2nd) row: no division
  // a copy), else plain loads (zero past O)
  auto issue = [&](int n) {
    if (n < nsteps) {
      unsigned char* st = ring + (n % p.ns) * stage_n;
      int q0, ng, k0, nk;
      step_of(n, q0, ng, k0, nk);
      const int ncr = dec_code_rows(s, nk), kr0 = F32 ? k0 : k0 >> pshift;
      if (p.vec && ncol == kDecCols) {
        constexpr int lc = F32 ? 5 : 3, rstep = kDecThreads >> lc;
        const int ch = tid & ((1 << lc) - 1);
        int qq = 0, rr = tid >> lc;
        for (; rr >= ncr; rr -= ncr) ++qq;
        while (qq < ng) {
          const size_t g = c + kWarps * (q0 + qq);
          cp_async16(st + qq * gb + rr * (kDecCols * CW) + ch * 16,
                     d.codes + ((g * code_rows + kr0 + rr) * s.O + col0) * CW + ch * 16, 16);
          for (rr += rstep; rr >= ncr; rr -= ncr) ++qq;
        }
      } else {
        for (int e = tid; e < ng * ncr * kDecCols; e += kDecThreads) {
          const int j = e % kDecCols, ra = e / kDecCols, qq = ra / ncr, r = ra - qq * ncr;
          const size_t g = c + kWarps * (q0 + qq);
          const size_t src = (g * code_rows + kr0 + r) * s.O + col0 + j;
          unsigned char* dst = st + qq * gb + r * (kDecCols * CW);
          if (F32)
            reinterpret_cast<float*>(dst)[j] =
                j < ncol ? reinterpret_cast<const float*>(d.codes)[src] : 0.f;
          else
            dst[j] = j < ncol ? d.codes[src] : 0;
        }
      }
    }
    cp_async_commit();
  };

  // x[row0 + r][g * h_g + i] of the class's groups -> slab[r][q * h_g + i]
  // (the first cp.async group; empty where XG), then every stage, all free
  // at the start; a later step goes into the stage the step before it freed
  if (!XG) stage_class_x<R>(slab, x, s, c, nq, row0, p.xvec);
  cp_async_commit();
  for (int n = 0; n < p.ns; ++n) issue(n);
  int committed = 1 + p.ns;  // cp.async groups: the slab, then one a step

  // where the class's x lives: the slab (row stride SW, group stride
  // h_g), or x itself (row stride h_in, group stride 8 * h_g)
  const float* xc = XG ? x + static_cast<size_t>(row0) * s.h_in + static_cast<size_t>(c) * h_g
                       : slab;
  const int x_row = XG ? s.h_in : SW;
  const int x_grp = XG ? kWarps * h_g : h_g;

  float acc0[R], acc1[R];  // columns 2 tid and 2 tid + 1
#pragma unroll
  for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
  // slot k of the staged rows at cs: both columns' values (a run starts on
  // a code byte, so a slot's code shift is its k's)
  auto values = [&](const unsigned char* cs, int k, float& v0, float& v1) {
    if (F32) {
      const float2 w = *reinterpret_cast<const float2*>(cs + k * (kDecCols * 4) + 8 * tid);
      v0 = w.x;
      v1 = w.y;
    } else {
      // decode_raw's arithmetic, its wbits == 0 test left out
      const unsigned w = *reinterpret_cast<const unsigned short*>(
          cs + (k >> pshift) * kDecCols + 2 * tid) >> ((k & (dc.per - 1)) * s.wbits);
      v0 = __fmul_rn(__fsub_rn(small_u2f(w & dc.mask), dc.zf), dc.scale);
      v1 = __fmul_rn(__fsub_rn(small_u2f((w >> 8) & dc.mask), dc.zf), dc.scale);
    }
  };
  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait(max(committed - (n + 2), 0));  // the slab and steps <= n
    __syncthreads();  // step n and the slab are in for all; step n - 1 is done
    if (n > 0) {
      issue(n + p.ns - 1);
      ++committed;
    }
    if (2 * tid < ncol) {
      const unsigned char* st = ring + (n % p.ns) * stage_n;
      int q0, ng, k0, nk;
      step_of(n, q0, ng, k0, nk);
      // P_c: the class's groups in increasing g, each group's slots in
      // order (a run continues where the step before ended), one rounded
      // product and one rounded sum a term
      for (int qq = 0; qq < ng; ++qq) {
        const unsigned char* cs = st + qq * gb;
        const float* xq = xc + (q0 + qq) * x_grp + k0;
        int k = 0;
        if (p.xvec) {  // h_g, k0 and nk are multiples of 4: four slots a round
#pragma unroll 2
          for (; k < nk; k += 4) {
            float4 xv[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
              xv[r] = *reinterpret_cast<const float4*>(xq + r * x_row + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v0, v1;
              values(cs, k + j, v0, v1);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float xr = j == 0 ? xv[r].x : j == 1 ? xv[r].y : j == 2 ? xv[r].z : xv[r].w;
                acc0[r] = __fadd_rn(acc0[r], __fmul_rn(xr, v0));
                acc1[r] = __fadd_rn(acc1[r], __fmul_rn(xr, v1));
              }
            }
          }
        }
#pragma unroll 4
        for (; k < nk; ++k) {
          float v0, v1;
          values(cs, k, v0, v1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xr = xq[r * x_row + k];
            acc0[r] = __fadd_rn(acc0[r], __fmul_rn(xr, v0));
            acc1[r] = __fadd_rn(acc1[r], __fmul_rn(xr, v1));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float2*>(part + r * kDecCols + 2 * tid) = make_float2(acc0[r], acc1[r]);
  combine_classes<kDecCols>(part, R, s, p, row0, col0, y);
}

// dense_correction at R = rows (1..8), one instance per count, so a block
// computes and stages only real rows; a plan with x in global memory has
// one row a block
template <bool RUNS, bool F32>
__device__ __forceinline__ void dense_rows(int rows, const float* x, const Delta& d,
                                           const Shape& s, const DecPlan& p, int row0, int col0,
                                           float* y, unsigned char* smem) {
  if constexpr (RUNS) {
    if (p.xg) {
      dense_correction<1, true, true, F32>(x, d, s, p, row0, col0, y, smem);
      return;
    }
  }
  switch (rows) {
    case 1: dense_correction<1, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 2: dense_correction<2, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 3: dense_correction<3, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 4: dense_correction<4, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 5: dense_correction<5, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 6: dense_correction<6, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    case 7: dense_correction<7, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
    default: dense_correction<8, RUNS, false, F32>(x, d, s, p, row0, col0, y, smem); break;
  }
}

template <bool RUNS>
__device__ __forceinline__ void dense_tile(int rows, const float* x, const Delta& d,
                                           const Shape& s, const DecPlan& p, int row0, int col0,
                                           float* y, unsigned char* smem) {
  if (s.wbits)
    dense_rows<RUNS, false>(rows, x, d, s, p, row0, col0, y, smem);
  else
    dense_rows<RUNS, true>(rows, x, d, s, p, row0, col0, y, smem);
}

// grid (p.cb, row tiles of p.rt rows, column tiles), clusters of p.cb
// blocks (a launch attribute); the last row tile holds what is left of T.
// The row tiles of a column tile are launched one after the other, so
// above 8 rows its codes are read from device memory about once and
// again from L2.
template <bool RUNS>
__global__ void __maxnreg__(128)
dense_spmm_kernel(const float* __restrict__ x, Delta d, Shape s, DecPlan p,
                  float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int row0 = blockIdx.y * p.rt;
  dense_tile<RUNS>(min(p.rt, s.T - row0), x, d, s, p, row0, blockIdx.z * kDecCols, y, dsmem);
}

// grid (p.cb, the segments' row tiles + 1, column tiles): the tiles as
// segments_decode_kernel lays them out along y (segment_tile), each
// computing only its segment's rows
template <bool RUNS>
__global__ void __maxnreg__(128)
dense_segments_kernel(const float* __restrict__ x, Delta stack, Shape s, Strides st,
                      int n_tenants, const int* __restrict__ seg_rows,
                      const int* __restrict__ seg_offsets, int n_seg, DecPlan p,
                      float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int col0 = blockIdx.z * kDecCols;
  Delta d;
  int row0, rows;
  if (segment_tile<false>(stack, s, st, n_tenants, seg_rows, seg_offsets, n_seg, p, col0, y, d,
                          row0, rows))
    dense_tile<RUNS>(rows, x, d, s, p, row0, col0, y, dsmem);
}

// The dense walk's plan for row tile tb; vec from the code rows'
// alignment (no idx is read), xvec from x's.
inline bool dense_launch_plan(const float* x, const Delta& d, const Shape& s, int tb,
                              bool strides_ok, DecPlan& p, size_t& smem) {
  if (!dense_plan(s, tb, p)) return false;
  p.vec = strides_ok && s.O % 16 == 0 && reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  p.xvec = s.h_g % 4 == 0 && s.h_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  smem = dense_smem_bytes(s, p);
  return true;
}

inline bool dense_runs(const Shape& s, const DecPlan& p) { return p.kc < s.keep || p.xg; }

}  // namespace dq
