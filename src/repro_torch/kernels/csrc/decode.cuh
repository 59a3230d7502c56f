// The decode route's routine (cluster_correction) and its two kernels,
// spmm_decode_kernel and segments_decode_kernel, templated on the idx
// entry type; each of decode_{spmm,segments}_{u8,i32}.cu instantiates
// one kernel at one type, so nvcc compiles the four in parallel. The
// design is described in delta_spmm.cu.
#pragma once

#include "common.cuh"

namespace dq {

// x[row0 + r][g * h_g + i] of class c's nq groups (g = c, c + 8, ...)
// for rows r < R -> slab[r][q * h_g + i] (row stride nq * h_g): 16-byte
// cp.async where xvec (a shift where h_g / 4 is a power of two), else
// plain loads; the caller commits the cp.async group.
template <int R>
__device__ __forceinline__ void stage_class_x(float* slab, const float* __restrict__ x,
                                              const Shape& s, int c, int nq, int row0,
                                              bool xvec) {
  const int h_g = s.h_g, SW = nq * h_g;
  if (xvec) {
    // 16-byte chunk e of a slab row: group q = e / v4, chunk e % v4 of it
    const int v4 = h_g / 4, lv = (v4 & (v4 - 1)) ? -1 : __ffs(v4) - 1;
    for (int r = 0; r < R; ++r)
      for (int e = threadIdx.x; e < nq * v4; e += kDecThreads) {
        const int q = lv >= 0 ? e >> lv : e / v4, i4 = e - q * v4;
        cp_async16(slab + r * SW + q * h_g + i4 * 4,
                   x + static_cast<size_t>(row0 + r) * s.h_in +
                       static_cast<size_t>(c + kWarps * q) * h_g + i4 * 4,
                   16);
      }
  } else {
    for (int e = threadIdx.x; e < R * SW; e += kDecThreads) {
      const int r = e / SW, rem = e - r * SW;
      const int q = rem / h_g, i = rem - q * h_g;
      slab[e] = x[static_cast<size_t>(row0 + r) * s.h_in +
                  static_cast<size_t>(c + kWarps * q) * h_g + i];
    }
  }
}

// The cluster's combine, once every block has written its class partial
// [R][NC] to `part` in its shared memory: block c writes its share of the
// tile's columns as ((P0 + P1) + ...) + P7, reading the other blocks'
// partials over distributed shared memory (all eight loads first,
// unrolled, so the remote reads overlap); a class past the cluster (no
// group) adds its zero partial. Synchronises the cluster before and
// after (no block leaves while another reads its partial).
template <int NC>
__device__ __forceinline__ void combine_classes(float* part, int R, const Shape& s,
                                                const DecPlan& p, int row0, int col0,
                                                float* __restrict__ y) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  cluster.sync();  // every class partial of the tile is in
  const int per = (NC + p.cb - 1) / p.cb;  // columns each block of the cluster writes
  for (int e = threadIdx.x; e < R * per; e += blockDim.x) {
    const int r = e / per;
    const int cc = c * per + e % per;
    if (cc < NC && col0 + cc < s.O) {
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v[w] = w < p.cb ? cluster.map_shared_rank(part, w)[r * NC + cc] : 0.f;
      float t = v[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, v[w]);
      y[static_cast<size_t>(row0 + r) * s.O + col0 + cc] = t;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// Rows [row0, row0 + R) x columns [col0, col0 + kDecCols) of x @
// dequant(d), idx entries of type IT (uint8_t or uint32_t). Called by all
// 8 blocks of a cluster with the same arguments (it synchronises the
// cluster). Block c (its rank) stages x's columns of the groups of class
// c (XG: reads them from global memory) and streams their idx/code tiles,
// each thread running P_c of its two columns for the R rows; then block c
// writes columns c * 16 .. c * 16 + 15 of the tile as ((P0 + P1) + ...) +
// P7, reading the other blocks' partials from their shared memory. A
// class with no group (c >= G) computes nothing and adds its zero
// partial, as the oracle does. RUNS: the plan may stream a group's kept
// slots in runs (kc < keep) or read x from global memory (XG); where it
// is false each step holds whole groups and the run logic compiles away.
template <int R, typename IT, bool RUNS, bool XG>
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
  const int gb = dec_group_bytes(s, p.kc);
  const int stage_n = p.sg * gb;
  const int ncol = min(kDecCols, s.O - col0);
  const int code_rows = s.wbits ? s.kp : keep;
  const int nch = RUNS ? (keep + p.kc - 1) / p.kc : 1;  // runs of slots a group (1: whole groups)
  const int nsteps = nch == 1 ? (nq + p.sg - 1) / p.sg : nq * nch;
  constexpr int IB = kDecCols * static_cast<int>(sizeof(IT));  // bytes of a staged idx row
  const int code_at = p.kc * IB;                               // a group's code rows
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(ring + p.ns * stage_n);
  float* part = slab + (XG ? 0 : p.rt * class_count(0, s.G) * h_g);
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;  // codes per byte is a power of two
  const IT* idx = reinterpret_cast<const IT*>(d.idx);

  // step n: groups q0 .. q0 + ng - 1 of the class, kept slots k0 .. k0 + nk - 1
  auto step_of = [&](int n, int& q0, int& ng, int& k0, int& nk) {
    if (nch == 1) {
      q0 = n * p.sg;
      ng = min(p.sg, nq - q0);
      k0 = 0;
      nk = keep;
    } else {
      q0 = n / nch;
      ng = 1;
      k0 = (n - q0 * nch) * p.kc;
      nk = min(p.kc, keep - k0);
    }
  };

  // step n -> stage n % ns, one cp.async group a step: 16-byte copies
  // spread over all threads for a full tile in 16-byte aligned rows, else
  // plain loads by each thread of its own columns (zero past O)
  auto issue = [&](int n) {
    if (n < nsteps) {
      unsigned char* st = ring + (n % p.ns) * stage_n;
      int q0, ng, k0, nk;
      step_of(n, q0, ng, k0, nk);
      if (p.vec && ncol == kDecCols && sizeof(IT) == 1 && s.wbits && nch == 1) {
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
      } else if (p.vec && ncol == kDecCols) {
        // any idx width, f32 codes, a run of slots: a group's chunks are
        // its nk idx rows of IB / 16 chunks, then its code rows of 8 (or
        // 32 for f32) chunks; thread t copies chunks t, t + 64, ...
        const int li = sizeof(IT) == 1 ? 3 : 5, lc = s.wbits ? 3 : 5;
        const int cw = s.wbits ? 1 : 4;                        // bytes of a code entry
        const int ncr = dec_code_rows(s, nk), kr0 = s.wbits ? k0 / dc.per : k0;
        const int ni = nk << li, P = ni + (ncr << lc);         // chunks a group
        int qq = 0, w = tid;
        while (w >= P) w -= P, ++qq;
        while (qq < ng) {
          const size_t g = c + kWarps * (q0 + qq);
          unsigned char* dst = st + qq * gb;
          const unsigned char* src;
          if (w < ni) {
            const int r = w >> li, ch = w & ((1 << li) - 1);
            src = d.idx + ((g * keep + k0 + r) * s.O + col0) * sizeof(IT) + ch * 16;
            dst += r * IB + ch * 16;
          } else {
            const int w2 = w - ni, r = w2 >> lc, ch = w2 & ((1 << lc) - 1);
            src = d.codes + ((g * code_rows + kr0 + r) * s.O + col0) * cw + ch * 16;
            dst += code_at + r * (kDecCols * cw) + ch * 16;
          }
          cp_async16(dst, src, 16);
          for (w += kDecThreads; w >= P; w -= P) ++qq;
        }
      } else {
        const int ncr = dec_code_rows(s, nk), kr0 = s.wbits ? k0 / dc.per : k0;
        for (int j = 2 * tid; j < 2 * tid + 2; ++j) {
          const bool live = j < ncol;
          const size_t o = col0 + j;
          for (int qq = 0; qq < ng; ++qq) {
            const size_t g = c + kWarps * (q0 + qq);
            unsigned char* gs = st + qq * gb;
            for (int k = 0; k < nk; ++k)
              reinterpret_cast<IT*>(gs)[k * kDecCols + j] =
                  live ? idx[(g * keep + k0 + k) * s.O + o] : IT(0);
            for (int r = 0; r < ncr; ++r) {
              if (s.wbits)
                gs[code_at + r * kDecCols + j] =
                    live ? d.codes[(g * code_rows + kr0 + r) * s.O + o] : 0;
              else
                reinterpret_cast<float*>(gs + code_at)[r * kDecCols + j] =
                    live ? reinterpret_cast<const float*>(d.codes)[(g * keep + k0 + r) * s.O + o]
                         : 0.f;
            }
          }
        }
      }
    }
    cp_async_commit();
  };

  // x[row0 + r][g * h_g + i] of the class's groups -> slab[r][q * h_g + i]
  // (the first cp.async group; empty where XG), then every stage, all free
  // at the start; a later step goes into the stage that the step before
  // it freed
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
      int q0, ng, k0, nk;
      step_of(n, q0, ng, k0, nk);
      const int nterms = ng * nk;
      // P_c: the class's groups in increasing g, each group's kept slots
      // in order (a run of them continues where the step before ended),
      // one rounded product and one rounded sum a term. k0 is a multiple
      // of the codes a byte holds, so a slot's code shift is its k's.
      int qq = 0, k = 0;
#pragma unroll 4
      for (int j = 0; j < nterms; ++j) {
        const unsigned char* gs = st + qq * gb;
        unsigned id0, id1;
        if (sizeof(IT) == 1) {
          const unsigned ids =
              *reinterpret_cast<const unsigned short*>(gs + k * kDecCols + 2 * tid);
          id0 = ids & 0xffu;
          id1 = ids >> 8;
        } else {
          const uint2 ids = *reinterpret_cast<const uint2*>(gs + k * IB + 8 * tid);
          id0 = ids.x;
          id1 = ids.y;
        }
        unsigned raw0, raw1;
        if (s.wbits) {
          const unsigned cw = *reinterpret_cast<const unsigned short*>(
              gs + code_at + (k >> pshift) * kDecCols + 2 * tid);
          raw0 = cw & 0xffu;
          raw1 = cw >> 8;
        } else {
          const uint2 cw = *reinterpret_cast<const uint2*>(gs + code_at +
                                                           k * kDecCols * 4 + 8 * tid);
          raw0 = cw.x;
          raw1 = cw.y;
        }
        const float v0 = decode_raw(s, dc, raw0, k), v1 = decode_raw(s, dc, raw1, k);
        const float* xq = xc + (q0 + qq) * x_grp;
        const float* x0 = xq + id0;
        const float* x1 = xq + id1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[0][r] = __fadd_rn(acc[0][r], __fmul_rn(x0[r * x_row], v0));
          acc[1][r] = __fadd_rn(acc[1][r], __fmul_rn(x1[r * x_row], v1));
        }
        if (++k == nk) {
          k = 0;
          ++qq;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float2*>(part + r * kDecCols + 2 * tid) = make_float2(acc[0][r], acc[1][r]);
  combine_classes<kDecCols>(part, R, s, p, row0, col0, y);
}


// G < 8 (the narrow tile): rows [row0, row0 + R) x columns [col0, col0 +
// kNarCols) of x @ dequant(d), idx entries of type IT. Each class holds
// one group, so block c of the cluster (its rank, c < G) runs group c:
// warp r the chain of row r, lane l column col0 + l, one chain a thread
// in slot order. It stages the rows' x columns of group c (XG: reads them
// from global memory) and streams the group's [keep, 32] idx/code tile
// (whole, or in runs of kc slots); then block c writes its share of the
// tile's columns as ((P0 + P1) + ...) + P7, reading the other blocks'
// partials from their shared memory, the classes past G adding their zero
// partial. Called by all blocks of a cluster with the same arguments; R
// (the rows, at most p.rt) is a runtime count, a warp a row.
template <typename IT, bool RUNS, bool XG>
__device__ void narrow_correction(int R, const float* __restrict__ x, const Delta& d,
                                  const Shape& s, const DecPlan& p, int row0, int col0,
                                  float* __restrict__ y, unsigned char* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, wr = tid >> 5, nth = blockDim.x;
  const int keep = s.keep, h_g = s.h_g;
  const int gb = nar_group_bytes(s, p.kc);
  const int ncol = min(kNarCols, s.O - col0);
  const int code_rows = s.wbits ? s.kp : keep;
  const int nsteps = RUNS ? (keep + p.kc - 1) / p.kc : 1;
  constexpr int IB = kNarCols * static_cast<int>(sizeof(IT));  // bytes of a staged idx row
  const int code_at = p.kc * IB;                               // the step's code rows
  const int cw = s.wbits ? 1 : 4;                              // bytes of a code entry
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(ring + p.ns * gb);
  float* part = slab + (XG ? 0 : p.rt * h_g);
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;  // codes per byte is a power of two
  const IT* idx = reinterpret_cast<const IT*>(d.idx);
  const size_t g = c;

  // step n (kept slots n * kc ..) -> stage n % ns, one cp.async group a
  // step: 16-byte copies spread over the block for a full tile in 16-byte
  // aligned rows, else plain loads (zero past O)
  auto issue = [&](int n) {
    if (n < nsteps) {
      unsigned char* st = ring + (n % p.ns) * gb;
      const int k0 = n * p.kc, nk = min(p.kc, keep - k0);
      const int ncr = dec_code_rows(s, nk), kr0 = s.wbits ? k0 / dc.per : k0;
      if (p.vec && ncol == kNarCols) {
        // an idx row is 2 (uint8) or 8 (int32) chunks, a code row 2 or 8 (f32)
        constexpr int li = sizeof(IT) == 1 ? 1 : 3;
        const int lc = s.wbits ? 1 : 3;
        const int ni = nk << li, P = ni + (ncr << lc);
        for (int w = tid; w < P; w += nth) {
          const unsigned char* src;
          unsigned char* dst;
          if (w < ni) {
            const int r = w >> li, ch = w & ((1 << li) - 1);
            src = d.idx + ((g * keep + k0 + r) * s.O + col0) * sizeof(IT) + ch * 16;
            dst = st + r * IB + ch * 16;
          } else {
            const int w2 = w - ni, r = w2 >> lc, ch = w2 & ((1 << lc) - 1);
            src = d.codes + ((g * code_rows + kr0 + r) * s.O + col0) * cw + ch * 16;
            dst = st + code_at + r * (kNarCols * cw) + ch * 16;
          }
          cp_async16(dst, src, 16);
        }
      } else {
        for (int e = tid; e < nk * kNarCols; e += nth) {
          const int r = e / kNarCols, j = e % kNarCols;
          reinterpret_cast<IT*>(st)[e] =
              j < ncol ? idx[(g * keep + k0 + r) * s.O + col0 + j] : IT(0);
        }
        for (int e = tid; e < ncr * kNarCols; e += nth) {
          const int r = e / kNarCols, j = e % kNarCols;
          const size_t src = (g * code_rows + kr0 + r) * s.O + col0 + j;
          if (s.wbits)
            st[code_at + e] = j < ncol ? d.codes[src] : 0;
          else
            reinterpret_cast<float*>(st + code_at)[e] =
                j < ncol ? reinterpret_cast<const float*>(d.codes)[src] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  // x[row0 + r][c * h_g + i] -> slab[r][i] (the first cp.async group;
  // empty where XG), then every stage, all free at the start
  if (XG) {
    // no slab
  } else if (p.xvec) {
    const int v4 = h_g / 4;
    for (int e = tid; e < R * v4; e += nth) {
      const int r = e / v4, i4 = e - r * v4;
      cp_async16(slab + r * h_g + i4 * 4,
                 x + static_cast<size_t>(row0 + r) * s.h_in + g * h_g + i4 * 4, 16);
    }
  } else {
    for (int e = tid; e < R * h_g; e += nth) {
      const int r = e / h_g, i = e - r * h_g;
      slab[e] = x[static_cast<size_t>(row0 + r) * s.h_in + g * h_g + i];
    }
  }
  cp_async_commit();
  for (int n = 0; n < p.ns; ++n) issue(n);
  int committed = 1 + p.ns;  // cp.async groups: the slab, then one a step

  // row wr's x of the group: the slab, or x itself
  const float* xr = XG ? x + static_cast<size_t>(row0 + wr) * s.h_in + g * h_g
                       : slab + wr * h_g;
  float acc = 0.f;
  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait(max(committed - (n + 2), 0));  // the slab and steps <= n
    __syncthreads();  // step n and the slab are in for all; step n - 1 is done
    if (n > 0) {
      issue(n + p.ns - 1);
      ++committed;
    }
    if (wr < R && lane < ncol) {
      const unsigned char* st = ring + (n % p.ns) * gb;
      const int nk = RUNS ? min(p.kc, keep - n * p.kc) : keep;
      const IT* ids = reinterpret_cast<const IT*>(st) + lane;
      // the group's kept slots in order (a run continues where the step
      // before ended; k0 is a multiple of the codes a byte holds, so a
      // slot's code shift is its k's), one rounded product and one
      // rounded sum a term
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        const unsigned raw =
            s.wbits ? st[code_at + (k >> pshift) * kNarCols + lane]
                    : reinterpret_cast<const unsigned*>(st + code_at)[k * kNarCols + lane];
        acc = __fadd_rn(acc, __fmul_rn(xr[ids[k * kNarCols]], decode_raw(s, dc, raw, k)));
      }
    }
  }

  if (wr < R) part[wr * kNarCols + lane] = acc;
  // combine_classes' combine, written out: through the helper this tile
  // ran 2-3% slower at 4 and 8 rows (row-wise T = 8, PERF.md)
  cluster.sync();  // every class partial of the tile is in
  const int per = (kNarCols + p.cb - 1) / p.cb;  // columns each block of the cluster writes
  for (int e = tid; e < R * per; e += nth) {
    const int r = e / per;
    const int cc = c * per + e % per;
    if (cc < kNarCols && col0 + cc < s.O) {
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v[w] = w < p.cb ? cluster.map_shared_rank(part, w)[r * kNarCols + cc] : 0.f;
      float t = v[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, v[w]);
      y[static_cast<size_t>(row0 + r) * s.O + col0 + cc] = t;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// cluster_correction at R = rows (1..8), one instance per count, so a
// block computes only real rows; a plan with x in global memory has one
// row a block
template <typename IT, bool RUNS>
__device__ __forceinline__ void rows_correction(int rows, const float* x, const Delta& d,
                                                const Shape& s, const DecPlan& p, int row0,
                                                int col0, float* y, unsigned char* smem) {
  if constexpr (RUNS) {
    if (p.xg) {
      cluster_correction<1, IT, true, true>(x, d, s, p, row0, col0, y, smem);
      return;
    }
  }
  switch (rows) {
    case 1: cluster_correction<1, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 2: cluster_correction<2, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 3: cluster_correction<3, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 4: cluster_correction<4, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 5: cluster_correction<5, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 6: cluster_correction<6, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    case 7: cluster_correction<7, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
    default: cluster_correction<8, IT, RUNS, false>(x, d, s, p, row0, col0, y, smem); break;
  }
}

// the tile's correction: the 128-column cluster routine, or the narrow
// tile (NAR, G < 8; a plan with x in global memory has one row a block)
template <typename IT, bool RUNS, bool NAR>
__device__ __forceinline__ void tile_correction(int rows, const float* x, const Delta& d,
                                                const Shape& s, const DecPlan& p, int row0,
                                                int col0, float* y, unsigned char* smem) {
  if constexpr (!NAR) {
    rows_correction<IT, RUNS>(rows, x, d, s, p, row0, col0, y, smem);
  } else {
    if constexpr (RUNS) {
      if (p.xg) {
        narrow_correction<IT, true, true>(1, x, d, s, p, row0, col0, y, smem);
        return;
      }
    }
    narrow_correction<IT, RUNS, false>(rows, x, d, s, p, row0, col0, y, smem);
  }
}

// grid (p.cb * column tiles, row tiles of p.rt rows), clusters of p.cb
// blocks (a launch attribute); the last row tile holds what is left of T.
// __maxnreg__: left to itself ptxas took 64 registers and spilled in the
// 8-row instance. NAR: the narrow tile (G < 8), blocks of 32 * p.rt
// threads.
template <typename IT, bool RUNS, bool NAR>
__global__ void __maxnreg__(128)
spmm_decode_kernel(const float* __restrict__ x, Delta d, Shape s, DecPlan p,
                   float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int row0 = blockIdx.y * p.rt;
  tile_correction<IT, RUNS, NAR>(min(p.rt, s.T - row0), x, d, s, p, row0,
                                 (blockIdx.x / p.cb) * (NAR ? kNarCols : kDecCols), y, dsmem);
}

// Rows [r0, r1) x this cluster block's share of the columns of the tile
// at col0 <- 0.
template <bool NAR>
__device__ __forceinline__ void zero_rows(float* __restrict__ y, const Shape& s,
                                          const DecPlan& p, int r0, int r1, int col0) {
  constexpr int NC = NAR ? kNarCols : kDecCols;
  const int c = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int per = (NC + p.cb - 1) / p.cb;
  for (int e = threadIdx.x; e < (r1 - r0) * per; e += (NAR ? blockDim.x : kDecThreads)) {
    const int cc = c * per + e % per, o = col0 + cc;
    if (cc < NC && o < s.O) y[static_cast<size_t>(r0 + e / per) * s.O + o] = 0.f;
  }
}

// The segments kernels' tiles (segments_decode_kernel here,
// dense_segments_kernel in dense.cuh): grid y enumerates the row tiles of
// the segments in segment order, each tile p.rt rows from its segment's
// start (gridDim.y - 1 bounds their count from above; the blocks past the
// last tile leave at once). The last y zero-fills the rows before the
// first segment and after the last; a segment whose tenant row lies
// outside the stack is zero-filled by its own tiles. Every other block
// gets its tile's first row, its rows (at most p.rt: a tile takes only
// its segment's rows) and its tenant's delta, and true. A cluster's
// blocks share blockIdx.y, so they agree. seg_offsets must be
// non-decreasing (tenant_segments' layout).
template <bool NAR>
__device__ __forceinline__ bool segment_tile(const Delta& stack, const Shape& s,
                                             const Strides& st, int n_tenants,
                                             const int* __restrict__ seg_rows,
                                             const int* __restrict__ seg_offsets, int n_seg,
                                             const DecPlan& p, int col0, float* __restrict__ y,
                                             Delta& d, int& row0, int& rows) {
  auto offset = [&](int i) { return min(max(seg_offsets[i], 0), s.T); };
  if (blockIdx.y == gridDim.y - 1) {
    zero_rows<NAR>(y, s, p, 0, offset(0), col0);
    zero_rows<NAR>(y, s, p, max(offset(0), offset(n_seg)), s.T, col0);
    return false;
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
  if (seg < 0) return false;  // past the last tile: the whole cluster leaves
  row0 = offset(seg) + tile * p.rt;
  rows = min(p.rt, offset(seg + 1) - row0);
  const int t = seg_rows[seg];
  if (t < 0 || t >= n_tenants) {
    zero_rows<NAR>(y, s, p, row0, row0 + rows, col0);
    return false;
  }
  d = Delta{stack.idx + t * st.idx, stack.codes + t * st.codes, stack.scale + t * st.scale,
            stack.zero + t * st.zero};
  return true;
}

template <typename IT, bool RUNS, bool NAR>
__global__ void __maxnreg__(128)
segments_decode_kernel(const float* __restrict__ x, Delta stack, Shape s, Strides st,
                       int n_tenants, const int* __restrict__ seg_rows,
                       const int* __restrict__ seg_offsets, int n_seg, DecPlan p,
                       float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int col0 = (blockIdx.x / p.cb) * (NAR ? kNarCols : kDecCols);
  Delta d;
  int row0, rows;
  if (segment_tile<NAR>(stack, s, st, n_tenants, seg_rows, seg_offsets, n_seg, p, col0, y, d,
                        row0, rows))
    tile_correction<IT, RUNS, NAR>(rows, x, d, s, p, row0, col0, y, dsmem);
}

// The decode route's plan for row tile tb (1, 2, 4 or 8 rows at most a
// block); vec and xvec from the row alignments (O % 16 == 0 makes every
// idx and code row a multiple of 16 bytes).
inline bool dec_launch_plan(const float* x, const Delta& d, const Shape& s, int tb, bool strides_ok,
                     DecPlan& p, size_t& smem) {
  if (!dec_plan(s, tb, p)) return false;
  p.vec = strides_ok && s.O % 16 == 0 && reinterpret_cast<uintptr_t>(d.idx) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  p.xvec = s.h_g % 4 == 0 && s.h_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  smem = dec_smem_bytes(s, p);
  return true;
}

// whether the plan needs the RUNS instance of the decode kernels
inline bool dec_runs(const Shape& s, const DecPlan& p) { return p.kc < s.keep || p.xg; }

// launches kernel on grid with clusters of p.cb blocks (set at launch:
// the kernels carry no compile-time cluster shape), blocks of kDecThreads
// threads, or a warp a row of the narrow tile
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                             cudaStream_t st, const DecPlan& p, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.nc == kNarCols ? 32 * p.rt : kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename IT>
cudaError_t launch_spmm_decode(const float* x, Delta d, Shape s, float* y, int tb,
                               cudaStream_t st) {
  DecPlan p;
  size_t smem;
  if (!dec_launch_plan(x, d, s, tb, true, p, smem)) return cudaErrorInvalidValue;
  const bool runs = dec_runs(s, p);
  const auto kernel = p.nc == kNarCols
                          ? (runs ? spmm_decode_kernel<IT, true, true>
                                  : spmm_decode_kernel<IT, false, true>)
                          : (runs ? spmm_decode_kernel<IT, true, false>
                                  : spmm_decode_kernel<IT, false, false>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.cb * ((s.O + p.nc - 1) / p.nc), (s.T + p.rt - 1) / p.rt);
  const cudaError_t launched = launch_clustered(kernel, grid, smem, st, p, x, d, s, p, y);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <typename IT>
cudaError_t launch_segments(const float* x, Delta d, Shape s, Strides strides,
                            int n_tenants, const int* seg_rows, const int* seg_offsets,
                            int n_seg, float* y, int tb, cudaStream_t st) {
  DecPlan p;
  size_t smem;
  const bool strides_ok = strides.idx % 16 == 0 && strides.codes % 16 == 0;
  if (!dec_launch_plan(x, d, s, tb, strides_ok, p, smem)) return cudaErrorInvalidValue;
  const bool runs = dec_runs(s, p);
  const auto kernel = p.nc == kNarCols
                          ? (runs ? segments_decode_kernel<IT, true, true>
                                  : segments_decode_kernel<IT, false, true>)
                          : (runs ? segments_decode_kernel<IT, true, false>
                                  : segments_decode_kernel<IT, false, false>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // segments' tiles: m nonempty segments (m <= min(n_seg, T)) of T rows in
  // all need at most m + (T - m) / rt tiles, largest at m = min(n_seg, T);
  // one more y zero-fills the rows outside the segments
  const int m = std::min(n_seg, s.T);
  const dim3 grid(p.cb * ((s.O + p.nc - 1) / p.nc), m + (s.T - m) / p.rt + 1);
  const cudaError_t launched =
      launch_clustered(kernel, grid, smem, st, p, x, d, s, strides,
                       n_tenants, seg_rows, seg_offsets, n_seg, p, y);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace dq
