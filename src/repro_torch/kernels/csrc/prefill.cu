// delta_spmm at prefill: the 128-row tile (rows in lanes) after
// transpose_pad_kernel; same bits as the decode route. The design is
// described in delta_spmm.cu.
#include "common.cuh"

namespace dq {

constexpr int kPrefillMaxGroups = 8;  // groups of one class a step may hold
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

}  // namespace dq
