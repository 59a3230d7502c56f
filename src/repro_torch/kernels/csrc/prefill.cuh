// delta_spmm at prefill: the 128-row tile (rows in lanes) after
// transpose_pad_kernel; same bits as the decode route. The kernel has two
// walks: whole groups a step (small groups, uint8 idx) and windows of x
// indices a step (every other packing, win_walk). The design is described
// in delta_spmm.cu; prefill.cu (uint8 idx, the transpose and the
// dispatch) and prefill_i32.cu (int32 idx) instantiate it, one idx width
// each.
#pragma once

#include "common.cuh"

namespace dq {

constexpr int kPrefillMaxGroups = 8;  // groups of one class a whole-group step may hold
constexpr int kPrefillThreads = 2 * kThreads;  // two row halves of 8 warps, 2 rows a lane

// The windowed walk: a step is a window of kWinIdx consecutive x indices
// of one group; each column's kept slots come from a ring of runs of
// kWinRun slots (the block's kWinCB columns: idx rows, then code rows).
constexpr int kWinIdx = 64;                        // x indices a window holds
constexpr int kWinRun = 8;                         // kept slots a ring run holds
constexpr int kWinEntries = kWinIdx + 2;           // table entries a column (even)
constexpr int kWinC = 4;                           // the kernel's C for this walk
constexpr int kWinCB = kWarps * kWinC;             // columns a block
constexpr int kWinWarps = kWinCB / 2;              // consumer warps, two columns each
constexpr int kWinThreads = (kWinWarps + 1) * 32;  // and one producer warp
constexpr int kWinStages = 4;                      // x windows in flight
constexpr int kWinPad = 16;                        // bytes after each ring row
constexpr int kWinMaxRuns = 256;                   // ring runs at most

// Shared memory of the whole-group walk: per stage sg x slabs [h_g][rb]
// f32 and their raw idx + codes (at most 5 bytes a kept value) and its
// barrier, two tables of sg [keep][cb] (offset, value) entries, and the
// running totals [rb][cb] f32.
inline size_t prefill_stage_bytes(int rb, int cb, int h_g, int keep, int sg) {
  return static_cast<size_t>(sg) * (static_cast<size_t>(h_g) * rb * sizeof(float) +
                                    (static_cast<size_t>(keep) * cb * 5 + 15) / 16 * 16);
}

inline size_t prefill_smem_bytes(int rb, int cb, int h_g, int keep, int sg, int stages) {
  return stages * (prefill_stage_bytes(rb, cb, h_g, keep, sg) + sizeof(uint64_t)) +
         2 * static_cast<size_t>(sg) * keep * cb * sizeof(int2) +
         static_cast<size_t>(rb) * cb * sizeof(float);
}

// the whole-group walk takes a packing where two stages of one group fit
// at 64 columns (uint8 idx: h_g <= 256)
inline bool prefill_whole_fits(int h_g, int keep) {
  return h_g > 0 && keep > 0 && keep <= h_g && h_g <= 256 &&
         prefill_smem_bytes(kPrefillRows, kWarps * 8, h_g, keep, 1, 2) <= kSmemMax;
}

__device__ __forceinline__ void prefill_terms(float (&part)[2], const float* xp, float v) {
  const float2 xv = *reinterpret_cast<const float2*>(xp);
  part[0] = __fadd_rn(part[0], __fmul_rn(xv.x, v));
  part[1] = __fadd_rn(part[1], __fmul_rn(xv.y, v));
}

// A step of the whole-group walk: class c, groups c + 8 j for j in
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

// ring row bytes (padded, so a half-warp reading one column in 16 rows
// spreads over the banks): idx rows of kWinCB entries, code rows
__host__ __device__ __forceinline__ int win_idx_row(int isz) { return kWinCB * isz + kWinPad; }
__host__ __device__ __forceinline__ int win_code_row(int wbits) {
  return kWinCB * (wbits ? 1 : 4) + kWinPad;
}

// code rows of a run of kWinRun slots (wbits bits a code: 8 / wbits
// codes a byte) or its f32 rows
__host__ __device__ __forceinline__ int win_code_rows(int wbits) {
  return wbits ? wbits : kWinRun;
}

// bytes of one ring run: kWinRun idx rows, then its code rows
__host__ __device__ __forceinline__ int win_run_bytes(int isz, int wbits) {
  return kWinRun * win_idx_row(isz) + win_code_rows(wbits) * win_code_row(wbits);
}

// Shared memory of the windowed walk, in this order: x windows
// [kWinStages][kWinIdx][128] f32, each consumer warp's table [2][kWinEntries]
// int2, the ring [nr][run bytes], the full and empty barriers of the x
// windows, the ring's landed runs by window [kWinStages] and each column's
// published cursor [kWinCB] (int).
inline size_t win_fixed_bytes() {
  return static_cast<size_t>(kWinStages) * kWinIdx * kPrefillRows * sizeof(float) +
         static_cast<size_t>(kWinWarps) * 2 * kWinEntries * sizeof(int2) +
         2 * kWinStages * sizeof(uint64_t) + (kWinStages + kWinCB) * sizeof(int);
}

// ring runs that fit beside the rest: a power of two (a run's place is
// its number's low bits)
inline int win_runs(int isz, int wbits) {
  const int fit = std::min(
      static_cast<int>((kSmemMax - win_fixed_bytes()) / win_run_bytes(isz, wbits)), kWinMaxRuns);
  int nr = 1;
  while (2 * nr <= fit) nr *= 2;
  return fit >= 1 ? nr : 0;
}

inline size_t win_smem_bytes(int nr, int isz, int wbits) {
  return win_fixed_bytes() + static_cast<size_t>(nr) * win_run_bytes(isz, wbits);
}

// A step of the windowed walk: window w (x indices w * kWinIdx ..) of
// group c + 8 j, the ord-th group of the class-major walk; ord < 0 past
// the last step.
struct WStep {
  int c, j, w, ord;
};

__device__ __forceinline__ WStep win_next(WStep t, int G, int nw) {
  if (t.ord < 0) return t;
  if (t.w + 1 < nw) return {t.c, t.j, t.w + 1, t.ord};
  if (t.j + 1 < class_count(t.c, G)) return {t.c, t.j + 1, 0, t.ord + 1};
  if (t.c + 1 < min(G, kWarps)) return {t.c + 1, 0, 0, t.ord + 1};
  return {kWarps, 0, 0, -1};
}

// the group of the ord-th place in the class-major walk
__device__ __forceinline__ int win_group(int ord, int G) {
  for (int c = 0; c < kWarps; ++c) {
    const int n = class_count(c, G);
    if (ord < n) return c + kWarps * ord;
    ord -= n;
  }
  return 0;
}

// cp.async's arrive on an mbarrier once this thread's earlier cp.async
// copies have landed (counted in the barrier's arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The windowed walk of the 128-row tile: rows [blockIdx.x * 128, + 128)
// x columns [blockIdx.y * 32, + 32) of x @ dequant(d), idx of type IT, nr
// ring runs. Warp specialised: the last warp (the producer) starts each
// window's [64][128] slab of xT as a bulk copy and the ring runs its
// columns will need as 16-byte cp.async (both land on the window's full
// barrier), as far ahead as kWinStages windows and the ring allow; each
// of the 16 consumer warps owns two columns end to end. A consumer warp
// walks the windows in the class-major order (classes c = 0..7, groups g =
// c, c + 8, ..., windows in increasing index), and for each: its two
// columns' kept slots inside the window, from their cursors on, half a
// warp a column, one lane a slot (in-window slots are a prefix: the slots
// are sorted), become a table of (x offset, value) entries in slot order;
// then every lane applies them to its 4 rows (float4 loads of the window),
// the two columns side by side. So each (row, column) chain is the
// oracle's: groups of a class in increasing g, slots in order, one
// rounded product and one rounded sum a term; partials fold into the
// total at each class's end in class order, classes past G add +0.0.
// Entering a group, a warp checks that its columns' slots strictly
// increase by index; an unsorted column is walked in slot order with x
// from xT in global memory instead. A slot whose run is not in the ring
// (not landed, or an unaligned layout: no ring) is read from global
// memory. The warps meet only at the barriers of the x windows, so they
// drift within kWinStages windows of each other.
template <typename IT>
__device__ __forceinline__ void win_walk(const float* __restrict__ xT, const Delta& d,
                                         const Shape& s, int nr, int vec,
                                         float* __restrict__ y) {
  constexpr int RB = kPrefillRows, CB = kWinCB, S = kWinStages, isz = sizeof(IT);
  extern __shared__ __align__(16) float psmem[];
  const int G = s.G, keep = s.keep, h_g = s.h_g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = warp == kWinWarps;
  const int r0 = blockIdx.x * RB, col0 = blockIdx.y * CB;
  const int ncol = min(CB, s.O - col0);
  const Decode dc = decode_consts(d, s);
  const int pshift = __ffs(dc.per) - 1;
  const int code_rows = s.wbits ? s.kp : keep;
  const int ce = s.wbits ? 1 : 4;                 // bytes of a code entry
  const int irow = win_idx_row(isz), crow = win_code_row(s.wbits);
  const int rbytes = win_run_bytes(isz, s.wbits);
  const int nw = (h_g + kWinIdx - 1) / kWinIdx;   // windows a group
  const int rpg = (keep + kWinRun - 1) / kWinRun; // runs a group
  const int total_runs = G * rpg;
  const int n_steps = G * nw;
  float* xs = psmem;                                                      // [S][kWinIdx][RB]
  int2* tbl = reinterpret_cast<int2*>(xs + S * kWinIdx * RB);             // [warps][2][entries]
  unsigned char* ring = reinterpret_cast<unsigned char*>(tbl + kWinWarps * 2 * kWinEntries);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(nr) * rbytes);
  uint64_t* empty = full + S;
  int* landed = reinterpret_cast<int*>(empty + S);  // [S]: runs below it are in
  int* pub = landed + S;                            // [CB]: stream slot of each column's cursor
  const IT* idx = reinterpret_cast<const IT*>(d.idx);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 33);  // the producer's lane 0 (bytes) and its 32 lanes' cp.async
      mbar_init(empty + i, kWinWarps);
    }
    mbar_fence_init();
  }
  for (int e = tid; e < CB; e += blockDim.x) pub[e] = 0;
  __syncthreads();

  if (producer) {
    // windows in walk order; before window m the slot's previous window
    // (m - S) is released by every consumer warp. Runs are started from
    // hi up to the least published cursor's run + nr: a consumer reads
    // only slots at or past its own cursor, so runs below the least are
    // free.
    int hi = 0;
    WStep t = {0, 0, 0, 0};
    for (int m = 0; m < n_steps; ++m, t = win_next(t, G, nw)) {
      const int b = m % S;
      if (m >= S) mbar_wait(empty + b, ((m / S) - 1) & 1);
      int from = hi;
      if (vec) {
        int least = reinterpret_cast<const volatile int*>(pub)[lane];
#pragma unroll
        for (int sh = 16; sh; sh >>= 1)
          least = min(least, __shfl_xor_sync(0xffffffffu, least, sh));
        hi = max(hi, min(least / kWinRun + nr, total_runs));  // cursors are stream slots
      }
      const int ci = ncol * isz / 16, cq = ncol * ce / 16;  // chunks an idx / code row
      for (int R = from; R < hi; ++R) {
        const int q = R / rpg;
        const size_t g = win_group(q, G);
        const int k0 = (R - q * rpg) * kWinRun, nk = min(kWinRun, keep - k0);
        const int c0 = s.wbits ? k0 / dc.per : k0;
        const int ncr = s.wbits ? (k0 + nk + dc.per - 1) / dc.per - c0 : nk;
        unsigned char* dst = ring + static_cast<size_t>(R & (nr - 1)) * rbytes;
        const int n_i = nk * ci;
        for (int e = lane; e < n_i + ncr * cq; e += 32) {
          if (e < n_i) {
            const int row = e / ci, ch = e - row * ci;
            cp_async16(dst + row * irow + ch * 16,
                       d.idx + ((g * keep + k0 + row) * s.O + col0) * isz + ch * 16, 16);
          } else {
            const int row = (e - n_i) / cq, ch = e - n_i - row * cq;
            cp_async16(dst + kWinRun * irow + row * crow + ch * 16,
                       d.codes + ((g * code_rows + c0 + row) * s.O + col0) * ce + ch * 16, 16);
          }
        }
      }
      if (lane == 0) {
        landed[b] = hi;
        const int w0 = t.w * kWinIdx, wn = min(kWinIdx, h_g - w0);
        fence_proxy_async();
        mbar_expect(full + b, wn * RB * sizeof(float));
        bulk_copy(xs + b * kWinIdx * RB,
                  xT + (static_cast<size_t>(blockIdx.x) * s.h_in +
                        static_cast<size_t>(t.c + kWarps * t.j) * h_g + w0) * RB,
                  wn * RB * sizeof(float), full + b);
      }
      cp_async_arrive(full + b);
    }
    cp_async_wait(0);
    return;
  }

  // a consumer warp: columns 2 * warp + h (h = lane / 16 building, both
  // computing), rows 4 * lane .. + 3
  const int half = lane >> 4, cand = lane & 15;
  const int col = 2 * warp + half;                  // this lane's column to build
  const bool live = col < ncol;
  const size_t o_col = static_cast<size_t>(col0) + col;
  const int rlo = 4 * lane;
  int2* tw = tbl + warp * 2 * kWinEntries;          // the warp's tables [2][entries]
  float part[2][4], total[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) part[j][m] = total[j][m] = 0.f;
  int cursor = 0;     // the next slot of this lane's column in the group
  bool unsorted = false;
  auto terms = [&](float (&pt)[4], const float4 xv, float v) {
    pt[0] = __fadd_rn(pt[0], __fmul_rn(xv.x, v));
    pt[1] = __fadd_rn(pt[1], __fmul_rn(xv.y, v));
    pt[2] = __fadd_rn(pt[2], __fmul_rn(xv.z, v));
    pt[3] = __fadd_rn(pt[3], __fmul_rn(xv.w, v));
  };

  WStep t = {0, 0, 0, 0};
  for (int m = 0; m < n_steps; ++m, t = win_next(t, G, nw)) {
    const int b = m % S;
    const int g = t.c + kWarps * t.j;
    const size_t gk = static_cast<size_t>(g) * keep;
    const int w0 = t.w * kWinIdx;
    const unsigned w1 = min(w0 + kWinIdx, h_g);
    if (t.w == 0) {
      // entering group g: are this column's slots strictly increasing?
      // (16 lanes, keep / 16 pairs each, from global memory)
      const int L = (keep + 15) / 16;
      const int k0 = cand * L, k1 = min(k0 + L, keep - 1);
      bool ok = true;
      if (live && k0 < keep) {
        const IT* ip = idx + gk * s.O + o_col;
        unsigned prev = ip[static_cast<size_t>(k0) * s.O];
#pragma unroll 8
        for (int k = k0 + 1; k <= k1; ++k) {
          const unsigned id = ip[static_cast<size_t>(k) * s.O];
          ok = ok && id > prev;
          prev = id;
        }
      }
      const unsigned bad = __ballot_sync(0xffffffffu, !ok) >> (16 * half) & 0xffffu;
      unsorted = live && bad != 0;
      cursor = live && !unsorted ? 0 : keep;
    }
    mbar_wait(full + b, (m / S) & 1);
    const int hl = landed[b];
    // this lane's column: its kept slots in the window -> tw[half][k - a]
    const int rb0 = t.ord * rpg;
    const int a = cursor;
    auto id_at = [&](int k) -> unsigned {
      const int R = rb0 + (k >> 3);
      if (R < hl)
        return *reinterpret_cast<const IT*>(ring + static_cast<size_t>(R & (nr - 1)) * rbytes +
                                            (k & (kWinRun - 1)) * irow + col * isz);
      return idx[(gk + k) * s.O + o_col];
    };
    auto code_at = [&](int k) -> unsigned {
      const int R = rb0 + (k >> 3);
      if (R < hl) {
        const unsigned char* rc =
            ring + static_cast<size_t>(R & (nr - 1)) * rbytes + kWinRun * irow;
        return s.wbits ? rc[((k & (kWinRun - 1)) >> pshift) * crow + col]
                       : *reinterpret_cast<const unsigned*>(rc + (k & (kWinRun - 1)) * crow +
                                                            col * 4);
      }
      return load_code(d, s, dc, g, k, static_cast<int>(o_col));
    };
    int n = 0;  // this lane's column's slots in the window
    for (int r = 0;; r += 16) {
      const int k = a + r + cand;
      const unsigned id = k < keep ? id_at(k) : 0xffffffffu;
      const bool in = id < w1;
      if (in) tw[half * kWinEntries + r + cand] =
          make_int2((static_cast<int>(id) - w0) * RB,
                    __float_as_int(decode_raw(s, dc, code_at(k), k)));
      const unsigned got = __ballot_sync(0xffffffffu, in);
      const int mine = __popc(got >> (16 * half) & 0xffffu);
      n += mine;
      // another round while either half filled all 16 (a prefix: sorted)
      if (__shfl_sync(0xffffffffu, mine, 0) < 16 && __shfl_sync(0xffffffffu, mine, 16) < 16)
        break;
    }
    cursor = a + n;
    const int n0 = __shfl_sync(0xffffffffu, n, 0), n1 = __shfl_sync(0xffffffffu, n, 16);
    __syncwarp();
    const float* xb = xs + b * kWinIdx * RB + rlo;
    if (t.w == 0) {
      // an unsorted column: its group in slot order, x from xT
      const float* xg = xT + (static_cast<size_t>(blockIdx.x) * s.h_in +
                              static_cast<size_t>(g) * h_g) * RB + rlo;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (__shfl_sync(0xffffffffu, unsorted, 16 * j)) {
          const size_t o = static_cast<size_t>(col0) + 2 * warp + j;
          for (int k = 0; k < keep; ++k) {
            const unsigned id = idx[(gk + k) * s.O + o];
            if (id < static_cast<unsigned>(h_g))
              terms(part[j], *reinterpret_cast<const float4*>(xg + static_cast<size_t>(id) * RB),
                    decode_value(d, s, dc, g, k, static_cast<int>(o)));
          }
        }
      }
    }
    // the two columns side by side, two entries a column a round
    const int most = max(n0, n1);
    for (int e = 0; e < most; e += 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nj = j ? n1 : n0;
        if (e < nj) {
          const int4 p = *reinterpret_cast<const int4*>(tw + j * kWinEntries + e);
          terms(part[j], *reinterpret_cast<const float4*>(xb + p.x), __int_as_float(p.y));
          if (e + 1 < nj)
            terms(part[j], *reinterpret_cast<const float4*>(xb + p.z), __int_as_float(p.w));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + b);  // the window and the tables are free
    if (cand == 0) pub[col] = t.ord * rpg * kWinRun + cursor;
    if (t.w == nw - 1 && t.j == class_count(t.c, G) - 1) {
      // the class's end: P0, then ((P0 + P1) + P2) + ...
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          total[j][q] = t.c == 0 ? part[j][q] : __fadd_rn(total[j][q], part[j][q]);
          part[j][q] = 0.f;
        }
    }
  }
  // classes with no group (G < 8) add their zero partial, as on the decode route
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int o = col0 + 2 * warp + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = total[j][q];
      for (int c = G; c < kWarps; ++c) v = __fadd_rn(v, 0.f);
      const int row = r0 + rlo + q;
      if (row < s.T && o < s.O) y[static_cast<size_t>(row) * s.O + o] = v;
    }
  }
}

// xT: x transposed and blocked by RB rows (transpose_pad_kernel), Tp =
// gridDim.x * RB; vec: the idx/codes rows of a tile are 16-byte aligned
// and ride the copies, else they are read from global memory. WIN: the
// windowed walk (win_walk; sg ring runs, C = kWinC). Else the whole-group
// walk: sg groups a step; stages: ring depth (2 builds each step's table
// behind a second barrier, 3 builds it a step ahead).
template <int C, typename IT, bool WIN>
__global__ void __launch_bounds__(WIN ? kWinThreads : kPrefillThreads, 1)
spmm_prefill_kernel(const float* __restrict__ xT, int Tp, Delta d, Shape s, int sg,
                    int stages, int vec, float* __restrict__ y) {
  if constexpr (WIN) {
    win_walk<IT>(xT, d, s, sg, vec, y);
  } else {
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
}

// The windowed walk for idx entries of type IT: as many ring runs as fit.
template <typename IT>
cudaError_t launch_prefill_win_t(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                                 cudaStream_t st) {
  const int nr = win_runs(sizeof(IT), s.wbits);
  if (nr < 1) return cudaErrorInvalidValue;
  const size_t smem = win_smem_bytes(nr, sizeof(IT), s.wbits);
  const cudaError_t err =
      cudaFuncSetAttribute(spmm_prefill_kernel<kWinC, IT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Tp / kPrefillRows, (s.O + kWinCB - 1) / kWinCB);
  spmm_prefill_kernel<kWinC, IT, true><<<grid, kWinThreads, smem, st>>>(xT, Tp, d, s, nr, 0,
                                                                        vec, y);
  return cudaGetLastError();
}

}  // namespace dq
