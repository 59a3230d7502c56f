// fused_base_delta: 3xTF32 on tensor cores, with its K-split combine.
// The design is described in delta_spmm.cu.
#include "common.cuh"

namespace dq {

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
// bytes of their [keep, BN] tiles (at most isz + 4 bytes a kept value).
int fused_chunk_groups(int h_g) {
  if (h_g % kFusedBK == 0) return 1;
  return kFusedBK % h_g == 0 ? kFusedBK / h_g : kFusedBK / h_g + 2;
}

size_t fused_raw_bytes(int h_g, int keep, int isz) {
  return (static_cast<size_t>(fused_chunk_groups(h_g)) * keep * kFusedBN * (isz + 4) + 15) /
         16 * 16;
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
  // a group of 32-row chunks (h_g a multiple of BK, read from global
  // memory): its column's kept slots are walked by a cursor across the
  // chunks where they are sorted by index (every producer sorts them),
  // checked once as the block enters the group; unsorted, each chunk
  // scans them all
  const bool walk = !raw && s.h_g % BK == 0 && s.h_g > BK;
  int walk_g = -1, cursor = 0;
  bool sorted = false;

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
                    s.O, s.isz, true, tid, kFusedThreads);
        stage_bytes(rs + ng * s.keep * BN * s.isz, d.codes, ng * code_rows,
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
        const unsigned char* rc = ri + ng * s.keep * BN * s.isz;
        const size_t gi = (static_cast<size_t>(g_lo) * s.keep) * s.O + o;
        const unsigned lo = static_cast<unsigned>(k0 - g_lo * s.h_g);  // chunk's first row in g
        if (walk && g_lo != walk_g) {  // entering a group: sorted? where is row lo?
          walk_g = g_lo;
          sorted = true;
          cursor = s.keep;
          unsigned prev = 0;
          for (int k = 0; k < s.keep; ++k) {
            const unsigned id = load_idx(d, s, gi + static_cast<size_t>(k) * s.O);
            if (k > 0 && id <= prev) sorted = false;
            if (cursor == s.keep && id >= lo) cursor = k;
            prev = id;
          }
        }
        if (walk && sorted) {
          for (; cursor < s.keep; ++cursor) {
            const unsigned row = load_idx(d, s, gi + static_cast<size_t>(cursor) * s.O) - lo;
            if (row >= static_cast<unsigned>(BK)) break;
            float* m = mt + row * kMergedPitch + tid;
            *m = __fadd_rn(*m, __fadd_rn(0.f, decode_raw(s, dc, load_code(d, s, dc, g_lo,
                                                                          cursor, o), cursor)));
          }
        }
        for (int gg = 0; gg < (walk && sorted ? 0 : ng); ++gg) {
          const int g = g_lo + gg;
          for (int k = 0; k < s.keep; ++k) {
            unsigned id, code;
            if (raw) {
              const int e = (gg * s.keep + k) * BN + tid;
              id = s.isz == 1 ? ri[e] : reinterpret_cast<const unsigned*>(ri)[e];
              code = s.wbits ? rc[(gg * code_rows + (k >> pshift)) * BN + tid]
                             : reinterpret_cast<const unsigned*>(rc)[(gg * s.keep + k) * BN + tid];
            } else {
              id = load_idx(d, s, (static_cast<size_t>(g) * s.keep + k) * s.O + o);
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
  size_t raw = vec ? fused_raw_bytes(s.h_g, s.keep, s.isz) : 0;
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

cudaError_t launch_fused_any(const float* x, const void* w, int w_bf16, Delta d, Shape s,
                             float* y, float* ws, int splits, int tb, cudaStream_t st) {
  return w_bf16 ? launch_fused<__nv_bfloat16>(x, w, d, s, y, ws, splits, tb, st)
                : launch_fused<float>(x, w, d, s, y, ws, splits, tb, st);
}

}  // namespace dq
