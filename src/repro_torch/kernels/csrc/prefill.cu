// delta_spmm's 128-row tile with uint8 idx (h_g up to 256): the
// transpose, the dispatch between the two walks, and the kernel at this
// width (prefill.cuh).
#include "prefill.cuh"

namespace dq {

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

// the 128-row tile takes every packing: the whole-group walk where it
// fits, the windowed walk elsewhere (delta_spmm_prefill_ok)
bool prefill_fits(int tb, int h_g, int keep) {
  return tb == kPrefillRows && h_g > 0 && keep > 0 && keep <= h_g;
}

// Groups a step holds and ring depth of the whole-group walk. A step's
// fixed cost (its barrier, its bulk copies, its table) is paid per step,
// so a step holds as many groups (up to 8) as 3 stages fit in the whole
// shared memory (an SM holds one 512-thread block by its registers); where
// one group does not fit that way, one group a step in 2 stages.
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
      spmm_prefill_kernel<C, uint8_t, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Tp / RB, (s.O + CB - 1) / CB);
  spmm_prefill_kernel<C, uint8_t, false><<<grid, kPrefillThreads, smem, st>>>(
      xT, Tp, d, s, sg, stages, vec, y);
  return cudaGetLastError();
}

cudaError_t launch_prefill_win_u8(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                                  cudaStream_t st) {
  return launch_prefill_win_t<uint8_t>(xT, Tp, d, s, vec, y, st);
}

// x -> xT [Tp / 128][h_in][128] (Tp = T rounded up to 128), then the
// whole-group walk at 64 columns a block, or 32 where the 64-column grid
// would give SMs fewer than 4 blocks (the better of 1, 2 and 4 at every
// full-width site on an H100, PERF.md), where a group fits it; else the
// windowed walk at 32 columns a block
cudaError_t launch_prefill(const float* x, float* xT, Delta d, Shape s, float* y,
                           cudaStream_t st) {
  const int Tp = (s.T + kPrefillRows - 1) / kPrefillRows * kPrefillRows;
  transpose_pad_kernel<<<dim3((s.h_in + 31) / 32, Tp / 32), dim3(32, 8), 0, st>>>(
      x, s.T, s.h_in, Tp, kPrefillRows, xT);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = s.O % 16 == 0 && reinterpret_cast<uintptr_t>(d.idx) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(d.codes) % 16 == 0;
  if (s.isz == 4) return launch_prefill_win_i32(xT, Tp, d, s, vec, y, st);
  if (!prefill_whole_fits(s.h_g, s.keep)) return launch_prefill_win_u8(xT, Tp, d, s, vec, y, st);
  const bool narrow = (Tp / kPrefillRows) * ((s.O + 63) / 64) < 4 * sm_count();
  return narrow ? launch_prefill_t<4>(xT, Tp, d, s, vec, y, st)
                : launch_prefill_t<8>(xT, Tp, d, s, vec, y, st);
}

}  // namespace dq
