// dense_segments_kernel: the segments kernel on the dense-group walk
// (dense.cuh), its own unit so nvcc compiles it beside the others.
#include "dense.cuh"

namespace dq {

cudaError_t launch_dense_segments(const float* x, Delta d, Shape s, Strides strides,
                                  int n_tenants, const int* seg_rows, const int* seg_offsets,
                                  int n_seg, float* y, int tb, cudaStream_t st) {
  DecPlan p;
  size_t smem;
  if (!dense_launch_plan(x, d, s, tb, strides.codes % 16 == 0, p, smem))
    return cudaErrorInvalidValue;
  const auto kernel =
      dense_runs(s, p) ? dense_segments_kernel<true> : dense_segments_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // as launch_segments: at most m + (T - m) / rt tiles for m = min(n_seg,
  // T) nonempty segments, and one more y that zero-fills
  const int m = std::min(n_seg, s.T);
  const dim3 grid(p.cb, m + (s.T - m) / p.rt + 1, (s.O + kDecCols - 1) / kDecCols);
  const cudaError_t launched =
      launch_clustered(kernel, grid, smem, st, p, x, d, s, strides, n_tenants, seg_rows,
                       seg_offsets, n_seg, p, y);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace dq
