// dense_spmm_kernel: delta_spmm's decode tiles on the dense-group walk
// (dense.cuh), its own unit so nvcc compiles it beside the others.
#include "dense.cuh"

namespace dq {

cudaError_t launch_dense_decode(const float* x, Delta d, Shape s, float* y, int tb,
                                cudaStream_t st) {
  DecPlan p;
  size_t smem;
  if (!dense_launch_plan(x, d, s, tb, true, p, smem)) return cudaErrorInvalidValue;
  const auto kernel = dense_runs(s, p) ? dense_spmm_kernel<true> : dense_spmm_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.cb, (s.T + p.rt - 1) / p.rt, (s.O + kDecCols - 1) / kDecCols);
  const cudaError_t launched = launch_clustered(kernel, grid, smem, st, p, x, d, s, p, y);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace dq
