// delta_spmm's 128-row tile with int32 idx (h_g above 256): the windowed
// walk of prefill.cuh at one type.
#include "prefill.cuh"

namespace dq {

cudaError_t launch_prefill_win_i32(const float* xT, int Tp, Delta d, Shape s, int vec, float* y,
                                   cudaStream_t st) {
  return launch_prefill_win_t<uint32_t>(xT, Tp, d, s, vec, y, st);
}

}  // namespace dq
