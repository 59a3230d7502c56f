// spmm_decode_kernel with int32 idx (h_g above 256): decode.cuh at one type.
#include "decode.cuh"

namespace dq {

cudaError_t launch_spmm_decode_i32(const float* x, Delta d, Shape s, float* y, int tb,
                                   cudaStream_t st) {
  return launch_spmm_decode<uint32_t>(x, d, s, y, tb, st);
}

}  // namespace dq
