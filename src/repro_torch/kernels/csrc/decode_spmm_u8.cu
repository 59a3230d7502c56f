// spmm_decode_kernel with uint8 idx (h_g up to 256): decode.cuh at one type.
#include "decode.cuh"

namespace dq {

cudaError_t launch_spmm_decode_u8(const float* x, Delta d, Shape s, float* y, int tb,
                                  cudaStream_t st) {
  return launch_spmm_decode<uint8_t>(x, d, s, y, tb, st);
}

}  // namespace dq
