// segments_decode_kernel with int32 idx (h_g above 256): decode.cuh at one type.
#include "decode.cuh"

namespace dq {

cudaError_t launch_segments_i32(const float* x, Delta d, Shape s, Strides strides,
                                int n_tenants, const int* seg_rows, const int* seg_offsets,
                                int n_seg, float* y, int tb, cudaStream_t st) {
  return launch_segments<uint32_t>(x, d, s, strides, n_tenants, seg_rows, seg_offsets, n_seg, y, tb, st);
}

}  // namespace dq
