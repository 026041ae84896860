// Device helpers the GroupNorm backward kernels share
// (csrc/group_norm_bwd.cu, csrc/group_norm_split_bwd.cu): one bf16
// rounding, the activation's slope times the cotangent, a parameter read
// as f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// g * act'(z); 0 none, 1 swish, 2 relu, 3 elu, 4 leaky relu (0.2). The
// exponential and the reciprocal take the special-function unit's
// approximations (2 ulp), as the Triton kernel before this one did:
// recomputed twice an element, they would otherwise bound the kernel.
template <int ACT>
__device__ __forceinline__ float dz_of(float g, float z) {
  if (ACT == 1) {
    const float sig = __fdividef(1.f, 1.f + __expf(-z));
    return g * (sig * (1.f + z * (1.f - sig)));
  } else if (ACT == 2) {
    return z > 0.f ? g : 0.f;
  } else if (ACT == 3) {
    return z > 0.f ? g : g * __expf(z);
  } else if (ACT == 4) {
    return z > 0.f ? g : 0.2f * g;
  }
  return g;
}

__device__ __forceinline__ float load_param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

}  // namespace
