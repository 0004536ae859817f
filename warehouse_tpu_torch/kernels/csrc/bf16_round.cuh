// Rounding to bfloat16 for the learners' bf16-operand products
// (matmul_dtype="bfloat16"): each product's operands are rounded to the
// nearest bf16 (ties to even, as XLA's convert) and multiplied and summed in
// float32. The product of two bf16 values is exact in float32 (8 + 8
// significant bits), so such a sum differs from the TPU kernel's only in its
// order, as the float32 route's does.
//
// The learner kernels take the choice as a template flag BF, dispatched at
// launch: with BF false rbf is the identity and the code is the float32
// route's, which the acting kernels and the IMPALA learner instantiate.
#pragma once

#include <cuda_bf16.h>

namespace {

template <bool BF>
__device__ __forceinline__ float rbf(float x) {
  if constexpr (BF)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <bool BF>
__device__ __forceinline__ float4 rbf4(float4 v) {
  if constexpr (BF)
    return make_float4(rbf<true>(v.x), rbf<true>(v.y), rbf<true>(v.z),
                       rbf<true>(v.w));
  else
    return v;
}

}  // namespace
