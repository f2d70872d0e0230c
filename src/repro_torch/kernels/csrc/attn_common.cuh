// Shared helpers of the attention kernels: f32 <-> storage-type moves.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of a (batch, sequence, head, feature) operand whose
// feature axis has unit stride.
struct Strides {
  long long b, s, h;
};

}  // namespace attn
