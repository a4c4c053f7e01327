// Shared helpers of the port's hand-written Hopper kernels: float <-> bf16
// conversion, the fused bias/activation epilogue, and warp reductions.
// Every kernel accumulates in fp32 whatever its storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define GT_DTYPE_F32 0
#define GT_DTYPE_BF16 1

// Epilogue codes: 0 = none, 1 = linear, 2 = lrelu.
#define GT_ACT_NONE 0
#define GT_ACT_LINEAR 1
#define GT_ACT_LRELU 2

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round through the storage type: the identity for fp32, bf16 rounding
// otherwise (mirrors a reference that casts an fp32 value to the dtype).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// act(u) * gain for the fused epilogue; lrelu is where(u >= 0, u, a*u),
// slope 1 at 0 exactly as the JAX activation table defines it.
__device__ __forceinline__ float apply_act(float u, int act, float alpha,
                                           float gain) {
  if (act == GT_ACT_LRELU) u = u >= 0.f ? u : u * alpha;
  return u * gain;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
