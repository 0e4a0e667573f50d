// Shared helpers for the paged-KV kernels: element conversions and the
// dtype switch of the plain C entry points.
//
// Pools hold float32 or bfloat16.  A bfloat16 pool is multiplied as bf16
// operands with float32 accumulation: operands are widened to float32 (a
// bf16 x bf16 product is exact in float32) and the softmax weights are
// rounded to bf16 before they multiply V, as the TPU kernels round them
// for their bf16 matrix unit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvc {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// value of x after a round trip through the operand type T
template <typename T>
__device__ __forceinline__ float round_op(float x) {
  return to_f<T>(from_f<T>(x));
}

}  // namespace kvc
