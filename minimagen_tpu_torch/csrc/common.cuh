// Shared helpers of the port's CUDA kernels: element-type conversion and
// rounding. Kernels take float32 or bfloat16 activations and compute in
// float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmt {

// Element types a kernel entry point accepts (the `dtype` argument).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to T and back: the rounding PyTorch applies after
// every elementwise op on a T tensor. Identity for float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

}  // namespace mmt
