// Shared helpers of the port's CUDA kernels.
//
// Every kernel computes the JAX package's numerics: matmul operands are
// rounded to the compute dtype (float32 or bfloat16), products accumulate in
// float32, biases and cell state stay float32. Operands are rounded as they
// are loaded, so the kernels take float32 inputs and weights as they are.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wf {

// dtype codes shared with the Python wrappers (ops/cuda_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// Closes the thread's outstanding cp.async copies into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace wf
