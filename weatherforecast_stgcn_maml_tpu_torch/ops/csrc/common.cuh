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

// Round a float32 value to T (round-to-nearest-even) and widen it back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// 16-byte asynchronous global -> shared copies (cp.async, sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace wf
