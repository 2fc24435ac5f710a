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

constexpr int kContractTile = 16;  // weight rows per pipelined tile of contract()

// acc[r][q] += sum_k opnd[r0 + r, k] * w[k, q * H + j] for q * H + j < ncols:
// w is [K, ncols] in global memory, streamed through wbuf in double-buffered
// [kContractTile, ncols] tiles; opnd is [rows, ldo] in shared memory. K is a
// multiple of 4. The block's first barrier comes before any read of opnd, so
// the caller's writes to it need none of their own. Ends with a barrier.
template <typename TW, int RPT, int NQ>
__device__ __forceinline__ void contract(const TW* __restrict__ w, int K,
                                         int ncols, const float* opnd, int ldo,
                                         TW* wbuf, int r0, int j, int H,
                                         float (&acc)[RPT][NQ]) {
  const int tiles = (K + kContractTile - 1) / kContractTile;
  const size_t tile_elems = (size_t)kContractTile * ncols;
  auto load_tile = [&](int i) {
    const int rows = min(kContractTile, K - i * kContractTile);
    const char* src = reinterpret_cast<const char*>(w + (size_t)i * tile_elems);
    char* dst = reinterpret_cast<char*>(wbuf + (size_t)(i & 1) * tile_elems);
    const int chunks = rows * ncols * (int)sizeof(TW) / 16;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x)
      cp_async16(dst + 16 * c, src + 16 * c);
  };
  load_tile(0);
  cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) load_tile(i + 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_all_but_newest();
    __syncthreads();  // tile i (and the operand rows) visible to all
    const TW* wt = wbuf + (size_t)(i & 1) * tile_elems + j;
    const int k0 = i * kContractTile;
    const int rows = min(kContractTile, K - k0);
    for (int kk = 0; kk < rows; kk += 4) {
      float4 v[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        v[r] = *reinterpret_cast<const float4*>(opnd + (size_t)(r0 + r) * ldo + k0 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const TW* wk = wt + (size_t)(kk + u) * ncols;
        float wq[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          wq[q] = q * H + j < ncols ? to_float(wk[q * H]) : 0.f;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float a = u == 0 ? v[r].x : u == 1 ? v[r].y : u == 2 ? v[r].z : v[r].w;
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(a, wq[q], acc[r][q]);
        }
      }
    }
    __syncthreads();  // done with buffer i % 2
  }
}

}  // namespace wf
