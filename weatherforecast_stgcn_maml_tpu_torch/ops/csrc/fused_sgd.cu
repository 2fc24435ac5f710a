// Whole-tree clip + SGD update (kernel rows 8 and 9): for every task v of a
// leading task axis of size V >= 1,
//   norm_v  = sqrt(sum over leaves of sum g^2), accumulated in float32;
//   scale_v = max_norm / (norm_v + 1e-6) if norm_v > max_norm, else 1;
//   p      <- p - (lr * scale_v) * g        on every leaf, in place.
// torch's clip_grad_norm_ semantics, as train/optimizers.clip_global_norm_tree.
//
// Replaces the Pallas kernels `_kernel` (V = 1, row 8) and `_kernel_batched`
// (V > 1, each task clipped by its own norm, row 9) of
// weatherforecast_stgcn_maml_tpu/ops/fused_sgd.py.
//
// Leaf table: the leaves' pointers and sizes travel by value in the launch's
// parameter space (a multi-tensor-apply layout, < 2 KB of the 4 KB limit),
// so no table is copied host -> device: the gradients are fresh tensors at
// every inner step, and a device-side table keyed on their pointers would be
// rebuilt and copied at almost every call. Each leaf is cut into chunks of
// kChunk elements; block (c, v) takes chunk c of task v.
//
// Two launches, no atomics, so the result does not depend on block order:
//   phase 1  block (c, v) writes the float32 sum of squares of its chunk to
//            partials[v][c] (a fixed-shape tree reduction in the block);
//   phase 2  block (c, v) sums partials[v][0 .. chunks) in one fixed order,
//            forms scale_v (every block of task v gets the same bits) and
//            updates its chunk in place.
//
// Bound: device memory. The work reads g twice and p once and writes p:
// 16 bytes an element, 12.9 MB at the reference model's 808,280 parameters,
// 3.9 us at 3.35 TB/s for V = 1 (15 us for V = 4); two adds and a multiply
// an element are nothing beside that.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr long long kChunk = 4096;  // elements of one leaf a block takes

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];            // elements of the leaf per task
  int chunk_start[kMaxLeaves + 1];    // first chunk of each leaf; [n_leaves] = total
};

// Sum over the block in a fixed order (warp shuffles, then the warp sums in
// warp order); every thread returns the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// The leaf that chunk c belongs to (a scan over at most kMaxLeaves entries).
__device__ __forceinline__ int leaf_of(const LeafTable& t, int n_leaves, int c) {
  int leaf = 0;
  while (leaf + 1 < n_leaves && t.chunk_start[leaf + 1] <= c) ++leaf;
  return leaf;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const LeafTable t, int n_leaves, float* __restrict__ partials) {
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  const int leaf = leaf_of(t, n_leaves, c);
  const long long n = t.n[leaf];
  const long long begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  const long long end = min(begin + kChunk, n);
  const float* __restrict__ g = t.g[leaf] + (long long)v * n;
  float s = 0.f;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float x = g[i];
    s = fmaf(x, x, s);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partials[(long long)v * chunks + c] = s;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const LeafTable t, int n_leaves, const float* __restrict__ partials,
              float lr, float max_norm) {
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kThreads) s += partials[(long long)v * chunks + i];
  const float norm = sqrtf(block_sum(s));
  const float scale = norm > max_norm ? max_norm / (norm + 1e-6f) : 1.f;
  const float step = lr * scale;
  const int leaf = leaf_of(t, n_leaves, c);
  const long long n = t.n[leaf];
  const long long begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  const long long end = min(begin + kChunk, n);
  float* __restrict__ p = t.p[leaf] + (long long)v * n;
  const float* __restrict__ g = t.g[leaf] + (long long)v * n;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    // Rounded product, then rounded difference: the plain version's
    // p - step * g, never contracted into an FMA.
    p[i] = __fsub_rn(p[i], __fmul_rn(step, g[i]));
  }
}

}  // namespace
}  // namespace wf

// The number of chunks of one task's leaves (the partials buffer holds
// n_tasks times as many floats), or -1 for a table the kernel does not take.
extern "C" long long wf_clip_sgd_chunks(int n_leaves, const long long* sizes) {
  if (n_leaves < 1 || n_leaves > wf::kMaxLeaves) return -1;
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] <= 0) return -1;
    chunks += (sizes[i] + wf::kChunk - 1) / wf::kChunk;
  }
  return chunks > 0x7fffffffLL ? -1 : chunks;
}

// p <- p - lr * clip(g) per task, in place, over n_leaves float32 leaves
// (params[i], grads[i]: n_tasks * sizes[i] contiguous elements, task-major).
// partials: n_tasks * wf_clip_sgd_chunks(...) floats of scratch. Returns a
// cudaError_t code (0 on success).
extern "C" int wf_clip_sgd_update(int n_leaves, void* const* params,
                                  const void* const* grads, const long long* sizes,
                                  int n_tasks, float lr, float max_norm,
                                  float* partials, void* stream) {
  const long long chunks = wf_clip_sgd_chunks(n_leaves, sizes);
  if (chunks < 0 || n_tasks < 1 || n_tasks > 65535) return (int)cudaErrorInvalidValue;
  wf::LeafTable t;
  int start = 0;
  for (int i = 0; i < n_leaves; ++i) {
    t.p[i] = static_cast<float*>(params[i]);
    t.g[i] = static_cast<const float*>(grads[i]);
    t.n[i] = sizes[i];
    t.chunk_start[i] = start;
    start += (int)((sizes[i] + wf::kChunk - 1) / wf::kChunk);
  }
  t.chunk_start[n_leaves] = start;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)chunks, (unsigned)n_tasks);
  wf::sumsq_kernel<<<grid, wf::kThreads, 0, s>>>(t, n_leaves, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::update_kernel<<<grid, wf::kThreads, 0, s>>>(t, n_leaves, partials, lr, max_norm);
  return (int)cudaGetLastError();
}
