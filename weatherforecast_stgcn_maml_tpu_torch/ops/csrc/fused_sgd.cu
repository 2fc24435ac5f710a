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
// Bound: device memory. The work reads g and p once and writes p once: 12
// bytes a value, 9.7 MB at the reference model's 808,280 parameters, 2.9 us
// at 3.35 TB/s for V = 1 (11.6 us for V = 4); a square, an add, a multiply
// and a subtract a value are nothing beside that.
//
// Row 8 (V = 1, the FO inner loop's update, 360 calls a meta step): two
// kernels chained by Hopper's programmatic dependent launch. The leaves
// are cut into chunks of kChunk values, one block a chunk, kVecs 16-byte
// vectors a thread (a leaf's ragged end, or a leaf base that is not 16-byte
// aligned, goes value by value).
//   sumsq4_kernel   signals `griddepcontrol.launch_dependents` as it starts;
//                   block c writes the float32 sum of squares of its chunk
//                   to partials[c];
//   update4_kernel  launched with programmatic stream serialization, so its
//                   blocks start while sumsq4_kernel runs: each loads its p
//                   and g into registers, waits (`griddepcontrol.wait`) for
//                   sumsq4_kernel's grid, sums partials[0 .. chunks) in one
//                   fixed order (every block forms the same scale bits) and
//                   writes p.
// So the update's loads overlap the norm and the launch gap between the two
// is hidden; a CUDA graph captures the pair. Measured against one
// cooperative launch that held g and p in registers across a grid barrier
// (tools/sgd_designs.py, design `coop`; PERF.md §6): on one H100 that
// design took 6.5 us a call by torch.profiler and 7.2 by graph replay, this
// one 5.9 and 5.7-6.0; the one-pass floor (p - lr * g alone) 3.0.
//
// Row 9 (V > 1, `_VBATCH`'s lockstep update) keeps its two kernels
// (sumsq_kernel, update_kernel: scalar accesses, a task axis on the grid's
// y, under its own entry, wf_clip_sgd_update_tasks): at V = 4 they took
// 11.5 us against 11.7-12.1 for row 8's pair, whose register-held chunks
// lower the occupancy that grid of 208 x 4 blocks wants.
//
// No float atomics in either: the same inputs give the same bits.
//
// Leaf table: the leaves' pointers and sizes travel by value in the
// launch's parameter space (__grid_constant__, < 2 KB of the 4 KB limit),
// so no table is copied host -> device: the gradients are fresh tensors at
// every inner step. The host packs one SgdLaunch a call (ops/fused_sgd.py
// `_Plan`).
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kVecs = 4;                              // 16-byte vectors a thread
constexpr long long kChunk = kThreads * 4LL * kVecs;  // values a block

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];          // values of the leaf per task
  int chunk_start[kMaxLeaves + 1];  // first chunk of each leaf; [n_leaves] = total
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

// This thread's part of chunk c of task v: the leaf's g and p bases for the
// task, the chunk's first value, the leaf's size, and whether both bases
// take 16-byte accesses.
struct Span {
  const float* g;
  float* p;
  long long begin, n;
  bool vec;
};

__device__ __forceinline__ Span span(const LeafTable& t, int n_leaves, int c, int v) {
  const int leaf = leaf_of(t, n_leaves, c);
  Span s;
  s.n = t.n[leaf];
  s.g = t.g[leaf] + (long long)v * s.n;
  s.p = t.p[leaf] + (long long)v * s.n;
  s.begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  s.vec = ((reinterpret_cast<uintptr_t>(s.g) | reinterpret_cast<uintptr_t>(s.p)) & 15) == 0;
  return s;
}

// The first of this thread's four values in vector k.
__device__ __forceinline__ long long at(const Span& s, int k) {
  return s.begin + 4 * ((long long)k * kThreads + threadIdx.x);
}

// Values i .. i + 3; those past the leaf's end read as 0 (they add nothing
// to the sum and are never stored).
__device__ __forceinline__ float4 load4(const float* a, long long i, const Span& s) {
  if (s.vec && i + 3 < s.n) return *reinterpret_cast<const float4*>(a + i);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < s.n) r.x = a[i];
  if (i + 1 < s.n) r.y = a[i + 1];
  if (i + 2 < s.n) r.z = a[i + 2];
  if (i + 3 < s.n) r.w = a[i + 3];
  return r;
}

__device__ __forceinline__ void store4(float* a, long long i, const Span& s, float4 r) {
  if (s.vec && i + 3 < s.n) {
    *reinterpret_cast<float4*>(a + i) = r;
    return;
  }
  if (i < s.n) a[i] = r.x;
  if (i + 1 < s.n) a[i + 1] = r.y;
  if (i + 2 < s.n) a[i + 2] = r.z;
  if (i + 3 < s.n) a[i + 3] = r.w;
}

// Row 8. Grid (chunks): partials[c] = the sum of squares of chunk c.
__global__ void __launch_bounds__(kThreads)
sumsq4_kernel(const __grid_constant__ LeafTable t, int n_leaves, float* __restrict__ partials) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x;
  const Span s = span(t, n_leaves, c, 0);
  float4 x[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) x[k] = load4(s.g, at(s, k), s);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    sq = fmaf(x[k].x, x[k].x, sq);
    sq = fmaf(x[k].y, x[k].y, sq);
    sq = fmaf(x[k].z, x[k].z, sq);
    sq = fmaf(x[k].w, x[k].w, sq);
  }
  sq = block_sum(sq);
  if (threadIdx.x == 0) partials[c] = sq;
}

// Rounded product, then rounded difference: the plain version's p - step *
// g, never contracted into an FMA.
__device__ __forceinline__ float sgd(float p, float step, float g) {
  return __fsub_rn(p, __fmul_rn(step, g));
}

__global__ void __launch_bounds__(kThreads)
update4_kernel(const __grid_constant__ LeafTable t, int n_leaves,
               const float* __restrict__ partials, float lr, float max_norm) {
  const int c = blockIdx.x, chunks = gridDim.x;
  const Span s = span(t, n_leaves, c, 0);
  float4 pv[kVecs], gv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    pv[k] = load4(s.p, at(s, k), s);
    gv[k] = load4(s.g, at(s, k), s);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // sumsq4_kernel's grid is done
  float total = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kThreads) total += __ldcg(partials + i);
  const float norm = sqrtf(block_sum(total));
  const float step = lr * (norm > max_norm ? max_norm / (norm + 1e-6f) : 1.f);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const float4 r = make_float4(sgd(pv[k].x, step, gv[k].x), sgd(pv[k].y, step, gv[k].y),
                                 sgd(pv[k].z, step, gv[k].z), sgd(pv[k].w, step, gv[k].w));
    store4(s.p, at(s, k), s, r);
  }
}

// Row 9. Grid (chunks, V): partials[v][c] = the sum of squares of chunk c
// of task v.
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ LeafTable t, int n_leaves, float* __restrict__ partials) {
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  const Span s = span(t, n_leaves, c, v);
  const long long end = min(s.begin + kChunk, s.n);
  const float* __restrict__ g = s.g;
  float sq = 0.f;
  for (long long i = s.begin + threadIdx.x; i < end; i += kThreads) sq = fmaf(g[i], g[i], sq);
  sq = block_sum(sq);
  if (threadIdx.x == 0) partials[(long long)v * chunks + c] = sq;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ LeafTable t, int n_leaves,
              const float* __restrict__ partials, float lr, float max_norm) {
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  float total = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kThreads) total += partials[(long long)v * chunks + i];
  const float norm = sqrtf(block_sum(total));
  const float step = lr * (norm > max_norm ? max_norm / (norm + 1e-6f) : 1.f);
  const Span s = span(t, n_leaves, c, v);
  const long long end = min(s.begin + kChunk, s.n);
  // Restricted: the loop's loads may run ahead of its stores.
  float* __restrict__ p = s.p;
  const float* __restrict__ g = s.g;
  for (long long i = s.begin + threadIdx.x; i < end; i += kThreads) p[i] = sgd(p[i], step, g[i]);
}

// The chunks of one task's leaves, or -1 for a table the kernel does not take.
long long task_chunks(int n_leaves, const long long* sizes) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return -1;
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] <= 0) return -1;
    chunks += (sizes[i] + kChunk - 1) / kChunk;
  }
  return chunks > 0x7fffffffLL ? -1 : chunks;
}

}  // namespace
}  // namespace wf

// One call's arguments, packed by ops/fused_sgd.py (`_Plan.launch`), 8
// bytes a field.
struct SgdLaunch {
  long long n_leaves, n_tasks;
  double lr, max_norm;
  long long partials, stream;
  long long leaves[3 * wf::kMaxLeaves];  // params[n], then grads[n], then sizes[n]
};

namespace {

// The leaf table of a launch and its chunks a task; false for a tree the
// kernels do not take.
bool table(const SgdLaunch* a, wf::LeafTable* t, int* chunks) {
  const int n = (int)a->n_leaves;
  if (a->n_leaves < 1 || a->n_leaves > wf::kMaxLeaves || a->n_tasks < 1 || a->n_tasks > 65535)
    return false;
  const long long* sizes = a->leaves + 2 * n;
  if (wf::task_chunks(n, sizes) < 1) return false;
  int start = 0;
  for (int i = 0; i < n; ++i) {
    t->p[i] = reinterpret_cast<float*>(a->leaves[i]);
    t->g[i] = reinterpret_cast<const float*>(a->leaves[n + i]);
    t->n[i] = sizes[i];
    t->chunk_start[i] = start;
    start += (int)((sizes[i] + wf::kChunk - 1) / wf::kChunk);
  }
  t->chunk_start[n] = start;
  *chunks = start;
  return true;
}

}  // namespace

// The floats of scratch (`partials`) one launch takes for n_tasks tasks of
// these leaves, or -1 for a tree the kernels do not take (no leaves or more
// than 64, an empty leaf, more than 65535 tasks).
extern "C" long long wf_clip_sgd_plan(int n_leaves, const long long* sizes, int n_tasks) {
  const long long chunks = wf::task_chunks(n_leaves, sizes);
  if (chunks < 0 || n_tasks < 1 || n_tasks > 65535) return -1;
  return chunks * n_tasks;
}

// Row 8: p <- p - lr * clip(g), in place, over n_leaves float32 leaves of
// one task (params[i], grads[i]: sizes[i] contiguous values). Returns a
// cudaError_t code (0 on success).
extern "C" int wf_clip_sgd_update(const SgdLaunch* a) {
  wf::LeafTable t;
  int chunks = 0;
  if (a->n_tasks != 1 || !table(a, &t, &chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a->stream);
  float* partials = reinterpret_cast<float*>(a->partials);
  int n_leaves = (int)a->n_leaves;
  wf::sumsq4_kernel<<<chunks, wf::kThreads, 0, stream>>>(t, n_leaves, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)chunks, 1, 1);
  cfg.blockDim = dim3(wf::kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpartials = partials;
  float lr = (float)a->lr, max_norm = (float)a->max_norm;
  err = cudaLaunchKernelEx(&cfg, wf::update4_kernel, t, n_leaves, cpartials, lr, max_norm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Row 9: the same per task of a leading task axis (params[i], grads[i]:
// n_tasks * sizes[i] contiguous values, task-major), each task clipped by
// its own norm. Returns a cudaError_t code (0 on success).
extern "C" int wf_clip_sgd_update_tasks(const SgdLaunch* a) {
  wf::LeafTable t;
  int chunks = 0;
  if (!table(a, &t, &chunks)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a->stream);
  float* partials = reinterpret_cast<float*>(a->partials);
  const dim3 grid((unsigned)chunks, (unsigned)a->n_tasks);
  int n_leaves = (int)a->n_leaves;
  wf::sumsq_kernel<<<grid, wf::kThreads, 0, stream>>>(t, n_leaves, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::update_kernel<<<grid, wf::kThreads, 0, stream>>>(t, n_leaves, partials, (float)a->lr,
                                                       (float)a->max_norm);
  return (int)cudaGetLastError();
}
