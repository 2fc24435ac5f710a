// The whole-tree clip + SGD update (kernel rows 8 and 9) in the designs
// that tools/sgd_designs.py times beside the port's own kernel
// (weatherforecast_stgcn_maml_tpu_torch/ops/csrc/fused_sgd.cu):
//   coop    one cooperative launch, every block resident: each block loads
//           its run of 2048-value chunks of g and p into registers (16-byte
//           vectors), writes its float32 sum of squares, meets every other
//           block at one grid barrier (cooperative_groups::this_grid()
//           .sync()), sums the partials in one fixed order and writes p
//           from the values it holds;
//   pdl4    row 8's two kernels (the sums of squares of 4096-value chunks,
//           then the update, chained by programmatic dependent launch) with
//           a task axis, to time them at row 9's V = 4;
//   stream  the bytes' floor: p - lr * g in one pass (no norm).
// coop and pdl4 compute what the port's kernel computes, in the same
// rounding. Built by tools/sgd_designs.py with nvcc on the card; the port
// does not use this file.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr long long kChunk = 4096;
constexpr int kPer = kChunk / kThreads;  // values a thread

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk_start[kMaxLeaves + 1];
};

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

__device__ __forceinline__ int leaf_of(const LeafTable& t, int n_leaves, int c) {
  int leaf = 0;
  while (leaf + 1 < n_leaves && t.chunk_start[leaf + 1] <= c) ++leaf;
  return leaf;
}

// 16-byte access to values i .. i + 3 of a leaf of n values at a; values
// past the end read as 0 and are not stored; an unaligned base or a ragged
// end goes value by value.
__device__ __forceinline__ float4 load4(const float* a, long long i, long long n, bool vec) {
  if (vec && i + 3 < n) return *reinterpret_cast<const float4*>(a + i);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n) r.x = a[i];
  if (i + 1 < n) r.y = a[i + 1];
  if (i + 2 < n) r.z = a[i + 2];
  if (i + 3 < n) r.w = a[i + 3];
  return r;
}

__device__ __forceinline__ void store4(float* a, long long i, long long n, bool vec, float4 r) {
  if (vec && i + 3 < n) {
    *reinterpret_cast<float4*>(a + i) = r;
    return;
  }
  if (i < n) a[i] = r.x;
  if (i + 1 < n) a[i + 1] = r.y;
  if (i + 2 < n) a[i + 2] = r.z;
  if (i + 3 < n) a[i + 3] = r.w;
}

constexpr int kVecs = kPer / 4;  // float4 a thread a chunk

// Design pdl4.
__global__ void __launch_bounds__(kThreads)
sumsq4_kernel(const __grid_constant__ LeafTable t, int n_leaves, float* __restrict__ partials) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  const int leaf = leaf_of(t, n_leaves, c);
  const long long n = t.n[leaf];
  const long long begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  const float* g = t.g[leaf] + (long long)v * n;
  const bool vec = (reinterpret_cast<unsigned long long>(g) & 15) == 0;
  float4 x[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    x[k] = load4(g, begin + 4 * ((long long)k * kThreads + threadIdx.x), n, vec);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    s = fmaf(x[k].x, x[k].x, s);
    s = fmaf(x[k].y, x[k].y, s);
    s = fmaf(x[k].z, x[k].z, s);
    s = fmaf(x[k].w, x[k].w, s);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partials[(long long)v * chunks + c] = s;
}

__global__ void __launch_bounds__(kThreads)
update4_kernel(const __grid_constant__ LeafTable t, int n_leaves,
               const float* __restrict__ partials, float lr, float max_norm) {
  const int c = blockIdx.x, v = blockIdx.y, chunks = gridDim.x;
  const int leaf = leaf_of(t, n_leaves, c);
  const long long n = t.n[leaf];
  const long long begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  float* p = t.p[leaf] + (long long)v * n;
  const float* g = t.g[leaf] + (long long)v * n;
  const bool vec = ((reinterpret_cast<unsigned long long>(g) |
                     reinterpret_cast<unsigned long long>(p)) & 15) == 0;
  float4 pv[kVecs], gv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = begin + 4 * ((long long)k * kThreads + threadIdx.x);
    pv[k] = load4(p, i, n, vec);
    gv[k] = load4(g, i, n, vec);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float s = 0.f;
  for (int i = threadIdx.x; i < chunks; i += kThreads)
    s += __ldcg(partials + (long long)v * chunks + i);
  const float norm = sqrtf(block_sum(s));
  const float scale = norm > max_norm ? max_norm / (norm + 1e-6f) : 1.f;
  const float step = lr * scale;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    float4 r;
    r.x = __fsub_rn(pv[k].x, __fmul_rn(step, gv[k].x));
    r.y = __fsub_rn(pv[k].y, __fmul_rn(step, gv[k].y));
    r.z = __fsub_rn(pv[k].z, __fmul_rn(step, gv[k].z));
    r.w = __fsub_rn(pv[k].w, __fmul_rn(step, gv[k].w));
    store4(p, begin + 4 * ((long long)k * kThreads + threadIdx.x), n, vec, r);
  }
}

// The bytes' floor (design stream): p <- p - lr * g in one pass, 16-byte
// accesses, no norm; not the update (no clip), its traffic alone.
__global__ void __launch_bounds__(kThreads)
stream_kernel(const __grid_constant__ LeafTable t, int n_leaves, float lr) {
  const int c = blockIdx.x, v = blockIdx.y;
  const int leaf = leaf_of(t, n_leaves, c);
  const long long n = t.n[leaf];
  const long long begin = (long long)(c - t.chunk_start[leaf]) * kChunk;
  float* p = t.p[leaf] + (long long)v * n;
  const float* g = t.g[leaf] + (long long)v * n;
  const bool vec = ((reinterpret_cast<unsigned long long>(g) |
                     reinterpret_cast<unsigned long long>(p)) & 15) == 0;
  float4 pv[kVecs], gv[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = begin + 4 * ((long long)k * kThreads + threadIdx.x);
    pv[k] = load4(p, i, n, vec);
    gv[k] = load4(g, i, n, vec);
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    float4 r;
    r.x = __fsub_rn(pv[k].x, __fmul_rn(lr, gv[k].x));
    r.y = __fsub_rn(pv[k].y, __fmul_rn(lr, gv[k].y));
    r.z = __fsub_rn(pv[k].z, __fmul_rn(lr, gv[k].z));
    r.w = __fsub_rn(pv[k].w, __fmul_rn(lr, gv[k].w));
    store4(p, begin + 4 * ((long long)k * kThreads + threadIdx.x), n, vec, r);
  }
}

// Design coop: 512 threads a block, chunks of 2048 values (one float4 a
// thread), up to kHold chunks a block held in registers across the barrier.
constexpr int kCoopThreads = 512;
constexpr long long kCoopChunk = 4 * kCoopThreads;
constexpr int kHold = 4;

__device__ __forceinline__ float coop_block_sum(float v) {
  __shared__ float warp_sums[kCoopThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kCoopThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

struct Slot {
  const float* g;
  float* p;
  long long i, n;
  bool vec;
};

// Chunk c of task v, this thread's four values; `leaf` advances to c's leaf.
__device__ __forceinline__ Slot slot(const LeafTable& t, int& leaf, int c, int v) {
  while (t.chunk_start[leaf + 1] <= c) ++leaf;
  Slot s;
  s.n = t.n[leaf];
  s.g = t.g[leaf] + (long long)v * s.n;
  s.p = t.p[leaf] + (long long)v * s.n;
  s.i = (long long)(c - t.chunk_start[leaf]) * kCoopChunk + 4 * threadIdx.x;
  s.vec = ((reinterpret_cast<uintptr_t>(s.g) | reinterpret_cast<uintptr_t>(s.p)) & 15) == 0;
  return s;
}

__device__ __forceinline__ float sumsq4(float s, float4 g) {
  s = fmaf(g.x, g.x, s);
  s = fmaf(g.y, g.y, s);
  s = fmaf(g.z, g.z, s);
  return fmaf(g.w, g.w, s);
}

__device__ __forceinline__ float4 sgd4(float4 p, float step, float4 g) {
  return make_float4(__fsub_rn(p.x, __fmul_rn(step, g.x)), __fsub_rn(p.y, __fmul_rn(step, g.y)),
                     __fsub_rn(p.z, __fmul_rn(step, g.z)), __fsub_rn(p.w, __fmul_rn(step, g.w)));
}

// Block b: task b / blocks_per_task, chunks [j * chunks / B, (j + 1) * chunks / B).
__global__ void __launch_bounds__(kCoopThreads, 2)
coop_kernel(const __grid_constant__ LeafTable t, int n_leaves, int chunks, int blocks_per_task,
            float* __restrict__ partials, float lr, float max_norm) {
  const int v = blockIdx.x / blocks_per_task, j = blockIdx.x % blocks_per_task;
  const int c0 = (int)((long long)j * chunks / blocks_per_task);
  const int c1 = (int)((long long)(j + 1) * chunks / blocks_per_task);
  __shared__ int first_leaf;  // c0's leaf, one thread a leaf
  if ((int)threadIdx.x < n_leaves && t.chunk_start[threadIdx.x] <= c0 &&
      c0 < t.chunk_start[threadIdx.x + 1])
    first_leaf = threadIdx.x;
  __syncthreads();
  const int leaf0 = first_leaf;
  float4 g_held[kHold], p_held[kHold];
  int leaf = leaf0;
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    if (c0 + k < c1) {
      const Slot s = slot(t, leaf, c0 + k, v);
      g_held[k] = load4(s.g, s.i, s.n, s.vec);
      p_held[k] = load4(s.p, s.i, s.n, s.vec);
    }
  }
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kHold; ++k)
    if (c0 + k < c1) sq = sumsq4(sq, g_held[k]);
  for (int c = c0 + kHold; c < c1; ++c) {
    const Slot s = slot(t, leaf, c, v);
    sq = sumsq4(sq, load4(s.g, s.i, s.n, s.vec));
  }
  sq = coop_block_sum(sq);
  if (threadIdx.x == 0) partials[blockIdx.x] = sq;
  cooperative_groups::this_grid().sync();
  float total = 0.f;
  for (int i = threadIdx.x; i < blocks_per_task; i += kCoopThreads)
    total += __ldcg(partials + (long long)v * blocks_per_task + i);
  const float norm = sqrtf(coop_block_sum(total));
  const float step = lr * (norm > max_norm ? max_norm / (norm + 1e-6f) : 1.f);
  leaf = leaf0;
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    if (c0 + k < c1) {
      const Slot s = slot(t, leaf, c0 + k, v);
      store4(s.p, s.i, s.n, s.vec, sgd4(p_held[k], step, g_held[k]));
    }
  }
  for (int c = c0 + kHold; c < c1; ++c) {
    const Slot s = slot(t, leaf, c, v);
    store4(s.p, s.i, s.n, s.vec,
           sgd4(load4(s.p, s.i, s.n, s.vec), step, load4(s.g, s.i, s.n, s.vec)));
  }
}

}  // namespace

// The port's packed launch (ops/fused_sgd.py `_Plan.launch`).
struct SgdLaunch {
  long long n_leaves, n_tasks;
  double lr, max_norm;
  long long partials, stream;
  long long leaves[3 * kMaxLeaves];
};

// The partials a launch of these designs takes: the most of n_tasks x
// chunks (pdl4) and the card's resident coop blocks.
extern "C" long long design_partials(int n_leaves, const long long* sizes, int n_tasks) {
  long long chunks = 0;
  for (int i = 0; i < n_leaves; ++i) chunks += (sizes[i] + kChunk - 1) / kChunk;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coop_kernel, kCoopThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long resident = (long long)per_sm * sms;
  return chunks * n_tasks > resident ? chunks * n_tasks : resident;
}

// Runs design coop: a grid of every resident block, split evenly over the
// tasks. A cudaError_t code.
extern "C" int design_coop(const SgdLaunch* a) {
  const int n = (int)a->n_leaves, tasks = (int)a->n_tasks;
  const long long* sizes = a->leaves + 2 * n;
  LeafTable t;
  int start = 0;
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<float*>(a->leaves[i]);
    t.g[i] = reinterpret_cast<const float*>(a->leaves[n + i]);
    t.n[i] = sizes[i];
    t.chunk_start[i] = start;
    start += (int)((sizes[i] + kCoopChunk - 1) / kCoopChunk);
  }
  t.chunk_start[n] = start;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coop_kernel, kCoopThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int bpt = per_sm * sms / tasks;
  if (bpt > start) bpt = start;
  if (bpt < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bpt * tasks), 1, 1);
  cfg.blockDim = dim3(kCoopThreads, 1, 1);
  cfg.stream = reinterpret_cast<cudaStream_t>(a->stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_leaves = n, chunks = start;
  float* partials = reinterpret_cast<float*>(a->partials);
  float lr = (float)a->lr, max_norm = (float)a->max_norm;
  cudaError_t err = cudaLaunchKernelEx(&cfg, coop_kernel, t, n_leaves, chunks, bpt, partials, lr,
                                       max_norm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {

int table(const SgdLaunch* a, LeafTable* t) {
  const int n = (int)a->n_leaves;
  const long long* sizes = a->leaves + 2 * n;
  int start = 0;
  for (int i = 0; i < n; ++i) {
    t->p[i] = reinterpret_cast<float*>(a->leaves[i]);
    t->g[i] = reinterpret_cast<const float*>(a->leaves[n + i]);
    t->n[i] = sizes[i];
    t->chunk_start[i] = start;
    start += (int)((sizes[i] + kChunk - 1) / kChunk);
  }
  t->chunk_start[n] = start;
  return start;
}

}  // namespace

// Runs design pdl4; a cudaError_t code.
extern "C" int design_pdl4(const SgdLaunch* a) {
  LeafTable t;
  const dim3 grid((unsigned)table(a, &t), (unsigned)a->n_tasks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a->stream);
  float* partials = reinterpret_cast<float*>(a->partials);
  int n_leaves = (int)a->n_leaves;
  sumsq4_kernel<<<grid, kThreads, 0, s>>>(t, n_leaves, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpartials = partials;
  float lr = (float)a->lr, max_norm = (float)a->max_norm;
  err = cudaLaunchKernelEx(&cfg, update4_kernel, t, n_leaves, cpartials, lr, max_norm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Runs design stream; a cudaError_t code.
extern "C" int design_stream(const SgdLaunch* a) {
  LeafTable t;
  const dim3 grid((unsigned)table(a, &t), (unsigned)a->n_tasks);
  stream_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(a->stream)>>>(
      t, (int)a->n_leaves, (float)a->lr);
  return (int)cudaGetLastError();
}
