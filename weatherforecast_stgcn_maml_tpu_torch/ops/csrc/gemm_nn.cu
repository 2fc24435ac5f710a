// Pipelined GEMM core, row-major, a batch as a leading index with strides:
//   NN  C = epilogue(op(A1) @ B1 [+ op(A2) @ B2])          (wf_gemm_nn)
//   TN  C[s] = A[ks]^T @ B[ks], split s of K, float32 partials  (wf_gemm_tn)
//
// Serves these kernel rows (TPU kernels in weatherforecast_stgcn_maml_tpu/ops/):
//   rows 1 and 3, fused_gcn.py `_stack_kernel` / `_kernel` (the GCN stack and
//     one layer, forward): hw = round(h) @ round(W) stored in the compute
//     dtype, then relu(round(A_hat) @ hw + b) (the bias + relu epilogue);
//   row 7, fused_gcn_train.py `_bwd_kernel` (the training GCN stack's
//     backward), layer by layer: dhw = round(A_hat^T) @ round(dz) per slice
//     (NN, batched, stored in the compute dtype), dW = round(h_in)^T @ dhw over
//     every slice and node (TN, split over K), and d_in = dhw @ round(W)^T,
//     whose relu-grad epilogue writes the layer below's dz = d_in * [h > 0] *
//     mask / keep in the compute dtype and its float32 column sums a row tile
//     (db's partials, summed in tile order by wf_sum_splits);
//   row 12, fused_gcn_shard.py `_fwd_kernel` (the node-sharded sandwich
//     layer's forward): relu(round(A_rows) @ hw_full[:, s] + b) * mask / keep
//     for every slice s in one batched launch over the node-major layout (the
//     bias + relu + mask epilogue), then hw_next = round(h_post) @ W_next;
//   rows 5, 15 and 17, fused_lstm_stack.py `_bwd_kernel_m` / `_bwd_kernel` /
//     `_bwd_kernel_mv` (the LSTM stack's backward; row 17 for V tasks, each
//     product batched over the tasks), off the serial chain: row 15's
//     recomputed gates of one layer for all T x R rows, act(in @ Wx +
//     h_{t-1} @ Wh + b) as two operand pairs into one float32 accumulator,
//     the second at a row offset of R (h_{-1} = 0; the gate epilogue), and
//     each row's input gradient round(dgates) @ Wx^T, times the layer
//     below's dropout mask and 1/keep (the mask epilogue); row 17's weight
//     gradients, dWx = round(in)^T round(dgates) and dWh = round(h_{t-1})^T
//     round(dgates) (TN, split over K, a task axis);
//   row 6, fused_gcn_train.py `_fwd_kernel` (the training GCN stack's
//     forward): row 1's two products a layer, the aggregation's bias + relu
//     + mask epilogue storing each layer's post-dropout h in the compute
//     dtype (ops/fused_gcn_train.py `forward_schedule`);
//   rows 4, 14 and 16, fused_lstm_stack.py `_fwd_kernel_m` / `_fwd_kernel` /
//     `_fwd_kernel_mv` (the LSTM stacks' training forwards; row 16 for V
//     tasks), layer by layer: the input product round(in) @ round(Wx) of all
//     T x R rows, batched over the steps (one task) or over the tasks, B's
//     batch stride stepping through each task's weights (enqueued from
//     lstm_stack_fwd.cu, which fills this file's NNLaunch);
//   row 19, lstm_scan.py `_bwd_kernel` (one LSTM layer's backward): its
//     weight gradient dWh = round(h_{t-1})^T round(dgates) (TN, split over
//     K, an A row offset; enqueued from lstm_scan.cu);
//   row 13, fused_gcn_shard.py `_bwd_kernel` (the node-sharded sandwich
//     layer's backward): round(g2) @ round(W_next)^T with the relu-grad
//     epilogue (dz and db's partials), dW_next = round(h_post)^T round(g2)
//     (TN, split K) and round(A_rows)^T @ round(dz) (NN).
// The other GEMMs of the port (the weight gradients of rows 5 and 15, row
// 20's projections) stay on gemm.cu.
//
// Numerics are the port's (common.cuh): operands are rounded to the compute
// dtype as they are loaded, products accumulate in float32. B is stored in
// the compute dtype; A in float32 or in the compute dtype (float32 A under
// bfloat16 compute is rounded on its way into shared memory).
//
// What bounds it, and the design:
//   float32 (the model's default): the card's FMA rate outside the tensor
//     cores (67 TFLOP/s), if shared memory keeps up. Each thread owns an
//     8 x 8 register tile and reads its operands as 16-byte vectors: per 4-deep
//     k step, 8 LDS.128 of A (its 8 rows, 4 k each; a quarter-warp reads one
//     address, a broadcast) and 8 of B (2 x 4 columns a k), 1 LDS.128 per 16
//     FFMAs. 16-deep K slabs arrive by cp.async in a 3-stage ring, one barrier
//     a slab; the ragged edge is zero-filled by the copy (src-size 0), so the
//     inner loop has no bounds checks. 128 x 64 tiles of 128 threads: row 3's
//     two products make 384 blocks each, one wave of the 396 slots that 3
//     blocks an SM give on 132 SMs (128 x 128 tiles made 192 blocks, 60 SMs
//     with two and 72 with one).
//   bfloat16: the tensor cores. Operands sit in shared memory as bf16 (rows
//     padded by 16 bytes, so ldmatrix's 8 rows fall in 8 distinct bank groups)
//     and each warp multiplies a 64 x 32 tile with mma.sync.m16n8k16 (bf16 in,
//     float32 accumulate), A by ldmatrix.x4, B by ldmatrix.x4.trans, in 32-deep
//     K slabs on the same 3-stage ring. float32 A is fetched into registers
//     before a slab's math and rounded into shared memory after it. wgmma with
//     TMA and warp specialisation is later work.
// Epilogues are compile-time variants (as runtime flags in gemm.cu they cost
// an occupancy step); the store dtype is a runtime flag of the epilogue.
//
// TN (A stored [K, M]): the weight gradients' layout, natural for both tiles.
//   float32: the A slab arrives by cp.async straight into the [BK][BM] layout
//     the FFMA outer product reads (two LDS.128 of A and two of B a k step per
//     64 FFMAs, as NN); ring, zero-filled edges and the 8 x 8 register tile
//     as NN.
//   bfloat16: A sits in shared memory as [BK][BM] rows and reaches mma.sync
//     by ldmatrix.x4.trans, B as in NN.
//   Split over K: at the GCN weight gradient's 256 x 256 output only 8 tiles
//     exist, so each block takes `kc` rows of K (256 at the reference width:
//     48 splits, 384 blocks, one wave at 3 blocks an SM) and writes its own
//     float32 partial; wf_sum_splits adds them in split order, so the result
//     does not depend on the order blocks ran in (no atomics: two runs are
//     bitwise equal). An output narrower than the tile (M = 24 at the GCN's
//     layer 0) zero-fills the missing columns as it loads, and warps whose
//     rows all lie past M skip the math.
//   A task axis (row 17: V tasks' LSTM weight gradients in one launch, each
//     task's operands and partials at strides of their own) shares
//     blockIdx.z with the splits, and `kc` is chosen for V tasks x tiles x
//     splits to make about one wave (ops/gemm.py `wave_split_rows`: 512 rows
//     at V = 2). An A row offset pairs A row k - a_off with B row k,
//     zero-filling the first a_off rows as they load: the recurrent weight
//     gradient h_{t-1}^T dgates_t over every step, at the splits of the
//     input weight gradient's.
#include <cstdint>

#include "common.cuh"
#include "gemm_nn_launch.cuh"

namespace wf {
namespace {

enum Epilogue : int {
  kEpiNone = 0,
  kEpiBiasRelu = 1,
  kEpiGates = 2,
  kEpiMask = 3,
  kEpiBiasReluMask = 4,  // relu(v + b[n]) * mask * scale
  kEpiReluGrad = 5,      // v * [res > 0] (* mask * scale), plus column sums a row tile
};

// One operand pair. Output row m of batch z takes A row m - row_offset
// (rows m < row_offset take no term of this pair): A[z*sa + (m -
// row_offset)*lda + k], B[z*sb + k*ldb + n], k < K.
struct NNPair {
  const void* A;
  long long sa;
  int lda, a_f32;  // a_f32: A is stored in float32 (else in the compute dtype)
  const void* B;
  long long sb;
  int ldb, K, row_offset;
};

struct NNArgs {
  NNPair pair[2];
  int pairs;
  void* C;  // C[z*sc + m*ldc + n], float32 or bfloat16 (c_bf16)
  long long sc;
  int ldc, c_bf16;
  const float* bias;    // [N]: bias + relu (+ mask), gates
  const int8_t* mask;   // C's layout: multiplies by mask * scale (may be null in relu-grad)
  float scale;
  int M, N;
  const void* res;  // relu-grad: the post-dropout activation in C's layout
  int res_bf16;     // ... stored in bfloat16 (else float32)
  float* colsum;    // relu-grad: colsum[(z * row tiles + tile) * ldp + n], float32
  int ldp;
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int EPI>
__device__ __forceinline__ float epilogue(float v, int n, long long at, const NNArgs& g) {
  if (EPI == kEpiBiasRelu) return fmaxf(v + g.bias[n], 0.f);
  if (EPI == kEpiBiasReluMask) return fmaxf(v + g.bias[n], 0.f) * ((float)g.mask[at] * g.scale);
  if (EPI == kEpiReluGrad) {
    const float h = g.res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g.res)[at])
                               : static_cast<const float*>(g.res)[at];
    v = v * (h > 0.f ? 1.f : 0.f);
    return g.mask ? v * ((float)g.mask[at] * g.scale) : v;
  }
  if (EPI == kEpiGates) {  // gate order i, f, g, o: tanh on g, sigmoid on the rest
    v = v + g.bias[n];
    return n / (g.N >> 2) == 2 ? tanhf(v) : sigmoidf(v);
  }
  if (EPI == kEpiMask) return v * ((float)g.mask[at] * g.scale);
  return v;
}

// Columns n .. n + W - 1 of row m (all < N: N is a multiple of 8 and n of W);
// v is left holding the epilogue's float32 values.
template <int EPI, int W>
__device__ __forceinline__ void store_run(const NNArgs& g, long long at, int n, float* v) {
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = epilogue<EPI>(v[j], n + j, at + j, g);
  if (g.c_bf16) {
    __nv_bfloat162* c = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(g.C) + at);
#pragma unroll
    for (int j = 0; j < W; j += 2) c[j / 2] = __floats2bfloat162_rn(v[j], v[j + 1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<float4*>(static_cast<float*>(g.C) + at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(g.C) + at) = make_float2(v[0], v[1]);
  }
}

// Pair 0 or 1 as values, each field picked by a select (no dynamic index
// into the kernel's parameters, which would copy them to local memory).
__device__ __forceinline__ NNPair pick(const NNArgs& g, bool second) {
  const NNPair& a = g.pair[0];
  const NNPair& b = g.pair[1];
  return NNPair{second ? b.A : a.A,         second ? b.sa : a.sa,
                second ? b.lda : a.lda,     second ? b.a_f32 : a.a_f32,
                second ? b.B : a.B,         second ? b.sb : a.sb,
                second ? b.ldb : a.ldb,     second ? b.K : a.K,
                second ? b.row_offset : a.row_offset};
}

// Slabs of the K loop: pair 0's, then pair 1's. A tile wholly above pair 1's
// row offset takes none of it.
__device__ __forceinline__ int slabs_of(const NNArgs& g, int p, int m0, int bm, int bk) {
  const NNPair& q = g.pair[p];  // p is a constant where this is inlined
  if (p >= g.pairs || m0 + bm <= q.row_offset) return 0;
  return (q.K + bk - 1) / bk;
}

// ---------------------------------------------------------------- float32

constexpr int kFBM = 128, kFBN = 64, kFBK = 16, kFThreads = 128, kFStages = 3;
constexpr int kFAStage = kFBM * kFBK;  // floats: A [BM][BK]
constexpr int kFBStage = kFBK * kFBN;  // B [BK][BN]
constexpr size_t kFSmem = (size_t)kFStages * (kFAStage + kFBStage) * sizeof(float);

template <int EPI>
__global__ void __launch_bounds__(kFThreads, 3) gemm_nn_f32_kernel(NNArgs g) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kFStages * kFAStage;
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // columns tx*4 .. +3 and 32 + tx*4 .. +3
  const int ty = tid / 8;  // rows ty*8 .. +7
  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;
  const long long z = blockIdx.z;
  const int kt0 = slabs_of(g, 0, m0, kFBM, kFBK);
  const int kts = kt0 + slabs_of(g, 1, m0, kFBM, kFBK);

  auto load_slab = [&](int s, int stage) {
    const NNPair q = pick(g, s >= kt0);
    const int k0 = (s < kt0 ? s : s - kt0) * kFBK;
    const float* A = static_cast<const float*>(q.A) + z * q.sa;
    const float* B = static_cast<const float*>(q.B) + z * q.sb;
    float* as = As + stage * kFAStage;
    float* bs = Bs + stage * kFBStage;
#pragma unroll
    for (int i = 0; i < kFAStage / 4 / kFThreads; ++i) {  // 16-byte chunks
      const int c = tid + i * kFThreads;
      const int r = c / (kFBK / 4);
      const int kc = (c % (kFBK / 4)) * 4;
      const int m = m0 + r;
      const int ma = m - q.row_offset;
      const bool ok = m < g.M && ma >= 0 && k0 + kc < q.K;
      cp_async16_zfill(as + r * kFBK + kc, ok ? A + (long long)ma * q.lda + k0 + kc : A, ok);
    }
#pragma unroll
    for (int i = 0; i < kFBStage / 4 / kFThreads; ++i) {
      const int c = tid + i * kFThreads;
      const int r = c / (kFBN / 4);
      const int nc = (c % (kFBN / 4)) * 4;
      const bool ok = k0 + r < q.K && n0 + nc < g.N;
      cp_async16_zfill(bs + r * kFBN + nc, ok ? B + (long long)(k0 + r) * q.ldb + n0 + nc : B,
                       ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < kts) load_slab(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < kts; ++s) {
    cp_async_wait<kFStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();                // ... every thread's; stage (s-1) % S is free
    const int nxt = s + kFStages - 1;
    if (nxt < kts) load_slab(nxt, nxt % kFStages);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    const float* as = As + (s % kFStages) * kFAStage + ty * 8 * kFBK;
    const float* bs = Bs + (s % kFStages) * kFBStage + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(as + i * kFBK + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (kk + u) * kFBN);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (kk + u) * kFBN + 32);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

  float cs[8];  // relu-grad: this thread's column sums over its rows
#pragma unroll
  for (int j = 0; j < 8; ++j) cs[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= g.M) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 32 + tx * 4;
      if (n < g.N) {
        store_run<EPI, 4>(g, z * g.sc + (long long)m * g.ldc + n, n, &acc[i][h * 4]);
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[h * 4 + j] += acc[i][h * 4 + j];
      }
    }
  }
  if constexpr (EPI == kEpiReluGrad) {
    // The tile's column sums: the 16 row groups' sums added in order.
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
    float* red = As;  // [16][kFBN]
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty * kFBN + (j / 4) * 32 + tx * 4 + j % 4] = cs[j];
    __syncthreads();
    if (tid < kFBN && n0 + tid < g.N) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kFThreads / 8; ++t) s += red[t * kFBN + tid];
      g.colsum[(z * gridDim.y + blockIdx.y) * g.ldp + n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kHBM = 128, kHBN = 64, kHBK = 32, kHThreads = 128, kHStages = 3;
constexpr int kHLdA = kHBK + 8;  // bf16 per A row in shared memory (80 bytes)
constexpr int kHLdB = kHBN + 8;  // per B row (144 bytes)
constexpr int kHAStage = kHBM * kHLdA;
constexpr int kHBStage = kHBK * kHLdB;
constexpr size_t kHSmem = (size_t)kHStages * (kHAStage + kHBStage) * sizeof(__nv_bfloat16);
constexpr int kHAChunks = kHBM * kHBK / 8 / kHThreads;  // 16-byte bf16 chunks of A a thread

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int EPI>
__global__ void __launch_bounds__(kHThreads, 3) gemm_nn_bf16_kernel(NNArgs g) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Bs = As + kHStages * kHAStage;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp % 2) * 64;  // the warp's 64 x 32 tile
  const int wn = (warp / 2) * 32;
  const int m0 = blockIdx.y * kHBM;
  const int n0 = blockIdx.x * kHBN;
  const long long z = blockIdx.z;
  const int kt0 = slabs_of(g, 0, m0, kHBM, kHBK);
  const int kts = kt0 + slabs_of(g, 1, m0, kHBM, kHBK);

  // A chunk c of a slab: row c / 4, k offset (c % 4) * 8.
  auto a_chunk = [&](const NNPair& q, int k0, int c, long long& at) {
    const int m = m0 + c / (kHBK / 8);
    const int ma = m - q.row_offset;
    at = (long long)ma * q.lda + k0 + (c % (kHBK / 8)) * 8;
    return m < g.M && ma >= 0 && k0 + (c % (kHBK / 8)) * 8 < q.K;
  };
  auto a_smem = [&](int stage, int c) {
    return As + stage * kHAStage + (c / (kHBK / 8)) * kHLdA + (c % (kHBK / 8)) * 8;
  };
  // Issues slab s's cp.async copies (B, and A when stored in bf16); returns
  // whether A is float32, which the caller fetches with fetch_a / put_a.
  auto load_slab = [&](int s, int stage) {
    const NNPair q = pick(g, s >= kt0);
    const int k0 = (s < kt0 ? s : s - kt0) * kHBK;
    const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(q.B) + z * q.sb;
    __nv_bfloat16* bs = Bs + stage * kHBStage;
#pragma unroll
    for (int i = 0; i < kHBK * kHBN / 8 / kHThreads; ++i) {
      const int c = tid + i * kHThreads;
      const int r = c / (kHBN / 8);
      const int nc = (c % (kHBN / 8)) * 8;
      const bool ok = k0 + r < q.K && n0 + nc < g.N;
      cp_async16_zfill(bs + r * kHLdB + nc, ok ? B + (long long)(k0 + r) * q.ldb + n0 + nc : B,
                       ok);
    }
    if (q.a_f32) return true;
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(q.A) + z * q.sa;
#pragma unroll
    for (int i = 0; i < kHAChunks; ++i) {
      const int c = tid + i * kHThreads;
      long long at;
      const bool ok = a_chunk(q, k0, c, at);
      cp_async16_zfill(a_smem(stage, c), ok ? A + at : A, ok);
    }
    return false;
  };
  float4 areg[kHAChunks][2];  // a float32 A slab in flight
  auto fetch_a = [&](int s) {
    const NNPair q = pick(g, s >= kt0);
    const int k0 = (s < kt0 ? s : s - kt0) * kHBK;
    const float* A = static_cast<const float*>(q.A) + z * q.sa;
#pragma unroll
    for (int i = 0; i < kHAChunks; ++i) {
      long long at;
      if (a_chunk(q, k0, tid + i * kHThreads, at)) {
        areg[i][0] = __ldg(reinterpret_cast<const float4*>(A + at));
        areg[i][1] = __ldg(reinterpret_cast<const float4*>(A + at + 4));
      } else {
        areg[i][0] = areg[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto put_a = [&](int stage) {  // rounded to bf16 (round-to-nearest-even)
#pragma unroll
    for (int i = 0; i < kHAChunks; ++i) {
      const float4 lo = areg[i][0], hi = areg[i][1];
      *reinterpret_cast<uint4*>(a_smem(stage, tid + i * kHThreads)) =
          make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                     pack_bf16(hi.z, hi.w));
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < kts && load_slab(s, s)) {
      fetch_a(s);
      put_a(s);
    }
    cp_async_commit();
  }
  for (int s = 0; s < kts; ++s) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();  // slab s visible (copies and stores); stage (s-1) % S free
    const int nxt = s + kHStages - 1;
    const bool f32_next = nxt < kts && load_slab(nxt, nxt % kHStages);
    cp_async_commit();
    if (f32_next) fetch_a(nxt);  // in flight during this slab's math
    const __nv_bfloat16* as = As + (s % kHStages) * kHAStage;
    const __nv_bfloat16* bs = Bs + (s % kHStages) * kHBStage;
#pragma unroll
    for (int ks = 0; ks < kHBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm + mi * 16 + lane % 16) * kHLdA + ks + (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kHLdB + wn +
                                 nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    if (f32_next) put_a(nxt % kHStages);  // published by the next slab's barrier
  }

  // acc[mi][ni]: rows wm + mi*16 + lane/4 (+8), columns wn + ni*8 + (lane%4)*2 (+1).
  float cs[4][2];  // relu-grad: this thread's column sums over its rows
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + lane / 4 + half * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + (lane % 4) * 2;
        if (n < g.N) {
          store_run<EPI, 2>(g, z * g.sc + (long long)m * g.ldc + n, n, &acc[mi][ni][half * 2]);
          cs[ni][0] += acc[mi][ni][half * 2];
          cs[ni][1] += acc[mi][ni][half * 2 + 1];
        }
      }
    }
  if constexpr (EPI == kEpiReluGrad) {
    // The tile's column sums: over the 8 lanes that share a column (a fixed
    // butterfly), then the two warps that share it, in order.
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[ni][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[ni][e] = v;
      }
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
    float* red = reinterpret_cast<float*>(smem4);  // [2][kHBN]
    if (lane < 4)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(warp % 2) * kHBN + wn + ni * 8 + lane * 2 + e] = cs[ni][e];
    __syncthreads();
    if (tid < kHBN && n0 + tid < g.N)
      g.colsum[(z * gridDim.y + blockIdx.y) * g.ldp + n0 + tid] = red[tid] + red[kHBN + tid];
  }
}

// ---------------------------------------------------------------- TN

// Block z works on task v = z / splits and split s = z % splits:
// C[v*st + s*sc + m*ldc + n] = sum over k in [s*kc, min(K, (s+1)*kc)) of
// A'[k, m] * B[v*sb + k*ldb + n], split s's float32 partial of A'^T @ B,
// where A' holds a_off zero rows and then A: A'[k, m] = A[v*sa + (k -
// a_off)*lda + m] for k >= a_off (the LSTM's recurrent weight gradient pairs
// h_{t-1} with the gate gradients of step t, h_{-1} = 0).
struct TNArgs {
  const void* A;  // [K - a_off, M], compute dtype
  const void* B;  // [K, N], compute dtype
  float* C;
  long long sc;
  int lda, ldb, ldc, M, N, K, kc;
  long long sa, sb, st;  // task strides of A, B and C
  int splits, a_off;
};

// float32: the NN tile's sizes (kFBM x kFBN, kFBK-deep slabs, kFStages) and
// ring size, A's slab stored [BK][BM].
constexpr int kTAStage = kFBK * kFBM;
static_assert(kTAStage == kFAStage, "TN float32 reuses NN's ring size");

__global__ void __launch_bounds__(kFThreads, 3) gemm_tn_f32_kernel(TNArgs g) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kFStages * kTAStage;
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // columns tx*4 .. +3 and 32 + tx*4 .. +3
  const int ty = tid / 8;  // rows ty*8 .. +7
  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;
  const int task = blockIdx.z / g.splits;
  const int split = blockIdx.z % g.splits;
  const int kb = split * g.kc;
  const int ke = min(g.K, kb + g.kc);
  const int kts = (ke - kb + kFBK - 1) / kFBK;
  const float* A = static_cast<const float*>(g.A) + task * g.sa;
  const float* B = static_cast<const float*>(g.B) + task * g.sb;

  auto load_slab = [&](int s, int stage) {
    const int k0 = kb + s * kFBK;
    float* as = As + stage * kTAStage;
    float* bs = Bs + stage * kFBStage;
#pragma unroll
    for (int i = 0; i < kTAStage / 4 / kFThreads; ++i) {  // 16-byte chunks of A rows
      const int c = tid + i * kFThreads;
      const int r = c / (kFBM / 4);
      const int mc = (c % (kFBM / 4)) * 4;
      const bool ok = k0 + r < ke && k0 + r >= g.a_off && m0 + mc < g.M;
      cp_async16_zfill(as + r * kFBM + mc,
                       ok ? A + (long long)(k0 + r - g.a_off) * g.lda + m0 + mc : A, ok);
    }
#pragma unroll
    for (int i = 0; i < kFBStage / 4 / kFThreads; ++i) {
      const int c = tid + i * kFThreads;
      const int r = c / (kFBN / 4);
      const int nc = (c % (kFBN / 4)) * 4;
      const bool ok = k0 + r < ke && n0 + nc < g.N;
      cp_async16_zfill(bs + r * kFBN + nc, ok ? B + (long long)(k0 + r) * g.ldb + n0 + nc : B,
                       ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const bool live = m0 + ty * 8 < g.M;  // rows past M (a narrow output) skip the math

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < kts) load_slab(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < kts; ++s) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    const int nxt = s + kFStages - 1;
    if (nxt < kts) load_slab(nxt, nxt % kFStages);
    cp_async_commit();
    if (!live) continue;
    const float* as = As + (s % kFStages) * kTAStage + ty * 8;
    const float* bs = Bs + (s % kFStages) * kFBStage + tx * 4;
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kFBM);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kFBM + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kFBN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kFBN + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* C = g.C + task * g.st + split * g.sc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= g.M) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 32 + tx * 4;
      if (n < g.N)
        *reinterpret_cast<float4*>(C + (long long)m * g.ldc + n) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

// bfloat16: the NN tile's sizes; A's slab stored [kHBK][kHBM] with rows
// padded by 16 bytes, so ldmatrix's 8 rows fall in 8 distinct bank groups.
constexpr int kULdA = kHBM + 8;
constexpr int kUAStage = kHBK * kULdA;
constexpr size_t kUSmem = (size_t)kHStages * (kUAStage + kHBStage) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kHThreads, 3) gemm_tn_bf16_kernel(TNArgs g) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Bs = As + kHStages * kUAStage;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp % 2) * 64;  // the warp's 64 x 32 tile
  const int wn = (warp / 2) * 32;
  const int m0 = blockIdx.y * kHBM;
  const int n0 = blockIdx.x * kHBN;
  const int task = blockIdx.z / g.splits;
  const int split = blockIdx.z % g.splits;
  const int kb = split * g.kc;
  const int ke = min(g.K, kb + g.kc);
  const int kts = (ke - kb + kHBK - 1) / kHBK;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.A) + task * g.sa;
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(g.B) + task * g.sb;

  auto load_slab = [&](int s, int stage) {
    const int k0 = kb + s * kHBK;
    __nv_bfloat16* as = As + stage * kUAStage;
    __nv_bfloat16* bs = Bs + stage * kHBStage;
#pragma unroll
    for (int i = 0; i < kHBK * kHBM / 8 / kHThreads; ++i) {
      const int c = tid + i * kHThreads;
      const int r = c / (kHBM / 8);
      const int mc = (c % (kHBM / 8)) * 8;
      const bool ok = k0 + r < ke && k0 + r >= g.a_off && m0 + mc < g.M;
      cp_async16_zfill(as + r * kULdA + mc,
                       ok ? A + (long long)(k0 + r - g.a_off) * g.lda + m0 + mc : A, ok);
    }
#pragma unroll
    for (int i = 0; i < kHBK * kHBN / 8 / kHThreads; ++i) {
      const int c = tid + i * kHThreads;
      const int r = c / (kHBN / 8);
      const int nc = (c % (kHBN / 8)) * 8;
      const bool ok = k0 + r < ke && n0 + nc < g.N;
      cp_async16_zfill(bs + r * kHLdB + nc, ok ? B + (long long)(k0 + r) * g.ldb + n0 + nc : B,
                       ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const bool live = m0 + wm < g.M;  // a warp whose rows all lie past M skips the math

#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < kts) load_slab(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < kts; ++s) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();
    const int nxt = s + kHStages - 1;
    if (nxt < kts) load_slab(nxt, nxt % kHStages);
    cp_async_commit();
    if (!live) continue;
    const __nv_bfloat16* as = As + (s % kHStages) * kUAStage;
    const __nv_bfloat16* bs = Bs + (s % kHStages) * kHBStage;
#pragma unroll
    for (int ks = 0; ks < kHBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
      // A^T's 16 x 16 fragment from the [k][m] rows: matrix q = lane / 8
      // covers rows (q & 1) * 8 and k (q >> 1) * 8 of it, and .trans hands
      // each thread its row-major pairs.
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], as + (ks + (lane >> 4) * 8 + (lane & 7)) * kULdA + wm +
                                      mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kHLdB + wn +
                                 nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

  float* C = g.C + task * g.st + split * g.sc;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + lane / 4 + half * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + (lane % 4) * 2;
        if (n < g.N)
          *reinterpret_cast<float2*>(C + (long long)m * g.ldc + n) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
}

// ---------------------------------------------------------------- launch

// Both rings fit the 48 KB of dynamic shared memory a block gets without
// an opt-in: no cudaFuncSetAttribute call on the launch path.
static_assert(kFSmem <= 48 * 1024 && kHSmem <= 48 * 1024 && kUSmem <= 48 * 1024,
              "opt-in shared memory");

// Refusals: an argument the kernel does not take. Negative, so that they
// never collide with a cudaError_t; ops/gemm.py `_NN_REFUSALS` words each.
enum Refusal {
  kRefuseInt32 = -1,     // a size, leading dimension or row offset over int32
  kRefuseSize = -2,      // M, N or batch not positive
  kRefuseN = -3,         // N not a multiple of 8
  kRefuseC = -4,         // C's strides not multiples of 8 or C not 16-byte aligned
  kRefuseDtype = -5,     // compute dtype neither float32 nor bfloat16
  kRefuseK = -6,         // K not positive or not a multiple of 8
  kRefuseAB = -7,        // A's or B's strides not multiples of 8 or data not 16-byte aligned
  kRefuseOffset = -8,    // negative row offset
  kRefuseAType = -9,     // float32 compute with A not in float32
  kRefuseBias = -10,     // a bias epilogue without a bias
  kRefuseMask = -11,     // the mask epilogue without a mask
  kRefuseEpilogue = -12, // no such epilogue
  kRefuseGrid = -13,     // more than 65535 row tiles or batch entries
  kRefuseReluGrad = -14, // the relu-grad epilogue without a residual or column-sum partials
  kRefuseM = -15,        // TN: M not a multiple of 8
  kRefuseSplit = -16,    // TN: split rows not a positive multiple of 32
};

template <typename KernelT>
int launch_kernel(KernelT kernel, int bm, int bn, int threads, size_t smem, const NNArgs& g,
                  int batch, cudaStream_t stream) {
  const dim3 grid((g.N + bn - 1) / bn, (g.M + bm - 1) / bm, batch);
  if (grid.y > 65535u || grid.z > 65535u) return kRefuseGrid;
  kernel<<<grid, threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_epi(int r_dt, const NNArgs& g, int batch, cudaStream_t s) {
  if (r_dt == kF32)
    return launch_kernel(gemm_nn_f32_kernel<EPI>, kFBM, kFBN, kFThreads, kFSmem, g, batch, s);
  return launch_kernel(gemm_nn_bf16_kernel<EPI>, kHBM, kHBN, kHThreads, kHSmem, g, batch, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace wf

// C = epilogue(op(A1) @ B1 [+ op(A2) @ B2]) for each of `batch` batch entries
// (see wf::NNPair / wf::NNArgs for the indexing). r_dt is the compute dtype
// (0 = float32, 1 = bfloat16); B1 and B2 are stored in it; a*_f32 says A is
// stored in float32 (else in the compute dtype; float32 compute takes only
// float32 A). c_bf16 stores C in bfloat16. epilogue: 0 none, 1 + bias then
// relu, 2 + bias then the LSTM gate activation (N = 4H, gate order i, f, g,
// o), 3 x mask * scale (int8 in C's layout), 4 + bias, relu, x mask *
// scale, 5 (relu-grad) x [res > 0] (res float32, or bfloat16 with res_bf16,
// in C's layout) x mask * scale where a mask is given, with the float32
// column sums of each 128-row tile written to colsum[(z * tiles + tile) *
// ldp + n]. a2 null: one pair. Every K, N,
// leading dimension and batch stride is a multiple of 8 elements and every
// pointer 16-byte aligned. Returns a cudaError_t code (0 on success); an
// argument the kernel does not take returns its negative wf::Refusal code
// without launching.
extern "C" int wf_gemm_nn(const NNLaunch* p) {
  using namespace wf;
  auto ptr = [](long long v) { return reinterpret_cast<const void*>(v); };
  const int32_t kMax = 0x7fffffff;
  if (p->lda1 > kMax || p->ldb1 > kMax || p->lda2 > kMax || p->ldb2 > kMax || p->ldc > kMax ||
      p->k1 > kMax || p->k2 > kMax || p->row_offset2 > kMax || p->M > kMax || p->N > kMax ||
      p->batch > kMax)
    return kRefuseInt32;
  const int r_dt = (int)p->r_dt;
  const int epilogue = (int)p->epilogue;
  const int M = (int)p->M, N = (int)p->N, batch = (int)p->batch;
  NNArgs g{};
  g.pair[0] = NNPair{ptr(p->a1), p->sa1, (int)p->lda1, (int)p->a1_f32, ptr(p->b1), p->sb1,
                     (int)p->ldb1, (int)p->k1, 0};
  g.pair[1] = NNPair{ptr(p->a2), p->sa2, (int)p->lda2, (int)p->a2_f32, ptr(p->b2), p->sb2,
                     (int)p->ldb2, (int)p->k2, (int)p->row_offset2};
  g.pairs = p->a2 ? 2 : 1;
  g.C = reinterpret_cast<void*>(p->c);
  g.sc = p->sc;
  g.ldc = (int)p->ldc;
  g.c_bf16 = (int)p->c_bf16;
  g.bias = reinterpret_cast<const float*>(p->bias);
  g.mask = reinterpret_cast<const int8_t*>(p->mask);
  g.scale = (float)p->scale;
  g.M = M;
  g.N = N;
  g.res = ptr(p->res);
  g.res_bf16 = (int)p->res_bf16;
  g.colsum = reinterpret_cast<float*>(p->colsum);
  g.ldp = (int)p->ldp;
  if (p->ldp > kMax) return kRefuseInt32;
  if (M <= 0 || N <= 0 || batch <= 0) return kRefuseSize;
  if (N % 8) return kRefuseN;
  if (g.ldc % 8 || g.sc % 8 || !aligned16(g.C)) return kRefuseC;
  if (r_dt != kF32 && r_dt != kBF16) return kRefuseDtype;
  for (int i = 0; i < g.pairs; ++i) {
    const NNPair& q = g.pair[i];
    if (q.K <= 0 || q.K % 8) return kRefuseK;
    if (q.lda % 8 || q.ldb % 8 || q.sa % 8 || q.sb % 8 || !aligned16(q.A) || !aligned16(q.B))
      return kRefuseAB;
    if (q.row_offset < 0) return kRefuseOffset;
    if (r_dt == kF32 && !q.a_f32) return kRefuseAType;
  }
  if ((epilogue == kEpiBiasRelu || epilogue == kEpiGates || epilogue == kEpiBiasReluMask) &&
      !g.bias)
    return kRefuseBias;
  if ((epilogue == kEpiMask || epilogue == kEpiBiasReluMask) && !g.mask) return kRefuseMask;
  if (epilogue == kEpiReluGrad && (!g.res || !g.colsum || g.ldp < N)) return kRefuseReluGrad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  switch (epilogue) {
    case kEpiNone:
      return launch_epi<kEpiNone>(r_dt, g, batch, s);
    case kEpiBiasRelu:
      return launch_epi<kEpiBiasRelu>(r_dt, g, batch, s);
    case kEpiGates:
      return launch_epi<kEpiGates>(r_dt, g, batch, s);
    case kEpiMask:
      return launch_epi<kEpiMask>(r_dt, g, batch, s);
    case kEpiBiasReluMask:
      return launch_epi<kEpiBiasReluMask>(r_dt, g, batch, s);
    case kEpiReluGrad:
      return launch_epi<kEpiReluGrad>(r_dt, g, batch, s);
  }
  return kRefuseEpilogue;
}

// C[v][s] = A'[v][ks]^T @ B[v][ks] for every task v < batch and split s of
// K: ks = rows [s*kc, min(K, (s+1)*kc)), A' = a_off zero rows over A [K -
// a_off, M], B [K, N], both stored in the compute dtype r_dt (0 = float32,
// 1 = bfloat16) with row strides lda, ldb and task strides sa, sb; C
// float32, task v's split s at C + v*st + s*sc, row stride ldc. M, N, every
// row and task stride and sc are multiples of 8 elements, every pointer
// 16-byte aligned, kc a positive multiple of 32. Returns a cudaError_t code,
// or a negative wf::Refusal without launching.
extern "C" int wf_gemm_tn(const TNLaunch* p) {
  using namespace wf;
  const int32_t kMax = 0x7fffffff;
  if (p->lda > kMax || p->ldb > kMax || p->ldc > kMax || p->M > kMax || p->N > kMax ||
      p->K > kMax || p->kc > kMax || p->batch > kMax || p->a_off > kMax)
    return kRefuseInt32;
  TNArgs g{reinterpret_cast<const void*>(p->a), reinterpret_cast<const void*>(p->b),
           reinterpret_cast<float*>(p->c), p->sc, (int)p->lda, (int)p->ldb, (int)p->ldc,
           (int)p->M, (int)p->N, (int)p->K, (int)p->kc, p->sa, p->sb, p->st, 0,
           (int)p->a_off};
  if (g.M <= 0 || g.N <= 0 || g.K <= 0 || p->batch <= 0) return kRefuseSize;
  if (g.N % 8) return kRefuseN;
  if (g.M % 8) return kRefuseM;
  if (g.kc <= 0 || g.kc % 32) return kRefuseSplit;
  if (g.a_off < 0) return kRefuseOffset;
  if (g.ldc % 8 || g.sc % 8 || g.st % 8 || !aligned16(g.C)) return kRefuseC;
  if (g.lda % 8 || g.ldb % 8 || g.sa % 8 || g.sb % 8 || !aligned16(g.A) || !aligned16(g.B))
    return kRefuseAB;
  g.splits = (g.K + g.kc - 1) / g.kc;
  const long long zs = p->batch * g.splits;
  if (zs > 65535) return kRefuseGrid;
  const dim3 grid((g.N + kFBN - 1) / kFBN, (g.M + kFBM - 1) / kFBM, (unsigned)zs);
  if (grid.y > 65535u) return kRefuseGrid;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  if (p->r_dt == kF32)
    gemm_tn_f32_kernel<<<grid, kFThreads, kFSmem, s>>>(g);
  else if (p->r_dt == kBF16)
    gemm_tn_bf16_kernel<<<grid, kHThreads, kUSmem, s>>>(g);
  else
    return kRefuseDtype;
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of the float32 (r_dt 0) or bfloat16 (1)
// NN kernel takes, its cp.async ring (ptxas -v reports static memory only);
// the TN kernels take the float32 ring and kUSmem.
extern "C" long long wf_gemm_nn_smem(int r_dt) {
  return r_dt == wf::kF32 ? (long long)wf::kFSmem : (long long)wf::kHSmem;
}
