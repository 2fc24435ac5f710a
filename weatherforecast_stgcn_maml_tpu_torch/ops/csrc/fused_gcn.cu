// Fused GCN encoder stack, forward only (serving).
//
// Replaces the Pallas kernel `_stack_kernel` of
// weatherforecast_stgcn_maml_tpu/ops/fused_gcn.py, which runs all L layers of
//     h = relu(A_hat @ (h @ W_l) + b_l)
// per time slice with the activation held in TPU VMEM. On Hopper one block
// has at most 227 KB of shared memory, far less than a [512, 256] activation
// chain plus A_hat, so the stack is two batched GEMM launches per layer
// instead (the Python wrapper loops over the layers):
//     hw  = h @ W_l                  M = slices*N, K = C_in, N = C_out
//     h'  = relu(A_hat @ hw + b_l)   per slice: M = N, K = N, N = C_out
// hw is stored rounded to the compute dtype, h' in the compute dtype (or
// float32 after the last layer), exactly the values the TPU kernel feeds its
// next product. Operands are rounded to the compute dtype on load and
// multiplied in float32, so float32 compute is true float32 (no TF32).
//
// Bound: at the reference width (N = 512, C = 256, 24 slices per window) the
// A_hat product dominates (2*N*N*C per slice), about 0.7 GFLOP per slice over
// the four layers, with A_hat (1 MB) and W (256 KB) re-read from L2 by every
// block. This first version is a plain shared-memory-tiled SIMT GEMM:
// 128x128 output tiles, 8-deep K slabs, 8x8 outputs per thread, float32 FMA.
// It is bound by shared-memory loads and FMA issue, not by device memory.
// Tensor cores (wgmma for bfloat16) and TMA are later work.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTM = 8;
constexpr int kTN = 8;

// C[b] = epilogue(A[b] @ B[b]) for b in [0, batch); row-major operands with
// leading dimensions lda/ldb/ldc and batch strides sa/sb/sc (sa = 0 shares A).
// TR is the compute dtype operands are rounded to; with BIAS_RELU the
// epilogue is relu(acc + bias[col]).
template <typename TA, typename TB, typename TC, typename TR, bool BIAS_RELU>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const TA* __restrict__ A, long long sa, int lda,
                const TB* __restrict__ B, long long sb, int ldb,
                TC* __restrict__ C, long long sc, int ldc,
                const float* __restrict__ bias, int M, int N, int K) {
  // +4 padding keeps the transposed A-tile stores free of bank conflicts.
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];

  const long long batch = blockIdx.z;
  A += batch * sa;
  B += batch * sb;
  C += batch * sc;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = e / kBK;
      const int kk = e % kBK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      const float v =
          (gm < M && gk < K) ? to_float(A[(long long)gm * lda + gk]) : 0.f;
      As[kk][r] = round_to<TR>(v);
    }
#pragma unroll
    for (int q = 0; q < (kBK * kBN) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = e / kBN;
      const int c = e % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + c;
      const float v =
          (gk < K && gn < N) ? to_float(B[(long long)gk * ldb + gn]) : 0.f;
      Bs[kk][c] = round_to<TR>(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (BIAS_RELU) v = fmaxf(v + bias[gn], 0.f);
      C[(long long)gm * ldc + gn] = from_float<TC>(v);
    }
  }
}

template <typename TA, typename TB, typename TC, typename TR, bool BIAS_RELU>
int launch(const void* A, long long sa, int lda, const void* B, long long sb,
           int ldb, void* C, long long sc, int ldc, const float* bias, int M,
           int N, int K, int batch, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  gemm_kernel<TA, TB, TC, TR, BIAS_RELU><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(A), sa, lda, static_cast<const TB*>(B), sb, ldb,
      static_cast<TC*>(C), sc, ldc, bias, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wf

// One GEMM of the GCN stack. dtype codes: 0 = float32, 1 = bfloat16.
// a/b/c_dt are the storage dtypes of A, B and C; r_dt is the compute dtype.
// Returns a cudaError_t code (0 on success); an unsupported combination
// returns cudaErrorInvalidValue without launching.
extern "C" int wf_gcn_gemm(int a_dt, int b_dt, int c_dt, int r_dt,
                           int bias_relu, const void* A, long long sa, int lda,
                           const void* B, long long sb, int ldb, void* C,
                           long long sc, int ldc, const float* bias, int M,
                           int N, int K, int batch, void* stream) {
  using wf::kBF16;
  using wf::kF32;
  using bf16 = __nv_bfloat16;
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || (bias_relu && !bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WF_GEMM(TA, TB, TC, TR, EPI)                                       \
  return wf::launch<TA, TB, TC, TR, EPI>(A, sa, lda, B, sb, ldb, C, sc, ldc, \
                                         bias, M, N, K, batch, s)
  if (!bias_relu) {
    // hw = h @ W: B is the float32 weight, C the compute dtype.
    if (b_dt != kF32 || c_dt != r_dt) return (int)cudaErrorInvalidValue;
    if (r_dt == kF32 && a_dt == kF32) WF_GEMM(float, float, float, float, false);
    if (r_dt == kBF16 && a_dt == kF32) WF_GEMM(float, float, bf16, bf16, false);
    if (r_dt == kBF16 && a_dt == kBF16) WF_GEMM(bf16, float, bf16, bf16, false);
  } else {
    // h' = relu(A_hat @ hw + b): A is the float32 adjacency, B = hw.
    if (a_dt != kF32 || b_dt != r_dt) return (int)cudaErrorInvalidValue;
    if (r_dt == kF32 && c_dt == kF32) WF_GEMM(float, float, float, float, true);
    if (r_dt == kBF16 && c_dt == kBF16) WF_GEMM(float, bf16, bf16, bf16, true);
    if (r_dt == kBF16 && c_dt == kF32) WF_GEMM(float, bf16, float, bf16, true);
  }
#undef WF_GEMM
  return (int)cudaErrorInvalidValue;
}
