// Tiled SIMT GEMM, the port's first, plus the fixed-order reduction that
// finishes a split-K product.
//
// The GEMM now serves one caller: the input projections of row 20
// (weatherforecast_stgcn_maml_tpu/ops/fused_lstm.py `_kernel`; csrc/fused_lstm.cu
// calls `wf_gemm` a layer, xp = in @ Wx + b, M = B*T, K = C_l, N = 4H). The
// GCN stacks' products (rows 1, 3, 6, 7, 12, 13) and every weight gradient
// (rows 5, 7, 11, 13, 15, 17, 19) run on csrc/gemm_nn.cu's core; its split-K
// TN partials, and the LSTM recurrences' bias partials, are added here by
// `wf_sum_splits`.
//
// Operands are rounded to the compute dtype as they are loaded and
// multiplied in float32, so float32 compute is true float32 (no TF32).
//
// A TPU kernel carries weight-gradient sums across its sequential grid; CUDA
// blocks run in no order. A long reduction (K = slices * N = 12,288 at the
// reference width) therefore splits K into chunks, each block writing its
// own float32 partial, and `wf_sum_splits` adds the partials in split order:
// the result does not depend on the order blocks ran in.
//
// Bound: float32 FMA throughput and shared-memory loads (a plain SIMT GEMM, 128 x
// 128 output tiles, 8-deep K slabs, 8 x 8 outputs per thread), not device
// memory. Tensor cores (wgmma for bfloat16) and TMA are later work.
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

// C[z] = epilogue(op(A) @ op(B)) for z in [0, batch * splits). Block z works
// on batch b = z / splits over K chunk s = z % splits (k in [s*kc,
// min(K, (s+1)*kc))) and writes C + z*sc. op(A)[m, k] is A[m*lda + k], or
// A[k*lda + m] with trans_a; op(B)[k, n] is B[k*ldb + n], or B[n*ldb + k]
// with trans_b. An optional int8 amask (same layout as A; TN layout only)
// multiplies each A element by amask * ascale before rounding; the epilogue
// adds bias[n], takes relu, and multiplies by cmask * cscale (same layout as
// C), each when given. The layout and the A mask are compile-time (NN, TN,
// TN with mask, NT are built): as runtime flags their extra registers cost
// the serving stack's GEMMs an occupancy step (2.3 -> 2.9 ms measured).
struct Gemm {
  const void* A;
  long long sa;
  int lda, trans_a;
  const int8_t* amask;
  float ascale;
  const void* B;
  long long sb;
  int ldb, trans_b;
  void* C;
  long long sc;
  int ldc;
  const float* bias;
  int relu;
  const int8_t* cmask;
  float cscale;
  int M, N, K, batch, splits, kc;
};

template <typename TA, typename TB, typename TC, typename TR, bool TRANS_A,
          bool TRANS_B, bool AMASK>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm g) {
  // +4 padding keeps the transposed A-tile stores free of bank conflicts.
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];

  const int z = blockIdx.z;
  const long long b = z / g.splits;
  const int k_begin = (z % g.splits) * g.kc;
  const int k_end = min(g.K, k_begin + g.kc);
  const TA* A = static_cast<const TA*>(g.A) + b * g.sa;
  const int8_t* am = AMASK ? g.amask + b * g.sa : nullptr;
  const TB* B = static_cast<const TB*>(g.B) + b * g.sb;
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

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // Neighbouring threads take neighbouring addresses in either layout.
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int r = TRANS_A ? e % kBM : e / kBK;
      const int kk = TRANS_A ? e / kBM : e % kBK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gm < g.M && gk < k_end) {
        const long long at = TRANS_A ? (long long)gk * g.lda + gm
                                     : (long long)gm * g.lda + gk;
        v = to_float(A[at]);
        if (AMASK) v = v * ((float)am[at] * g.ascale);
      }
      As[kk][r] = round_to<TR>(v);
    }
#pragma unroll
    for (int q = 0; q < (kBK * kBN) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = TRANS_B ? e % kBK : e / kBN;
      const int c = TRANS_B ? e / kBK : e % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + c;
      float v = 0.f;
      if (gk < k_end && gn < g.N)
        v = to_float(B[TRANS_B ? (long long)gn * g.ldb + gk
                               : (long long)gk * g.ldb + gn]);
      Bs[kk][c] = round_to<TR>(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
      float bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  TC* C = static_cast<TC*>(g.C) + z * g.sc;
  const int8_t* cm = g.cmask ? g.cmask + z * g.sc : nullptr;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= g.N) continue;
      const long long at = (long long)gm * g.ldc + gn;
      float v = acc[i][j];
      if (g.bias) v = v + g.bias[gn];
      if (g.relu) v = fmaxf(v, 0.f);
      if (cm) v = v * ((float)cm[at] * g.cscale);
      C[at] = from_float<TC>(v);
    }
  }
}

template <typename TA, typename TB, typename TC, typename TR>
int launch(const Gemm& g, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM,
                  g.batch * g.splits);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  if (g.amask && !(g.trans_a && !g.trans_b)) return (int)cudaErrorInvalidValue;
  if (!g.trans_a && !g.trans_b)
    gemm_kernel<TA, TB, TC, TR, false, false, false><<<grid, kThreads, 0, stream>>>(g);
  else if (g.trans_a && !g.trans_b && g.amask)
    gemm_kernel<TA, TB, TC, TR, true, false, true><<<grid, kThreads, 0, stream>>>(g);
  else if (g.trans_a && !g.trans_b)
    gemm_kernel<TA, TB, TC, TR, true, false, false><<<grid, kThreads, 0, stream>>>(g);
  else if (!g.trans_a && g.trans_b)
    gemm_kernel<TA, TB, TC, TR, false, true, false><<<grid, kThreads, 0, stream>>>(g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename TA, typename TB, typename TC>
int launch_r(int r_dt, const Gemm& g, cudaStream_t s) {
  if (r_dt == kF32) return launch<TA, TB, TC, float>(g, s);
  if (r_dt == kBF16) return launch<TA, TB, TC, __nv_bfloat16>(g, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TA, typename TB>
int launch_c(int c_dt, int r_dt, const Gemm& g, cudaStream_t s) {
  if (c_dt == kF32) return launch_r<TA, TB, float>(r_dt, g, s);
  if (c_dt == kBF16) return launch_r<TA, TB, __nv_bfloat16>(r_dt, g, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TA>
int launch_b(int b_dt, int c_dt, int r_dt, const Gemm& g, cudaStream_t s) {
  if (b_dt == kF32) return launch_c<TA, float>(c_dt, r_dt, g, s);
  if (b_dt == kBF16) return launch_c<TA, __nv_bfloat16>(c_dt, r_dt, g, s);
  return (int)cudaErrorInvalidValue;
}

// out[m*ldo + n] = sum over s in order of part[s*stride + m*N + n].
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  long long stride, float* __restrict__ out,
                                  int M, int N, int ldo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * stride + i];
  out[(i / N) * ldo + i % N] = v;
}

}  // namespace
}  // namespace wf

// One GEMM (see wf::Gemm). dtype codes: 0 = float32, 1 = bfloat16; a/b/c_dt
// are the storage dtypes of A, B and C, r_dt the compute dtype operands are
// rounded to. Returns a cudaError_t code (0 on success); an unsupported
// argument returns cudaErrorInvalidValue without launching.
extern "C" int wf_gemm(int a_dt, int b_dt, int c_dt, int r_dt, const void* A,
                       long long sa, int lda, int trans_a,
                       const int8_t* amask, float ascale, const void* B,
                       long long sb, int ldb, int trans_b, void* C,
                       long long sc, int ldc, const float* bias, int relu,
                       const int8_t* cmask, float cscale, int M, int N, int K,
                       int batch, int splits, int kc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || batch <= 0 || splits <= 0 || kc <= 0 ||
      (long long)splits * kc < K)
    return (int)cudaErrorInvalidValue;
  const wf::Gemm g{A, sa, lda, trans_a, amask, ascale, B, sb, ldb, trans_b,
                   C, sc, ldc, bias, relu, cmask, cscale, M, N, K, batch,
                   splits, kc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dt == wf::kF32) return wf::launch_b<float>(b_dt, c_dt, r_dt, g, s);
  if (a_dt == wf::kBF16)
    return wf::launch_b<__nv_bfloat16>(b_dt, c_dt, r_dt, g, s);
  return (int)cudaErrorInvalidValue;
}

// out[m, n] (row stride ldo) = sum over the `splits` float32 partials
// part[s] ([M, N], `stride` floats apart), added in split order.
extern "C" int wf_sum_splits(const float* part, int splits, long long stride,
                             float* out, int M, int N, int ldo, void* stream) {
  if (M <= 0 || N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)M * N;
  wf::sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      part, splits, stride, out, M, N, ldo);
  return (int)cudaGetLastError();
}
