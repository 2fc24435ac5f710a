// Node-sharded GCN "sandwich" layer, forward and backward (kernel rows 12
// and 13): the backward's epilogue. The layer's products all run through
// the GEMM of gemm.cu; ops/fused_gcn_shard.py sequences them.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
// weatherforecast_stgcn_maml_tpu/ops/fused_gcn_shard.py. Activations are
// node-major here ([rows, W, C]: node r's W time slices side by side), so
// the node all-gather (along dim 0) hands the layer hw_full [N, W, hid] and
// the reduce-scatter takes d_hw_full [N, W, hid] with no permute copy, and
// every product below is one GEMM over uniform strides:
//   forward   h_post = relu(A_rows @ hw_full[:, w] + b) * mask / keep
//                      (one launch batched over the W slices, the GEMM's
//                      bias / relu / mask epilogue), stored in the compute
//                      dtype as the residual;
//             hw_next = round(h_post) @ round(W_next)   (one launch)
//   backward  t = round(g2) @ round(W_next)^T           (GEMM, transposed B)
//             dz = (g1 + t) * [h_post > 0] * mask / keep  (this file)
//             db = colsum(dz)                  (gemm.cu reductions)
//             dW_next = round(h_post)^T @ round(g2)      (split-K GEMM)
//             d_hw_full = round(A_rows)^T @ round(dz)    (GEMM, transposed A:
//                         this rank's partial over all N rows)
// g1 (the cotangent of h_post) is absent when only hw_next feeds the next
// layer, t when there is no next layer. relu' comes from the post-dropout
// residual as in row 7: where the mask is live h_post > 0 iff the
// pre-activation is, and where it is 0 the mask factor zeroes the term.
//
// Bound, one layer with a next layer at NL = N = 512, W = 24, hid = 256:
// 4.83 GFLOP forward, 6.44 backward, 0.072 and 0.096 ms at the card's
// float32 rate; this elementwise pass moves a few MB and is bound by device
// memory.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

template <typename TG, typename TH>
__global__ void shard_dz_kernel(const TG* __restrict__ g1,
                                const float* __restrict__ t,
                                const TH* __restrict__ h_post,
                                const int8_t* __restrict__ mask,
                                float inv_keep, float* __restrict__ dz,
                                long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = (g1 ? to_float(g1[i]) : 0.f) + (t ? t[i] : 0.f);
  v = v * (to_float(h_post[i]) > 0.f ? 1.f : 0.f);
  if (mask) v = v * ((float)mask[i] * inv_keep);
  dz[i] = v;
}

template <typename TG, typename TH>
int launch(const void* g1, const float* t, const void* h_post,
           const int8_t* mask, float inv_keep, float* dz, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  shard_dz_kernel<TG, TH><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const TG*>(g1), t, static_cast<const TH*>(h_post), mask,
      inv_keep, dz, n);
  return (int)cudaGetLastError();
}

template <typename TG>
int launch_h(int h_dt, const void* g1, const float* t, const void* h_post,
             const int8_t* mask, float inv_keep, float* dz, long long n,
             cudaStream_t s) {
  if (h_dt == kF32) return launch<TG, float>(g1, t, h_post, mask, inv_keep, dz, n, s);
  if (h_dt == kBF16)
    return launch<TG, __nv_bfloat16>(g1, t, h_post, mask, inv_keep, dz, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// dz = (g1 + t) * [h_post > 0] * (mask * inv_keep if mask else 1) over n
// elements, float32 out; g1 (dtype code g1_dt) or t (float32) may be null,
// not both. h_dt is h_post's dtype code (0 = float32, 1 = bfloat16).
// Returns a cudaError_t code (0 on success).
extern "C" int wf_gcn_shard_dz(int g1_dt, int h_dt, const void* g1,
                               const float* t, const void* h_post,
                               const int8_t* mask, float inv_keep, float* dz,
                               long long n, void* stream) {
  if (n <= 0 || (!g1 && !t)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g1_dt == wf::kF32)
    return wf::launch_h<float>(h_dt, g1, t, h_post, mask, inv_keep, dz, n, s);
  if (g1_dt == wf::kBF16)
    return wf::launch_h<__nv_bfloat16>(h_dt, g1, t, h_post, mask, inv_keep, dz, n, s);
  return (int)cudaErrorInvalidValue;
}
