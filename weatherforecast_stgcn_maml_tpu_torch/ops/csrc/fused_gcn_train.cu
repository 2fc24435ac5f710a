// Fused GCN encoder stack, training forward and backward (kernel rows 6 and
// 7): the relu / dropout gradient of the backward. The stack's products all
// run through the GEMM of gemm.cu; ops/fused_gcn_train.py sequences them.
//
// Replaces the Pallas kernels `_fwd_kernel` (+ `_fwd_kernel_nomask`) and
// `_bwd_kernel` (+ `_bwd_kernel_nomask`) of
// weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py. Per layer l:
//   forward   hw = round(h) @ round(W_l), stored in the compute dtype;
//             h' = relu(A_hat @ hw + b_l) * mask_l / keep (the GEMM's
//             epilogue), stored in the compute dtype as the residual h_all[l];
//   backward  dz = dh * [h_all[l] > 0] * mask_l / keep   (this file)
//             db_l = colsum(dz)                           (gemm.cu reductions)
//             dhw = round(A_hat^T @ round(dz))            (GEMM, transposed A)
//             dW_l = round(h_in)^T @ dhw over all slices and nodes
//                                                         (GEMM, split K)
//             d_in = dhw @ round(W_l)^T, float32          (GEMM, transposed B)
// relu' comes from the post-dropout residual, compared in float32: where the
// mask is live h' > 0 iff the pre-activation is, and where it is 0 the mask
// factor zeroes the term anyway.
//
// Bound: about 17.9 GFLOP forward and 22.8 GFLOP backward at the training
// shapes (24 slices of 512 nodes, 4 layers of width 256), 0.27 and 0.34 ms
// at the card's float32 rate; this elementwise pass moves 24 x 512 x 256
// elements per layer (a few MB) and is bound by device memory.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

template <typename TD, typename TH>
__global__ void relu_mask_grad_kernel(const TD* __restrict__ dh,
                                      const TH* __restrict__ h_post,
                                      const int8_t* __restrict__ mask,
                                      float inv_keep, float* __restrict__ dz,
                                      long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = to_float(dh[i]) * (to_float(h_post[i]) > 0.f ? 1.f : 0.f);
  if (mask) v = v * ((float)mask[i] * inv_keep);
  dz[i] = v;
}

template <typename TD, typename TH>
int launch(const void* dh, const void* h_post, const int8_t* mask,
           float inv_keep, float* dz, long long n, cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  relu_mask_grad_kernel<TD, TH><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const TD*>(dh), static_cast<const TH*>(h_post), mask,
      inv_keep, dz, n);
  return (int)cudaGetLastError();
}

template <typename TD>
int launch_h(int h_dt, const void* dh, const void* h_post, const int8_t* mask,
             float inv_keep, float* dz, long long n, cudaStream_t s) {
  if (h_dt == kF32) return launch<TD, float>(dh, h_post, mask, inv_keep, dz, n, s);
  if (h_dt == kBF16)
    return launch<TD, __nv_bfloat16>(dh, h_post, mask, inv_keep, dz, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// dz = dh * [h_post > 0] * (mask * inv_keep if mask else 1) over n elements,
// float32 out. dh_dt / h_dt are the dtype codes of dh and h_post (0 =
// float32, 1 = bfloat16). Returns a cudaError_t code (0 on success).
extern "C" int wf_gcn_relu_mask_grad(int dh_dt, int h_dt, const void* dh,
                                     const void* h_post, const int8_t* mask,
                                     float inv_keep, float* dz, long long n,
                                     void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh_dt == wf::kF32)
    return wf::launch_h<float>(h_dt, dh, h_post, mask, inv_keep, dz, n, s);
  if (dh_dt == wf::kBF16)
    return wf::launch_h<__nv_bfloat16>(h_dt, dh, h_post, mask, inv_keep, dz, n, s);
  return (int)cudaErrorInvalidValue;
}
