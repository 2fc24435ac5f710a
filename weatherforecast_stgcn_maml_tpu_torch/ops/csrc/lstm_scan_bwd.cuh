// One LSTM layer's backward recurrence: the device code that kernel rows 19
// (lstm_scan.cu) and 15 (fused_lstm_split.cu) share.
//
// From the gradient g [T, R, H] of the layer's h sequence, its activated
// gates [T, R, 4H] (float32) and its cell states c_all [T, R, H], it walks
// t = T-1 .. 0 with dh / dc carries (zero at t = T-1):
//     dh = g[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//     dgates = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i (1-g^2),
//               dh * tanh(c_t) * o(1-o)]                  (c_{-1} = 0)
//     dh_carry = round(dgates) @ round(Wh)^T;  dc_carry = dc * f
// and writes dgates [T, R, 4H] float32: one [rows, 4H] x [4H, H] contraction a
// step, the only truly serial work of an LSTM layer's backward. The arithmetic
// is JAX's: `lstm_scan._bwd_kernel` for row 19, `fused_lstm_stack._bwd_kernel`
// for row 15, whose gate recomputation and input gradient run off this chain
// on gemm_nn.cu.
//
// Design: each block owns a tile of rows (independent sequences) for all T
// steps; thread (group, j) owns hidden unit j of RPT rows, so the dh and dc
// carries stay in its registers; only round(dgates) [rows, 4H] goes through
// shared memory for the contraction, which streams Wh^T [4H, H] from L2 in
// cp.async tiles (contract() of common.cuh). c_all is read in its stored
// dtype TC: float32 for row 19 (its forward's own), the compute dtype for
// row 15 (JAX's residual contract).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace wf {
// Internal linkage: each source that includes this has its own copy.
namespace {

struct ScanBwd {
  const float* g;      // [T, R, H] gradient of the h sequence
  const float* gates;  // [T, R, 4H] activated gates
  const void* c_all;   // [T, R, H] in TC
  const void* wht;     // [4H, H] in the compute dtype
  float* dgates;       // [T, R, 4H]
  int T, R, H;
};

constexpr int kScanBwdThreads = 256;  // 256 / H row groups of H threads

template <typename TW, typename TC, int RPT>
__global__ void __launch_bounds__(kScanBwdThreads) lstm_scan_bwd_kernel(ScanBwd a) {
  extern __shared__ float4 smem4[];
  const int H = a.H;
  const int g4 = 4 * H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, H]
  float* dg = reinterpret_cast<float*>(wbuf + 2 * kContractTile * H);  // [rows_blk, 4H]
  const TW* wht = static_cast<const TW*>(a.wht);
  const TC* c_all = static_cast<const TC*>(a.c_all);
  const int j = threadIdx.x % H;
  const int r0 = (threadIdx.x / H) * RPT;
  const int row0 = blockIdx.x * rows_blk;
  const long long step = (long long)a.R * H;  // one [R, H] slice

  float dh_c[RPT], dc_c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh_c[r] = dc_c[r] = 0.f;

  for (int t = a.T - 1; t >= 0; --t) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r0 + r;
      float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c_t = 0.f, c_prev = 0.f, g_t = 0.f;
      if (row < a.R) {
        const float* gt = a.gates + ((long long)t * a.R + row) * g4 + j;
        ig = gt[0];
        fg = gt[H];
        gg = gt[2 * H];
        og = gt[3 * H];
        const long long o = t * step + (long long)row * H + j;
        c_t = to_float(c_all[o]);
        if (t > 0) c_prev = to_float(c_all[o - step]);
        g_t = a.g[o];
      }
      const float tc = tanhf(c_t);
      const float dh = g_t + dh_c[r];
      const float dc = dc_c[r] + dh * og * (1.f - tc * tc);
      const float d_o = dh * tc * og * (1.f - og);
      const float d_i = dc * gg * ig * (1.f - ig);
      const float d_f = dc * c_prev * fg * (1.f - fg);
      const float d_g = dc * ig * (1.f - gg * gg);
      dc_c[r] = dc * fg;
      if (row < a.R) {
        float* out = a.dgates + ((long long)t * a.R + row) * g4 + j;
        out[0] = d_i;
        out[H] = d_f;
        out[2 * H] = d_g;
        out[3 * H] = d_o;
      }
      // The previous step's contraction closed with a barrier: dg is free.
      float* dgr = dg + (r0 + r) * g4 + j;
      dgr[0] = round_to<TW>(d_i);
      dgr[H] = round_to<TW>(d_f);
      dgr[2 * H] = round_to<TW>(d_g);
      dgr[3 * H] = round_to<TW>(d_o);
    }
    if (t == 0) break;  // no carry into t = -1
    // dh_carry = round(dgates) @ Wh^T: [rows, 4H] x [4H, H]; column j is
    // this thread's own unit, so the carry stays in its registers.
    float acc[RPT][1];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r][0] = 0.f;
    contract<TW, RPT, 1>(wht, g4, H, dg, g4, wbuf, r0, j, H, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) dh_c[r] = acc[r][0];
  }
}

// Dynamic shared memory a block takes: Wh^T's double-buffered tiles and
// round(dgates) of its rows.
inline size_t scan_bwd_smem(int H, int rpt, size_t tw) {
  const int rows_blk = (kScanBwdThreads / H) * rpt;
  return 2 * (size_t)kContractTile * H * tw + (size_t)rows_blk * 4 * H * sizeof(float);
}

template <typename TW, typename TC, int RPT>
int launch_scan_bwd(const ScanBwd& a, cudaStream_t stream) {
  const int groups = kScanBwdThreads / a.H;
  const int rows_blk = groups * RPT;
  const size_t smem = scan_bwd_smem(a.H, RPT, sizeof(TW));
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB opt-in per block
  cudaError_t err = cudaFuncSetAttribute(lstm_scan_bwd_kernel<TW, TC, RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + rows_blk - 1) / rows_blk;
  lstm_scan_bwd_kernel<TW, TC, RPT><<<blocks, groups * a.H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch one backward recurrence on `stream`: w_dt (0 = float32, 1 =
// bfloat16) is the compute dtype, Wh^T's; c_all is float32 or, with
// C_IN_COMPUTE, in the compute dtype. rows_per_thread is 2, 4 or 8; H a
// multiple of 4, at most 256. Returns a cudaError_t code.
template <bool C_IN_COMPUTE>
int launch_scan_bwd_dt(int w_dt, int rpt, const ScanBwd& a, cudaStream_t s) {
  if (a.T <= 0 || a.R <= 0 || a.H <= 0 || a.H > kScanBwdThreads || a.H % 4)
    return (int)cudaErrorInvalidValue;
  using CB = typename std::conditional<C_IN_COMPUTE, __nv_bfloat16, float>::type;
  if (w_dt == kF32) {
    switch (rpt) {
      case 2:
        return launch_scan_bwd<float, float, 2>(a, s);
      case 4:
        return launch_scan_bwd<float, float, 4>(a, s);
      case 8:
        return launch_scan_bwd<float, float, 8>(a, s);
    }
  } else if (w_dt == kBF16) {
    switch (rpt) {
      case 2:
        return launch_scan_bwd<__nv_bfloat16, CB, 2>(a, s);
      case 4:
        return launch_scan_bwd<__nv_bfloat16, CB, 4>(a, s);
      case 8:
        return launch_scan_bwd<__nv_bfloat16, CB, 8>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf
