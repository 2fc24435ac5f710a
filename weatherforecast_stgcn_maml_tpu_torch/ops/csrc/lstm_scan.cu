// One LSTM layer's recurrence with a hand-written backward: kernel rows 18
// and 19.
//
// Replaces the Pallas kernels of weatherforecast_stgcn_maml_tpu/ops/
// lstm_scan.py:
//   row 18 `_fwd_kernel` (launched by `_fwd_pallas`): xp [T, B, 4H] float32
//     (the hoisted input projection + bias) and Wh [H, 4H] -> h_all, c_all
//     [T, B, H] float32; the device code is lstm_recurrence.cuh's, shared
//     with row 20. Here it can also store the activated gates [T, B, 4H]
//     (float32) for the backward;
//   row 19 `_bwd_kernel` (launched by `_bwd_pallas`): walking t = T-1 .. 0
//     with dh / dc carries (zero at t = T-1),
//       dh = g[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//       dgates = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i (1-g^2),
//                 dh * tanh(c_t) * o(1-o)]
//       dh_carry = round(dgates) @ round(Wh)^T;  dc_carry = dc * f
//     and writes dgates [T, B, 4H] float32. The wrapper (ops/lstm_scan.py)
//     forms dWh = round(h_{t-1})^T @ round(dgates) over every step and row
//     with gemm.cu's split-K product; dxp is dgates itself.
//
// Design: the TPU backward recomputes the gates from xp and h_{t-1} (its HBM
// stream was the scarce resource): one [B, H] @ [H, 4H] product more per
// step on the serial chain. Here the forward stores the activated gates
// when a backward will follow (25 MB a layer at B = 512, T = 24, H = 128)
// and the backward reads them, so each backward step is one contraction,
// as in row 5 (where storing them halved the serial work). The function's
// outputs are JAX's: h_all (and, inside the op, c_all) from the forward,
// dgates from the backward. Each block owns a tile of rows for all T steps; the
// dh and dc carries of thread (g, j)'s unit j stay in its registers, only
// round(dgates) [rows, 4H] goes through shared memory for the contraction,
// which streams Wh^T [4H, H] from L2 in cp.async tiles (common.cuh).
//
// Bound at the inner step's shape (T = 24, B = 512, H = 128): 1.61 GFLOP a
// direction in the recurrence (the backward adds 1.61 for dWh), 0.024 and
// 0.048 ms at the card's float32 rate; the xp / dgates streams (25 MB each)
// take 0.008 ms of device memory time. So the kernels are bound by the
// serial T-step chain and the per-step Wh stream from L2, not by memory.
#include "lstm_recurrence.cuh"

namespace wf {
namespace {

struct ScanBwd {
  const float* g;      // [T, R, H] gradient of h_all
  const float* gates;  // [T, R, 4H] activated gates from the forward
  const float* c_all;  // [T, R, H]
  const void* wht;     // [4H, H] in the compute dtype
  float* dgates;       // [T, R, 4H]
  int T, R, H;
};

template <typename TW, int RPT>
__global__ void __launch_bounds__(kRecurrenceThreads) lstm_scan_bwd_kernel(ScanBwd a) {
  extern __shared__ float4 smem4[];
  const int H = a.H;
  const int g4 = 4 * H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, H]
  float* dg = reinterpret_cast<float*>(wbuf + 2 * kContractTile * H);  // [rows_blk, 4H]
  const TW* wht = static_cast<const TW*>(a.wht);
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
        c_t = a.c_all[o];
        if (t > 0) c_prev = a.c_all[o - step];
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

template <typename TW, int RPT>
int launch_bwd(const ScanBwd& a, cudaStream_t stream) {
  const int groups = kRecurrenceThreads / a.H;
  const int rows_blk = groups * RPT;
  const size_t smem = 2 * (size_t)kContractTile * a.H * sizeof(TW) +
                      (size_t)rows_blk * 4 * a.H * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB opt-in per block
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_bwd_kernel<TW, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + rows_blk - 1) / rows_blk;
  lstm_scan_bwd_kernel<TW, RPT><<<blocks, groups * a.H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_bwd_rpt(int rpt, const ScanBwd& a, cudaStream_t s) {
  switch (rpt) {
    case 2:
      return launch_bwd<TW, 2>(a, s);
    case 4:
      return launch_bwd<TW, 4>(a, s);
    case 8:
      return launch_bwd<TW, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// Row 18: the recurrence of one layer over xp [T, R, 4H] float32
// (contiguous, time-major) with Wh [H, 4H] in the compute dtype w_dt (0 =
// float32, 1 = bfloat16), writing h_all and c_all [T, R, H] float32 and,
// unless it is null, gates [T, R, 4H] float32. rows_per_thread (2, 4 or 8)
// sets the row tile: a block holds 256 / H * rows_per_thread rows. H is a
// multiple of 4, at most 256. Returns a cudaError_t code (0 on success).
extern "C" int wf_lstm_scan_fwd(int w_dt, int rows_per_thread, const float* xp,
                                const void* wh, float* h_all, float* c_all,
                                float* gates, int T, int R, int H, void* stream) {
  if (!h_all || !c_all) return (int)cudaErrorInvalidValue;
  const long long g4 = 4LL * H;
  const wf::RecurrenceIO a{xp, (long long)R * g4, g4, wh, h_all, c_all,
                           (long long)R * H, H, gates, nullptr, T, R, H};
  return wf::launch_recurrence_dt(w_dt, rows_per_thread, a, static_cast<cudaStream_t>(stream));
}

// Row 19: dgates [T, R, 4H] float32 from the gradient g of h_all, the
// forward's gates and c_all, and Wh^T [4H, H] in the compute dtype. Layouts,
// H and rows_per_thread as in wf_lstm_scan_fwd.
extern "C" int wf_lstm_scan_bwd(int w_dt, int rows_per_thread, const float* g,
                                const float* gates, const float* c_all,
                                const void* wht, float* dgates, int T, int R, int H,
                                void* stream) {
  if (T <= 0 || R <= 0 || H <= 0 || H > wf::kRecurrenceThreads || H % 4)
    return (int)cudaErrorInvalidValue;
  const wf::ScanBwd a{g, gates, c_all, wht, dgates, T, R, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == wf::kF32) return wf::launch_bwd_rpt<float>(rows_per_thread, a, s);
  if (w_dt == wf::kBF16) return wf::launch_bwd_rpt<__nv_bfloat16>(rows_per_thread, a, s);
  return (int)cudaErrorInvalidValue;
}
