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
//   row 19 `_bwd_kernel` (launched by `_bwd_pallas`): the reverse-time
//     recurrence from the gradient of h_all, the stored gates and c_all to
//     dgates [T, B, 4H] float32; the device code is lstm_scan_bwd.cuh's,
//     shared with row 15 (fused_lstm_split.cu). The wrapper (ops/lstm_scan.py)
//     forms dWh = round(h_{t-1})^T @ round(dgates) over every step and row
//     with gemm.cu's split-K product; dxp is dgates itself.
//
// Design: the TPU backward recomputes the gates from xp and h_{t-1} (its HBM
// stream was the scarce resource): one [B, H] @ [H, 4H] product more per
// step on the serial chain. Here the forward stores the activated gates
// when a backward will follow (25 MB a layer at B = 512, T = 24, H = 128)
// and the backward reads them, so each backward step is one contraction.
// The function's outputs are JAX's: h_all (and, inside the op, c_all) from
// the forward, dgates from the backward. The forward's block owns a tile
// of rows for all T steps with Wh streamed from L2 in cp.async tiles
// (common.cuh); the backward keeps Wh^T resident in the shared memory of a
// thread-block cluster (lstm_scan_bwd.cuh, the recurrence rows 5 and 15
// share).
//
// Bound at the inner step's shape (T = 24, B = 512, H = 128): 1.61 GFLOP a
// direction in the recurrence (the backward adds 1.61 for dWh), 0.024 and
// 0.048 ms at the card's float32 rate; the xp / dgates streams (25 MB each)
// take 0.008 ms of device memory time. So the kernels are bound by the
// serial T-step chain, not by memory.
#include "lstm_recurrence.cuh"
#include "lstm_scan_bwd.cuh"

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
// forward's gates and c_all (float32), and Wh^T's column slices wts [cs,
// 4H, hcp] in the compute dtype w_dt, by the cluster plan (cs, hcp, rb) of
// lstm_scan_bwd.cuh (ops/fused_lstm_stack.py `recurrence_plan`). Returns a
// cudaError_t code.
extern "C" int wf_lstm_scan_bwd(int w_dt, int cs, int hcp, int rb, const float* g,
                                const float* gates, const float* c_all, const void* wts,
                                float* dgates, int T, int R, int H, void* stream) {
  const wf::ScanBwd a{g, gates, c_all, wts, dgates, nullptr, nullptr, T, R, H, cs, 1};
  return wf::launch_scan_bwd_dt<false>(w_dt, hcp, rb, a, static_cast<cudaStream_t>(stream));
}
