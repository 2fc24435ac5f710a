// The backward of one LSTM layer's recurrence: kernel row 19. Its forward,
// row 18, runs on the cluster forward recurrence of lstm_scan_fwd.cuh
// (through the entry `wf_lstm_stack_forward_recurrence` of lstm_stack_fwd.cu:
// xp with the bias, h_all and c_all in float32, the gates to an array of
// their own).
//
// Replaces the Pallas kernel `_bwd_kernel` of weatherforecast_stgcn_maml_tpu/
// ops/lstm_scan.py (launched by `_bwd_pallas`): the reverse-time recurrence
// from the gradient of h_all, the stored gates and c_all to dgates [T, B, 4H]
// float32; the device code is lstm_scan_bwd.cuh's, shared with rows 5, 15
// and 17 (fused_lstm_split.cu). The wrapper (ops/lstm_scan.py) forms dWh =
// round(h_{t-1})^T @ round(dgates) over every step and row with gemm.cu's
// split-K product; dxp is dgates itself.
//
// Design: the TPU backward recomputes the gates from xp and h_{t-1} (its HBM
// stream was the scarce resource): one [B, H] @ [H, 4H] product more per
// step on the serial chain. Here the forward stores the activated gates
// when a backward will follow (25 MB a layer at B = 512, T = 24, H = 128)
// and the backward reads them, so each backward step is one contraction,
// with Wh^T resident in the shared memory of a thread-block cluster
// (lstm_scan_bwd.cuh). The function's outputs are JAX's.
//
// Bound at the inner step's shape (T = 24, B = 512, H = 128): 1.61 GFLOP in
// the recurrence (dWh adds 1.61), 0.048 ms at the card's float32 rate; the
// gates / dgates streams (25 MB each) take 0.015 ms of device memory time.
// So the kernel is bound by the serial T-step chain, not by memory.
#include "lstm_scan_bwd.cuh"

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
