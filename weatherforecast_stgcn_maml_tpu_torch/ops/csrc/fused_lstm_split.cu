// The serial recurrence of the LSTM stacks' training backwards, one launch
// a layer: the entry of lstm_scan_bwd.cuh that kernel rows 5, 15 and 17
// share.
//
// Row 15 replaces the Pallas kernel `_bwd_kernel` (+ `_bwd_kernel_nomask`)
// of weatherforecast_stgcn_maml_tpu/ops/fused_lstm_stack.py, launched by
// `_bwd_pallas` under `_MERGED_GATES = False` or `merged=False`. The TPU
// kernel walks t = T-1 .. 0 and l = L-1 .. 0 as one serial chain,
// recomputing each stage's gates from the residuals and contracting
// round(dgates) with Wx_l^T and Wh_l^T: four contractions a stage. Only the
// dh carry through Wh_l^T is recurrent, so the port walks layer by layer
// (ops/fused_lstm_stack.py `backward_schedule`): the gates of all T x R rows
// of a layer in one gemm_nn.cu launch, then the recurrence below (one
// contraction a step: lstm_scan_bwd.cuh, reading c_all in the compute
// dtype), then the input gradient in one more gemm_nn.cu launch. Row 5
// walks the same schedule from row 4's stored gates, and row 17 (row 5 for
// V tasks, from row 16's) one launch a layer for all tasks. Row 14, the
// unmerged-gates forward, runs on row 4's layer-by-layer forward
// (lstm_stack_fwd.cu).
#include <cstdint>

#include "common.cuh"
#include "lstm_scan_bwd.cuh"

// The arguments of one backward recurrence, every field 8 bytes wide, so
// the Python side packs them with one struct format (ops/fused_lstm_stack.py
// `_SCAN_LAUNCH`): one ctypes argument in place of twenty-six.
struct ScanLaunch {
  long long w_dt, cs, hcp, rb, tasks;
  long long g, sg, gates, sgates, c_all, sc, wts, sw, dgates, sdg;
  long long dh_all, dc_all, sdh, db, sdb, ldb;
  long long T, R, H, stream;
  long long k_res;  // resident rows of a slice (lstm_scan_bwd.cuh); 4H or -1: all
};
static_assert(sizeof(ScanLaunch) == 26 * 8, "ScanLaunch is 26 packed 8-byte fields");

// The backward recurrence of one layer of either LSTM stack, for `tasks`
// tasks at once: the serial part of the merged stack's training backward
// (kernel row 5; row 17 with a task each for V tasks) and of the
// unmerged-gates one (row 15). dgates [T, R, 4H] float32 from the gradient
// g [T, R, H] float32 of the layer's h sequence, its activated gates [T, R,
// 4H] float32 (row 4's or 16's stored ones for rows 5 and 17, recomputed
// for row 15), its c_all [T, R, H] in the compute dtype w_dt (0 = float32,
// 1 = bfloat16) and Wh^T's column slices wts [cs, 4H, hcp] in w_dt, by the
// cluster plan (cs, hcp, rb, k_res) of lstm_scan_bwd.cuh (ops/fused_lstm_stack.py
// `recurrence_plan`; a streamed plan takes the bias partials, one task);
// also each step's dh and dc [T, R, H] float32 into
// dh_all and dc_all unless they are null (both or neither), and the bias
// gradient's partials, a row tile each, into db unless it is null. Task z's
// arrays start z times their stride (s*, in elements) after task 0's; row
// tile y's partial starts at db + z * sdb + y * ldb. Returns a cudaError_t
// code.
extern "C" int wf_lstm_stack_recurrence(const ScanLaunch* p) {
  if (p->T > 0x7fffffff || p->R > 0x7fffffff || p->H > 0x7fffffff || p->tasks > 0x7fffffff ||
      p->k_res > 4 * p->H)
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long v) { return reinterpret_cast<const void*>(v); };
  wf::ScanBwd a{static_cast<const float*>(ptr(p->g)),
                static_cast<const float*>(ptr(p->gates)),
                ptr(p->c_all),
                ptr(p->wts),
                reinterpret_cast<float*>(p->dgates),
                reinterpret_cast<float*>(p->dh_all),
                reinterpret_cast<float*>(p->dc_all),
                (int)p->T, (int)p->R, (int)p->H, (int)p->cs, (int)p->tasks};
  a.sg = p->sg;
  a.sgates = p->sgates;
  a.sc = p->sc;
  a.sw = p->sw;
  a.sdg = p->sdg;
  a.sdh = p->sdh;
  a.db = reinterpret_cast<float*>(p->db);
  a.sdb = p->sdb;
  a.ldb = p->ldb;
  a.k_res = (int)p->k_res;
  return wf::launch_scan_bwd_dt<true>((int)p->w_dt, (int)p->hcp, (int)p->rb, a,
                                      reinterpret_cast<cudaStream_t>(p->stream));
}

// The most clusters of that recurrence's plan (cs, hcp, rb) at hidden width
// H that the card runs at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t code.
extern "C" int wf_lstm_stack_recurrence_clusters(int w_dt, int cs, int hcp, int rb, int H) {
  const wf::ScanBwd a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, 1,       1,       H,       cs,      1};
  int n = 0;
  const int err = wf::launch_scan_bwd_dt<true>(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}

// The dynamic shared memory a block of that recurrence takes.
extern "C" long long wf_lstm_stack_recurrence_smem(int w_dt, int hcp, int rb, int H) {
  return (long long)wf::scan_bwd_smem(H, hcp, rb, w_dt == wf::kF32 ? 4 : 2);
}

// The same two questions of a streamed plan, k_res resident rows of a slice
// (the bias partials' instance, as rows 5 and 15 launch it).
extern "C" int wf_lstm_stack_recurrence_stream_clusters(int w_dt, int cs, int hcp, int rb, int H,
                                                        int k_res) {
  wf::ScanBwd a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, 1,       1,       H,       cs,      1};
  a.db = reinterpret_cast<float*>(16);  // asked, not launched
  a.k_res = k_res;
  int n = 0;
  const int err = wf::launch_scan_bwd_dt<true>(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}

extern "C" long long wf_lstm_stack_recurrence_stream_smem(int w_dt, int hcp, int rb, int H,
                                                          int k_res) {
  return (long long)wf::scan_bwd_stream_smem(H, hcp, rb, w_dt == wf::kF32 ? 4 : 2, k_res);
}
