// The LSTM stacks' training forwards (kernel rows 4, 14 and 16) and the
// eval forward (rows 2, 14 and 20: the top layer's last h, no dropout),
// layer by layer: the C entry that enqueues the whole schedule from one host
// call, and the forward recurrence alone (also the whole of row 18, one
// layer's recurrence: ops/lstm_scan.py).
//
// Replaces the Pallas kernels of weatherforecast_stgcn_maml_tpu/ops/
// fused_lstm_stack.py `_fwd_kernel_m` (+ `_fwd_kernel_m_nomask`, row 4),
// launched by `_fwd_pallas_m` with residuals, `_fwd_kernel` (+
// `_fwd_kernel_nomask`, row 14, `_MERGED_GATES = False`), launched by
// `_fwd_pallas`, and `_fwd_kernel_mv` (+ `_nomask`, row 16: row 4 for V
// tasks, each with its own weights, under `_VBATCH`), launched by
// `_fwd_pallas_mv`. The TPU kernels walk all T x L stages as one chain, with
// one [in | h] @ [[Wx], [Wh]] contraction a stage (rows 4 and 16) or in @ Wx
// + h @ Wh from separate weight arrays (row 14). Only the h carry is
// recurrent, so here, for l = 0 .. L-1 (ops/fused_lstm_stack.py
// `forward_schedule` and `tasks_forward_schedule` state the same schedule
// on swappable pieces):
//   1. xp_l = round(in_l) @ round(Wx_l) for all T x R rows: one gemm_nn.cu
//      launch, written straight into the layer's gates [T, R, 4H] float32;
//      no bias (the recurrence adds it). One task: batched over the T steps,
//      so x's [B, T, C] layout needs no copy. V tasks: batched over the
//      tasks, M = T x R rows a task (x time-major), B's batch stride stepping
//      through each task's weights;
//   2. the forward recurrence (lstm_scan_fwd.cuh) over those gates in place
//      (V tasks: one launch, the tasks on the grid's z axis): the activated
//      gates, round(h) and round(c) into the layer's h_all and c_all, the next
//      layer's input round(h * mask_l * inv_keep) into `masked` where masks are
//      given (else the next layer reads h_all), and the top layer's last h in
//      float32.
// in_0 is x; in_l above it is layer l-1's h_all or, with masks, `masked`
// ([T, R, H], one buffer for every layer: layer l+1's product has read it
// before layer l+1's recurrence writes it again, in stream order). Each
// layer's gates, h_all and c_all start a layer stride after the layer
// below's; a stride of 0 makes every layer reuse one buffer, on the same
// ordering: row 14 keeps no gates (its backward recomputes them), and the
// eval forward keeps no residuals (only the top layer's last h leaves: no c,
// and no h sequence at the top layer). The eval forward is row 14's without
// residuals, and rows 2 and 20 run it too, from the layers' own Wx, Wh and
// b: the TPU's merged [[Wx], [Wh]] layout of row 2
// (`_fwd_kernel_m_lastonly_nomask`, one [in | h] contraction a stage)
// changes the gates only in the order of a float32 addition, and row 20's
// body (weatherforecast_stgcn_maml_tpu/ops/fused_lstm.py `_kernel`) adds in
// this recurrence's order, (round(in) Wx + b) + round(h) Wh.
// Rows 4 and 16's weights are the row blocks of wcat_l = [[Wx_l], [Wh_l]];
// row 14's are its own arrays: the entry takes a (Wx_l, Wh_l, k_l, task
// stride) quadruple a layer. Row 16's masks [V, L-1, T, R, H] and its
// `masked` buffer (one [T, R, H] a task) keep row 4's order: layer l+1's
// product reads a task's buffer before layer l+1's recurrence writes it.
//
// Bound at the training shapes (T = 24, R = 512, C = 256, H = 128, L = 4):
// the input products are 8.05 GFLOP (0.12 ms at the card's float32 rate),
// the recurrences 6.44 GFLOP over 4 x 24 serial steps; the whole forward
// moves ~130 MB (x, the gates out and back, h and c): 0.22 ms by operations.
// Row 16 at V = 2 does twice that work, on the same 4 x 24 serial steps.
#include <cstdint>

#include "common.cuh"
#include "gemm_nn_launch.cuh"
#include "lstm_scan_fwd.cuh"

// The arguments of one forward, 32 packed 8-byte fields (ops/fused_lstm_stack.py
// `_STACK_FWD`), followed by L quadruples (wx_l, wh_l, k_l, sw_l): layer l's
// weights Wx_l [k_l, 4H] and Wh_l [H, 4H] in the compute dtype (row-major,
// row stride 4H, 16-byte aligned; under a streamed plan, k_res in [0, H),
// Wh_l laid out as the recurrence's slices [cs, H, 4, hcp]), its input width
// k_l (C, then H) and its weights' task stride sw_l (elements).
struct StackFwdLaunch {
  long long w_dt, cs, hcp, rb;
  long long x, sxt, sxr, x_f32;  // x[t, r, c] at x + t*sxt + r*sxr + c (elements)
  long long bias, masks;         // [L, 4H] float32; [L-1, T, R, H] int8 or 0
  double inv_keep;
  long long h_all, c_all, gates, h_last, masked;
  long long res_ls, gates_ls;    // layer strides (elements) of h_all / c_all and of gates
  long long T, R, H, L, stream;
  // Tasks, and the task strides (elements) of x, bias, masks, h_all / c_all,
  // gates, h_last and masked: task v's arrays start v strides after task 0's.
  long long tasks, sxv, sbv, smv, sresv, sgv, slv, snv;
  long long k_res;  // the recurrences' resident rows of a slice (lstm_scan_fwd.cuh)
};
static_assert(sizeof(StackFwdLaunch) == 32 * 8, "StackFwdLaunch is 32 packed 8-byte fields");

// Rows 4, 14 and 16 and the eval forward: for each layer one NN product
// (gemm_nn.cu) and one forward recurrence of the plan (cs, hcp, rb, k_res)
// (lstm_scan_fwd.cuh), on `stream`, in that order. w_dt is the compute dtype (0 = float32, 1 =
// bfloat16); x is float32 (x_f32) or in the compute dtype; layer l's h_all
// and c_all [T, R, H] at l * res_ls and masked [T, R, H] (with masks) in the
// compute dtype, its gates [T, R, 4H] at l * gates_ls and h_last [R, H]
// float32 (res_ls is 0 or at least T * R * H, gates_ls 0 or at least T * R *
// 4H; without masks and with res_ls 0, layer l+1 reads and overwrites layer
// l's h_all, and the top layer stores no h_all; c_all 0 stores no c). With
// tasks > 1 every array of task v starts v times its task stride after task
// 0's, and x is time-major within a task (sxt = R * sxr):
// each product is one launch for all tasks, M = T * R. Returns 0, a
// cudaError_t code, or the product's negative refusal code (ops/gemm.py
// `_NN_REFUSALS`); the first failure stops the schedule.
extern "C" int wf_lstm_stack_forward(const StackFwdLaunch* p) {
  const long long* layer = reinterpret_cast<const long long*>(p + 1);
  const long long T = p->T, R = p->R, H = p->H, L = p->L, V = p->tasks, g4 = 4 * H;
  const long long res = T * R * H;  // one layer's [T, R, H]
  if (T <= 0 || R <= 0 || H <= 0 || L <= 0 || V <= 0 || T > 0x7fffffff || R > 0x7fffffff ||
      H > 0x7fffffff || T > 65535 || V > 65535 || T * R > 0x7fffffff || p->k_res > H ||
      (p->w_dt != wf::kF32 && p->w_dt != wf::kBF16) || (V > 1 && p->sxt != R * p->sxr) ||
      (p->res_ls != 0 && p->res_ls < res) || (p->gates_ls != 0 && p->gates_ls < 4 * res))
    return (int)cudaErrorInvalidValue;
  const long long tw = p->w_dt == wf::kBF16 ? 2 : 4;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  long long in = p->x;
  for (long long l = 0; l < L; ++l) {
    const long long wx = layer[4 * l], wh = layer[4 * l + 1], k = layer[4 * l + 2];
    const long long sw = layer[4 * l + 3];
    float* gates = reinterpret_cast<float*>(p->gates) + l * p->gates_ls;
    const bool top = l + 1 == L;
    const int8_t* mask = top || !p->masks ? nullptr
                                          : reinterpret_cast<const int8_t*>(p->masks) + l * res;
    NNLaunch g{};
    g.r_dt = p->w_dt;
    g.a1 = in;
    g.lda1 = l == 0 ? p->sxr : k;
    g.a1_f32 = l == 0 ? p->x_f32 : p->w_dt == wf::kF32;
    g.b1 = wx;
    g.ldb1 = g4;
    g.k1 = k;
    g.c = reinterpret_cast<long long>(gates);
    g.ldc = g4;
    g.scale = 1.0;
    g.N = g4;
    g.stream = p->stream;
    if (V == 1) {  // batched over the steps
      g.sa1 = l == 0 ? p->sxt : R * k;
      g.sc = R * g4;
      g.M = R;
      g.batch = T;
    } else {  // batched over the tasks: layer l's input is x, h_all[l-1] or masked
      g.sa1 = l == 0 ? p->sxv : (in == p->masked ? p->snv : p->sresv);
      g.sb1 = sw;
      g.sc = p->sgv;
      g.M = T * R;
      g.batch = V;
    }
    int err = wf_gemm_nn(&g);
    if (err) return err;
    const long long h_l = p->h_all + l * p->res_ls * tw;
    // Without residuals only the top layer's last h leaves: its h sequence
    // is not stored, nor (c_all null) any layer's c.
    wf::ScanFwd a{gates,
                  gates,
                  reinterpret_cast<const void*>(wh),
                  g4,
                  reinterpret_cast<const float*>(p->bias) + l * g4,
                  top && p->res_ls == 0 ? nullptr : reinterpret_cast<void*>(h_l),
                  p->c_all ? reinterpret_cast<void*>(p->c_all + l * p->res_ls * tw) : nullptr,
                  0,
                  mask,
                  (float)p->inv_keep,
                  mask ? reinterpret_cast<void*>(p->masked) : nullptr,
                  top ? reinterpret_cast<float*>(p->h_last) : nullptr,
                  (int)T,
                  (int)R,
                  (int)H,
                  (int)p->cs};
    a.k_res = (int)p->k_res;
    if (V > 1) {
      a.tasks = (int)V;
      a.sxp = a.sgates = p->sgv;
      a.sw = sw;
      a.sbias = p->sbv;
      a.sres = p->sresv;
      a.smask = p->smv;
      a.snext = p->snv;
      a.slast = p->slv;
    }
    err = wf::launch_scan_fwd((int)p->w_dt, (int)p->hcp, (int)p->rb, a, s);
    if (err) return err;
    in = mask ? p->masked : h_l;
  }
  return 0;
}

// The arguments of one forward recurrence, 30 packed 8-byte fields
// (ops/fused_lstm_stack.py `_SCAN_FWD`): wf::ScanFwd's with the plan.
struct ScanFwdLaunch {
  long long w_dt, cs, hcp, rb;
  long long xp, gates, wh, ldw, bias, h_all, c_all, out_f32, mask;
  double inv_keep;
  long long next_in, h_last, T, R, H, stream;
  long long tasks, sxp, sgates, sw, sbias, sres, smask, snext, slast;
  long long k_res;  // resident rows of a slice; in [0, H): wh is the slices [cs, H, 4, hcp]
};
static_assert(sizeof(ScanFwdLaunch) == 30 * 8, "ScanFwdLaunch is 30 packed 8-byte fields");

// One layer's forward recurrence alone (wf::ScanFwd for the arguments), on
// the plan (cs, hcp, rb, k_res): rows 4, 14 and 16's recurrence a launch at a time
// (gates = xp: in place; row 16's tasks on the grid's z axis), and row 18
// (xp with the bias, no bias array; the gates to an array of their own or
// nowhere; h and c in float32). Returns a cudaError_t code.
extern "C" int wf_lstm_stack_forward_recurrence(const ScanFwdLaunch* p) {
  if (p->T > 0x7fffffff || p->R > 0x7fffffff || p->H > 0x7fffffff || p->tasks > 0x7fffffff ||
      p->k_res > p->H)
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  wf::ScanFwd a{static_cast<const float*>(ptr(p->xp)),
                static_cast<float*>(ptr(p->gates)),
                ptr(p->wh),
                p->ldw,
                static_cast<const float*>(ptr(p->bias)),
                ptr(p->h_all),
                ptr(p->c_all),
                (int)p->out_f32,
                static_cast<const int8_t*>(ptr(p->mask)),
                (float)p->inv_keep,
                ptr(p->next_in),
                static_cast<float*>(ptr(p->h_last)),
                (int)p->T,
                (int)p->R,
                (int)p->H,
                (int)p->cs};
  a.tasks = (int)p->tasks;
  a.sxp = p->sxp;
  a.sgates = p->sgates;
  a.sw = p->sw;
  a.sbias = p->sbias;
  a.sres = p->sres;
  a.smask = p->smask;
  a.snext = p->snext;
  a.slast = p->slast;
  a.k_res = (int)p->k_res;
  return wf::launch_scan_fwd((int)p->w_dt, (int)p->hcp, (int)p->rb, a,
                             reinterpret_cast<cudaStream_t>(p->stream));
}

// The most clusters of the forward recurrence's plan (cs, hcp, rb) at hidden
// width H that the card runs at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t code.
extern "C" int wf_lstm_stack_forward_clusters(int w_dt, int cs, int hcp, int rb, int H) {
  wf::ScanFwd a{};
  a.T = a.R = 1;
  a.H = H;
  a.cs = cs;
  int n = 0;
  const int err = wf::launch_scan_fwd(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}

// The dynamic shared memory a block of that recurrence takes.
extern "C" long long wf_lstm_stack_forward_smem(int w_dt, int hcp, int rb, int H) {
  return (long long)wf::scan_fwd_smem(H, hcp, rb, w_dt == wf::kF32 ? 4 : 2);
}

// The same two questions of a streamed plan, k_res resident rows of a slice.
extern "C" int wf_lstm_stack_forward_stream_clusters(int w_dt, int cs, int hcp, int rb, int H,
                                                     int k_res) {
  wf::ScanFwd a{};
  a.T = a.R = 1;
  a.H = H;
  a.cs = cs;
  a.k_res = k_res;
  int n = 0;
  const int err = wf::launch_scan_fwd(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}

extern "C" long long wf_lstm_stack_forward_stream_smem(int w_dt, int hcp, int rb, int H,
                                                       int k_res) {
  return (long long)wf::scan_fwd_stream_smem(H, hcp, rb, w_dt == wf::kF32 ? 4 : 2, k_res);
}
