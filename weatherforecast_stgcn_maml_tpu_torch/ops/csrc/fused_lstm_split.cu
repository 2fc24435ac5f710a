// Fused LSTM stack with unmerged gates: the training forward (and the eval
// forward), all layers and all time steps in one launch, and the serial
// recurrence of the training backward, one launch a layer.
//
// Replaces two Pallas kernels of weatherforecast_stgcn_maml_tpu/ops/
// fused_lstm_stack.py, selected there by `_MERGED_GATES = False` or
// `merged=False`:
//   forward (kernel row 14): `_fwd_kernel` (+ `_fwd_kernel_nomask`),
//     launched by `_fwd_pallas`. Per step t and layer l it computes
//         gates = in_t @ Wx_l + h_{t-1} @ Wh_l + b_l        (gate order i,f,g,o)
//         c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//     as two contractions into one float32 accumulator, from the separate
//     Wx and Wh arrays (no [[Wx], [Wh]] concatenation), and stores only the
//     residuals JAX stores: h and c [L, T, R, H] in the compute dtype (no
//     gates; the eval call stores neither). Layer l's input is layer l-1's h
//     of the same step times its int8 dropout mask and 1/keep, rounded to
//     the compute dtype; the top layer's last h is returned in float32.
//   backward (kernel row 15): `_bwd_kernel` (+ `_bwd_kernel_nomask`),
//     launched by `_bwd_pallas`. The TPU kernel walks t = T-1 .. 0 and l =
//     L-1 .. 0 as one serial chain, recomputing each stage's gates from the
//     residuals and contracting round(dgates) with Wx_l^T and Wh_l^T: four
//     contractions a stage. Only the dh carry through Wh_l^T is recurrent, so
//     the port walks layer by layer (ops/fused_lstm_stack.py
//     `backward_schedule`): the gates of all T x R rows of a layer in one
//     gemm_nn.cu launch, then the recurrence below (one contraction a step:
//     lstm_scan_bwd.cuh, reading c_all in the compute dtype), then the input
//     gradient in one more gemm_nn.cu launch.
// The recurrence entry below also serves the merged stack's backward (row
// 5), which walks the same schedule from row 4's stored gates, and row 17
// (row 5 for V tasks, from row 16's), one launch a layer for all tasks.
//
// Translation of the forward: as in row 4, each block owns a tile of rows
// (independent sequences) and walks time and layers itself; thread (g, j)
// owns hidden unit j of RPT rows, so the cell update needs no exchange
// between threads. Each contraction streams its weight matrix from L2
// through a double-buffered cp.async tile ring (`contract()` in
// common.cuh); unlike row 4's merged kernel the ring is not carried across
// contractions, a simpler schedule that pays one tile's latency per
// contraction.
//
// Bound: the forward is row 4's work (about 14.5 GFLOP at the training
// shapes: 24 steps, 512 rows, 4 layers of width 128, input 256; 0.22 ms at
// the card's float32 rate), bound by the serial T * L chain of weight
// streams from L2, not by device memory.
#include <cstdint>

#include "common.cuh"
#include "lstm_scan_bwd.cuh"

namespace wf {
namespace {

constexpr int kTargetThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB opt-in per block

struct SplitArgs {
  const float* x;  // x[t, r, c] at x[t * st + r * sr + c], float32
  long long st, sr;
  const void* wx0;      // [C, 4H]      compute dtype
  const void* wxr;      // [L-1, H, 4H] compute dtype (unused when L = 1)
  const void* wh;       // [L, H, 4H]   compute dtype
  const float* bias;    // [L, 4H]
  const int8_t* masks;  // [L-1, T, R, H] or null
  float inv_keep;
  void* h_all;  // [L, T, R, H] compute dtype, written unless null
  void* c_all;
  float* out;  // [R, H], the top layer's last h
  int T, R, C, H, L;
};

template <typename TW, int RPT>
__global__ void lstm_split_fwd_kernel(SplitArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, C = a.C, L = a.L, T = a.T, R = a.R;
  const int g4 = 4 * H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, 4H]
  float* xin = reinterpret_cast<float*>(wbuf + 2 * kContractTile * g4);  // [rows_blk, C]
  float* hin = xin + (size_t)rows_blk * C;         // [L, rows_blk, H] layer l's input (l >= 1)
  float* hrec = hin + (size_t)L * rows_blk * H;    // [L, rows_blk, H] round(h_{t-1})
  float* cs = hrec + (size_t)L * rows_blk * H;     // [L, rows_blk, H] c carry
  const TW* wx0 = static_cast<const TW*>(a.wx0);
  const TW* wxr = static_cast<const TW*>(a.wxr);
  const TW* wh = static_cast<const TW*>(a.wh);
  TW* h_all = static_cast<TW*>(a.h_all);
  TW* c_all = static_cast<TW*>(a.c_all);
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;  // first local row of this thread
  const int row0 = blockIdx.x * rows_blk;
  const size_t step_elems = (size_t)R * H;  // one [R, H] slice of h_all

  // hin, hrec and cs are contiguous; the first contraction's barrier
  // publishes the zeros.
  for (int i = tid; i < 3 * L * rows_blk * H; i += blockDim.x) hin[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    // x_t into layer 0's operand rows, rounded to the compute dtype. The
    // last reader (the previous step's layer-0 contraction) ended with a
    // barrier.
    for (int i = tid; i < rows_blk * C; i += blockDim.x) {
      const int r = i / C;
      const int c = i % C;
      const int row = row0 + r;
      xin[i] = row < R ? round_to<TW>(a.x[t * a.st + row * a.sr + c]) : 0.f;
    }
    for (int l = 0; l < L; ++l) {
      const int kin = l == 0 ? C : H;
      const TW* wx = l == 0 ? wx0 : wxr + (size_t)(l - 1) * H * g4;
      const float* in_l = l == 0 ? xin : hin + (size_t)l * rows_blk * H;
      float* hr = hrec + (size_t)l * rows_blk * H;
      float* cl = cs + (size_t)l * rows_blk * H;
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      contract<TW, RPT, 4>(wx, kin, g4, in_l, kin, wbuf, r0, j, H, acc);  // in_t @ Wx_l
      if (t > 0)  // h_{-1} = 0: its product is zero
        contract<TW, RPT, 4>(wh + (size_t)l * H * g4, H, g4, hr, H, wbuf, r0, j, H, acc);

      // Both contractions ended with a barrier: hr and hin[l + 1] are free.
      const float* bl = a.bias + (size_t)l * g4;
      const size_t slice = ((size_t)l * T + t) * step_elems;  // h_all[l, t]
      float* in_next = hin + (size_t)(l + 1) * rows_blk * H;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const size_t at = (size_t)(r0 + r) * H + j;
        const float ig = sigmoidf(acc[r][0] + bl[j]);
        const float fg = sigmoidf(acc[r][1] + bl[H + j]);
        const float gg = tanhf(acc[r][2] + bl[2 * H + j]);
        const float og = sigmoidf(acc[r][3] + bl[3 * H + j]);
        const float c = fg * cl[at] + ig * gg;
        const float h = og * tanhf(c);
        cl[at] = c;
        hr[at] = round_to<TW>(h);
        const int row = row0 + r0 + r;
        const size_t o = slice + (size_t)row * H + j;
        if (h_all && row < R) {
          h_all[o] = from_float<TW>(h);
          c_all[o] = from_float<TW>(c);
        }
        if (l + 1 < L) {
          // Inter-layer dropout: masks[l, t] has h_all[l, t]'s layout.
          float nx = h;
          if (a.masks) {
            const float m = row < R ? (float)a.masks[o] : 0.f;
            nx = h * (m * a.inv_keep);
          }
          in_next[at] = round_to<TW>(nx);
        }
        if (l == L - 1 && t == T - 1 && row < R) a.out[(size_t)row * H + j] = h;
      }
    }
  }
}

size_t fwd_smem(const SplitArgs& a, int rows_blk, size_t tw) {
  return 2 * (size_t)kContractTile * 4 * a.H * tw +
         ((size_t)rows_blk * a.C + 3 * (size_t)a.L * rows_blk * a.H) * sizeof(float);
}

template <typename KernelT>
int launch_kernel(KernelT kernel, const SplitArgs& a, int rpt, size_t smem,
                  cudaStream_t stream) {
  const int groups = a.H >= kTargetThreads ? 1 : kTargetThreads / a.H;
  const int threads = groups * a.H;
  const int rows_blk = groups * rpt;
  if (threads > 1024 || smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.R + rows_blk - 1) / rows_blk, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int rows_blk_of(const SplitArgs& a, int rpt) {
  return (a.H >= kTargetThreads ? 1 : kTargetThreads / a.H) * rpt;
}

template <typename TW, int RPT>
int launch_fwd(const SplitArgs& a, cudaStream_t s) {
  return launch_kernel(lstm_split_fwd_kernel<TW, RPT>, a, RPT,
                       fwd_smem(a, rows_blk_of(a, RPT), sizeof(TW)), s);
}

template <typename TW>
int launch_rpt(int rpt, const SplitArgs& a, cudaStream_t s) {
  switch (rpt) {
    case 2:
      return launch_fwd<TW, 2>(a, s);
    case 4:
      return launch_fwd<TW, 4>(a, s);
    case 8:
      return launch_fwd<TW, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// Forward of the unmerged-gates stack (kernel row 14; see wf::SplitArgs for
// the layouts). w_dt is the dtype code of the weights, the residuals and
// the compute dtype (0 = float32, 1 = bfloat16); rows_per_thread (2, 4 or 8)
// sets the row tile, a block holding 256 / H * rows_per_thread rows. h_all
// and c_all are both written, or both null (the eval forward). C and H are
// multiples of 8. Returns a cudaError_t code (0 on success).
extern "C" int wf_lstm_split_fwd(int w_dt, int rows_per_thread, const float* x,
                                 long long st, long long sr, const void* wx0,
                                 const void* wxr, const void* wh, const float* bias,
                                 const int8_t* masks, float inv_keep, void* h_all,
                                 void* c_all, float* out, int T, int R, int C, int H,
                                 int L, void* stream) {
  if (!h_all != !c_all || T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0 || C % 8 || H % 8)
    return (int)cudaErrorInvalidValue;
  wf::SplitArgs a{};
  a.x = x;
  a.st = st;
  a.sr = sr;
  a.wx0 = wx0;
  a.wxr = wxr;
  a.wh = wh;
  a.bias = bias;
  a.masks = masks;
  a.inv_keep = inv_keep;
  a.h_all = h_all;
  a.c_all = c_all;
  a.out = out;
  a.T = T;
  a.R = R;
  a.C = C;
  a.H = H;
  a.L = L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == wf::kF32) return wf::launch_rpt<float>(rows_per_thread, a, s);
  if (w_dt == wf::kBF16) return wf::launch_rpt<__nv_bfloat16>(rows_per_thread, a, s);
  return (int)cudaErrorInvalidValue;
}

// The arguments of one backward recurrence, every field 8 bytes wide, so
// the Python side packs them with one struct format (ops/fused_lstm_stack.py
// `_SCAN_LAUNCH`): one ctypes argument in place of twenty-five.
struct ScanLaunch {
  long long w_dt, cs, hcp, rb, tasks;
  long long g, sg, gates, sgates, c_all, sc, wts, sw, dgates, sdg;
  long long dh_all, dc_all, sdh, db, sdb, ldb;
  long long T, R, H, stream;
};
static_assert(sizeof(ScanLaunch) == 25 * 8, "ScanLaunch is 25 packed 8-byte fields");

// The backward recurrence of one layer of either LSTM stack, for `tasks`
// tasks at once: the serial part of the merged stack's training backward
// (kernel row 5; row 17 with a task each for V tasks) and of the
// unmerged-gates one (row 15). dgates [T, R, 4H] float32 from the gradient
// g [T, R, H] float32 of the layer's h sequence, its activated gates [T, R,
// 4H] float32 (row 4's or 16's stored ones for rows 5 and 17, recomputed
// for row 15), its c_all [T, R, H] in the compute dtype w_dt (0 = float32,
// 1 = bfloat16) and Wh^T's column slices wts [cs, 4H, hcp] in w_dt, by the
// cluster plan (cs, hcp, rb) of lstm_scan_bwd.cuh (ops/fused_lstm_stack.py
// `recurrence_plan`); also each step's dh and dc [T, R, H] float32 into
// dh_all and dc_all unless they are null (both or neither), and the bias
// gradient's partials, a row tile each, into db unless it is null. Task z's
// arrays start z times their stride (s*, in elements) after task 0's; row
// tile y's partial starts at db + z * sdb + y * ldb. Returns a cudaError_t
// code.
extern "C" int wf_lstm_stack_recurrence(const ScanLaunch* p) {
  if (p->T > 0x7fffffff || p->R > 0x7fffffff || p->H > 0x7fffffff || p->tasks > 0x7fffffff)
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
