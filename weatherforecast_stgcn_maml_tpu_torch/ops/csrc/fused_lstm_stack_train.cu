// Fused LSTM stack, training backward of V tasks in one launch: the
// reverse-time recurrence of all layers of every task (kernel row 17).
//
// Replaces the Pallas kernel `_bwd_kernel_mv` (+ `_bwd_kernel_mv_nomask`,
// launched by `_bwd_pallas_mv`) of weatherforecast_stgcn_maml_tpu/ops/
// fused_lstm_stack.py: the merged stack's backward (row 5) for V tasks,
// each with its own weights. As in the forward (csrc/fused_lstm_stack.cu),
// the tasks are the grid's second axis. Walking t = T-1 .. 0 and, per step,
// l = L-1 .. 0, it
//   * reads the activated gates (i, f, g, o) the forward stored, and c_t,
//     c_{t-1} from the forward's residuals (zero at t = 0);
//   * carries dh, dc per layer: dh = dh_carry (+ g at the top layer's last
//     step) (+ the gradient from layer l+1 at the same step), dc = dc_carry
//     + dh * o * (1 - tanh(c)^2), and forms dgates = [di, df, dg, do];
//   * contracts round(dgates) @ wcat_l^T: its first K_in columns are the
//     input gradient (dx for layer 0; for layer l-1 at the same step after
//     the mask / keep), its last H columns the recurrent carry to t-1.
// The single-task backward (row 5) walks layer by layer instead
// (ops/fused_lstm_stack.py `backward_schedule` on lstm_scan_bwd.cuh and
// gemm_nn.cu); this kernel goes onto that schedule next.
//
// Translation: the TPU kernel recomputes the gates from the residuals (its
// HBM stream was the scarce resource) and accumulates dwcat and db in its
// output blocks across the sequential grid. Here the forward stores the
// gates, which halves the serial work per (step, layer): one contraction
// instead of two. CUDA blocks run in parallel and in no order, so, as in
// the forward, each block owns a tile of rows and walks time and layers
// itself, with its dh / dc carries in shared memory; per-block partial
// weight gradients would take about 300 MB a task at 4 rows per block at
// the reference width, so this kernel writes dgates [V, L, T, R, 4H] in
// float32 (100 MB a task) instead, and the wrapper forms each task's dwcat_l
// = [inp | h_prev]^T @ dgates_l over K = T * R and db_l = colsum(dgates_l)
// with the split-K GEMM and the fixed-order reductions of gemm.cu. Under
// float32 the result differs from the TPU kernel's only in the order of
// the float32 sums.
//
// Bound: about 29 GFLOP a task at the training shapes (the dgates @ wcat^T
// contraction here and the weight gradients, each as much as the forward),
// 0.43 ms at the card's float32 rate, plus the gates and dgates streams
// (100 MB each, 0.06 ms). Like the forward, each block streams wcat_l^T
// (laid out once per call by the wrapper) from L2 in cp.async
// double-buffered tiles, so the kernel is bound by that stream's latency and
// by the serial T * L chain, not by device memory.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kTargetThreads = 256;
constexpr int kTileK = kContractTile;     // weight rows per pipelined tile
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB opt-in per block

struct BwdArgs {
  const float* g;       // [R, H] gradient of the top layer's last h
  const float* gates;   // [L, T, R, 4H] activated gates of the forward
  const void* c_all;    // [L, T, R, H] residual c, compute dtype
  const int8_t* masks;  // [L-1, T, R, H] or null
  float inv_keep;
  const void* wcatT0;  // [4H, C + H]
  const void* wcatTr;  // [L-1, 4H, 2H]
  float* dx;           // [T, R, C]
  float* dgates;       // [L, T, R, 4H]
  int T, R, C, H, L;
  int V;  // tasks: every array above has a leading task axis
};

// Thread (group, j) owns hidden unit j of RPT rows: its four gate gradients,
// and the input-gradient columns q * H + j of the contraction (NQ >=
// (C + H) / H of them).
template <typename TW, int RPT, int NQ>
__global__ void lstm_stack_bwd_kernel(BwdArgs args) {
  extern __shared__ float4 smem4[];
  const int H = args.H, C = args.C, L = args.L, T = args.T, R = args.R;
  const int g4 = 4 * H;
  // Task v = blockIdx.y: each array at v times its one-task size.
  BwdArgs a = args;
  {
    const size_t v = blockIdx.y;
    const size_t res = (size_t)L * T * R * H;  // one task's [L, T, R, H]
    a.g += v * R * H;
    a.gates += v * res * 4;
    a.c_all = static_cast<const TW*>(a.c_all) + v * res;
    if (a.masks) a.masks += v * (L - 1) * T * R * H;
    a.wcatT0 = static_cast<const TW*>(a.wcatT0) + v * g4 * (C + H);
    a.wcatTr = static_cast<const TW*>(a.wcatTr) + v * (L - 1) * g4 * 2 * H;
    a.dx += v * T * R * C;
    a.dgates += v * res * 4;
  }
  const int kmax = (C > H ? C : H) + H;  // widest wcat_l^T row
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kTileK, kmax]
  float* dg = reinterpret_cast<float*>(wbuf + 2 * kTileK * kmax);  // [rows_blk, 4H]
  float* dhc = dg + rows_blk * g4;      // [L, rows_blk, H] dh carry
  float* dcc = dhc + L * rows_blk * H;  // [L, rows_blk, H] dc carry
  float* dfa = dcc + L * rows_blk * H;  // [rows_blk, H] from the layer above
  const TW* c_all = static_cast<const TW*>(a.c_all);
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * rows_blk;
  const size_t step_elems = (size_t)R * H;  // one [R, H] slice of c_all

  for (int i = tid; i < (2 * L + 1) * rows_blk * H; i += blockDim.x) dhc[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int kin = l == 0 ? C : H;
      const int kl = kin + H;
      const TW* wt = l == 0 ? static_cast<const TW*>(a.wcatT0)
                            : static_cast<const TW*>(a.wcatTr) + (size_t)(l - 1) * g4 * 2 * H;
      const size_t slice = ((size_t)l * T + t) * step_elems;  // c_all[l, t]
      const bool top_last = l == L - 1 && t == T - 1;

      // Gate gradients (the contraction's first barrier publishes dg).
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
        float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f;
        float c_t = 0.f, c_prev = 0.f, g_top = 0.f;
        if (row < R) {
          const float* gt = a.gates + slice * 4 + (size_t)row * g4;
          ig = gt[j];
          fg = gt[H + j];
          gg = gt[2 * H + j];
          og = gt[3 * H + j];
          const size_t o = slice + (size_t)row * H + j;
          c_t = to_float(c_all[o]);
          if (t > 0) c_prev = to_float(c_all[o - step_elems]);
          if (top_last) g_top = a.g[(size_t)row * H + j];
        }
        const float tc = tanhf(c_t);
        const size_t at = ((size_t)l * rows_blk + lr) * H + j;
        float dh = dhc[at];
        if (top_last) dh = dh + g_top;
        if (l < L - 1) dh = dh + dfa[(size_t)lr * H + j];
        const float dc = dcc[at] + dh * og * (1.f - tc * tc);
        const float d_o = dh * tc * og * (1.f - og);
        const float d_i = dc * gg * ig * (1.f - ig);
        const float d_f = dc * c_prev * fg * (1.f - fg);
        const float d_g = dc * ig * (1.f - gg * gg);
        dcc[at] = dc * fg;
        if (row < R) {
          float* out = a.dgates + slice * 4 + (size_t)row * g4;
          out[j] = d_i;
          out[H + j] = d_f;
          out[2 * H + j] = d_g;
          out[3 * H + j] = d_o;
        }
        float* dgr = dg + (size_t)lr * g4;
        dgr[j] = round_to<TW>(d_i);
        dgr[H + j] = round_to<TW>(d_f);
        dgr[2 * H + j] = round_to<TW>(d_g);
        dgr[3 * H + j] = round_to<TW>(d_o);
      }

      // dxh = round(dgates) @ wcat_l^T: [rows, 4H] x [4H, kl].
      float acc[RPT][NQ];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;
      contract<TW, RPT, NQ>(wt, g4, kl, dg, g4, wbuf, r0, j, H, acc);

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int k = q * H + j;
          if (k >= kl) continue;
          const float v = acc[r][q];
          if (k >= kin) {
            dhc[((size_t)l * rows_blk + lr) * H + (k - kin)] = v;  // to t-1
          } else if (l == 0) {
            if (row < R) a.dx[((size_t)t * R + row) * C + k] = v;
          } else {
            float m = 1.f;
            if (a.masks)
              m = row < R ? (float)a.masks[slice - (size_t)T * step_elems +
                                           (size_t)row * H + k] * a.inv_keep
                          : 0.f;
            dfa[(size_t)lr * H + k] = a.masks ? v * m : v;  // to layer l-1
          }
        }
      }
      __syncthreads();  // carries visible; dg free for the next stage
    }
  }
}

template <typename TW, int RPT, int NQ>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const int groups = a.H >= kTargetThreads ? 1 : kTargetThreads / a.H;
  const int threads = groups * a.H;
  const int rows_blk = groups * RPT;
  const int kmax = (a.C > a.H ? a.C : a.H) + a.H;
  const size_t smem =
      2 * (size_t)kTileK * kmax * sizeof(TW) +
      ((size_t)rows_blk * 4 * a.H + (2 * (size_t)a.L + 1) * rows_blk * a.H) *
          sizeof(float);
  if (threads > 1024 || smem > kMaxSmemBytes || a.C % 8 || a.H % 8 ||
      a.C + a.H > NQ * a.H)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_stack_bwd_kernel<TW, RPT, NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.R + rows_blk - 1) / rows_blk, a.V);
  lstm_stack_bwd_kernel<TW, RPT, NQ><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW, int RPT>
int launch_nq(const BwdArgs& a, cudaStream_t s) {
  if (a.C + a.H <= 4 * a.H) return launch<TW, RPT, 4>(a, s);
  if (a.C + a.H <= 8 * a.H) return launch<TW, RPT, 8>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TW>
int launch_rpt(int rpt, const BwdArgs& a, cudaStream_t s) {
  switch (rpt) {
    case 2:
      return launch_nq<TW, 2>(a, s);
    case 4:
      return launch_nq<TW, 4>(a, s);
    case 8:
      return launch_nq<TW, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_dt(int w_dt, int rpt, const BwdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == kF32) return launch_rpt<float>(rpt, a, s);
  if (w_dt == kBF16) return launch_rpt<__nv_bfloat16>(rpt, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// Training backward recurrence of V tasks in one launch (kernel row 17),
// each array with a leading task axis: g [V, R, H] (the gradient of the top
// layer's last h), gates [V, L, T, R, 4H] (the forward's activated gates),
// c_all [V, L, T, R, H] (its residual c, compute dtype), masks [V, L-1, T,
// R, H] (int8, or null) with inv_keep, wcatT0 [V, 4H, C + H], wcatTr [V,
// L-1, 4H, 2H] (the transposed [[Wx], [Wh]], compute dtype), dx [V, T, R,
// C], dgates [V, L, T, R, 4H]. w_dt is the compute dtype (0 = float32, 1 =
// bfloat16); rows_per_thread (2, 4 or 8) sets the row tile as in the
// forward. C and H are multiples of 8 and C <= 7 H. Returns a cudaError_t
// code (0 on success).
extern "C" int wf_lstm_stack_train_bwd_tasks(
    int w_dt, int rows_per_thread, int V, const float* g, const float* gates,
    const void* c_all, const int8_t* masks, float inv_keep, const void* wcatT0,
    const void* wcatTr, float* dx, float* dgates, int T, int R, int C, int H,
    int L, void* stream) {
  if (T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0 || V <= 0 || V > 65535)
    return (int)cudaErrorInvalidValue;
  const wf::BwdArgs a{g, gates, c_all, masks, inv_keep, wcatT0, wcatTr,
                      dx, dgates, T, R, C, H, L, V};
  return wf::launch_dt(w_dt, rows_per_thread, a, stream);
}
