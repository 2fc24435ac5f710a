// Fused LSTM stack with unmerged gates: the training forward (and the eval
// forward) and the training backward, all layers and all time steps in one
// launch each.
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
//     launched by `_bwd_pallas`. Walking t = T-1 .. 0 and l = L-1 .. 0, it
//     recomputes each stage's gates from the residuals (the input from x or
//     from the layer below's stored h, masked as in the forward; h_{t-1}
//     from the stored h, zero at t = 0), forms the gate gradients from the
//     dh / dc carries as row 5 does (csrc/fused_lstm_stack_train.cu), and
//     contracts round(dgates) with Wx_l^T (the input gradient: dx, or the
//     layer below's dh at the same step after its mask) and with Wh_l^T (the
//     dh carry to t-1): 4 contractions a stage.
//
// Translation: as in row 4, each block owns a tile of rows (independent
// sequences) and walks time and layers itself; thread (g, j) owns hidden
// unit j of RPT rows, so the cell update needs no exchange between threads.
// Each contraction streams its weight matrix from L2 through a
// double-buffered cp.async tile ring (`contract()` in common.cuh); unlike
// row 4's merged kernel the ring is not carried across contractions, a
// simpler schedule that pays one tile's latency per contraction. The TPU
// kernel accumulates dWx, dWh and db in its output blocks across the
// sequential grid; CUDA blocks run in no order, so this kernel writes the
// float32 gate gradients [L, T, R, 4H] and the wrapper forms dWx_l = inp^T @
// dgates_l, dWh_l = h_prev^T @ dgates_l and db_l over K = T * R with
// gemm.cu's split-K products and fixed-order sums (no float atomics), as row
// 5's wrapper does.
//
// Bound: the forward is row 4's work (about 14.5 GFLOP at the training
// shapes: 24 steps, 512 rows, 4 layers of width 128, input 256; 0.22 ms at
// the card's float32 rate) and the backward row 5's plus the recomputed
// forward (29.0 GFLOP counted as row 5's). Both are bound by the serial
// T * L chain of weight streams from L2, not by device memory.
#include <cstdint>

#include "common.cuh"

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
  void* h_all;  // [L, T, R, H] compute dtype: forward writes (unless null), backward reads
  void* c_all;
  float* out;  // forward: [R, H], the top layer's last h
  // Backward only.
  const float* g;     // [R, H] gradient of the top layer's last h
  const void* wxT0;   // [4H, C]      compute dtype
  const void* wxTr;   // [L-1, 4H, H] compute dtype
  const void* whT;    // [L, 4H, H]   compute dtype
  float* dx;          // [T, R, C]
  float* dgates;      // [L, T, R, 4H]
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

// Thread (group, j) owns hidden unit j of RPT rows: its four gate
// gradients, and the input-gradient columns q * H + j (NQ >= C / H of them).
template <typename TW, int RPT, int NQ>
__global__ void lstm_split_bwd_kernel(SplitArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, C = a.C, L = a.L, T = a.T, R = a.R;
  const int g4 = 4 * H;
  const int kmax = C > H ? C : H;          // widest layer input
  const int wcols = g4 > kmax ? g4 : kmax;  // widest weight tile row
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, wcols]
  float* ins = reinterpret_cast<float*>(wbuf + 2 * kContractTile * wcols);  // [rows_blk, kin]
  float* hp = ins + (size_t)rows_blk * kmax;  // [rows_blk, H] h_{t-1}
  float* dg = hp + (size_t)rows_blk * H;      // [rows_blk, 4H] round(dgates)
  float* dhc = dg + (size_t)rows_blk * g4;    // [L, rows_blk, H] dh carry
  float* dcc = dhc + (size_t)L * rows_blk * H;  // [L, rows_blk, H] dc carry
  float* dfa = dcc + (size_t)L * rows_blk * H;  // [rows_blk, H] from the layer above
  const TW* wx0 = static_cast<const TW*>(a.wx0);
  const TW* wxr = static_cast<const TW*>(a.wxr);
  const TW* wh = static_cast<const TW*>(a.wh);
  const TW* wxT0 = static_cast<const TW*>(a.wxT0);
  const TW* wxTr = static_cast<const TW*>(a.wxTr);
  const TW* whT = static_cast<const TW*>(a.whT);
  const TW* h_all = static_cast<const TW*>(a.h_all);
  const TW* c_all = static_cast<const TW*>(a.c_all);
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * rows_blk;
  const size_t step_elems = (size_t)R * H;

  for (int i = tid; i < (2 * L + 1) * rows_blk * H; i += blockDim.x) dhc[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int kin = l == 0 ? C : H;
      const size_t slice = ((size_t)l * T + t) * step_elems;  // h_all[l, t]
      const bool top_last = l == L - 1 && t == T - 1;

      // This stage's operand rows (the previous stage ended with a barrier):
      // the input as the forward rounded it, and h_{t-1}.
      for (int i = tid; i < rows_blk * kin; i += blockDim.x) {
        const int r = i / kin;
        const int k = i % kin;
        const int row = row0 + r;
        float v = 0.f;
        if (row < R) {
          if (l == 0) {
            v = round_to<TW>(a.x[t * a.st + row * a.sr + k]);
          } else {
            const size_t o = slice - (size_t)T * step_elems + (size_t)row * H + k;
            v = to_float(h_all[o]);  // h_all[l - 1, t]
            if (a.masks) v = v * ((float)a.masks[o] * a.inv_keep);
            v = round_to<TW>(v);
          }
        }
        ins[i] = v;
      }
      if (t > 0) {
        for (int i = tid; i < rows_blk * H; i += blockDim.x) {
          const int row = row0 + i / H;
          hp[i] = row < R ? to_float(h_all[slice - step_elems + (size_t)row * H + i % H]) : 0.f;
        }
      }

      // Recompute the gates: in @ Wx_l + h_{t-1} @ Wh_l.
      const TW* wx = l == 0 ? wx0 : wxr + (size_t)(l - 1) * H * g4;
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      contract<TW, RPT, 4>(wx, kin, g4, ins, kin, wbuf, r0, j, H, acc);
      if (t > 0)
        contract<TW, RPT, 4>(wh + (size_t)l * H * g4, H, g4, hp, H, wbuf, r0, j, H, acc);

      // Gate gradients (the next contraction's first barrier publishes dg).
      const float* bl = a.bias + (size_t)l * g4;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
        const float ig = sigmoidf(acc[r][0] + bl[j]);
        const float fg = sigmoidf(acc[r][1] + bl[H + j]);
        const float gg = tanhf(acc[r][2] + bl[2 * H + j]);
        const float og = sigmoidf(acc[r][3] + bl[3 * H + j]);
        float c_t = 0.f, c_prev = 0.f, g_top = 0.f;
        if (row < R) {
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

      // The input gradient round(dgates) @ Wx_l^T and the carry
      // round(dgates) @ Wh_l^T (zero at t = 0: nothing reads it).
      float din[RPT][NQ];
      float dhp[RPT][1];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        dhp[r][0] = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) din[r][q] = 0.f;
      }
      const TW* wxt = l == 0 ? wxT0 : wxTr + (size_t)(l - 1) * g4 * H;
      contract<TW, RPT, NQ>(wxt, g4, kin, dg, g4, wbuf, r0, j, H, din);
      if (t > 0)
        contract<TW, RPT, 1>(whT + (size_t)l * g4 * H, g4, H, dg, g4, wbuf, r0, j, H, dhp);

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
        dhc[((size_t)l * rows_blk + lr) * H + j] = dhp[r][0];  // to t-1
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int k = q * H + j;
          if (k >= kin) continue;
          const float v = din[r][q];
          if (l == 0) {
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
      __syncthreads();  // carries visible; operand rows free for the next stage
    }
  }
}

size_t fwd_smem(const SplitArgs& a, int rows_blk, size_t tw) {
  return 2 * (size_t)kContractTile * 4 * a.H * tw +
         ((size_t)rows_blk * a.C + 3 * (size_t)a.L * rows_blk * a.H) * sizeof(float);
}

size_t bwd_smem(const SplitArgs& a, int rows_blk, size_t tw) {
  const int kmax = a.C > a.H ? a.C : a.H;
  const int wcols = 4 * a.H > kmax ? 4 * a.H : kmax;
  return 2 * (size_t)kContractTile * wcols * tw +
         ((size_t)rows_blk * kmax + (size_t)rows_blk * a.H + (size_t)rows_blk * 4 * a.H +
          (2 * (size_t)a.L + 1) * rows_blk * a.H) * sizeof(float);
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

template <typename TW, int RPT>
int launch_bwd(const SplitArgs& a, cudaStream_t s) {
  const size_t smem = bwd_smem(a, rows_blk_of(a, RPT), sizeof(TW));
  if (a.C <= 2 * a.H) return launch_kernel(lstm_split_bwd_kernel<TW, RPT, 2>, a, RPT, smem, s);
  if (a.C <= 4 * a.H) return launch_kernel(lstm_split_bwd_kernel<TW, RPT, 4>, a, RPT, smem, s);
  if (a.C <= 8 * a.H) return launch_kernel(lstm_split_bwd_kernel<TW, RPT, 8>, a, RPT, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <bool BWD, typename TW>
int launch_rpt(int rpt, const SplitArgs& a, cudaStream_t s) {
  switch (rpt) {
    case 2:
      return BWD ? launch_bwd<TW, 2>(a, s) : launch_fwd<TW, 2>(a, s);
    case 4:
      return BWD ? launch_bwd<TW, 4>(a, s) : launch_fwd<TW, 4>(a, s);
    case 8:
      return BWD ? launch_bwd<TW, 8>(a, s) : launch_fwd<TW, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BWD>
int launch_dt(int w_dt, int rpt, const SplitArgs& a, void* stream) {
  if (a.T <= 0 || a.R <= 0 || a.C <= 0 || a.H <= 0 || a.L <= 0 || a.C % 8 || a.H % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == kF32) return launch_rpt<BWD, float>(rpt, a, s);
  if (w_dt == kBF16) return launch_rpt<BWD, __nv_bfloat16>(rpt, a, s);
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
  if (!h_all != !c_all) return (int)cudaErrorInvalidValue;
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
  return wf::launch_dt<false>(w_dt, rows_per_thread, a, stream);
}

// Backward recurrence of the unmerged-gates stack (kernel row 15): from g
// [R, H], x [T, R, C] (contiguous, float32), the forward's residuals h_all
// and c_all [L, T, R, H], the weights, their transposes wxT0 [4H, C], wxTr
// [L-1, 4H, H], whT [L, 4H, H] (compute dtype), bias and masks, it writes dx
// [T, R, C] and the float32 gate gradients dgates [L, T, R, 4H] that the
// weight-gradient products read. Returns a cudaError_t code.
extern "C" int wf_lstm_split_bwd(int w_dt, int rows_per_thread, const float* g,
                                 const float* x, const void* h_all, const void* c_all,
                                 const void* wx0, const void* wxr, const void* wh,
                                 const void* wxT0, const void* wxTr, const void* whT,
                                 const float* bias, const int8_t* masks, float inv_keep,
                                 float* dx, float* dgates, int T, int R, int C, int H,
                                 int L, void* stream) {
  if (!h_all || !c_all) return (int)cudaErrorInvalidValue;
  wf::SplitArgs a{};
  a.x = x;
  a.st = (long long)R * C;
  a.sr = C;
  a.wx0 = wx0;
  a.wxr = wxr;
  a.wh = wh;
  a.bias = bias;
  a.masks = masks;
  a.inv_keep = inv_keep;
  a.h_all = const_cast<void*>(h_all);
  a.c_all = const_cast<void*>(c_all);
  a.g = g;
  a.wxT0 = wxT0;
  a.wxTr = wxTr;
  a.whT = whT;
  a.dx = dx;
  a.dgates = dgates;
  a.T = T;
  a.R = R;
  a.C = C;
  a.H = H;
  a.L = L;
  return wf::launch_dt<true>(w_dt, rows_per_thread, a, stream);
}
