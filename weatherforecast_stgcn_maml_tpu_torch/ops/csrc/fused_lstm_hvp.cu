// Second-order (R-operator) kernels of the fused LSTM stack: the tangents of
// the training forward and of its backward, for the Hessian-vector products
// of second-order MAML.
//
// Replaces two Pallas kernels of weatherforecast_stgcn_maml_tpu/ops/
// fused_lstm_hvp.py:
//   row 10: `_hvpfwd_kernel_m` (+ `_nomask`), launched by `_hvpfwd_pallas_m`:
//     the directional derivative of the stack forward (h, c of every layer
//     and step, and the top layer's last h) along (dx, dW, db);
//   row 11: `_hvpbwd_kernel_m` (+ `_nomask`), launched by `_hvpbwd_pallas_m`:
//     the directional derivative of the stack backward (dx, dW, db) along
//     (dg, dx, dh_all, dc_all, dW, db).
//
// Translation: the TPU kernels recompute the primal gates and the primal
// backward recurrence beside the tangents (3 and 9 "dot units" per step and
// layer; a dot unit is one [rows, K_l] x [K_l, 4H] product). Here the primal
// runs first, in the port's own first-order kernels, which keep what the
// tangents need: the forward (fused_lstm_stack.cu, row 4) stores the
// activated gates, and the backward (row 5's layer-by-layer schedule on
// lstm_scan_bwd.cuh) stores each stage's dh, dc and dgates. So these kernels
// compute tangents only:
//   row 10, per step t and layer l (gate order i, f, g, o; s = sigmoid'):
//     ds  = [dx_in | dh_{t-1} | x_in | h_{t-1}] @ [[W_l], [dW_l]] + db_l
//           (one contraction over 2 K_l rows: 2 dot units)
//     di = i(1-i) ds_i ... dg = (1-g^2) ds_g
//     dc = df c_{t-1} + f dc_{t-1} + di g + i dg
//     dh = do tanh(c) + o (1 - tanh(c)^2) dc
//   writing dh_all, dc_all (compute dtype) and the activated gates' tangents
//   [L, T, R, 4H] float32, which row 11 reads;
//   row 11, walking t and l backwards, linearises every line of row 5
//   (csrc/lstm_scan_bwd.cuh) around its stored dh, dc, dgates, and
//   contracts [tdgates | dgates] @ [[W_l^T], [dW_l^T]] (8H rows: 2 dot
//   units) for the tangent of dxh: its first K_l columns go to the layer
//   below (or to tdx), the last H to step t-1. It writes tdgates [L, T, R,
//   4H] float32; the wrapper forms the weight-gradient tangents
//   xh^T @ tdgates + dxh^T @ dgates and the bias tangent colsum(tdgates) with
//   the split-K GEMM and fixed-order reductions of gemm.cu (2 more dot units).
// As in rows 4-5, each block owns a tile of rows (rows are independent
// sequences) and walks every step and layer itself, carrying its tangent
// h / c (row 10) or tangent dh / dc (row 11) in shared memory, and streams
// the stacked weights from L2 in cp.async double-buffered tiles (contract()
// in common.cuh). Operands are rounded to the compute dtype, products
// accumulate in float32, carries stay float32.
//
// Bound, at the inner step's shapes (24 steps, 512 rows, 4 layers of width
// 128, input 256): row 10 does 2 dot units, 29 GFLOP, 0.43 ms at the card's
// float32 rate, and moves about 0.3 GB (the gates and their tangents, 100
// MB each), 0.09 ms: bound by operations. Row 11 with its GEMMs does 4 dot
// units, 58 GFLOP (0.87 ms), and moves about 0.6 GB (0.18 ms): bound by
// operations. Like rows 4-5 they are in practice bound by the serial T x L
// chain and the latency of each stage's weight stream, not by the card's
// rates.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kTargetThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB opt-in per block

struct FwdArgs {
  const float* x;       // [T, R, C]
  const float* tx;      // [T, R, C] tangent of x
  const void* w2_0;     // [2 (C + H), 4H]: [[Wx_0], [Wh_0], [tWx_0], [tWh_0]]
  const void* w2_r;     // [L-1, 4H, 4H]: the same for layers 1..L-1
  const float* tb;      // [L, 4H] tangent of the bias
  const int8_t* masks;  // [L-1, T, R, H] or null
  float inv_keep;
  const void* h_all;    // [L, T, R, H] the forward's residuals, compute dtype
  const void* c_all;
  const float* gates;   // [L, T, R, 4H] the forward's activated gates
  void* th_all;         // [L, T, R, H] tangents of h_all, c_all (compute dtype)
  void* tc_all;
  float* tgates;        // [L, T, R, 4H] tangents of the activated gates
  float* th_last;       // [R, H] tangent of the top layer's last h
  int T, R, C, H, L;
};

// Thread (group, j) owns hidden unit j of RPT rows, as in the forward: the
// four gate tangents of that unit, so the cell update needs no exchange.
template <typename TW, int RPT>
__global__ void hvp_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, C = a.C, L = a.L, T = a.T, R = a.R;
  const int g4 = 4 * H;
  const int kmax = (C > H ? C : H) + H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, 4H]
  float* opnd = reinterpret_cast<float*>(wbuf + 2 * kContractTile * g4);  // [rows_blk, 2 kmax]
  float* thc = opnd + (size_t)rows_blk * 2 * kmax;  // [L, rows_blk, H] tangent h carry
  float* tcc = thc + (size_t)L * rows_blk * H;      // [L, rows_blk, H] tangent c carry
  const TW* h_all = static_cast<const TW*>(a.h_all);
  const TW* c_all = static_cast<const TW*>(a.c_all);
  TW* th_all = static_cast<TW*>(a.th_all);
  TW* tc_all = static_cast<TW*>(a.tc_all);
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * rows_blk;
  const size_t step_elems = (size_t)R * H;  // one [R, H] slice of h_all

  for (int i = tid; i < 2 * L * rows_blk * H; i += blockDim.x) thc[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      const int kin = l == 0 ? C : H;
      const int kl = kin + H;
      const int ld = 2 * kl;
      // Operand rows [tangent input | tangent h_{t-1} | input | h_{t-1}],
      // rounded to the compute dtype. Layer l > 0 takes layer l-1's h (and
      // its tangent, this step's carry) times the dropout mask and 1/keep.
      for (int i = tid; i < rows_blk * kl; i += blockDim.x) {
        const int r = i / kl;
        const int k = i % kl;
        const int row = row0 + r;
        float tv = 0.f, v = 0.f;
        if (row < R) {
          if (k < kin) {
            if (l == 0) {
              const size_t o = ((size_t)t * R + row) * C + k;
              tv = a.tx[o];
              v = a.x[o];
            } else {
              const size_t o = ((size_t)(l - 1) * T + t) * step_elems + (size_t)row * H + k;
              const float m = a.masks ? (float)a.masks[o] * a.inv_keep : 1.f;
              tv = thc[((size_t)(l - 1) * rows_blk + r) * H + k] * m;
              v = to_float(h_all[o]) * m;
            }
          } else {
            const int u = k - kin;
            tv = thc[((size_t)l * rows_blk + r) * H + u];
            if (t > 0)
              v = to_float(h_all[((size_t)l * T + t - 1) * step_elems + (size_t)row * H + u]);
          }
        }
        opnd[(size_t)r * ld + k] = round_to<TW>(tv);
        opnd[(size_t)r * ld + kl + k] = round_to<TW>(v);
      }

      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const TW* w = l == 0 ? static_cast<const TW*>(a.w2_0)
                           : static_cast<const TW*>(a.w2_r) + (size_t)(l - 1) * 4 * H * g4;
      contract<TW, RPT, 4>(w, ld, g4, opnd, ld, wbuf, r0, j, H, acc);

      const float* tb = a.tb + (size_t)l * g4;
      const size_t slice = ((size_t)l * T + t) * step_elems;  // h_all[l, t]
      const bool last = l == L - 1 && t == T - 1;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
        float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c_t = 0.f, c_prev = 0.f;
        const size_t o = slice + (size_t)row * H + j;
        if (row < R) {
          const float* gt = a.gates + slice * 4 + (size_t)row * g4;
          ig = gt[j];
          fg = gt[H + j];
          gg = gt[2 * H + j];
          og = gt[3 * H + j];
          c_t = to_float(c_all[o]);
          if (t > 0) c_prev = to_float(c_all[o - step_elems]);
        }
        const float ti = ig * (1.f - ig) * (acc[r][0] + tb[j]);
        const float tf = fg * (1.f - fg) * (acc[r][1] + tb[H + j]);
        const float tg = (1.f - gg * gg) * (acc[r][2] + tb[2 * H + j]);
        const float to = og * (1.f - og) * (acc[r][3] + tb[3 * H + j]);
        const size_t at = ((size_t)l * rows_blk + lr) * H + j;
        const float tc = tf * c_prev + fg * tcc[at] + ti * gg + ig * tg;
        const float tch = tanhf(c_t);
        const float th = to * tch + og * (1.f - tch * tch) * tc;
        thc[at] = th;
        tcc[at] = tc;
        if (row < R) {
          th_all[o] = from_float<TW>(th);
          tc_all[o] = from_float<TW>(tc);
          float* out = a.tgates + slice * 4 + (size_t)row * g4;
          out[j] = ti;
          out[H + j] = tf;
          out[2 * H + j] = tg;
          out[3 * H + j] = to;
          if (last) a.th_last[(size_t)row * H + j] = th;
        }
      }
      __syncthreads();  // carries visible to the next stage's operand rows
    }
  }
}

struct BwdArgs {
  const float* tg;      // [R, H] tangent of g, the gradient of the last h
  const float* gates;   // [L, T, R, 4H] the forward's activated gates
  const float* tgates;  // [L, T, R, 4H] their tangents (row 10)
  const void* c_all;    // [L, T, R, H] residual c and its tangent, compute dtype
  const void* tc_all;
  const float* dh_all;  // [L, T, R, H] the backward's dh and dc (row 5)
  const float* dc_all;
  const float* dgates;  // [L, T, R, 4H] the backward's gate gradients (row 5)
  const int8_t* masks;  // [L-1, T, R, H] or null
  float inv_keep;
  const void* wT2_0;    // [8H, C + H]: [[Wcat_0^T], [tWcat_0^T]]
  const void* wT2_r;    // [L-1, 8H, 2H]
  float* tdx;           // [T, R, C]
  float* tdgates;       // [L, T, R, 4H]
  int T, R, C, H, L;
};

// Thread (group, j) owns hidden unit j of RPT rows: the four gate-gradient
// tangents of that unit, and the columns q * H + j of the contraction.
template <typename TW, int RPT, int NQ>
__global__ void hvp_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, C = a.C, L = a.L, T = a.T, R = a.R;
  const int g4 = 4 * H;
  const int kmax = (C > H ? C : H) + H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, kmax]
  float* opnd = reinterpret_cast<float*>(wbuf + 2 * kContractTile * kmax);  // [rows_blk, 8H]
  float* tdhc = opnd + (size_t)rows_blk * 2 * g4;  // [L, rows_blk, H] tangent dh carry
  float* tdcc = tdhc + (size_t)L * rows_blk * H;   // [L, rows_blk, H] tangent dc carry
  float* tda = tdcc + (size_t)L * rows_blk * H;    // [rows_blk, H] from the layer above
  const TW* c_all = static_cast<const TW*>(a.c_all);
  const TW* tc_all = static_cast<const TW*>(a.tc_all);
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * rows_blk;
  const size_t step_elems = (size_t)R * H;

  for (int i = tid; i < (2 * L + 1) * rows_blk * H; i += blockDim.x) tdhc[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int kin = l == 0 ? C : H;
      const int kl = kin + H;
      const TW* wt = l == 0 ? static_cast<const TW*>(a.wT2_0)
                            : static_cast<const TW*>(a.wT2_r) + (size_t)(l - 1) * 2 * g4 * 2 * H;
      const size_t slice = ((size_t)l * T + t) * step_elems;
      const bool top_last = l == L - 1 && t == T - 1;

      // Tangents of the gate gradients (the contraction's first barrier
      // publishes the operand rows).
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int lr = r0 + r;
        const int row = row0 + lr;
        float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, ti = 0.f, tf = 0.f, tg = 0.f, to = 0.f;
        float c_t = 0.f, c_prev = 0.f, tc_t = 0.f, tc_prev = 0.f, dh = 0.f, dc = 0.f;
        float dgi = 0.f, dgf = 0.f, dgg = 0.f, dgo = 0.f, tg_top = 0.f;
        if (row < R) {
          const size_t g_at = slice * 4 + (size_t)row * g4;
          const float* gt = a.gates + g_at;
          const float* tgt = a.tgates + g_at;
          const float* dgt = a.dgates + g_at;
          ig = gt[j];
          fg = gt[H + j];
          gg = gt[2 * H + j];
          og = gt[3 * H + j];
          ti = tgt[j];
          tf = tgt[H + j];
          tg = tgt[2 * H + j];
          to = tgt[3 * H + j];
          dgi = dgt[j];
          dgf = dgt[H + j];
          dgg = dgt[2 * H + j];
          dgo = dgt[3 * H + j];
          const size_t o = slice + (size_t)row * H + j;
          c_t = to_float(c_all[o]);
          tc_t = to_float(tc_all[o]);
          if (t > 0) {
            c_prev = to_float(c_all[o - step_elems]);
            tc_prev = to_float(tc_all[o - step_elems]);
          }
          dh = a.dh_all[o];
          dc = a.dc_all[o];
          if (top_last) tg_top = a.tg[(size_t)row * H + j];
        }
        const size_t at = ((size_t)l * rows_blk + lr) * H + j;
        float tdh = tdhc[at] + tg_top;
        if (l < L - 1) tdh += tda[(size_t)lr * H + j];
        const float tch = tanhf(c_t);
        const float om = 1.f - tch * tch;
        const float ttc = om * tc_t;  // tangent of tanh(c)
        const float tdc = tdcc[at] + tdh * og * om + dh * to * om - dh * og * (2.f * tch * ttc);
        const float so = og * (1.f - og);
        const float si = ig * (1.f - ig);
        const float sf = fg * (1.f - fg);
        const float sg = 1.f - gg * gg;
        const float tdo = tdh * tch * so + dh * ttc * so + dh * tch * (1.f - 2.f * og) * to;
        const float tdi = tdc * gg * si + dc * tg * si + dc * gg * (1.f - 2.f * ig) * ti;
        const float tdf = tdc * c_prev * sf + dc * tc_prev * sf + dc * c_prev * (1.f - 2.f * fg) * tf;
        const float tdg = tdc * ig * sg + dc * ti * sg - dc * ig * (2.f * gg * tg);
        tdcc[at] = tdc * fg + dc * tf;
        if (row < R) {
          float* out = a.tdgates + slice * 4 + (size_t)row * g4;
          out[j] = tdi;
          out[H + j] = tdf;
          out[2 * H + j] = tdg;
          out[3 * H + j] = tdo;
        }
        float* op = opnd + (size_t)lr * 2 * g4;
        op[j] = round_to<TW>(tdi);
        op[H + j] = round_to<TW>(tdf);
        op[2 * H + j] = round_to<TW>(tdg);
        op[3 * H + j] = round_to<TW>(tdo);
        op[g4 + j] = round_to<TW>(dgi);
        op[g4 + H + j] = round_to<TW>(dgf);
        op[g4 + 2 * H + j] = round_to<TW>(dgg);
        op[g4 + 3 * H + j] = round_to<TW>(dgo);
      }

      // tdxh = [tdgates | dgates] @ [[Wcat_l^T], [tWcat_l^T]]: [rows, 8H] x [8H, kl].
      float acc[RPT][NQ];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[r][q] = 0.f;
      contract<TW, RPT, NQ>(wt, 2 * g4, kl, opnd, 2 * g4, wbuf, r0, j, H, acc);

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
            tdhc[((size_t)l * rows_blk + lr) * H + (k - kin)] = v;  // to t-1
          } else if (l == 0) {
            if (row < R) a.tdx[((size_t)t * R + row) * C + k] = v;
          } else {
            float m = 1.f;
            if (a.masks)
              m = row < R ? (float)a.masks[slice - (size_t)T * step_elems +
                                           (size_t)row * H + k] * a.inv_keep
                          : 0.f;
            tda[(size_t)lr * H + k] = v * m;  // to layer l-1
          }
        }
      }
      __syncthreads();  // carries visible; the operand rows free for the next stage
    }
  }
}

int block_threads(int H) { return (H >= kTargetThreads ? 1 : kTargetThreads / H) * H; }

template <typename TW, int RPT>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const int threads = block_threads(a.H);
  const int rows_blk = threads / a.H * RPT;
  const int kmax = (a.C > a.H ? a.C : a.H) + a.H;
  const size_t smem = 2 * (size_t)kContractTile * 4 * a.H * sizeof(TW) +
                      ((size_t)rows_blk * 2 * kmax + 2 * (size_t)a.L * rows_blk * a.H) *
                          sizeof(float);
  if (threads > 1024 || smem > kMaxSmemBytes || a.C % 8 || a.H % 8)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hvp_fwd_kernel<TW, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + rows_blk - 1) / rows_blk;
  hvp_fwd_kernel<TW, RPT><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW, int RPT, int NQ>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int threads = block_threads(a.H);
  const int rows_blk = threads / a.H * RPT;
  const int kmax = (a.C > a.H ? a.C : a.H) + a.H;
  const size_t smem = 2 * (size_t)kContractTile * kmax * sizeof(TW) +
                      ((size_t)rows_blk * 8 * a.H + (2 * (size_t)a.L + 1) * rows_blk * a.H) *
                          sizeof(float);
  if (threads > 1024 || smem > kMaxSmemBytes || a.C % 8 || a.H % 8 ||
      a.C + a.H > NQ * a.H)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hvp_bwd_kernel<TW, RPT, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + rows_blk - 1) / rows_blk;
  hvp_bwd_kernel<TW, RPT, NQ><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW, int RPT>
int launch_bwd_nq(const BwdArgs& a, cudaStream_t s) {
  if (a.C + a.H <= 4 * a.H) return launch_bwd<TW, RPT, 4>(a, s);
  if (a.C + a.H <= 8 * a.H) return launch_bwd<TW, RPT, 8>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TW>
int fwd_rpt(int rpt, const FwdArgs& a, cudaStream_t s) {
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

template <typename TW>
int bwd_rpt(int rpt, const BwdArgs& a, cudaStream_t s) {
  switch (rpt) {
    case 2:
      return launch_bwd_nq<TW, 2>(a, s);
    case 4:
      return launch_bwd_nq<TW, 4>(a, s);
    case 8:
      return launch_bwd_nq<TW, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// Row 10 (see wf::FwdArgs for the layouts). w_dt is the dtype code of the
// weights, the residuals h_all / c_all, their tangents and the compute dtype
// (0 = float32, 1 = bfloat16); rows_per_thread (2, 4 or 8) sets the row tile
// as in the forward. C and H are multiples of 8. Returns a cudaError_t code.
extern "C" int wf_lstm_hvp_fwd(int w_dt, int rows_per_thread, const float* x,
                               const float* tx, const void* w2_0,
                               const void* w2_r, const float* tb,
                               const int8_t* masks, float inv_keep,
                               const void* h_all, const void* c_all,
                               const float* gates, void* th_all, void* tc_all,
                               float* tgates, float* th_last, int T, int R,
                               int C, int H, int L, void* stream) {
  if (T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const wf::FwdArgs a{x, tx, w2_0, w2_r, tb, masks, inv_keep, h_all, c_all, gates,
                      th_all, tc_all, tgates, th_last, T, R, C, H, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == wf::kF32) return wf::fwd_rpt<float>(rows_per_thread, a, s);
  if (w_dt == wf::kBF16) return wf::fwd_rpt<__nv_bfloat16>(rows_per_thread, a, s);
  return (int)cudaErrorInvalidValue;
}

// Row 11 (see wf::BwdArgs). Dtype code and row tile as in wf_lstm_hvp_fwd;
// C and H are multiples of 8 and C <= 7 H. Writes tdx and tdgates; returns
// a cudaError_t code.
extern "C" int wf_lstm_hvp_bwd(int w_dt, int rows_per_thread, const float* tg,
                               const float* gates, const float* tgates,
                               const void* c_all, const void* tc_all,
                               const float* dh_all, const float* dc_all,
                               const float* dgates, const int8_t* masks,
                               float inv_keep, const void* wT2_0,
                               const void* wT2_r, float* tdx, float* tdgates,
                               int T, int R, int C, int H, int L, void* stream) {
  if (T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const wf::BwdArgs a{tg, gates, tgates, c_all, tc_all, dh_all, dc_all, dgates, masks,
                      inv_keep, wT2_0, wT2_r, tdx, tdgates, T, R, C, H, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == wf::kF32) return wf::bwd_rpt<float>(rows_per_thread, a, s);
  if (w_dt == wf::kBF16) return wf::bwd_rpt<__nv_bfloat16>(rows_per_thread, a, s);
  return (int)cudaErrorInvalidValue;
}
