// The tangent of the LSTM stack's training forward (kernel row 10), for the
// Hessian-vector products of second-order MAML.
//
// Replaces the Pallas kernel `_hvpfwd_kernel_m` (+ `_nomask`) of
// weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py, launched by
// `_hvpfwd_pallas_m`: the directional derivative of the stack forward (h, c
// of every layer and step, and the top layer's last h) along (dx, dW, db).
// Row 11, the tangent of the backward, runs layer by layer on
// lstm_scan_tan.cu's recurrence and the GEMM core (ops/fused_lstm_hvp.py
// `hvp_backward_schedule`).
//
// Translation: the TPU kernel recomputes the primal gates beside the
// tangents (3 "dot units" per step and layer; a dot unit is one [rows, K_l]
// x [K_l, 4H] product). Here the primal runs first, in row 4's layer-by-layer
// forward, which stores the activated gates, so this kernel computes
// tangents only, per step t and layer l (gate order i, f, g, o):
//     ds  = [dx_in | dh_{t-1} | x_in | h_{t-1}] @ [[W_l], [dW_l]] + db_l
//           (one contraction over 2 K_l rows: 2 dot units)
//     di = i(1-i) ds_i ... dg = (1-g^2) ds_g
//     dc = df c_{t-1} + f dc_{t-1} + di g + i dg
//     dh = do tanh(c) + o (1 - tanh(c)^2) dc
// writing dh_all, dc_all (compute dtype) and the activated gates' tangents
// [L, T, R, 4H] float32, which row 11 reads. Each block owns a tile of rows
// (rows are independent sequences) and walks every step and layer itself,
// carrying its tangent h / c in shared memory, and streams the stacked
// weights from L2 in cp.async double-buffered tiles (contract() in
// common.cuh). Operands are rounded to the compute dtype, products
// accumulate in float32, carries stay float32.
//
// Bound, at the inner step's shapes (24 steps, 512 rows, 4 layers of width
// 128, input 256): 2 dot units, 29 GFLOP, 0.43 ms at the card's float32
// rate, and about 0.3 GB moved (the gates and their tangents, 100 MB each),
// 0.09 ms: bound by operations. Like row 4 before it went layer by layer it
// is in practice bound by the serial T x L chain and the latency of each
// stage's weight stream, not by the card's rates.
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
