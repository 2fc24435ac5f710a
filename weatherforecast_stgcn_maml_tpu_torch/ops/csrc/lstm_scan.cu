// The backward of one LSTM layer's recurrence: kernel row 19. Its forward,
// row 18, runs on the cluster forward recurrence of lstm_scan_fwd.cuh
// (through the entry `wf_lstm_stack_forward_recurrence` of lstm_stack_fwd.cu:
// xp with the bias, h_all and c_all in float32, the gates to an array of
// their own).
//
// Replaces the Pallas kernel `_bwd_kernel` of weatherforecast_stgcn_maml_tpu/
// ops/lstm_scan.py (launched by `_bwd_pallas`, inside the custom VJP
// `_recurrence_bwd`): the reverse-time recurrence from the gradient of h_all,
// the stored gates and c_all to dgates [T, B, 4H] float32, and the weight
// gradient dWh = round(h_{t-1})^T @ round(dgates) over every step and row,
// which JAX forms outside its kernel (one jnp.dot); dxp is dgates itself.
//
// Design: the TPU backward recomputes the gates from xp and h_prev (its HBM
// stream was the scarce resource): one [B, H] @ [H, 4H] product more per
// step on the serial chain. Here the forward stores the activated gates
// when a backward will follow (25 MB a layer at B = 512, T = 24, H = 128)
// and the backward reads them, so each backward step is one contraction,
// with Wh^T resident in the shared memory of a thread-block cluster
// (lstm_scan_bwd.cuh, shared with rows 5, 15 and 17). One host call
// (`wf_lstm_scan_backward`, ops/lstm_scan.py `scan_backward`; the same
// schedule on swappable pieces is `scan_backward_schedule`) enqueues the
// whole backward:
//   1. Wh^T's column slices for the cluster plan (cs, hcp, rb) in the compute
//      dtype (ops/fused_lstm_stack.py `recurrence_weights`): one launch of
//      fused_gcn_train.cu's transpose-and-round, a matrix a slice;
//   2. the recurrence (lstm_scan_bwd.cuh) into dgates;
//   3. under bfloat16, round(h_{t-1}) and round(dgates) once each (h_all is
//      row 18's float32 output; JAX rounds both), and under float32 at a
//      hidden width that is no multiple of 8, h_{t-1} with its columns
//      zero-padded to one (the TN core's M and row strides): one launch;
//   4. dWh's K-split partials on gemm_nn.cu's TN core: A = h_all's first (T -
//      1) x R rows at a row offset of R (h_{-1} = 0: JAX's `_shift_prev`
//      without a shifted copy), B = dgates, split rows from ops/gemm.py
//      `wave_split_rows` (48 splits of 256 rows at T = 24, R = 512);
//   5. gemm.cu's `sum_splits` adds them in split order into dWh's first H
//      rows: no atomics, so two runs give the same bits.
// The function's outputs are JAX's.
//
// Bound at the inner step's shape (T = 24, B = 512, H = 128): 1.61 GFLOP in
// the recurrence and 1.61 in dWh, 0.048 ms at the card's float32 rate; the
// gates / dgates streams (25 MB each) take 0.015 ms of device memory time.
// So the recurrence is bound by its serial T-step chain, not by memory, and
// dWh by the TN core's rate.
#include <cstdint>

#include "common.cuh"
#include "gemm_nn_launch.cuh"
#include "lstm_scan_bwd.cuh"

// gemm.cu: out[m, n] (row stride ldo) = the `splits` float32 partials
// part[s] ([M, N] rows of `stride` floats apart), added in split order.
extern "C" int wf_sum_splits(const float* part, int splits, long long stride, float* out, int M,
                             int N, int ldo, void* stream);
// fused_gcn_train.cu: up to 8 float32 matrices rounded to dt, transposed
// with their columns past `rows` zero where trans[i], in one launch.
extern "C" int wf_transpose_round(int dt, int count, const void* const* src, void* const* dst,
                                  const int* rows, const int* cols, const int* ld,
                                  const int* trans, const int* drows, void* stream);

namespace wf {
namespace {

// dst [rows, dcols] (contiguous, in TW) = round(src [rows, cols] float32,
// contiguous), its columns past cols zero; cols and dcols multiples of 4.
struct RoundPad {
  const float* src;
  void* dst;
  long long rows;
  int cols, dcols;
};

struct RoundPadArgs {
  RoundPad mat[2];
};

// Matrix blockIdx.y, four elements a thread and step (float4 in, 16 or 8
// bytes out). The matrix is picked by a select: a dynamic index into the
// kernel's parameters would copy them to local memory.
template <typename TW>
__global__ void __launch_bounds__(256) round_pad_kernel(RoundPadArgs args) {
  const RoundPad m = blockIdx.y ? args.mat[1] : args.mat[0];
  const int dq = m.dcols / 4;
  const long long quads = m.rows * dq;
  TW* dst = static_cast<TW*>(m.dst);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dq;
    const int c = (int)(i % dq) * 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * m.dcols + c, c < m.cols ? load4(m.src + r * m.cols + c) : zero);
  }
}

template <typename TW>
int launch_round_pad(const RoundPadArgs& args, int count, cudaStream_t s) {
  long long quads = 0;
  for (int i = 0; i < count; ++i) {
    const long long q = args.mat[i].rows * (args.mat[i].dcols / 4);
    quads = q > quads ? q : quads;
  }
  const long long want = (quads + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  round_pad_kernel<TW><<<dim3(blocks, count), 256, 0, s>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wf

// Row 19's recurrence alone: dgates [T, R, 4H] float32 from the gradient g of
// h_all, the forward's gates and c_all (float32), and Wh^T's column slices
// wts [cs, 4H, hcp] in the compute dtype w_dt, by the cluster plan (cs, hcp,
// rb, k_res) of lstm_scan_bwd.cuh (ops/fused_lstm_stack.py `recurrence_plan`).
// Returns a cudaError_t code.
extern "C" int wf_lstm_scan_bwd(int w_dt, int cs, int hcp, int rb, int k_res, const float* g,
                                const float* gates, const float* c_all, const void* wts,
                                float* dgates, int T, int R, int H, void* stream) {
  wf::ScanBwd a{g, gates, c_all, wts, dgates, nullptr, nullptr, T, R, H, cs, 1};
  a.k_res = k_res;
  return wf::launch_scan_bwd_dt<false>(w_dt, hcp, rb, a, static_cast<cudaStream_t>(stream));
}

// The arguments of row 19's whole backward, 22 packed 8-byte fields
// (ops/lstm_scan.py `_SCAN_BWD`).
struct ScanBackwardLaunch {
  long long w_dt, cs, hcp, rb;
  // float32 inputs: g, c_all, h_all [T, R, H], gates [T, R, 4H], wh [H, 4H]
  long long g, gates, c_all, wh, h_all;
  // workspace: wts [cs, 4H, hcp] in the compute dtype; h_round [(T-1) R, hp]
  // in the compute dtype where h_{t-1} is rounded or padded (bfloat16, or hp
  // != H; T > 1), else 0; dg_round [T R, 4H] in bfloat16 (bfloat16 only; else
  // 0); part [S, hp, 4H] float32
  long long wts, h_round, dg_round, part;
  long long dgates, dwh;  // float32 outputs [T, R, 4H] and [H, 4H]
  long long T, R, H, hp, split_rows, stream;
  long long k_res;  // the recurrence's resident rows of a slice; 4H or -1: all
};
static_assert(sizeof(ScanBackwardLaunch) == 22 * 8,
              "ScanBackwardLaunch is 22 packed 8-byte fields");

// Row 19: dgates and dWh (above) in five launches or fewer on `stream`, in
// order: the weight layout, the recurrence of the plan (cs, hcp, rb, k_res), the
// rounding and padding (where needed), dWh's TN partials with split_rows
// rows a split (S = ceil(T R / split_rows)), their sum. hp is H rounded up to
// a multiple of 8. Every array is 16-byte aligned. Returns 0, a cudaError_t
// code, or the TN core's negative refusal code (ops/gemm.py
// `_NN_REFUSALS`); the first failure stops the schedule.
extern "C" int wf_lstm_scan_backward(const ScanBackwardLaunch* p) {
  using namespace wf;
  const long long T = p->T, R = p->R, H = p->H, hp = p->hp, g4 = 4 * H;
  const bool bf16 = p->w_dt == kBF16;
  const bool round_h = (bf16 || hp != H) && T > 1;  // h_{t-1} rounded or padded (T = 1: no rows)
  if (T <= 0 || R <= 0 || H <= 0 || H % 4 || T * R > 0x7fffffff || H > 0x7fffffff ||
      (p->w_dt != kF32 && !bf16) || hp < H || hp % 8 || hp - H >= 8 ||
      (p->hcp != 32 && p->hcp != 64 && p->hcp != 128) ||
      !cluster_size_ok((int)p->cs) ||
      scan_units((int)H, (int)p->cs) > p->hcp || p->split_rows <= 0 || p->k_res > g4 ||
      round_h != (p->h_round != 0) || bf16 != (p->dg_round != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  auto fptr = [](long long v) { return reinterpret_cast<const float*>(v); };
  // Slice b: Wh's rows [b * hc, b * hc + hc) transposed, zero past them to
  // hcp columns (a block that owns no unit reads its slice for nothing);
  // one launch a group of up to 8 slices (wf_transpose_round's limit). A
  // streamed plan's slices are laid out alike: its blocks read their first
  // k_res rows once and the rest at every step.
  const int hc = scan_units((int)H, (int)p->cs), hcp = (int)p->hcp;
  const void* src[kWideCluster];
  void* dst[kWideCluster];
  int rows[kWideCluster], cols[kWideCluster], ld[kWideCluster], trans[kWideCluster],
      drows[kWideCluster], slices = 0;
  for (int b = 0; b < p->cs && b * hc < H; ++b, ++slices) {
    src[slices] = fptr(p->wh) + (size_t)b * hc * g4;
    dst[slices] = reinterpret_cast<char*>(p->wts) + (size_t)b * g4 * hcp * (bf16 ? 2 : 4);
    rows[slices] = (int)(H - b * hc < hc ? H - b * hc : hc);
    cols[slices] = ld[slices] = (int)g4;
    trans[slices] = 1;
    drows[slices] = hcp;
  }
  for (int b = 0; b < slices; b += 8) {
    const int n = slices - b < 8 ? slices - b : 8;
    const int err = wf_transpose_round((int)p->w_dt, n, src + b, dst + b, rows + b, cols + b,
                                       ld + b, trans + b, drows + b, s);
    if (err) return err;
  }
  ScanBwd a{fptr(p->g),
            fptr(p->gates),
            fptr(p->c_all),
            reinterpret_cast<const void*>(p->wts),
            reinterpret_cast<float*>(p->dgates),
            nullptr,
            nullptr,
            (int)T,
            (int)R,
            (int)H,
            (int)p->cs,
            1};
  a.k_res = (int)p->k_res;
  int err = launch_scan_bwd_dt<false>((int)p->w_dt, (int)p->hcp, (int)p->rb, a, s);
  if (err) return err;
  RoundPadArgs rp{};
  int count = 0;
  if (round_h)
    rp.mat[count++] = RoundPad{fptr(p->h_all), reinterpret_cast<void*>(p->h_round), (T - 1) * R,
                               (int)H, (int)hp};
  if (bf16)
    rp.mat[count++] = RoundPad{fptr(p->dgates), reinterpret_cast<void*>(p->dg_round), T * R,
                               (int)g4, (int)g4};
  if (count) {
    err = bf16 ? launch_round_pad<__nv_bfloat16>(rp, count, s)
               : launch_round_pad<float>(rp, count, s);
    if (err) return err;
  }
  TNLaunch t{};
  t.r_dt = p->w_dt;
  t.a = round_h ? p->h_round : p->h_all;
  t.lda = hp;
  t.b = bf16 ? p->dg_round : p->dgates;
  t.ldb = g4;
  t.c = p->part;
  t.sc = hp * g4;
  t.ldc = g4;
  t.M = hp;
  t.N = g4;
  t.K = T * R;
  t.kc = p->split_rows;
  t.stream = p->stream;
  t.batch = 1;
  t.a_off = R;
  err = wf_gemm_tn(&t);
  if (err) return err;
  const long long splits = (T * R + p->split_rows - 1) / p->split_rows;
  return wf_sum_splits(fptr(p->part), (int)splits, hp * g4, reinterpret_cast<float*>(p->dwh),
                       (int)H, (int)g4, (int)g4, reinterpret_cast<void*>(p->stream));
}
