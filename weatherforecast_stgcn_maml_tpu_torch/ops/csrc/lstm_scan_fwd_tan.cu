// The tangent of the LSTM stack's training forward (kernel row 10), for the
// Hessian-vector products of second-order MAML, layer by layer: the tangent
// forward recurrence, kept in a thread-block cluster, and the C entry that
// enqueues the whole schedule from one host call.
//
// Replaces the Pallas kernel `_hvpfwd_kernel_m` (+ `_nomask`) of
// weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py, launched by
// `_hvpfwd_pallas_m`: the directional derivative of the stack forward (h, c
// of every layer and step, and the top layer's last h) along (dx, dW, db).
// The TPU kernel walks all T x L stages as one chain, recomputing the primal
// beside the tangents with one [tin | th | in | h] @ [[W], [tW]] contraction
// a stage. Here the primal comes from row 4 at the same point (its h_all,
// c_all and activated gates), and of the tangent pre-activation of layer l
//     ds_l[t] = round(tin_l[t]) @ round(Wx_l)
//             + round([in_l[t] | h_l[t-1]]) @ round(tW_l)      (tW_l = [[tWx_l], [tWh_l]])
//             + round(th_l[t-1]) @ round(Wh_l) + tb_l
// only the last product is on the serial chain. So, for l = 0 .. L-1
// (ops/fused_lstm_hvp.py `hvp_forward_schedule` states the same schedule on
// swappable pieces):
//   1. the off-chain terms: one gemm_nn.cu launch of two operand pairs,
//      tin_l @ Wx_l and [in_l | h_l shifted a step] @ tW_l, written straight
//      into the layer's tangent gates [T, R, 4H] float32, no bias. The
//      weights are read as the caller stores them (W_l's rows, the whole of
//      tW_l): no copy in float32;
//   2. the tangent recurrence (below) over those in place: the gates'
//      tangents ta, th and tc [T, R, H] in the compute dtype, below the top
//      layer the next layer's operands [tin | in | h shifted] [T, R, 3H] in
//      the compute dtype, at the top layer the last th in float32.
// Layer 0's operands are tx itself and [x | h_0 shifted], which one pack
// launch writes; above it the recurrence of layer l-1 writes tin_l =
// round(th * mask * inv_keep) from the float32 th (JAX's rounding point),
// in_l = round(round(h_{l-1}) * mask * inv_keep) from row 4's h_all (row
// 11's choice, `hvp_backward_schedule`: equal to JAX's in float32, rounded
// from round(h) in bfloat16) and row 4's h_l a step back (zero at t = 0),
// into one buffer every layer reuses: layer l+1's product has read it before
// layer l+1's recurrence writes it again, in stream order.
//
// The tangent cell, from row 4's activated gates (i, f, g, o) and c_all:
//     ta = slopes(a) * ds   (i(1-i), f(1-f), 1-g^2, o(1-o))
//     tc = tf * c_{t-1} + f * tc + ti * g + i * tg
//     th = to * tanh(c) + o * (1 - tanh(c)^2) * tc
// with c_{-1} = 0 and tc, th carries zero at t = 0, as the TPU kernel's.
//
// Bound at the inner step's shapes (T = 24, R = 512, C = 256, H = 128, L =
// 4): 29 GFLOP (0.43 ms at the card's float32 rate), of which the serial
// th @ Wh products are 6.44 over 4 x 24 steps; the off-chain products are
// 22.5. The recurrence is lstm_scan_fwd.cuh's design (its helpers: Wh
// resident in shared memory split by units over a 1-16 block cluster,
// round(th) exchanged over distributed shared memory, one cluster barrier a
// step) with the tangent cell: a thread owns a row and 4 units, and reads
// 12 values a unit a step (4 gates, c, 4 ds, and its c_{t-1}, tc carries in
// registers; below the top layer h and the next layer's h too), so its plan
// (ops/fused_lstm_hvp.py `tangent_forward_plan`) keeps row tiles of at most
// 8 rows: one (row, 4 units) a thread.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "gemm_nn_launch.cuh"
#include "lstm_scan_fwd.cuh"

namespace wf {
namespace {

struct ScanFwdTan {
  float* tgates;       // [T, R, 4H] in: the off-chain tangent products; out: ta
  const float* gates;  // [T, R, 4H] the forward's activated gates
  const void* c_all;   // [T, R, H] the forward's c, compute dtype
  const void* h_all;   // [T, R, H] the forward's h, compute dtype (read with next_in)
  const void* h_next;  // [T, R, H] the next layer's h, compute dtype (read with next_in)
  const void* wh;      // Wh [H, 4H] in the compute dtype, row stride ldw
  long long ldw;
  const float* tb;     // [4H] the bias tangent
  void* th_all;        // [T, R, H] compute dtype
  void* tc_all;
  const int8_t* mask;  // [T, R, H] the next layer's dropout mask, or null
  float inv_keep;
  void* next_in;       // [T, R, 3H] the next layer's [tin | in | h_{t-1}], compute dtype,
                       // or null
  float* th_last;      // [R, H] the last step's th, or null
  int T, R, H, cs;
};

// The tangent cell of one unit: the gates' tangents ta[0..3] from the
// activated gates and the tangent pre-activations, tc and th updated; cp is
// c_{t-1}, c is c_t.
__device__ __forceinline__ void cell_tan(float gi, float gf, float gg, float go, float si,
                                         float sf, float sg, float so, float c, float cp,
                                         float& tc, float& th, float (&ta)[4]) {
  ta[0] = gi * (1.f - gi) * si;
  ta[1] = gf * (1.f - gf) * sf;
  ta[2] = (1.f - gg * gg) * sg;
  ta[3] = go * (1.f - go) * so;
  tc = ta[1] * cp + gf * tc + ta[0] * gg + gi * ta[2];
  const float tch = tanhf(c);
  th = ta[3] * tch + go * (1.f - tch * tch) * tc;
}

// One step's inputs of a thread's (row, 4 units): the off-chain products ds,
// the activated gates, c_t and, below the top layer, h_t and the next
// layer's h_{t-1} (zero at t = 0).
template <typename TW>
__device__ __forceinline__ void load_tan_step(const ScanFwdTan& a, int t, int row, int j,
                                              float4 (&ds)[4], float4 (&gt)[4], float4& c,
                                              float4& h, float4& hn) {
  const size_t g = ((size_t)t * a.R + row) * 4 * a.H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ds[q] = load4(a.tgates + g + q * a.H);
    gt[q] = load4(a.gates + g + q * a.H);
  }
  const size_t o = ((size_t)t * a.R + row) * a.H + j;
  c = load4(static_cast<const TW*>(a.c_all) + o);
  if (a.next_in) {
    h = load4(static_cast<const TW*>(a.h_all) + o);
    hn = t > 0 ? load4(static_cast<const TW*>(a.h_next) + o - (size_t)a.R * a.H)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Grid (cs, row tiles); clusters of cs blocks along x: block rank b owns
// units [b*hc, b*hc + hc) of the cluster's RB rows. 32 * UPT = hcp. The
// shared memory is the forward recurrence's (`scan_fwd_smem`), the tiles
// holding round(th).
template <typename TW, int UPT, int RB>
__global__ void __launch_bounds__(kScanThreads, 1) lstm_scan_fwd_tan_kernel(const ScanFwdTan a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int HCP = 32 * UPT;
  constexpr int EPT = (RB * HCP / 4 + kScanThreads - 1) / kScanThreads;  // (row, 4 units) a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, R = a.R, H = a.H, g4 = 4 * H;
  const int rank = (int)cluster.block_rank();
  const int hc = scan_units(H, a.cs);
  const int j0 = rank * hc;
  const int nu = max(0, min(hc, H - j0));  // this block's units (a multiple of 4)
  const int nq = nu / 4;
  const int row0 = blockIdx.y * RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  TW* w_s = reinterpret_cast<TW*>(smem);                    // [H, 4, HCP]
  TW* th_s = w_s + (size_t)H * 4 * HCP;                     // [2, RB, H]
  float* part = reinterpret_cast<float*>(th_s + (size_t)2 * RB * H);  // [2, 4, RB, HCP]

  if (T > 1) scan_fwd_copy_slice<TW, HCP>(w_s, a.wh, a.ldw, H, j0, nu);

  int pr[EPT], pj[EPT];
  scan_fwd_pairs<RB, EPT>(nq, j0, pr, pj);
  // Per pair: this step's inputs (loaded a step ahead), the bias tangent,
  // and the carries c_{t-1} and tc.
  float4 ds[EPT][4], gt[EPT][4], tb[EPT][4], cc[EPT], hv[EPT], hn[EPT], cp[EPT], tcc[EPT];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    cc[e] = hv[e] = hn[e] = cp[e] = tcc[e] = zero;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ds[e][q] = gt[e][q] = zero;
      tb[e][q] = pr[e] >= 0 ? load4(a.tb + q * H + pj[e]) : zero;
    }
    if (pr[e] >= 0 && row0 + pr[e] < R)
      load_tan_step<TW>(a, 0, row0 + pr[e], pj[e], ds[e], gt[e], cc[e], hv[e], hn[e]);
  }

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      scan_fwd_contract<TW, UPT, RB>(th_s + (size_t)((t - 1) & 1) * RB * H, w_s, part, H, warp,
                                     lane);
      __syncthreads();  // the partials visible to the threads that own the units
    }

    TW* tn = th_s + (size_t)(t & 1) * RB * H;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0) continue;
      const int r = pr[e], j = pj[e], row = row0 + r;
      float4 s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[q] = add4(ds[e][q], tb[e][q]);
        if (t > 0) s[q] = add4(s[q], scan_fwd_partial<RB, HCP>(part, q, r, j - j0));
      }
      float ta[4][4];  // [unit][gate]
      float4 th;
      const float4* g = gt[e];
      cell_tan(g[0].x, g[1].x, g[2].x, g[3].x, s[0].x, s[1].x, s[2].x, s[3].x, cc[e].x, cp[e].x,
               tcc[e].x, th.x, ta[0]);
      cell_tan(g[0].y, g[1].y, g[2].y, g[3].y, s[0].y, s[1].y, s[2].y, s[3].y, cc[e].y, cp[e].y,
               tcc[e].y, th.y, ta[1]);
      cell_tan(g[0].z, g[1].z, g[2].z, g[3].z, s[0].z, s[1].z, s[2].z, s[3].z, cc[e].z, cp[e].z,
               tcc[e].z, th.z, ta[2]);
      cell_tan(g[0].w, g[1].w, g[2].w, g[3].w, s[0].w, s[1].w, s[2].w, s[3].w, cc[e].w, cp[e].w,
               tcc[e].w, th.w, ta[3]);
      cp[e] = cc[e];
      // round(th_t) into every block's tile first: the partners wait for it
      if (t + 1 < T) scan_fwd_share(cluster, tn + (size_t)r * H + j, th, a.cs);
      if (row < R) {
        float* out = a.tgates + ((size_t)t * R + row) * g4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store4(out + q * H, make_float4(ta[0][q], ta[1][q], ta[2][q], ta[3][q]));
        const size_t o = ((size_t)t * R + row) * H + j;
        store4(static_cast<TW*>(a.th_all) + o, th);
        store4(static_cast<TW*>(a.tc_all) + o, tcc[e]);
        if (a.next_in) {
          float4 m = make_float4(1.f, 1.f, 1.f, 1.f);
          if (a.mask) {
            const char4 mk = *reinterpret_cast<const char4*>(a.mask + o);
            m = make_float4((float)mk.x * a.inv_keep, (float)mk.y * a.inv_keep,
                            (float)mk.z * a.inv_keep, (float)mk.w * a.inv_keep);
          }
          TW* nx = static_cast<TW*>(a.next_in) + ((size_t)t * R + row) * 3 * H + j;
          store4(nx, make_float4(th.x * m.x, th.y * m.y, th.z * m.z, th.w * m.w));
          const float4 h = hv[e];
          store4(nx + H, make_float4(h.x * m.x, h.y * m.y, h.z * m.z, h.w * m.w));
          store4(nx + 2 * H, hn[e]);
        }
        if (a.th_last && t == T - 1) store4(a.th_last + (size_t)row * H + j, th);
      }
    }
    if (t + 1 == T) break;
    // One cluster barrier a step, as the forward recurrence's; step t+1's
    // inputs are loaded between arrive and wait.
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0 || row0 + pr[e] >= R) continue;
      load_tan_step<TW>(a, t + 1, row0 + pr[e], pj[e], ds[e], gt[e], cc[e], hv[e], hn[e]);
    }
    cluster_wait();
    if (t == 0) {  // the weight slice has landed (each thread's copies, then all)
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
  }
}

template <typename TW, int UPT, int RB>
int scan_tan_run(const ScanFwdTan& a, cudaStream_t stream, int* max_clusters) {
  static bool opted[64] = {};
  return launch_cluster(lstm_scan_fwd_tan_kernel<TW, UPT, RB>, a, opted, a.cs,
                        (unsigned)((a.R + RB - 1) / RB), 1u,
                        scan_fwd_smem(a.H, 32 * UPT, RB, sizeof(TW)), stream, max_clusters);
}

template <typename TW, int UPT>
int scan_tan_rb(int rb, const ScanFwdTan& a, cudaStream_t s, int* max_clusters) {
  switch (rb) {
    case 2:
      return scan_tan_run<TW, UPT, 2>(a, s, max_clusters);
    case 4:
      return scan_tan_run<TW, UPT, 4>(a, s, max_clusters);
    case 8:
      return scan_tan_run<TW, UPT, 8>(a, s, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TW>
int scan_tan_hcp(int hcp, int rb, const ScanFwdTan& a, cudaStream_t s, int* max_clusters) {
  switch (hcp) {
    case 32:
      return scan_tan_rb<TW, 1>(rb, a, s, max_clusters);
    case 64:
      return scan_tan_rb<TW, 2>(rb, a, s, max_clusters);
    case 128:
      return scan_tan_rb<TW, 4>(rb, a, s, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// Launch one tangent forward recurrence on `stream` (or, with max_clusters,
// ask the occupancy of its clusters): w_dt (0 = float32, 1 = bfloat16) is
// the compute dtype, Wh's, c_all's, h_all's and the outputs'. The plan
// (a.cs, hcp, rb) is the caller's, as the forward recurrence's with rb 2, 4
// or 8. ldw is a multiple of 4; tgates, gates, tb and th_last are 16-byte
// aligned, the compute-dtype arrays aligned to 4 elements, the mask to 4
// bytes; a mask only with next_in, next_in with h_all and h_next. Returns a
// cudaError_t code.
int launch_scan_fwd_tan(int w_dt, int hcp, int rb, const ScanFwdTan& a, cudaStream_t s,
                        int* max_clusters = nullptr) {
  const bool bf16 = w_dt == kBF16;
  const size_t tw = bf16 ? 2 : 4;
  if ((w_dt != kF32 && !bf16) || !scan_fwd_plan_ok(bf16, hcp, rb, a.cs, a.T, a.R, a.H, 14u) ||
      (a.mask && !a.next_in) || (a.next_in && (!a.h_all || !a.h_next)))
    return (int)cudaErrorInvalidValue;
  if (!aligned_to(a.tgates, 16) || !aligned_to(a.gates, 16) || !aligned_to(a.tb, 16) ||
      !aligned_to(a.th_last, 16) || !aligned_to(a.wh, 4 * tw) || !aligned_to(a.c_all, 4 * tw) ||
      !aligned_to(a.h_all, 4 * tw) || !aligned_to(a.h_next, 4 * tw) ||
      !aligned_to(a.th_all, 4 * tw) ||
      !aligned_to(a.tc_all, 4 * tw) || !aligned_to(a.next_in, 4 * tw) ||
      !aligned_to(a.mask, 4) || a.ldw % 4)
    return (int)cudaErrorMisalignedAddress;
  if (bf16) return scan_tan_hcp<__nv_bfloat16>(hcp, rb, a, s, max_clusters);
  return scan_tan_hcp<float>(hcp, rb, a, s, max_clusters);
}

// Layer 0's second operand [x | h_0 a step back] [T * R, C + H] in the
// compute dtype TA: x rounded to it (as the product would round it), h zero
// at t = 0. A grid-stride loop over 4-element groups.
template <typename TA>
__global__ void pack_input_kernel(const float* x, const TA* h, TA* out, long long rows, int R,
                                  int C, int H) {
  const int q4 = (C + H) / 4;
  const long long n = rows * q4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / q4;
    const int c = (int)(i % q4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C)
      v = load4(x + m * C + c);
    else if (m >= R)
      v = load4(h + (m - R) * H + (c - C));
    store4(out + m * (C + H) + c, v);
  }
}

// Launch the pack on `stream`: x float32, h and out in the compute dtype
// w_dt; C and H multiples of 4, the arrays 16-byte aligned. Returns a
// cudaError_t code.
int launch_pack(int w_dt, const void* x, const void* h, void* out, long long rows, int R, int C,
                int H, cudaStream_t s) {
  if (C % 4 || H % 4 || !aligned_to(x, 16) || !aligned_to(h, 16) || !aligned_to(out, 16))
    return (int)cudaErrorInvalidValue;
  const long long n = rows * ((C + H) / 4);
  const int threads = 256;
  const int blocks = (int)std::min<long long>((n + threads - 1) / threads, 132 * 16);
  const float* xf = static_cast<const float*>(x);
  if (w_dt == kBF16)
    pack_input_kernel<<<blocks, threads, 0, s>>>(xf, static_cast<const __nv_bfloat16*>(h),
                                                 static_cast<__nv_bfloat16*>(out), rows, R, C, H);
  else
    pack_input_kernel<<<blocks, threads, 0, s>>>(xf, static_cast<const float*>(h),
                                                 static_cast<float*>(out), rows, R, C, H);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wf

// The arguments of one tangent forward, 24 packed 8-byte fields
// (ops/fused_lstm_hvp.py `_HVP_FWD`), followed by L triples (wx_l, wh_l,
// tw_l): layer l's Wx_l [k_l, 4H] and Wh_l [H, 4H] (the row blocks of W_l)
// and tW_l [k_l + H, 4H], in the compute dtype (row-major, row stride 4H,
// 16-byte aligned), k_l = C at l = 0, else H.
struct HvpFwdLaunch {
  long long w_dt, cs, hcp, rb;
  long long x, tx, pack;     // x, tx [T, R, C] float32; pack [T, R, C + H] compute dtype
  long long next_in;         // [T, R, 3H] compute dtype (scratch; L > 1)
  long long h_all, c_all;    // row 4's [L, T, R, H] compute dtype
  long long gates;           // row 4's [L, T, R, 4H] float32
  long long tb, masks;       // [L, 4H] float32; [L-1, T, R, H] int8 or 0
  double inv_keep;
  long long th_all, tc_all;  // [L, T, R, H] compute dtype
  long long tgates, th_last; // [L, T, R, 4H], [R, H] float32
  long long T, R, C, H, L, stream;
};
static_assert(sizeof(HvpFwdLaunch) == 24 * 8, "HvpFwdLaunch is 24 packed 8-byte fields");

// Row 10: layer 0's pack [x | h_0 shifted], then for each layer one NN
// product of two operand pairs (gemm_nn.cu) and one tangent forward
// recurrence of the plan (cs, hcp, rb), on `stream`, in that order. w_dt is
// the compute dtype (0 = float32, 1 = bfloat16). Returns 0, a cudaError_t
// code, or the product's negative refusal code (ops/gemm.py
// `_NN_REFUSALS`); the first failure stops the schedule.
extern "C" int wf_lstm_hvp_forward(const HvpFwdLaunch* p) {
  const long long* layer = reinterpret_cast<const long long*>(p + 1);
  const long long T = p->T, R = p->R, C = p->C, H = p->H, L = p->L, g4 = 4 * H;
  if (T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0 || T * R > 0x7fffffff ||
      C + H > 0x7fffffff || (p->w_dt != wf::kF32 && p->w_dt != wf::kBF16) ||
      (L > 1 && !p->next_in))
    return (int)cudaErrorInvalidValue;
  const long long tw = p->w_dt == wf::kBF16 ? 2 : 4;
  const long long res = T * R * H;  // one layer's [T, R, H]
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  int err = wf::launch_pack((int)p->w_dt, ptr(p->x), ptr(p->h_all), ptr(p->pack), T * R, (int)R,
                            (int)C, (int)H, s);
  if (err) return err;
  for (long long l = 0; l < L; ++l) {
    const long long k = l == 0 ? C : H;
    const long long h_l = p->h_all + l * res * tw;
    const bool top = l + 1 == L;
    float* tgates = reinterpret_cast<float*>(p->tgates) + l * 4 * res;
    NNLaunch g{};
    g.r_dt = p->w_dt;
    g.a1 = l == 0 ? p->tx : p->next_in;  // tin_l
    g.lda1 = l == 0 ? C : 3 * H;
    g.a1_f32 = l == 0 || p->w_dt == wf::kF32;
    g.b1 = layer[3 * l];  // Wx_l
    g.ldb1 = g4;
    g.k1 = k;
    g.a2 = l == 0 ? p->pack : p->next_in + H * tw;  // [in_l | h_l a step back]
    g.lda2 = l == 0 ? C + H : 3 * H;
    g.a2_f32 = p->w_dt == wf::kF32;
    g.b2 = layer[3 * l + 2];  // tW_l
    g.ldb2 = g4;
    g.k2 = k + H;
    g.c = reinterpret_cast<long long>(tgates);
    g.ldc = g4;
    g.scale = 1.0;
    g.M = T * R;
    g.N = g4;
    g.batch = 1;
    g.stream = p->stream;
    err = wf_gemm_nn(&g);
    if (err) return err;
    const wf::ScanFwdTan a{tgates,
                           reinterpret_cast<const float*>(p->gates) + l * 4 * res,
                           ptr(p->c_all + l * res * tw),
                           ptr(h_l),
                           top ? nullptr : ptr(h_l + res * tw),
                           ptr(layer[3 * l + 1]),
                           g4,
                           reinterpret_cast<const float*>(p->tb) + l * g4,
                           ptr(p->th_all + l * res * tw),
                           ptr(p->tc_all + l * res * tw),
                           top || !p->masks ? nullptr
                                            : reinterpret_cast<const int8_t*>(p->masks) + l * res,
                           (float)p->inv_keep,
                           top ? nullptr : ptr(p->next_in),
                           top ? reinterpret_cast<float*>(p->th_last) : nullptr,
                           (int)T,
                           (int)R,
                           (int)H,
                           (int)p->cs};
    err = wf::launch_scan_fwd_tan((int)p->w_dt, (int)p->hcp, (int)p->rb, a, s);
    if (err) return err;
  }
  return 0;
}

// The arguments of one tangent forward recurrence, 22 packed 8-byte fields
// (ops/fused_lstm_hvp.py `_SCAN_FWD_TAN`): wf::ScanFwdTan's with the plan.
struct ScanFwdTanLaunch {
  long long w_dt, cs, hcp, rb;
  long long tgates, gates, c_all, h_all, h_next, wh, ldw, tb, th_all, tc_all, mask;
  double inv_keep;
  long long next_in, th_last, T, R, H, stream;
};
static_assert(sizeof(ScanFwdTanLaunch) == 22 * 8, "ScanFwdTanLaunch is 22 packed 8-byte fields");

// One layer's tangent forward recurrence alone (wf::ScanFwdTan for the
// arguments), on the plan (cs, hcp, rb). Returns a cudaError_t code.
extern "C" int wf_lstm_tangent_forward_recurrence(const ScanFwdTanLaunch* p) {
  if (p->T > 0x7fffffff || p->R > 0x7fffffff || p->H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  const wf::ScanFwdTan a{static_cast<float*>(ptr(p->tgates)),
                         static_cast<const float*>(ptr(p->gates)),
                         ptr(p->c_all),
                         ptr(p->h_all),
                         ptr(p->h_next),
                         ptr(p->wh),
                         p->ldw,
                         static_cast<const float*>(ptr(p->tb)),
                         ptr(p->th_all),
                         ptr(p->tc_all),
                         static_cast<const int8_t*>(ptr(p->mask)),
                         (float)p->inv_keep,
                         ptr(p->next_in),
                         static_cast<float*>(ptr(p->th_last)),
                         (int)p->T,
                         (int)p->R,
                         (int)p->H,
                         (int)p->cs};
  return wf::launch_scan_fwd_tan((int)p->w_dt, (int)p->hcp, (int)p->rb, a,
                                 reinterpret_cast<cudaStream_t>(p->stream));
}

// The most clusters of the tangent forward recurrence's plan (cs, hcp, rb)
// at hidden width H that the card runs at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t code.
extern "C" int wf_lstm_tangent_forward_clusters(int w_dt, int cs, int hcp, int rb, int H) {
  wf::ScanFwdTan a{};
  a.T = a.R = 1;
  a.H = H;
  a.cs = cs;
  int n = 0;
  const int err = wf::launch_scan_fwd_tan(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}
