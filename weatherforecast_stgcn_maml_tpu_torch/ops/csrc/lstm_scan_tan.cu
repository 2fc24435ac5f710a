// One LSTM layer's tangent recurrence: the serial part of kernel row 11,
// the tangent of the merged stack's training backward (second-order MAML),
// which ops/fused_lstm_hvp.py `hvp_backward_schedule` walks layer by layer.
//
// Replaces the Pallas kernel `_hvpbwd_kernel_m` (+ `_hvpbwd_kernel_m_nomask`)
// of weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py, launched by
// `_hvpbwd_pallas_m`. The TPU kernel walks all T x L stages backwards as one
// chain, recomputing the primal backward and beside it its tangent, and
// contracts [tdgates | dgates] @ [[W], [tW]]^T a stage. Only the tangent
// carries are serial:
//     tdh_{t-1} = round(tdgates_t) @ round(Wh)^T + round(dgates_t) @ round(tWh)^T
//     tdc_{t-1} = tdc * f + dc * tf
// and the second term of tdh does not depend on the chain. So the schedule
// forms it for all steps off the chain (p below: one gemm_nn.cu product a
// layer), and this recurrence, from the layer's activated gates (row 4's),
// their tangents (row 10's), c_all and its tangent, the primal backward's
// dh and dc (row 5's, dc before the * f), walks t = T-1 .. 0 with the
// tangent carries (zero at t = T-1):
//     tdh = g[t] + p[t] + round(tdgates_{t+1}) @ round(Wh)^T   (p[T-1] = 0)
//     ttc = (1 - tanh(c)^2) tc
//     tdc = tdc_carry + tdh o (1 - tanh(c)^2) + dh to (1 - tanh(c)^2)
//           - dh o 2 tanh(c) ttc
//     tdgates = the tangents of [dc g i(1-i), dc c_{t-1} f(1-f),
//                                dc i (1-g^2), dh tanh(c) o(1-o)]
// writing tdgates [T, R, 4H] float32 and the bias tangent's partials (the
// column sums of tdgates over every step and each row tile's rows). g is
// the tangent of the gradient of the layer's h sequence: zero but the
// gradient's tangent at the top layer's last step, below it the input
// tangent of the layer above. The arithmetic is `_hvpbwd_kernel_m`'s lines
// for the tangents (weatherforecast_stgcn_maml_tpu/ops/fused_lstm_hvp.py).
//
// Bound: at the inner step's shapes (T = 24, R = 512, H = 128) a layer's
// recurrence is 1.61 GFLOP (0.024 ms at the card's float32 rate) and moves
// ~100 MB (the gates and their tangents in, tdgates out, seven [T, R, H]
// streams: 0.03 ms); neither bounds it. The T-step chain does.
//
// Design: lstm_scan_bwd.cuh's, whose contraction this is (round(tdgates)
// with Wh^T in place of round(dgates)): Wh^T stays in the shared memory of
// a cluster of cs blocks for all T steps, split by hidden units; a thread
// owns a row and 4 units, the tdc carry in its registers; round(tdgates)
// goes into the [RB, 4H] tile of every block of the cluster (distributed
// shared memory), one cluster barrier a step, the tiles in two alternating
// buffers. The cell reads 15 values a unit (row 5's reads 7), all loaded for
// step t-1 between the barrier's arrive and its wait; the plan
// (ops/fused_lstm_hvp.py `tangent_plan`) keeps RB <= 8, so a thread owns one
// (row, 4 units) and the inputs, the carry and the bias sums fit in its
// registers beside the contraction's.
#include <cstdint>

#include "common.cuh"
#include "lstm_scan_bwd.cuh"

namespace wf {
namespace {

struct ScanTan {
  const float* g;       // [T, R, H] tangent of the gradient of the h sequence
  const float* p;       // [T-1, R, H] round(dgates_{t+1}) @ round(tWh)^T, read at t < T-1
  const float* gates;   // [T, R, 4H] activated gates
  const float* tgates;  // [T, R, 4H] their tangents
  const void* c_all;    // [T, R, H] compute dtype
  const void* tc_all;   // [T, R, H] its tangent, compute dtype
  const float* dh_all;  // [T, R, H] the backward's dh
  const float* dc_all;  // [T, R, H] the backward's dc (before the * f)
  const void* wts;      // [cs, 4H, hcp] Wh^T's column slices (lstm_scan_bwd.cuh)
  float* tdgates;       // [T, R, 4H]
  float* db;            // [row tiles, ldb]: tile y's column sums of tdgates at db + y * ldb
  long long ldb;
  int T, R, H, cs;
};

// One step's inputs of 4 units of one row, as float32.
struct TanIn {
  float4 i, f, gg, o, ti, tf, tg, to;  // gates and their tangents
  float4 c, cp, tc, tcp, dh, dc, g;    // c_t, c_{t-1}, their tangents; dh, dc; g[t] + p[t]
};

// Load step t's inputs; c_t and tc_t only when !have_c (they are the step
// above's c_{t-1} and tc_{t-1}).
template <typename TC>
__device__ __forceinline__ void load_tan(const ScanTan& a, int t, int row, int j, bool have_c,
                                         TanIn& in) {
  const size_t gt = ((size_t)t * a.R + row) * 4 * a.H + j;
  in.i = load4(a.gates + gt);
  in.f = load4(a.gates + gt + a.H);
  in.gg = load4(a.gates + gt + 2 * a.H);
  in.o = load4(a.gates + gt + 3 * a.H);
  in.ti = load4(a.tgates + gt);
  in.tf = load4(a.tgates + gt + a.H);
  in.tg = load4(a.tgates + gt + 2 * a.H);
  in.to = load4(a.tgates + gt + 3 * a.H);
  const TC* c_all = static_cast<const TC*>(a.c_all);
  const TC* tc_all = static_cast<const TC*>(a.tc_all);
  const size_t o = ((size_t)t * a.R + row) * a.H + j;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!have_c) {
    in.c = load4(c_all + o);
    in.tc = load4(tc_all + o);
  }
  const size_t prev = o - (size_t)a.R * a.H;
  in.cp = t > 0 ? load4(c_all + prev) : zero;
  in.tcp = t > 0 ? load4(tc_all + prev) : zero;
  in.dh = load4(a.dh_all + o);
  in.dc = load4(a.dc_all + o);
  in.g = load4(a.g + o);
  if (t + 1 < a.T) in.g = add4(in.g, load4(a.p + o));
}

// The tangent cell of one unit: the gate-gradient tangents (di, df, dg,
// d_o) and the tdc carry into t-1, from tdh.
__device__ __forceinline__ void cell_tan(float i, float f, float gg, float o, float ti, float tf,
                                         float tg, float to, float c, float cp, float tc,
                                         float tcp, float dh, float dc, float tdh, float& tdcc,
                                         float& di, float& df, float& dg, float& d_o) {
  const float tch = tanhf(c);
  const float om = 1.f - tch * tch;
  const float ttc = om * tc;  // tangent of tanh(c)
  const float tdc = tdcc + tdh * o * om + dh * to * om - dh * o * (2.f * tch * ttc);
  const float si = i * (1.f - i), sf = f * (1.f - f), sg = 1.f - gg * gg, so = o * (1.f - o);
  di = tdc * gg * si + dc * tg * si + dc * gg * (1.f - 2.f * i) * ti;
  df = tdc * cp * sf + dc * tcp * sf + dc * cp * (1.f - 2.f * f) * tf;
  dg = tdc * i * sg + dc * ti * sg - dc * i * (2.f * gg * tg);
  d_o = tdh * tch * so + dh * ttc * so + dh * tch * (1.f - 2.f * o) * to;
  tdcc = tdc * f + dc * tf;
}

// Grid (cs, row tiles); clusters of cs blocks along x: block rank b owns
// units [b*hc, b*hc + hc) of the cluster's RB rows. 32 * UPT = hcp. Shared
// memory as lstm_scan_bwd_kernel's (scan_bwd_smem).
template <typename TW, int UPT, int RB>
__global__ void __launch_bounds__(kScanThreads, 1) lstm_scan_tan_kernel(const ScanTan a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int HCP = 32 * UPT;
  constexpr int EPT = (RB * HCP / 4 + kScanThreads - 1) / kScanThreads;  // (row, 4 units) a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int T = a.T, R = a.R, H = a.H, g4 = 4 * H;
  const int rank = (int)cluster.block_rank();
  const int hc = scan_units(H, a.cs);
  const int j0 = rank * hc;
  const int nq = max(0, min(hc, H - j0)) / 4;  // this block's 4-unit groups
  const int row0 = blockIdx.y * RB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  TW* w_s = reinterpret_cast<TW*>(smem + 16);           // [4H, HCP]
  TW* td_s = w_s + (size_t)g4 * HCP;                     // [2, RB, 4H] round(tdgates)
  float* part = reinterpret_cast<float*>(td_s + (size_t)2 * RB * g4);  // [8, RB, HCP]

  // The weight slice, copied while the first step's cell math runs.
  if (T > 1 && tid == 0)
    scan_copy_slice(bar, w_s, a.wts, rank, (unsigned)((size_t)g4 * HCP * sizeof(TW)));

  // Thread tid owns (row r, units j .. j+3) for e < EPT: pair tid + e * 256.
  int pr[EPT], pj[EPT];
  TanIn in[EPT];
  float4 tdcc[EPT];
  float4 dsum[EPT][4];  // the bias tangent's sums over the steps
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = tid + e * kScanThreads;
    pr[e] = nq > 0 && p < RB * nq ? p / nq : -1;
    pj[e] = nq > 0 ? j0 + 4 * (p % nq) : 0;
    tdcc[e] = zero;
#pragma unroll
    for (int q = 0; q < 4; ++q) dsum[e][q] = zero;
    in[e] = TanIn{zero, zero, zero, zero, zero, zero, zero, zero,
                  zero, zero, zero, zero, zero, zero, zero};
    if (pr[e] >= 0 && row0 + pr[e] < R) load_tan<TW>(a, T - 1, row0 + pr[e], pj[e], false, in[e]);
  }

  for (int t = T - 1; t >= 0; --t) {
    TW* tile = td_s + (size_t)(t & 1) * RB * g4;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0) continue;
      const int r = pr[e], j = pj[e], row = row0 + r;
      // tdh = g + p + the carry, the warps' partial sums added in order.
      const float4 carry = t < T - 1 ? scan_carry<RB, HCP>(part, r, j - j0) : zero;
      const float4 tdh = add4(in[e].g, carry);
      const TanIn& s = in[e];
      float4 d[4];
      cell_tan(s.i.x, s.f.x, s.gg.x, s.o.x, s.ti.x, s.tf.x, s.tg.x, s.to.x, s.c.x, s.cp.x,
               s.tc.x, s.tcp.x, s.dh.x, s.dc.x, tdh.x, tdcc[e].x, d[0].x, d[1].x, d[2].x, d[3].x);
      cell_tan(s.i.y, s.f.y, s.gg.y, s.o.y, s.ti.y, s.tf.y, s.tg.y, s.to.y, s.c.y, s.cp.y,
               s.tc.y, s.tcp.y, s.dh.y, s.dc.y, tdh.y, tdcc[e].y, d[0].y, d[1].y, d[2].y, d[3].y);
      cell_tan(s.i.z, s.f.z, s.gg.z, s.o.z, s.ti.z, s.tf.z, s.tg.z, s.to.z, s.c.z, s.cp.z,
               s.tc.z, s.tcp.z, s.dh.z, s.dc.z, tdh.z, tdcc[e].z, d[0].z, d[1].z, d[2].z, d[3].z);
      cell_tan(s.i.w, s.f.w, s.gg.w, s.o.w, s.ti.w, s.tf.w, s.tg.w, s.to.w, s.c.w, s.cp.w,
               s.tc.w, s.tcp.w, s.dh.w, s.dc.w, tdh.w, tdcc[e].w, d[0].w, d[1].w, d[2].w, d[3].w);
      if (row < R) {
        float* out = a.tdgates + ((size_t)t * R + row) * g4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store4(out + q * H, d[q]);
          dsum[e][q] = add4(dsum[e][q], d[q]);
        }
      }
      if (t > 0) {  // round(tdgates) into every block's tile (rows past R: zeros)
        TW* loc = tile + (size_t)r * g4 + j;
        for (int b = 0; b < a.cs; ++b) {
          TW* dst = cluster.map_shared_rank(loc, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) store4(dst + q * H, d[q]);
        }
      }
    }
    if (t == 0) break;  // no carry into t = -1
    // One cluster barrier a step (lstm_scan_bwd.cuh): step t-1's inputs are
    // loaded between arrive and wait.
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0 || row0 + pr[e] >= R) continue;
      in[e].c = in[e].cp;
      in[e].tc = in[e].tcp;
      load_tan<TW>(a, t - 1, row0 + pr[e], pj[e], true, in[e]);
    }
    cluster_wait();
    if (t == T - 1) mbar_wait(smem_u32(bar), 0);  // the weight slice has landed

    // The tdh carry of this block's units: [RB, 4H] x [4H, hc].
    scan_contract<TW, UPT, RB>(tile, w_s, part, g4, warp, lane);
    __syncthreads();  // the partial sums visible to the threads that own the units
  }

  scan_db_partial<RB, HCP, EPT>(part, pr, pj, dsum, j0, nq, H, a.db + blockIdx.y * a.ldb);
}

template <typename TW, int UPT, int RB>
int scan_tan_run(const ScanTan& a, cudaStream_t stream, int* max_clusters) {
  static bool opted[64] = {};
  return launch_cluster(lstm_scan_tan_kernel<TW, UPT, RB>, a, opted, a.cs,
                        (unsigned)((a.R + RB - 1) / RB), 1u,
                        scan_bwd_smem(a.H, 32 * UPT, RB, sizeof(TW)), stream, max_clusters);
}

template <typename TW, int UPT>
int scan_tan_rb(int rb, const ScanTan& a, cudaStream_t s, int* max_clusters) {
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
int scan_tan_hcp(int hcp, int rb, const ScanTan& a, cudaStream_t s, int* max_clusters) {
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

// Launch one tangent recurrence (or, with max_clusters, ask the occupancy
// of its clusters): w_dt (0 = float32, 1 = bfloat16) is the compute dtype,
// the weight slices', c_all's and tc_all's. The plan (a.cs blocks a
// cluster, hcp weight columns a block, rb rows a cluster) is the caller's:
// cs 1, 2, 4, 8 or 16, hcp 32, 64 or 128 and at least scan_units(H, cs),
// rb 2, 4 or 8, within 227 KB of shared memory. H is a multiple of 4;
// every array is 16-byte aligned (c_all and tc_all in bfloat16: 8-byte),
// ldb a multiple of 4. Returns a cudaError_t code: a plan or an argument it does not take is
// cudaErrorInvalidValue or cudaErrorMisalignedAddress; a cluster launch the
// card refuses returns the card's code. Nothing falls back to another kernel.
int launch_scan_tan(int w_dt, int hcp, int rb, const ScanTan& a, cudaStream_t s,
                    int* max_clusters = nullptr) {
  const bool bf16 = w_dt == kBF16;
  const size_t tw = bf16 ? 2 : 4;
  if ((w_dt != kF32 && !bf16) || (hcp != 32 && hcp != 64 && hcp != 128) ||
      (rb != 2 && rb != 4 && rb != 8) || !cluster_size_ok(a.cs) ||
      a.T <= 0 || a.R <= 0 || a.H <= 0 || a.H % 4 || scan_units(a.H, a.cs) > hcp ||
      (a.R + rb - 1) / rb > 65535 || scan_bwd_smem(a.H, hcp, rb, tw) > kScanMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!aligned_to(a.g, 16) || !aligned_to(a.p, 16) || !aligned_to(a.gates, 16) ||
      !aligned_to(a.tgates, 16) || !aligned_to(a.c_all, 4 * tw) ||
      !aligned_to(a.tc_all, 4 * tw) || !aligned_to(a.dh_all, 16) || !aligned_to(a.dc_all, 16) ||
      !aligned_to(a.wts, 16) || !aligned_to(a.tdgates, 16) || !aligned_to(a.db, 16) ||
      a.ldb % 4)
    return (int)cudaErrorMisalignedAddress;
  if (bf16) return scan_tan_hcp<__nv_bfloat16>(hcp, rb, a, s, max_clusters);
  return scan_tan_hcp<float>(hcp, rb, a, s, max_clusters);
}

}  // namespace
}  // namespace wf

// The arguments of one tangent recurrence, 20 packed 8-byte fields
// (ops/fused_lstm_hvp.py `_SCAN_TAN`).
struct ScanTanLaunch {
  long long w_dt, cs, hcp, rb;
  long long g, p, gates, tgates, c_all, tc_all, dh_all, dc_all, wts, tdgates, db, ldb;
  long long T, R, H, stream;
};
static_assert(sizeof(ScanTanLaunch) == 20 * 8, "ScanTanLaunch is 20 packed 8-byte fields");

// Row 11's tangent recurrence of one layer (wf::ScanTan for the arguments)
// on the plan (cs, hcp, rb). Returns a cudaError_t code.
extern "C" int wf_lstm_tangent_recurrence(const ScanTanLaunch* p) {
  if (p->T > 0x7fffffff || p->R > 0x7fffffff || p->H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  const wf::ScanTan a{static_cast<const float*>(ptr(p->g)),
                      static_cast<const float*>(ptr(p->p)),
                      static_cast<const float*>(ptr(p->gates)),
                      static_cast<const float*>(ptr(p->tgates)),
                      ptr(p->c_all),
                      ptr(p->tc_all),
                      static_cast<const float*>(ptr(p->dh_all)),
                      static_cast<const float*>(ptr(p->dc_all)),
                      ptr(p->wts),
                      static_cast<float*>(ptr(p->tdgates)),
                      static_cast<float*>(ptr(p->db)),
                      p->ldb,
                      (int)p->T,
                      (int)p->R,
                      (int)p->H,
                      (int)p->cs};
  return wf::launch_scan_tan((int)p->w_dt, (int)p->hcp, (int)p->rb, a,
                             reinterpret_cast<cudaStream_t>(p->stream));
}

// The most clusters of the tangent recurrence's plan (cs, hcp, rb) at hidden
// width H that the card runs at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t code. Its shared memory a block is the backward
// recurrence's (wf_lstm_stack_recurrence_smem).
extern "C" int wf_lstm_tangent_recurrence_clusters(int w_dt, int cs, int hcp, int rb, int H) {
  wf::ScanTan a{};
  a.T = a.R = 1;
  a.H = H;
  a.cs = cs;
  int n = 0;
  const int err = wf::launch_scan_tan(w_dt, hcp, rb, a, nullptr, &n);
  return err ? -err : n;
}
