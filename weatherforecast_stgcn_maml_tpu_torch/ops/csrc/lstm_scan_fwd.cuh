// One LSTM layer's forward recurrence, kept in a thread-block cluster: the
// serial part of kernel rows 4 (the merged stack's training forward), 14
// (the unmerged-gates stack's) and 16 (row 4 for V tasks, each with its own
// weights: the grid's z axis) and of the eval forwards of rows 2 and 20
// (row 14's schedule without residuals), which ops/fused_lstm_stack.py
// `forward_schedule` and the C entry of lstm_stack_fwd.cu walk layer by
// layer, and the whole of row 18 (one layer's recurrence, ops/lstm_scan.py).
//
// From xp [T, R, 4H] float32, round(in) @ round(Wx) of every step and row
// (gemm_nn.cu's product, without the bias; row 18's xp holds the bias), it
// walks t = 0 .. T-1 with h / c carries (zero at t = 0):
//     gates = act((xp[t] + b) + round(h_{t-1}) @ round(Wh))   (i, f, g, o)
//     c = f * c + i * g;  h = o * tanh(c)
// and writes the activated gates (float32, the backward's residual: over xp
// in place for rows 4 and 14, to an array of their own for row 18, or
// nowhere), h and c [T, R, H] in the compute dtype (rounded) or, for row
// 18, in float32 (either, where its pointer is null, nowhere: the eval
// forward of rows 2, 14 and 20 keeps no c, and its top layer no h), where a
// mask is given the next layer's input
// round(h * mask * inv_keep) [T, R, H] in the compute dtype (JAX's rounding
// point: from the float32 h, not from round(h)), and where asked the last
// step's h [R, H] in float32. The arithmetic is JAX's
// `fused_lstm_stack._fwd_kernel_m` (weatherforecast_stgcn_maml_tpu/ops/),
// which walks all T x L stages as one chain with one [in | h] @ [[Wx],
// [Wh]] contraction a stage, and `lstm_scan._fwd_kernel` (row 18); here the
// input half is one product a layer off the chain, and this recurrence
// contracts only round(h_{t-1}) with Wh.
//
// Bound: at the training shapes (T = 24, R = 512, H = 128) a layer's
// recurrence is 1.61 GFLOP (0.024 ms at the card's float32 rate) and moves
// 25 MB of xp in and gates out (0.015 ms); neither bounds it. The T-step
// chain does: streamed from L2 at every step, Wh alone (256 KB in float32)
// would cost ~17 us a step.
//
// Design, as the backward's (lstm_scan_bwd.cuh, whose helpers it uses): Wh
// stays in shared memory for all T steps, split by hidden units over a
// cluster of cs blocks (1-8, or 16 where 8 do not hold Wh: float32 H
// 260-436, bfloat16 H 440-512): block b holds the four gate columns of its
// hc units, [H, 4, hcp] (zero-padded to hcp), 128 KB at float32 H = 128
// with cs = 2, copied once a launch by cp.async while step 0 (which needs no
// weights: h_{-1} = 0) runs. A thread owns a row and 4 units of all four
// gates (4 x 4 gate values), so the c carry stays in its registers. A step: the block's 8
// warps contract the cluster's round(h_{t-1}) tile [RB, H] with their slice
// (warp w: gate w % 4 over half of K; lane: UPT units of every row; the h
// row read as broadcast 16-byte loads), write float32 partials [2, 4, RB,
// hcp], sync the block; the owners add the two halves in order to xp + b,
// apply the cell, store, and write round(h_t) of their units into the [RB,
// H] tile of every block of the cluster (distributed shared memory). The
// tiles alternate between two buffers, so one cluster barrier a step
// suffices: a partner's writes of step t never meet this block's reads of
// step t-1's tile. The grid is clusters x row tiles x tasks, sized
// (ops/fused_lstm_stack.py `forward_plan`, by task count) to fill the SMs in
// one wave: at R = 512, 64 clusters of 2 blocks x 8 rows in float32, 128
// blocks x 4 rows in bfloat16; R = 1024 (the adaptation step) and row 16's
// two tasks double the rows a cluster; validate's R = 1536 takes 48
// clusters of 2 x 32 rows in float32 (at 16 rows it would take three
// waves), 96 blocks x 16 rows in bfloat16. Task z reads and writes every array
// at z times its task stride (zero strides and one task: row 4's launch). The
// slice copy, the contraction, the partials' sum and the tile exchange are
// helpers (scan_fwd_*) that the tangent forward recurrence of row 10
// (lstm_scan_fwd_tan.cu) shares.
//
// Streamed slices (the STREAM variant, lstm_scan_bwd.cuh's design): where
// no cluster of 1-16 blocks holds Wh (float32 H > 436, bfloat16 H > 512), or
// where the eval forward's plan prefers it (ops/fused_lstm_stack.py
// `eval_plan`), Wh comes laid out as the blocks' slices [cs, H, 4, hcp]
// (`forward_weights`); a block copies the first k_res K-rows of its slice
// once a launch by bulk copies behind an mbarrier, and reads the other H -
// k_res rows at every step in chunks of kStreamChunk bytes through
// kStreamStages stage buffers (`SliceStream`), each warp its gate over its half of the
// resident rows and of every chunk, the two halves added in order as above.
// The resident kernel (k_res = H) is the variant STREAM = false, its code
// unchanged.
#pragma once

#include "lstm_scan_bwd.cuh"

namespace wf {
// Internal linkage: each source that includes this has its own copy.
namespace {

struct ScanFwd {
  const float* xp;     // [T, R, 4H] round(in) @ round(Wx) (row 18: + the bias)
  float* gates;        // [T, R, 4H] the activated gates (xp itself: in place), or null
  const void* wh;      // Wh [H, 4H] in the compute dtype, row stride ldw
  long long ldw;
  const float* bias;   // [4H], or null (xp holds it)
  void* h_all;         // [T, R, H] h, c: rounded to the compute dtype, or
  void* c_all;         //   float32 where out_f32 is set
  int out_f32;
  const int8_t* mask;  // [T, R, H] the next layer's dropout mask, or null
  float inv_keep;
  void* next_in;       // [T, R, H] round(h * mask * inv_keep), compute dtype (with mask)
  float* h_last;       // [R, H] the last step's h, or null
  int T, R, H, cs;
  int tasks = 1;  // the grid's z axis: task z reads and writes each array at z
                  // times its task stride below (in elements of its own type)
  long long sxp, sgates, sw, sbias, sres, smask, snext, slast;  // sres: h_all's, c_all's
  int k_res = -1;  // K-rows of each block's slice kept in shared memory, a
                   // multiple of 16 bytes' k values; the rest are streamed, and
                   // wh is the slices [cs, H, 4, hcp]. Negative or H: all of
                   // them, wh is Wh [H, 4H] (the resident kernel)
};

// Dynamic shared memory a block takes: its weight slice [H, 4, hcp] and two
// round(h) tiles [rb, H] in the compute dtype, and the warps' partial gates
// [2, 4, rb, hcp] float32.
inline size_t scan_fwd_smem(int H, int hcp, int rb, size_t tw) {
  return 4 * (size_t)H * hcp * tw + 2 * (size_t)rb * H * tw +
         8 * (size_t)rb * hcp * sizeof(float);
}

// The streamed variant's: its mbarriers (kStreamHeader bytes), the resident
// rows [k_res, 4, hcp] and kStreamStages stage buffers of a chunk's rows, the
// tiles and partials as above.
inline size_t scan_fwd_stream_smem(int H, int hcp, int rb, size_t tw, int k_res) {
  const size_t row = 4 * (size_t)hcp * tw;
  return kStreamHeader + ((size_t)k_res + kStreamStages * (size_t)stream_rows((int)row)) * row +
         2 * (size_t)rb * H * tw + 8 * (size_t)rb * hcp * sizeof(float);
}

// Four elements (16 bytes in float32, 8 in bfloat16) into shared memory,
// zero-filled where !ok.
template <typename TW>
__device__ __forceinline__ void cp_async_units(TW* dst, const TW* src, bool ok) {
  constexpr int kBytes = 4 * sizeof(TW);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
               "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0)
               : "memory");
}

// The block's weight slice: Wh[k, q*H + j0 + u] at w_s[(k*4 + q)*HCP + u]
// for its nu units, the columns past them zero-filled, by cp.async as one
// group: it lands while step 0 runs (cp.async.wait_all before step 1).
template <typename TW, int HCP>
__device__ __forceinline__ void scan_fwd_copy_slice(TW* w_s, const void* wh_, long long ldw,
                                                    int H, int j0, int nu) {
  const TW* wh = static_cast<const TW*>(wh_);
  constexpr int G = HCP / 4;  // 4-unit groups of a (k, gate) row
  for (int i = threadIdx.x; i < H * 4 * G; i += kScanThreads) {
    const int k = i / (4 * G), q = (i / G) % 4, u = (i % G) * 4;
    const bool ok = u < nu;
    cp_async_units(w_s + ((size_t)k * 4 + q) * HCP + u,
                   ok ? wh + (size_t)k * ldw + q * H + j0 + u : wh, ok);
  }
  cp_async_commit();
}

// Partial gates of this block's units: the round(h_{t-1}) tile hb [RB, H]
// x the slice [H, HCP] of gate q = warp % 4 over K half warp / 4 (lane:
// units lane*UPT .. +UPT-1 of every row, the h row read as broadcast
// 16-byte loads), into part [2, 4, RB, HCP] (`scan_fwd_partial` adds the
// halves).
template <typename TW, int UPT, int RB>
__device__ __forceinline__ void scan_fwd_contract(const TW* hb, const TW* w_s, float* part, int H,
                                                  int warp, int lane) {
  constexpr int HCP = 32 * UPT;
  constexpr int VK = 16 / sizeof(TW);  // k values a 16-byte load of an h row
  const int q = warp & 3, kh = warp >> 2;
  float acc[RB][UPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int p = 0; p < UPT; ++p) acc[r][p] = 0.f;
  const int nch = H / VK;
  const int c_hi = (kh + 1) * nch / 2;
  const TW* wl = w_s + (size_t)q * HCP + lane * UPT;
  for (int c = kh * nch / 2; c < c_hi; ++c) {
    const int k = c * VK;
    float w[VK][UPT];
#pragma unroll
    for (int u = 0; u < VK; ++u) load_units<UPT>(wl + (size_t)(k + u) * 4 * HCP, w[u]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float av[VK];
      load_k(hb + (size_t)r * H + k, av);
#pragma unroll
      for (int u = 0; u < VK; ++u)
#pragma unroll
        for (int p = 0; p < UPT; ++p) acc[r][p] = fmaf(av[u], w[u][p], acc[r][p]);
    }
  }
  float* pw = part + (size_t)(kh * 4 + q) * RB * HCP + lane * UPT;
#pragma unroll
  for (int r = 0; r < RB; ++r) store_units<UPT>(pw + (size_t)r * HCP, acc[r]);
}

// scan_fwd_contract's inner loop over the K-rows [k0, k0 + kn), the weight
// row k at w + (k - k0) * 4 * HCP, warp w's gate over its half of them, into
// the lane's sums acc.
template <typename TW, int UPT, int RB>
__device__ __forceinline__ void scan_fwd_accum(const TW* hb, const TW* w, int k0, int kn, int H,
                                               int warp, int lane, float (&acc)[RB][UPT]) {
  constexpr int HCP = 32 * UPT;
  constexpr int VK = 16 / sizeof(TW);
  const int q = warp & 3, kh = warp >> 2;
  const int nch = kn / VK;
  const int c_hi = (kh + 1) * nch / 2;
  const TW* wl = w + (size_t)q * HCP + lane * UPT;
  for (int c = kh * nch / 2; c < c_hi; ++c) {
    const int k = c * VK;
    float wv[VK][UPT];
#pragma unroll
    for (int u = 0; u < VK; ++u) load_units<UPT>(wl + (size_t)(k + u) * 4 * HCP, wv[u]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float av[VK];
      load_k(hb + (size_t)r * H + k0 + k, av);
#pragma unroll
      for (int u = 0; u < VK; ++u)
#pragma unroll
        for (int p = 0; p < UPT; ++p) acc[r][p] = fmaf(av[u], wv[u][p], acc[r][p]);
    }
  }
}

// scan_fwd_contract on a streamed slice: the resident rows, then the step's
// nc chunks from chunk g on (g advances past them); after each chunk the
// block syncs and thread 0 issues the chunk kStreamStages on into the freed
// buffer.
template <typename TW, int UPT, int RB, int KC>
__device__ __forceinline__ void scan_fwd_contract_stream(
    const TW* hb, const TW* w_s, const SliceStream<TW, 4 * 32 * UPT, KC>& st, int& g,
    float* part, int H, int warp, int lane) {
  constexpr int HCP = 32 * UPT;
  const int q = warp & 3, kh = warp >> 2;
  float acc[RB][UPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int p = 0; p < UPT; ++p) acc[r][p] = 0.f;
  scan_fwd_accum<TW, UPT, RB>(hb, w_s, 0, st.k_res, H, warp, lane, acc);
  for (int c = 0; c < st.nc; ++c, ++g) {
    int k0, kn;
    const TW* w = st.wait(g, k0, kn);
    scan_fwd_accum<TW, UPT, RB>(hb, w, k0, kn, H, warp, lane, acc);
    __syncthreads();  // every warp done with the buffer
    if (threadIdx.x == 0) st.issue(g + kStreamStages);
  }
  float* pw = part + (size_t)(kh * 4 + q) * RB * HCP + lane * UPT;
#pragma unroll
  for (int r = 0; r < RB; ++r) store_units<UPT>(pw + (size_t)r * HCP, acc[r]);
}

// Gate q's product of row r, units u .. u+3 (u from the block's first
// unit): the two K halves added in order.
template <int RB, int HCP>
__device__ __forceinline__ float4 scan_fwd_partial(const float* part, int q, int r, int u) {
  const float* pp = part + ((size_t)q * RB + r) * HCP + u;
  return add4(load4(pp), load4(pp + (size_t)4 * RB * HCP));
}

// round(v) of 4 units of one row into the tile at `loc` of every block of
// the cluster (distributed shared memory).
template <typename TW>
__device__ __forceinline__ void scan_fwd_share(cg::cluster_group& cluster, TW* loc, float4 v,
                                               int cs) {
  for (int b = 0; b < cs; ++b) store4(cluster.map_shared_rank(loc, b), v);
}

// The (row, 4 units) pairs of thread tid, pair tid + e * 256 for e < EPT:
// row pr[e] of the tile (-1: none) and first unit pj[e].
template <int RB, int EPT>
__device__ __forceinline__ void scan_fwd_pairs(int nq, int j0, int (&pr)[EPT], int (&pj)[EPT]) {
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = threadIdx.x + e * kScanThreads;
    pr[e] = nq > 0 && p < RB * nq ? p / nq : -1;
    pj[e] = nq > 0 ? j0 + 4 * (p % nq) : 0;
  }
}

// The cell of one unit: its activated gates into a[0..3], c and h updated.
__device__ __forceinline__ void cell_fwd(float pi, float pf, float pg, float po, float& c,
                                         float& h, float (&a)[4]) {
  a[0] = sigmoidf(pi);
  a[1] = sigmoidf(pf);
  a[2] = tanhf(pg);
  a[3] = sigmoidf(po);
  c = a[1] * c + a[0] * a[2];
  h = a[3] * tanhf(c);
}

// Grid (cs, row tiles, tasks); clusters of cs blocks along x: block rank b
// owns units [b*hc, b*hc + hc) of the cluster's RB rows. 32 * UPT = hcp.
// STREAM: the first a.k_res rows of the slice resident, the rest streamed.
template <typename TW, int UPT, int RB, bool STREAM>
__global__ void __launch_bounds__(kScanThreads, 1) lstm_scan_fwd_kernel(const ScanFwd tasks) {
  extern __shared__ __align__(128) unsigned char smem[];
  ScanFwd a = tasks;  // this block's task: each array z task strides on
  {
    const long long z = blockIdx.z;
    const size_t to = a.out_f32 ? sizeof(float) : sizeof(TW);  // h_all's and c_all's bytes
    a.xp = tasks.xp + z * tasks.sxp;
    if (a.gates) a.gates = tasks.gates + z * tasks.sgates;
    a.wh = static_cast<const TW*>(tasks.wh) + z * tasks.sw;
    if (a.bias) a.bias = tasks.bias + z * tasks.sbias;
    if (a.h_all) a.h_all = static_cast<char*>(tasks.h_all) + z * tasks.sres * to;
    if (a.c_all) a.c_all = static_cast<char*>(tasks.c_all) + z * tasks.sres * to;
    if (a.mask) a.mask = tasks.mask + z * tasks.smask;
    if (a.next_in) a.next_in = static_cast<TW*>(tasks.next_in) + z * tasks.snext;
    if (a.h_last) a.h_last = tasks.h_last + z * tasks.slast;
  }
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
  constexpr int KC = stream_rows(4 * HCP * sizeof(TW));  // STREAM: rows a chunk
  const int k_res = STREAM ? a.k_res : H;                  // resident rows of the slice
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);       // STREAM: 1 + stages mbarriers
  TW* w_s = reinterpret_cast<TW*>(smem + (STREAM ? kStreamHeader : 0));  // [k_res, 4, HCP]
  // STREAM: the stage buffers [kStreamStages, KC, 4, HCP] after the resident rows.
  TW* h_s = w_s + (size_t)k_res * 4 * HCP +
            (STREAM ? kStreamStages * KC * 4 * HCP : 0);  // [2, RB, H]
  float* part = reinterpret_cast<float*>(h_s + (size_t)2 * RB * H);  // [2, 4, RB, HCP]
  SliceStream<TW, 4 * HCP, KC> st{};
  int chunk = 0;  // STREAM: the next chunk a contraction reads
  if constexpr (STREAM) {
    st.full = bar + 1;
    st.stage = w_s + (size_t)k_res * 4 * HCP;
    st.slice = static_cast<const TW*>(a.wh) + (size_t)rank * H * 4 * HCP;
    st.k_res = k_res;
    st.K = H;
    st.nc = (H - k_res + KC - 1) / KC;
    st.total = (T - 1) * st.nc;
    if (T > 1 && tid == 0) st.start(bar, w_s);
  } else {
    if (T > 1) scan_fwd_copy_slice<TW, HCP>(w_s, a.wh, a.ldw, H, j0, nu);
  }

  int pr[EPT], pj[EPT];
  scan_fwd_pairs<RB, EPT>(nq, j0, pr, pj);
  float4 xp[EPT][4], bias[EPT][4], cc[EPT];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    cc[e] = zero;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xp[e][q] = zero;
      bias[e][q] = pr[e] >= 0 && a.bias ? load4(a.bias + q * H + pj[e]) : zero;
    }
    if (pr[e] >= 0 && row0 + pr[e] < R) {
      const float* gt = a.xp + (size_t)(row0 + pr[e]) * g4 + pj[e];
#pragma unroll
      for (int q = 0; q < 4; ++q) xp[e][q] = load4(gt + q * H);
    }
  }

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      const TW* hb = h_s + (size_t)((t - 1) & 1) * RB * H;
      if constexpr (STREAM)
        scan_fwd_contract_stream<TW, UPT, RB, KC>(hb, w_s, st, chunk, part, H, warp, lane);
      else
        scan_fwd_contract<TW, UPT, RB>(hb, w_s, part, H, warp, lane);
      __syncthreads();  // the partials visible to the threads that own the units
    }

    TW* hn = h_s + (size_t)(t & 1) * RB * H;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0) continue;
      const int r = pr[e], j = pj[e], row = row0 + r;
      float4 pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pre[q] = add4(xp[e][q], bias[e][q]);
        if (t > 0) pre[q] = add4(pre[q], scan_fwd_partial<RB, HCP>(part, q, r, j - j0));
      }
      float act[4][4];  // [unit][gate]
      float4 h;
      cell_fwd(pre[0].x, pre[1].x, pre[2].x, pre[3].x, cc[e].x, h.x, act[0]);
      cell_fwd(pre[0].y, pre[1].y, pre[2].y, pre[3].y, cc[e].y, h.y, act[1]);
      cell_fwd(pre[0].z, pre[1].z, pre[2].z, pre[3].z, cc[e].z, h.z, act[2]);
      cell_fwd(pre[0].w, pre[1].w, pre[2].w, pre[3].w, cc[e].w, h.w, act[3]);
      if (row < R) {
        if (a.gates) {
          float* gt = a.gates + ((size_t)t * R + row) * g4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            store4(gt + q * H, make_float4(act[0][q], act[1][q], act[2][q], act[3][q]));
        }
        const size_t o = ((size_t)t * R + row) * H + j;
        if (std::is_same<TW, float>::value || a.out_f32) {
          if (a.h_all) store4(static_cast<float*>(a.h_all) + o, h);
          if (a.c_all) store4(static_cast<float*>(a.c_all) + o, cc[e]);
        } else {
          if (a.h_all) store4(static_cast<TW*>(a.h_all) + o, h);
          if (a.c_all) store4(static_cast<TW*>(a.c_all) + o, cc[e]);
        }
        if (a.next_in) {
          const char4 m = *reinterpret_cast<const char4*>(a.mask + o);
          store4(static_cast<TW*>(a.next_in) + o,
                 make_float4(h.x * ((float)m.x * a.inv_keep), h.y * ((float)m.y * a.inv_keep),
                             h.z * ((float)m.z * a.inv_keep), h.w * ((float)m.w * a.inv_keep)));
        }
        if (a.h_last && t == T - 1) store4(a.h_last + (size_t)row * H + j, h);
      }
      // round(h_t) into every block's tile (rows past R too)
      if (t + 1 < T) scan_fwd_share(cluster, hn + (size_t)r * H + j, h, a.cs);
    }
    if (t + 1 == T) break;
    // One cluster barrier a step: every block's tile of step t written (the
    // arrive releases this block's writes), and every block done with step
    // t's contraction, so the partials and the other tile are free. Step
    // t+1's xp is loaded between arrive and wait.
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0 || row0 + pr[e] >= R) continue;
      const float* gt = a.xp + ((size_t)(t + 1) * R + row0 + pr[e]) * g4 + pj[e];
#pragma unroll
      for (int q = 0; q < 4; ++q) xp[e][q] = load4(gt + q * H);
    }
    cluster_wait();
    if (t == 0) {  // the weight slice has landed (each thread's copies, then all)
      if constexpr (STREAM) {
        mbar_wait(smem_u32(bar), 0);
      } else {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
      }
    }
  }
}

// Launch one kernel instance, or (max_clusters not null) ask how many of
// its clusters fit on the card at once.
template <typename TW, int UPT, int RB, bool STREAM>
int scan_fwd_run(const ScanFwd& a, cudaStream_t stream, int* max_clusters) {
  static bool opted[64] = {};
  const int hcp = 32 * UPT;
  return launch_cluster(lstm_scan_fwd_kernel<TW, UPT, RB, STREAM>, a, opted, a.cs,
                        (unsigned)((a.R + RB - 1) / RB), (unsigned)a.tasks,
                        STREAM ? scan_fwd_stream_smem(a.H, hcp, RB, sizeof(TW), a.k_res)
                               : scan_fwd_smem(a.H, hcp, RB, sizeof(TW)),
                        stream, max_clusters);
}

// The streamed variant is built at row tiles of 8 and 16 (`kStreamTilesFwd`),
// but for 16 rows at 4 bfloat16 units a lane (its registers would spill).
constexpr unsigned kStreamTilesFwd = 8u | 16u;

template <typename TW, int UPT, bool STREAM>
int scan_fwd_rb(int rb, const ScanFwd& a, cudaStream_t s, int* max_clusters) {
  switch (rb) {
    case 2:
      if constexpr (!STREAM) return scan_fwd_run<TW, UPT, 2, STREAM>(a, s, max_clusters);
      break;
    case 4:
      if constexpr (!STREAM) return scan_fwd_run<TW, UPT, 4, STREAM>(a, s, max_clusters);
      break;
    case 8:
      return scan_fwd_run<TW, UPT, 8, STREAM>(a, s, max_clusters);
    case 16:
      if constexpr (!STREAM || !(sizeof(TW) == 2 && UPT == 4))
        return scan_fwd_run<TW, UPT, 16, STREAM>(a, s, max_clusters);
      break;
    case 32:  // validate's 1536 rows in one wave. Its accumulators and a
              // 16-byte load's weights fit in registers (no spill) only where
              // the k values of the load times the units a lane are at most 8:
              // float32 at UPT <= 2, bfloat16 at UPT 1.
      if constexpr (!STREAM && 16 / sizeof(TW) * UPT <= 8)
        return scan_fwd_run<TW, UPT, 32, STREAM>(a, s, max_clusters);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TW, bool STREAM>
int scan_fwd_hcp(int hcp, int rb, const ScanFwd& a, cudaStream_t s, int* max_clusters) {
  switch (hcp) {
    case 32:
      return scan_fwd_rb<TW, 1, STREAM>(rb, a, s, max_clusters);
    case 64:
      return scan_fwd_rb<TW, 2, STREAM>(rb, a, s, max_clusters);
    case 128:
      return scan_fwd_rb<TW, 4, STREAM>(rb, a, s, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether a forward recurrence's plan (a cs-block cluster, hcp weight
// columns a block and gate, rb rows a cluster) and shape are ones the
// kernels take: cs 1, 2, 4, 8 or 16 (`cluster_size_ok`), hcp 32, 64 or
// 128 and at least scan_units(H, cs), rb among `tiles` (a bit a row tile: 2, 4, 8, 16, and
// 32 at hcp <= 64 in float32, hcp 32 in bfloat16), within 227 KB of shared
// memory; H a multiple of 4 in float32 and of 8 in bfloat16 (the h tile's
// 16-byte loads); 1 to 65535 tasks. A streamed plan (k_res in [0, H): a
// multiple of 16 bytes' k values) takes the tiles of `kStreamTilesFwd`.
inline bool scan_fwd_plan_ok(bool bf16, int hcp, int rb, int cs, int T, int R, int H,
                             unsigned tiles, int tasks = 1, int k_res = -1) {
  const bool stream = k_res >= 0 && k_res < H;
  const size_t tw = bf16 ? 2 : 4;
  return (hcp == 32 || hcp == 64 || hcp == 128) &&
         (rb == 2 || rb == 4 || rb == 8 || rb == 16 ||
          (rb == 32 && hcp <= (bf16 ? 32 : 64))) &&
         (tiles & (unsigned)rb) && cluster_size_ok(cs) && T > 0 && R > 0 &&
         H > 0 && H % (bf16 ? 8 : 4) == 0 && scan_units(H, cs) <= hcp &&
         (R + rb - 1) / rb <= 65535 && tasks > 0 && tasks <= 65535 &&
         (stream ? (kStreamTilesFwd & (unsigned)rb) && k_res % (16 / (int)tw) == 0 &&
                       scan_fwd_stream_smem(H, hcp, rb, tw, k_res) <= kScanMaxSmem
                 : scan_fwd_smem(H, hcp, rb, tw) <= kScanMaxSmem);
}

// Launch one forward recurrence on `stream` (or, with max_clusters, ask the
// occupancy of its clusters): w_dt (0 = float32, 1 = bfloat16) is the
// compute dtype, Wh's and the residuals'. The plan (a.cs, hcp, rb) is the
// caller's (`scan_fwd_plan_ok`). ldw is a multiple of 4; xp, gates, bias
// and h_last are 16-byte aligned, Wh, next_in and h_all / c_all (float32
// with out_f32, else in the compute dtype) aligned to 4 elements, the mask
// to 4 bytes; mask and next_in come together; each task stride keeps its
// array's alignment (a multiple of 4 elements). Returns a cudaError_t code: a
// plan or an argument it does not take is cudaErrorInvalidValue or
// cudaErrorMisalignedAddress; a cluster launch the card refuses returns the
// card's code. Nothing falls back to another kernel. A template of the
// argument type (always ScanFwd), so that a source that includes this header
// for its helpers alone instantiates none of the kernel's instances.
template <typename Args>
int launch_scan_fwd(int w_dt, int hcp, int rb, const Args& a, cudaStream_t s,
                    int* max_clusters = nullptr) {
  const bool bf16 = w_dt == kBF16;
  const size_t tw = bf16 ? 2 : 4;
  const size_t to = a.out_f32 ? 4 : tw;
  const bool stream = a.k_res >= 0 && a.k_res < a.H;
  if ((w_dt != kF32 && !bf16) ||
      !scan_fwd_plan_ok(bf16, hcp, rb, a.cs, a.T, a.R, a.H, 62u, a.tasks, a.k_res) ||
      !a.mask != !a.next_in)
    return (int)cudaErrorInvalidValue;
  // A streamed plan's slices are read by bulk copies: 16-byte aligned, and so
  // is each task's (a multiple of 16 bytes' elements).
  if (!aligned_to(a.xp, 16) || !aligned_to(a.gates, 16) || !aligned_to(a.bias, 16) ||
      !aligned_to(a.h_last, 16) || !aligned_to(a.wh, stream ? 16 : 4 * tw) ||
      !aligned_to(a.h_all, 4 * to) || !aligned_to(a.c_all, 4 * to) ||
      !aligned_to(a.next_in, 4 * tw) || !aligned_to(a.mask, 4) || a.ldw % 4 || a.sxp % 4 ||
      a.sgates % 4 || a.sw % (stream ? 16 / (long long)tw : 4) || a.sbias % 4 || a.sres % 4 ||
      a.smask % 4 || a.snext % 4 || a.slast % 4)
    return (int)cudaErrorMisalignedAddress;
  if (stream) {
    if (bf16) return scan_fwd_hcp<__nv_bfloat16, true>(hcp, rb, a, s, max_clusters);
    return scan_fwd_hcp<float, true>(hcp, rb, a, s, max_clusters);
  }
  if (bf16) return scan_fwd_hcp<__nv_bfloat16, false>(hcp, rb, a, s, max_clusters);
  return scan_fwd_hcp<float, false>(hcp, rb, a, s, max_clusters);
}

}  // namespace
}  // namespace wf
