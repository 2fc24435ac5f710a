// One LSTM layer's backward recurrence: the device code that kernel rows 5
// (the merged stack's training backward), 15 (the unmerged-gates stack's;
// both through the entry in fused_lstm_split.cu) and 19 (lstm_scan.cu) share.
//
// From the gradient g [T, R, H] of the layer's h sequence, its activated
// gates [T, R, 4H] (float32) and its cell states c_all [T, R, H], it walks
// t = T-1 .. 0 with dh / dc carries (zero at t = T-1):
//     dh = g[t] + dh_carry;  dc = dc_carry + dh * o * (1 - tanh(c_t)^2)
//     dgates = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i (1-g^2),
//               dh * tanh(c_t) * o(1-o)]                  (c_{-1} = 0)
//     dh_carry = round(dgates) @ round(Wh)^T;  dc_carry = dc * f
// and writes dgates [T, R, 4H] float32 and, where asked, each step's dh and
// dc (before the * f) [T, R, H] float32: the carries the second-order
// backward (lstm_scan_tan.cu) reads; and, where asked, the bias gradient's
// partials: the float32 column sums of dgates over every step and the rows
// of each row tile. The arithmetic is JAX's
// (weatherforecast_stgcn_maml_tpu/ops/): `fused_lstm_stack._bwd_kernel_m`
// for row 5, `fused_lstm_stack._bwd_kernel` for row 15, `fused_lstm_stack.
// _bwd_kernel_mv` for row 17 (V tasks, each with its own weights: the
// grid's z axis), `lstm_scan._bwd_kernel` for row 19. Those TPU kernels walk
// the stack as one chain; here each layer's gate products (row 15), input
// gradient and weight gradients are products off this chain
// (ops/fused_lstm_stack.py `backward_schedule`), and this recurrence is the
// only serial work.
//
// Bound: at the training shapes (T = 24, R = 512, H = 128) a layer is 1.61
// GFLOP (0.024 ms at the card's float32 rate) and moves 2 x 25 MB of gates
// and dgates (0.015 ms): neither bounds it. The T-step chain does, and
// each step contracts [rows, 4H] with all of Wh^T [4H, H] (256 KB in
// float32): streamed from L2 at every step, Wh^T alone costs ~17 us a step
// on an H100, 0.40 ms a layer.
//
// Design: Wh^T stays in shared memory for all T steps. Its H columns are
// split across a thread-block cluster of cs blocks, the smallest power of
// two (at most 8, or Hopper's non-portable 16 where 8 do not hold it)
// whose slice [4H, hc] fits beside the dgates tiles: float32 H = 128 takes
// 2 blocks of 128 KB, bfloat16 H = 128 one block, float32 H = 256 eight,
// float32 H = 260-396 and bfloat16 H = 420-512 sixteen (hc <= 32 units).
// Each block copies its slice once a launch (bulk
// copies behind an mbarrier, overlapping the first step's gate math) and
// owns the dh / dc carries of its hc units for the cluster's RB rows. A
// step: the block's threads form the dgates of its units (thread: a row and
// 4 units, the dc carry in its registers), write round(dgates) into the
// [RB, 4H] tile of every block of the cluster (distributed shared memory),
// sync the cluster once, and contract the whole tile with their slice: each
// warp an eighth of K, each lane UPT units of all RB rows (one broadcast
// 16-byte load of a dgates row per 16 bytes of K, one vector load of its
// units' weights per k), the warps' partial sums added in a fixed order by
// the threads that own the units. The tiles alternate between two buffers,
// so a partner's writes for step t-1 never meet this block's reads of step
// t, and one cluster barrier a step suffices. The grid is clusters x row
// tiles, sized (ops/fused_lstm_stack.py `recurrence_plan`) to fill the SMs
// in one wave: at R = 512, 64 clusters of 2 blocks x 8 rows in float32,
// 128 blocks x 4 rows in bfloat16; row 17's V tasks multiply the row tiles
// by V (V = 2: 32 clusters of 2 blocks x 16 rows a task in float32). c_all
// is read in its stored dtype TC: float32 for row 19 (its forward's own),
// the compute dtype for rows 5, 15 and 17 (JAX's residual contract).
// The bias gradient (row 17) costs no pass of its own: each thread adds its
// float32 dgates over the steps in registers, and after the last step the
// block adds its rows' sums in row order into one partial a row tile
// (ops/gemm.py `sum_splits` adds the tiles in order: no atomics).
//
// Streamed slices (the STREAM variant): where no cluster of 1-16 blocks holds
// Wh^T (float32 H > 396, bfloat16 H > 512), a block keeps the first k_res
// K-rows of its slice [4H, hcp] in shared memory, copied once a launch as
// above, and reads the other 4H - k_res rows from global memory at every
// step, where they stay L2-resident across the steps and the clusters: in
// chunks of kStreamChunk bytes, by bulk copies (cp.async.bulk, the TMA's
// one-dimensional form) into kStreamStages stage buffers behind an mbarrier
// each, so that that many chunks are in flight. A chunk costs the block a
// wait and a barrier, and its loop is short: large chunks amortise both. The first chunks of a step are issued while
// the step before contracts its last ones, so they land during the gate
// math, the cluster barrier and the contraction of the resident rows; each
// chunk consumed frees its buffer for the chunk kStreamStages after it. Each warp takes its eighth of the resident rows
// and of every chunk; the warps' partial sums are added in warp order as
// above, and the arithmetic (round(dgates) @ round(Wh)^T, float32
// accumulation) is the resident kernel's. The resident kernel (k_res = 4H) is
// the variant STREAM = false, its code unchanged.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace wf {
// Internal linkage: each source that includes this has its own copy.
namespace {

namespace cg = cooperative_groups;

struct ScanBwd {
  const float* g;      // [T, R, H] gradient of the h sequence
  const float* gates;  // [T, R, 4H] activated gates
  const void* c_all;   // [T, R, H] in TC
  const void* wts;     // [cs, 4H, hcp] in the compute dtype: block b's slice
                       // Wh^T[:, b*hc : b*hc + hc], zero-padded to hcp columns
  float* dgates;       // [T, R, 4H]
  float* dh_all;       // [T, R, H] each step's dh, or null
  float* dc_all;       // [T, R, H] each step's dc, or null (with dh_all)
  int T, R, H;
  int cs;     // blocks a cluster
  int tasks;  // the grid's z axis: task z reads and writes each array below
              // at z times its task stride (in elements of its own type)
  long long sg, sgates, sc, sw, sdg, sdh;  // sdh: dh_all's and dc_all's
  float* db;  // [z * sdb + tile * ldb + n] (n < 4H): the column sums of
              // dgates over every step and the tile's rows, or null
  long long sdb, ldb;
  int k_res = -1;  // K-rows of each block's slice kept in shared memory, a
                   // multiple of 16 bytes' k values; the rest are streamed.
                   // Negative or 4H: all of them (the resident kernel)
};

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr size_t kScanMaxSmem = 232448;  // 227 KB opt-in per block
constexpr unsigned kBulkChunk = 32768;   // bytes a bulk copy of the weight slice
constexpr int kStreamChunk = 32768;      // bytes a chunk of a streamed slice's rows
constexpr int kStreamStages = 2;         // chunks in flight (stage buffers)
constexpr int kStreamHeader = 64;        // the streamed variants' mbarriers: 1 + stages

// Rows of one streamed chunk whose rows take row_bytes each (a multiple of
// 16 bytes' k values at every weight-column count and dtype the plans use).
__host__ __device__ constexpr int stream_rows(int row_bytes) { return kStreamChunk / row_bytes; }

// The hidden units each block of a cs-block cluster owns: a multiple of 4.
__host__ __device__ inline int scan_units(int H, int cs) {
  return (H + 4 * cs - 1) / (4 * cs) * 4;
}

// Dynamic shared memory a block takes: its mbarrier (16 B), its weight
// slice [4H, hcp] and two round(dgates) tiles [rb, 4H] in the compute dtype,
// and the warps' partial carries [8, rb, hcp] float32.
inline size_t scan_bwd_smem(int H, int hcp, int rb, size_t tw) {
  return 16 + 4 * (size_t)H * hcp * tw + 2 * (size_t)rb * 4 * H * tw +
         (size_t)kScanWarps * rb * hcp * sizeof(float);
}

// The streamed variant's: its mbarriers (kStreamHeader bytes), the resident
// rows [k_res, hcp] and kStreamStages stage buffers of a chunk's rows, the
// tiles and partials as above.
inline size_t scan_bwd_stream_smem(int H, int hcp, int rb, size_t tw, int k_res) {
  const size_t row = (size_t)hcp * tw;
  return kStreamHeader + ((size_t)k_res + kStreamStages * (size_t)stream_rows((int)row)) * row +
         2 * (size_t)rb * 4 * H * tw + (size_t)kScanWarps * rb * hcp * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Four consecutive values as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
}
// Four values stored in T (rounded to nearest even for bfloat16).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// 16 bytes of one dgates row: 4 (float32) or 8 (bfloat16) k values.
__device__ __forceinline__ void load_k(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void load_k(const __nv_bfloat16* p, float (&a)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  a[0] = bf_lo(v.x);
  a[1] = bf_hi(v.x);
  a[2] = bf_lo(v.y);
  a[3] = bf_hi(v.y);
  a[4] = bf_lo(v.z);
  a[5] = bf_hi(v.z);
  a[6] = bf_lo(v.w);
  a[7] = bf_hi(v.w);
}

// A lane's UPT consecutive units of one weight row.
template <int UPT>
__device__ __forceinline__ void load_units(const float* p, float (&w)[UPT]) {
  if constexpr (UPT == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (UPT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = *p;
  }
}
template <int UPT>
__device__ __forceinline__ void load_units(const __nv_bfloat16* p, float (&w)[UPT]) {
  if constexpr (UPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = bf_lo(v.x);
    w[1] = bf_hi(v.x);
    w[2] = bf_lo(v.y);
    w[3] = bf_hi(v.y);
  } else if constexpr (UPT == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    w[0] = bf_lo(v);
    w[1] = bf_hi(v);
  } else {
    w[0] = __bfloat162float(*p);
  }
}
template <int UPT>
__device__ __forceinline__ void store_units(float* p, const float (&v)[UPT]) {
  if constexpr (UPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (UPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The two halves of a cluster barrier (release on arrive, acquire on wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One step's inputs of 4 units of one row, as float32.
struct StepIn {
  float4 i, f, gg, o, c, cp, g;  // gates, c_t, c_{t-1}, the gradient of h_t
};

// Load step t's inputs; c_t only when !have_c (it is the step above's c_{t-1}).
template <typename TC>
__device__ __forceinline__ void load_step(const ScanBwd& a, int t, int row, int j,
                                          bool have_c, StepIn& in) {
  const TC* c_all = static_cast<const TC*>(a.c_all);
  const float* gt = a.gates + ((size_t)t * a.R + row) * 4 * a.H + j;
  in.i = load4(gt);
  in.f = load4(gt + a.H);
  in.gg = load4(gt + 2 * a.H);
  in.o = load4(gt + 3 * a.H);
  const size_t o = ((size_t)t * a.R + row) * a.H + j;
  if (!have_c) in.c = load4(c_all + o);
  in.cp = t > 0 ? load4(c_all + o - (size_t)a.R * a.H) : make_float4(0.f, 0.f, 0.f, 0.f);
  in.g = load4(a.g + o);
}

// The cell's backward for one unit: the gate gradients d[0..3] (i, f, g,
// o), dc, and the dc carry into t-1.
__device__ __forceinline__ void cell_bwd(float gi, float gf, float gg, float go, float c,
                                         float cp, float dh, float& dcc, float& di, float& df,
                                         float& dg, float& d_o, float& dc) {
  const float tc = tanhf(c);
  dc = dcc + dh * go * (1.f - tc * tc);
  d_o = dh * tc * go * (1.f - go);
  di = dc * gg * gi * (1.f - gi);
  df = dc * cp * gf * (1.f - gf);
  dg = dc * gi * (1.f - gg * gg);
  dcc = dc * gf;
}

// Thread 0: block `rank`'s weight slice (`bytes` of wts from rank * bytes)
// into w_s by bulk copies that complete on the mbarrier `bar`; the block
// waits for it with mbar_wait(smem_u32(bar), 0) before its first read.
template <typename TW>
__device__ __forceinline__ void scan_copy_slice(uint64_t* bar, TW* w_s, const void* wts,
                                                int rank, unsigned bytes) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  const char* src = static_cast<const char*>(wts) + (size_t)rank * bytes;
  for (unsigned off = 0; off < bytes; off += kBulkChunk) {
    const unsigned n = bytes - off < kBulkChunk ? bytes - off : kBulkChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(w_s) + off),
        "l"(src + off), "r"(n), "r"(b)
        : "memory");
  }
}

// Thread 0: `bytes` from src into shared memory at dst, completing on the
// mbarrier `bar` (its arrival and the transaction count in one), by bulk
// copies of at most kBulkChunk bytes.
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst, const void* src,
                                          unsigned bytes) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  for (unsigned off = 0; off < bytes; off += kBulkChunk) {
    const unsigned n = bytes - off < kBulkChunk ? bytes - off : kBulkChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(dst) + off),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

// A block's streamed slice: rows [0, k_res) of its K rows resident, the rest
// read a chunk of KC rows at a time into kStreamStages stage buffers. Chunk g
// (counted over every step: g = (step - 1) * nc + c for the c-th of the
// step's nc chunks) lands in buffer g % S on mbarrier full[g % S], its
// (g / S)-th completion (S = kStreamStages).
template <typename TW, int ROW, int KC>
struct SliceStream {
  static constexpr int S = kStreamStages;
  uint64_t* full;     // [S] mbarriers
  TW* stage;          // [S, KC, ROW]
  const TW* slice;    // this block's slice [K, ROW] in global memory
  int k_res, K, nc, total;

  // Thread 0: chunk g into its buffer (none past the last step's).
  __device__ __forceinline__ void issue(int g) const {
    if (g >= total) return;
    const int k0 = k_res + (g % nc) * KC, kn = min(KC, K - k0);
    // The buffer's last reads (generic proxy) before the copy's writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(full + g % S, stage + (size_t)(g % S) * KC * ROW, slice + (size_t)k0 * ROW,
              (unsigned)((size_t)kn * ROW * sizeof(TW)));
  }
  // Thread 0 at the launch, before any thread waits on them: the mbarriers
  // (resident copy `res`, then the S stage buffers'), the resident rows into
  // w_s and the first S chunks.
  __device__ __forceinline__ void start(uint64_t* res, TW* w_s) const {
    for (int i = 0; i <= S; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(res + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(res, w_s, slice, (unsigned)((size_t)k_res * ROW * sizeof(TW)));
    for (int g = 0; g < S; ++g) issue(g);
  }
  // Every thread: wait for chunk g; -> its buffer and its rows [k0, k0 + kn).
  __device__ __forceinline__ const TW* wait(int g, int& k0, int& kn) const {
    mbar_wait(smem_u32(full + g % S), (uint32_t)((g / S) & 1));
    k0 = k_res + (g % nc) * KC;
    kn = min(KC, K - k0);
    return stage + (size_t)(g % S) * KC * ROW;
  }
};

// The carry of this block's units: the tile [RB, 4H] (compute dtype) x its
// weight slice [4H, HCP], warp w over its eighth of K; lane: units lane*UPT
// .. +UPT-1 of every row (one broadcast 16-byte load of a tile row per 16
// bytes of K, one vector load of its units' weights per k); the warps'
// partial sums into part [8, RB, HCP] (`scan_carry` adds them).
template <typename TW, int UPT, int RB>
__device__ __forceinline__ void scan_contract(const TW* tile, const TW* w_s, float* part,
                                              int g4, int warp, int lane) {
  constexpr int HCP = 32 * UPT;
  constexpr int VK = 16 / sizeof(TW);  // k values a 16-byte load of a tile row
  float acc[RB][UPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int p = 0; p < UPT; ++p) acc[r][p] = 0.f;
  const int nch = g4 / VK;
  const int c_hi = (warp + 1) * nch / kScanWarps;
  const TW* wl = w_s + lane * UPT;
  for (int c = warp * nch / kScanWarps; c < c_hi; ++c) {
    const int k = c * VK;
    float w[VK][UPT];
#pragma unroll
    for (int u = 0; u < VK; ++u) load_units<UPT>(wl + (size_t)(k + u) * HCP, w[u]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float av[VK];
      load_k(tile + (size_t)r * g4 + k, av);
#pragma unroll
      for (int u = 0; u < VK; ++u)
#pragma unroll
        for (int p = 0; p < UPT; ++p) acc[r][p] = fmaf(av[u], w[u][p], acc[r][p]);
    }
  }
  float* pw = part + (size_t)warp * RB * HCP + lane * UPT;
#pragma unroll
  for (int r = 0; r < RB; ++r) store_units<UPT>(pw + (size_t)r * HCP, acc[r]);
}

// scan_contract's inner loop over the K-rows [k0, k0 + kn) of the tile, the
// weight row k at w + (k - k0) * HCP, warp w over its eighth of them, into
// the lane's sums acc.
template <typename TW, int UPT, int RB>
__device__ __forceinline__ void scan_accum(const TW* tile, const TW* w, int k0, int kn, int g4,
                                           int warp, int lane, float (&acc)[RB][UPT]) {
  constexpr int HCP = 32 * UPT;
  constexpr int VK = 16 / sizeof(TW);
  const int nch = kn / VK;
  const int c_hi = (warp + 1) * nch / kScanWarps;
  const TW* wl = w + lane * UPT;
  for (int c = warp * nch / kScanWarps; c < c_hi; ++c) {
    const int k = c * VK;
    float wv[VK][UPT];
#pragma unroll
    for (int u = 0; u < VK; ++u) load_units<UPT>(wl + (size_t)(k + u) * HCP, wv[u]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float av[VK];
      load_k(tile + (size_t)r * g4 + k0 + k, av);
#pragma unroll
      for (int u = 0; u < VK; ++u)
#pragma unroll
        for (int p = 0; p < UPT; ++p) acc[r][p] = fmaf(av[u], wv[u][p], acc[r][p]);
    }
  }
}

// scan_contract on a streamed slice: the resident rows, then the step's nc
// chunks from chunk g on (g advances past them); after each chunk the block
// syncs and thread 0 issues the chunk kStreamStages on into the freed buffer.
template <typename TW, int UPT, int RB, int KC>
__device__ __forceinline__ void scan_contract_stream(const TW* tile, const TW* w_s,
                                                     const SliceStream<TW, 32 * UPT, KC>& st,
                                                     int& g, float* part, int g4, int warp,
                                                     int lane) {
  constexpr int HCP = 32 * UPT;
  float acc[RB][UPT];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int p = 0; p < UPT; ++p) acc[r][p] = 0.f;
  scan_accum<TW, UPT, RB>(tile, w_s, 0, st.k_res, g4, warp, lane, acc);
  for (int c = 0; c < st.nc; ++c, ++g) {
    int k0, kn;
    const TW* w = st.wait(g, k0, kn);
    scan_accum<TW, UPT, RB>(tile, w, k0, kn, g4, warp, lane, acc);
    __syncthreads();  // every warp done with the buffer
    if (threadIdx.x == 0) st.issue(g + kStreamStages);
  }
  float* pw = part + (size_t)warp * RB * HCP + lane * UPT;
#pragma unroll
  for (int r = 0; r < RB; ++r) store_units<UPT>(pw + (size_t)r * HCP, acc[r]);
}

// The carry of row r's units u .. u+3 (u from the block's first unit): the
// warps' partial sums added in warp order.
template <int RB, int HCP>
__device__ __forceinline__ float4 scan_carry(const float* part, int r, int u) {
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* pp = part + (size_t)r * HCP + u;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(pp + (size_t)w * RB * HCP);
    carry.x += v.x;
    carry.y += v.y;
    carry.z += v.z;
    carry.w += v.w;
  }
  return carry;
}

// The bias gradient's partial of this row tile into db (the block's units
// of each gate: db[q * H + j0 + u]), after the last step: the threads' sums
// over the steps (rows past R hold zeros) laid out [RB][4][HCP] over the
// warps' partial-carry buffer, then each (gate, unit) of the block's nq * 4
// units added over the RB rows in row order.
template <int RB, int HCP, int EPT>
__device__ __forceinline__ void scan_db_partial(float* part, const int (&pr)[EPT],
                                                const int (&pj)[EPT], const float4 (&dsum)[EPT][4],
                                                int j0, int nq, int H, float* db) {
  __syncthreads();  // every thread done reading `part` for step 0's carry
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    if (pr[e] < 0) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      store4(part + ((size_t)pr[e] * 4 + q) * HCP + (pj[e] - j0), dsum[e][q]);
  }
  __syncthreads();
  const int nu = 4 * nq;
  for (int i = threadIdx.x; i < 4 * nu; i += kScanThreads) {
    const int q = i / nu, u = i % nu;
    float v = 0.f;
    for (int r = 0; r < RB; ++r) v += part[((size_t)r * 4 + q) * HCP + u];
    db[q * H + j0 + u] = v;
  }
}

// Grid (cs, row tiles, tasks); clusters of cs blocks along x: block rank b
// owns units [b*hc, b*hc + hc) of the cluster's RB rows. 32 * UPT = hcp. DB:
// the bias gradient's partials into a.db (a compile-time variant: its 16
// sums a thread would cost the others registers). STREAM: the first a.k_res
// rows of the slice resident, the rest streamed (`SliceStream`).
template <typename TW, typename TC, int UPT, int RB, bool DB, bool STREAM>
__global__ void __launch_bounds__(kScanThreads, 1) lstm_scan_bwd_kernel(const ScanBwd tasks) {
  extern __shared__ __align__(128) unsigned char smem[];
  ScanBwd a = tasks;  // this block's task
  {
    const long long z = blockIdx.z;
    a.g += z * a.sg;
    a.gates += z * a.sgates;
    a.c_all = static_cast<const TC*>(a.c_all) + z * a.sc;
    a.wts = static_cast<const TW*>(a.wts) + z * a.sw;
    a.dgates += z * a.sdg;
    if (a.dh_all) {
      a.dh_all += z * a.sdh;
      a.dc_all += z * a.sdh;
    }
    if (DB) a.db += z * a.sdb + blockIdx.y * a.ldb;
  }
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
  constexpr int KC = stream_rows(HCP * sizeof(TW));  // STREAM: rows a chunk
  const int k_res = STREAM ? a.k_res : g4;             // resident rows of the slice
  TW* w_s = reinterpret_cast<TW*>(smem + (STREAM ? kStreamHeader : 16));  // [k_res, HCP]
  // STREAM: the stage buffers [kStreamStages, KC, HCP] after the resident rows.
  TW* dg_s = w_s + (size_t)k_res * HCP + (STREAM ? kStreamStages * KC * HCP : 0);  // [2, RB, 4H]
  float* part = reinterpret_cast<float*>(dg_s + (size_t)2 * RB * g4);  // [8, RB, HCP]
  SliceStream<TW, HCP, KC> st{};
  int chunk = 0;  // STREAM: the next chunk a contraction reads
  if constexpr (STREAM) {
    st.full = bar + 1;
    st.stage = w_s + (size_t)k_res * HCP;
    st.slice = static_cast<const TW*>(a.wts) + (size_t)rank * g4 * HCP;
    st.k_res = k_res;
    st.K = g4;
    st.nc = (g4 - k_res + KC - 1) / KC;
    st.total = (T - 1) * st.nc;
  }

  // The weight slice (STREAM: its resident rows and first chunks),
  // copied while the first step's gate math runs.
  if (T > 1 && tid == 0) {
    if constexpr (STREAM)
      st.start(bar, w_s);
    else
      scan_copy_slice(bar, w_s, a.wts, rank, (unsigned)((size_t)g4 * HCP * sizeof(TW)));
  }

  // Thread tid owns (row r, units j .. j+3) for e < EPT: pair tid + e * 256.
  int pr[EPT], pj[EPT];
  StepIn in[EPT];
  float4 dcc[EPT];
  float4 dsum[DB ? EPT : 1][4];  // the bias gradient's sums over the steps
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = tid + e * kScanThreads;
    pr[e] = nq > 0 && p < RB * nq ? p / nq : -1;
    pj[e] = nq > 0 ? j0 + 4 * (p % nq) : 0;
    dcc[e] = zero;
    if constexpr (DB) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dsum[e][q] = zero;
    }
    in[e] = StepIn{zero, zero, zero, zero, zero, zero, zero};
    if (pr[e] >= 0 && row0 + pr[e] < R) load_step<TC>(a, T - 1, row0 + pr[e], pj[e], false, in[e]);
  }

  for (int t = T - 1; t >= 0; --t) {
    TW* dgb = dg_s + (size_t)(t & 1) * RB * g4;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0) continue;
      const int r = pr[e], j = pj[e], row = row0 + r;
      // dh = g + the carry, the warps' partial sums added in order.
      const float4 carry = t < T - 1 ? scan_carry<RB, HCP>(part, r, j - j0) : zero;
      const StepIn& s = in[e];
      const float4 dh = make_float4(s.g.x + carry.x, s.g.y + carry.y, s.g.z + carry.z,
                                    s.g.w + carry.w);
      float4 d[4], dc;
      cell_bwd(s.i.x, s.f.x, s.gg.x, s.o.x, s.c.x, s.cp.x, dh.x, dcc[e].x, d[0].x, d[1].x,
               d[2].x, d[3].x, dc.x);
      cell_bwd(s.i.y, s.f.y, s.gg.y, s.o.y, s.c.y, s.cp.y, dh.y, dcc[e].y, d[0].y, d[1].y,
               d[2].y, d[3].y, dc.y);
      cell_bwd(s.i.z, s.f.z, s.gg.z, s.o.z, s.c.z, s.cp.z, dh.z, dcc[e].z, d[0].z, d[1].z,
               d[2].z, d[3].z, dc.z);
      cell_bwd(s.i.w, s.f.w, s.gg.w, s.o.w, s.c.w, s.cp.w, dh.w, dcc[e].w, d[0].w, d[1].w,
               d[2].w, d[3].w, dc.w);
      if (row < R) {
        float* out = a.dgates + ((size_t)t * R + row) * g4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) store4(out + q * H, d[q]);
        if (a.dh_all) {
          const size_t o = ((size_t)t * R + row) * H + j;
          store4(a.dh_all + o, dh);
          store4(a.dc_all + o, dc);
        }
        if constexpr (DB) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dsum[e][q].x += d[q].x;
            dsum[e][q].y += d[q].y;
            dsum[e][q].z += d[q].z;
            dsum[e][q].w += d[q].w;
          }
        }
      }
      if (t > 0) {  // round(dgates) into every block's tile (rows past R: zeros)
        TW* loc = dgb + (size_t)r * g4 + j;
        for (int b = 0; b < a.cs; ++b) {
          TW* dst = cluster.map_shared_rank(loc, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) store4(dst + q * H, d[q]);
        }
      }
    }
    if (t == 0) break;  // no carry into t = -1
    // One cluster barrier a step: every block's tile of step t written (the
    // arrive releases this block's writes), and every block done with step
    // t+1's contraction, so buffer t-1 is free. Step t-1's inputs are loaded
    // between arrive and wait: in flight across the barrier and the
    // contraction, and not held up by the arrive's release.
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      if (pr[e] < 0 || row0 + pr[e] >= R) continue;
      in[e].c = in[e].cp;
      load_step<TC>(a, t - 1, row0 + pr[e], pj[e], true, in[e]);
    }
    cluster_wait();
    if (t == T - 1) mbar_wait(smem_u32(bar), 0);  // the weight slice has landed

    // dh_carry of this block's units: [RB, 4H] x [4H, hc].
    if constexpr (STREAM)
      scan_contract_stream<TW, UPT, RB, KC>(dgb, w_s, st, chunk, part, g4, warp, lane);
    else
      scan_contract<TW, UPT, RB>(dgb, w_s, part, g4, warp, lane);
    __syncthreads();  // the partial sums visible to the threads that own the units
  }

  if constexpr (DB) scan_db_partial<RB, HCP, EPT>(part, pr, pj, dsum, j0, nq, H, a.db);
}

// The cluster sizes the recurrences take: the portable 1, 2, 4 and 8, and
// Hopper's non-portable 16 (ops/fused_lstm_stack.py `_cluster_plan` takes it
// only where no smaller cluster's shared memory holds the weight slice).
constexpr int kWideCluster = 16;
__host__ __device__ inline bool cluster_size_ok(int cs) {
  return cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == kWideCluster;
}

// Launch `kernel` on a grid of (cs, gy, gz) blocks in clusters of cs along
// x with `smem` bytes of dynamic shared memory, or (max_clusters not null)
// ask how many of its clusters fit on the card at once. `opted` holds the
// kernel's opt-ins to more than 48 KB of shared memory and to clusters
// above the portable 8 blocks, once a device. A 16-block cluster the card
// cannot run fails at its launch, with the card's code: nothing falls back
// to a smaller cluster.
template <typename Args>
int launch_cluster(void (*kernel)(Args), const Args& a, bool (&opted)[64], int cs, unsigned gy,
                   unsigned gz, size_t smem, cudaStream_t stream, int* max_clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kScanMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = max_clusters ? dim3(cs, 1, 1) : dim3(cs, gy, gz);
  cfg.blockDim = dim3(kScanThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch one kernel instance, or (max_clusters not null) ask how many of
// its clusters fit on the card at once.
template <typename TW, typename TC, int UPT, int RB, bool DB, bool STREAM>
int scan_bwd_run(const ScanBwd& a, cudaStream_t stream, int* max_clusters) {
  static bool opted[64] = {};
  const int hcp = 32 * UPT;
  return launch_cluster(lstm_scan_bwd_kernel<TW, TC, UPT, RB, DB, STREAM>, a, opted, a.cs,
                        (unsigned)((a.R + RB - 1) / RB), (unsigned)a.tasks,
                        STREAM ? scan_bwd_stream_smem(a.H, hcp, RB, sizeof(TW), a.k_res)
                               : scan_bwd_smem(a.H, hcp, RB, sizeof(TW)),
                        stream, max_clusters);
}

// The streamed variant is built at every row tile (2 for the widest H) but
// 16 rows at 4 bfloat16 units a lane (its registers would spill).
constexpr unsigned kStreamTilesBwd = 2u | 4u | 8u | 16u;

template <typename TW, typename TC, int UPT, bool DB, bool STREAM>
int scan_bwd_rb(int rb, const ScanBwd& a, cudaStream_t s, int* max_clusters) {
  switch (rb) {
    case 2:
      return scan_bwd_run<TW, TC, UPT, 2, DB, STREAM>(a, s, max_clusters);
    case 4:
      return scan_bwd_run<TW, TC, UPT, 4, DB, STREAM>(a, s, max_clusters);
    case 8:
      return scan_bwd_run<TW, TC, UPT, 8, DB, STREAM>(a, s, max_clusters);
    case 16:
      if constexpr (!STREAM || !(sizeof(TW) == 2 && UPT == 4))
        return scan_bwd_run<TW, TC, UPT, 16, DB, STREAM>(a, s, max_clusters);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TW, typename TC, bool DB, bool STREAM = false>
int scan_bwd_hcp(int hcp, int rb, const ScanBwd& a, cudaStream_t s, int* max_clusters) {
  switch (hcp) {
    case 32:
      return scan_bwd_rb<TW, TC, 1, DB, STREAM>(rb, a, s, max_clusters);
    case 64:
      return scan_bwd_rb<TW, TC, 2, DB, STREAM>(rb, a, s, max_clusters);
    case 128:
      return scan_bwd_rb<TW, TC, 4, DB, STREAM>(rb, a, s, max_clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether a backward plan streams its slices: k_res in [0, 4H).
__host__ __device__ inline bool scan_streams(int k_res, int H) { return k_res >= 0 && k_res < 4 * H; }

inline bool aligned_to(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// Launch one backward recurrence on `stream` (or, with max_clusters, ask
// the occupancy of its clusters): w_dt (0 = float32, 1 = bfloat16) is the
// compute dtype, the weight slices'; c_all is float32 or, with
// C_IN_COMPUTE, in the compute dtype. The plan (a.cs blocks a cluster, hcp
// weight columns a block, rb rows a cluster, a.k_res resident rows of a
// slice) is the caller's: cs 1, 2, 4, 8 or 16, hcp 32, 64 or 128 and at
// least scan_units(H, cs), rb 2, 4, 8 or 16, within 227 KB of shared
// memory; 1 to 65535 tasks. A streamed plan (k_res in [0, 4H): a multiple of
// 16 bytes' k values) takes, with C_IN_COMPUTE, the bias
// gradient's partials (the stack entry's instances), without, none (row
// 19's). H is a multiple of 4;
// every array is 16-byte aligned (c_all in bfloat16: 8-byte), and so is
// every task's slice of it. Returns a cudaError_t code:
// a plan or an argument it does not take is cudaErrorInvalidValue or
// cudaErrorMisalignedAddress; a cluster launch the card refuses returns the
// card's code. Nothing falls back to another kernel.
template <bool C_IN_COMPUTE>
int launch_scan_bwd_dt(int w_dt, int hcp, int rb, const ScanBwd& a, cudaStream_t s,
                       int* max_clusters = nullptr) {
  const bool bf16 = w_dt == kBF16;
  const size_t tw = bf16 ? 2 : 4;
  const bool stream = scan_streams(a.k_res, a.H);
  if ((w_dt != kF32 && !bf16) || (hcp != 32 && hcp != 64 && hcp != 128) ||
      (rb != 2 && rb != 4 && rb != 8 && rb != 16) ||
      !cluster_size_ok(a.cs) || a.T <= 0 || a.R <= 0 || a.H <= 0 ||
      a.H % 4 || scan_units(a.H, a.cs) > hcp || (a.R + rb - 1) / rb > 65535 ||
      a.tasks <= 0 || a.tasks > 65535 || !a.dh_all != !a.dc_all ||
      (stream ? scan_bwd_stream_smem(a.H, hcp, rb, tw, a.k_res)
              : scan_bwd_smem(a.H, hcp, rb, tw)) > kScanMaxSmem ||
      (stream && (!(kStreamTilesBwd & (unsigned)rb) || a.k_res % (16 / (int)tw) ||
                  (C_IN_COMPUTE && !a.db))))
    return (int)cudaErrorInvalidValue;
  const int tc = C_IN_COMPUTE && bf16 ? 2 : 4;  // c_all's bytes an element
  if (!aligned_to(a.g, 16) || !aligned_to(a.gates, 16) || !aligned_to(a.dgates, 16) ||
      !aligned_to(a.wts, 16) || !aligned_to(a.c_all, 4 * tc) ||
      !aligned_to(a.dh_all, 16) || !aligned_to(a.dc_all, 16) || !aligned_to(a.db, 4) ||
      a.sg % 4 || a.sgates % 4 || a.sdg % 4 || a.sdh % 4 || a.sc % 4 || a.sw % (bf16 ? 8 : 4))
    return (int)cudaErrorMisalignedAddress;
  using CB = typename std::conditional<C_IN_COMPUTE, __nv_bfloat16, float>::type;
  // The bias-gradient variants exist for the stack entry alone (rows 5, 15, 17).
  if constexpr (!C_IN_COMPUTE) {
    if (a.db) return (int)cudaErrorInvalidValue;
  }
  if (stream) {  // rows 5 and 15 (with the bias partials) or row 19 (without)
    if (bf16) return scan_bwd_hcp<__nv_bfloat16, CB, C_IN_COMPUTE, true>(hcp, rb, a, s,
                                                                          max_clusters);
    return scan_bwd_hcp<float, float, C_IN_COMPUTE, true>(hcp, rb, a, s, max_clusters);
  }
  if constexpr (C_IN_COMPUTE) {
    if (a.db) {
      if (bf16) return scan_bwd_hcp<__nv_bfloat16, CB, true>(hcp, rb, a, s, max_clusters);
      return scan_bwd_hcp<float, float, true>(hcp, rb, a, s, max_clusters);
    }
  }
  if (bf16) return scan_bwd_hcp<__nv_bfloat16, CB, false>(hcp, rb, a, s, max_clusters);
  return scan_bwd_hcp<float, float, false>(hcp, rb, a, s, max_clusters);
}

}  // namespace
}  // namespace wf
