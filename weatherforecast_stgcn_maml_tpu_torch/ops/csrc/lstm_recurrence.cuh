// One LSTM layer's recurrence, forward: the device code of kernel row 20
// (fused_lstm.cu). Row 18 runs on the cluster forward recurrence of
// lstm_scan_fwd.cuh instead.
//
// Given the input projection xp = x @ Wx + b (float32, computed outside the
// recurrence), it walks t = 0 .. T-1 with zero carries at t = 0:
//     gates = xp[t] + round(h_{t-1}) @ round(Wh)     (gate order i, f, g, o)
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with Wh [H, 4H] in the compute dtype TW, float32 accumulation and float32
// h and c carries, as the JAX package's `lstm_recurrence_xla` and the Pallas
// bodies `lstm_scan._fwd_kernel` and `fused_lstm._kernel` compute.
//
// Translation: on the TPU one grid step is one time step, the carries sit in
// VMEM scratch across grid steps and Wh stays resident in VMEM. CUDA blocks
// run in parallel and in no order, so each block owns a tile of rows (rows
// are independent sequences) and walks all T steps itself. Thread (g, j)
// owns hidden unit j of RPT rows and computes all four gates of that unit,
// so its c carry stays in registers and the cell needs no exchange; only
// the recurrent operand round(h_{t-1}) [rows, H] lives in shared memory,
// read by every thread of the next step's contraction. Wh (256 KB in
// float32 at H = 128) does not fit next to it in a block's 227 KB, so every
// step streams it from L2 in double-buffered cp.async tiles (contract() of
// common.cuh).
#pragma once

#include "common.cuh"

namespace wf {
// Internal linkage: each source that includes this has its own copy of the
// kernels, so no two objects of the library register the same one.
namespace {

// Where one recurrence reads and writes. Element (t, r, k) of a [T, R, *]
// stream lives at base + t * st + r * sr + k (k contiguous). Every output
// may be null: h_seq / c_seq [T, R, H] float32 (the strides of h_st / h_sr),
// gates [T, R, 4H] float32 time-major and contiguous (the activated gates, a
// residual for the backward), h_last [R, H] float32 (h at t = T-1).
struct RecurrenceIO {
  const float* xp;
  long long xp_st, xp_sr;
  const void* wh;  // [H, 4H] in the compute dtype
  float* h_seq;
  float* c_seq;
  long long h_st, h_sr;
  float* gates;
  float* h_last;
  int T, R, H;
};

constexpr int kRecurrenceThreads = 256;  // 256 / H row groups of H threads

// Launch: blockDim.x = (256 / H) * H threads (H <= 256, H % 4 == 0), a block
// holding (256 / H) * RPT rows; dynamic shared memory
// recurrence_smem_bytes<TW, RPT>(H).
template <typename TW, int RPT>
__global__ void __launch_bounds__(kRecurrenceThreads)
    lstm_recurrence_kernel(RecurrenceIO a) {
  extern __shared__ float4 smem4[];
  const int H = a.H;
  const int g4 = 4 * H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kContractTile, 4H]
  float* hs = reinterpret_cast<float*>(wbuf + 2 * kContractTile * g4);  // [rows_blk, H]
  const TW* wh = static_cast<const TW*>(a.wh);
  const int j = threadIdx.x % H;
  const int r0 = (threadIdx.x / H) * RPT;  // first local row of this thread
  const int row0 = blockIdx.x * rows_blk;

  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.f;

  for (int t = 0; t < a.T; ++t) {
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    // h_{-1} = 0: step 0's recurrent product is zero. contract() opens with
    // a barrier (the previous step's writes to hs are visible) and closes
    // with one (every read of hs is done before this step overwrites it).
    if (t > 0) contract<TW, RPT, 4>(wh, H, g4, hs, H, wbuf, r0, j, H, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r0 + r;
      const bool live = row < a.R;
      const float* x = a.xp + t * a.xp_st + row * a.xp_sr + j;
      const float ig = sigmoidf((live ? x[0] : 0.f) + acc[r][0]);
      const float fg = sigmoidf((live ? x[H] : 0.f) + acc[r][1]);
      const float gg = tanhf((live ? x[2 * H] : 0.f) + acc[r][2]);
      const float og = sigmoidf((live ? x[3 * H] : 0.f) + acc[r][3]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      hs[(r0 + r) * H + j] = round_to<TW>(h);
      if (!live) continue;
      const long long o = t * a.h_st + row * a.h_sr + j;
      if (a.h_seq) a.h_seq[o] = h;
      if (a.c_seq) a.c_seq[o] = c[r];
      if (a.gates) {
        float* gt = a.gates + ((long long)t * a.R + row) * g4 + j;
        gt[0] = ig;
        gt[H] = fg;
        gt[2 * H] = gg;
        gt[3 * H] = og;
      }
      if (a.h_last && t == a.T - 1) a.h_last[(long long)row * H + j] = h;
    }
  }
}

template <typename TW, int RPT>
size_t recurrence_smem_bytes(int H) {
  const int rows_blk = (kRecurrenceThreads / H) * RPT;
  return 2 * (size_t)kContractTile * 4 * H * sizeof(TW) + (size_t)rows_blk * H * sizeof(float);
}

// Launch one recurrence on `stream`; returns a cudaError_t code.
template <typename TW, int RPT>
int launch_recurrence(const RecurrenceIO& a, cudaStream_t stream) {
  if (a.T <= 0 || a.R <= 0 || a.H <= 0 || a.H > kRecurrenceThreads || a.H % 4)
    return (int)cudaErrorInvalidValue;
  const int groups = kRecurrenceThreads / a.H;
  const int rows_blk = groups * RPT;
  const size_t smem = recurrence_smem_bytes<TW, RPT>(a.H);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB opt-in per block
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel<TW, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.R + rows_blk - 1) / rows_blk;
  lstm_recurrence_kernel<TW, RPT><<<blocks, groups * a.H, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_recurrence_rpt(int rpt, const RecurrenceIO& a, cudaStream_t stream) {
  switch (rpt) {
    case 2:
      return launch_recurrence<TW, 2>(a, stream);
    case 4:
      return launch_recurrence<TW, 4>(a, stream);
    case 8:
      return launch_recurrence<TW, 8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The compute dtype code (0 = float32, 1 = bfloat16) picks TW.
int launch_recurrence_dt(int w_dt, int rpt, const RecurrenceIO& a, cudaStream_t stream) {
  if (w_dt == kF32) return launch_recurrence_rpt<float>(rpt, a, stream);
  if (w_dt == kBF16) return launch_recurrence_rpt<__nv_bfloat16>(rpt, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf
