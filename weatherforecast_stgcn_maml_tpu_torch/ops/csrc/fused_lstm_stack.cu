// Fused LSTM stack forward: all layers and all time steps in one launch.
//
// Replaces the Pallas kernel of weatherforecast_stgcn_maml_tpu/ops/
// fused_lstm_stack.py `_fwd_kernel_m_lastonly_nomask` (kernel row 2, the
// eval forward), launched by `_fwd_pallas_m(..., emit_residuals=False)`:
// returns only the top layer's last hidden state. The training forwards left
// this kernel: the one-task one (row 4), the unmerged-gates one (row 14) and
// the task-batched one (row 16, `_fwd_kernel_mv`) run layer by layer on
// gemm_nn.cu and the cluster recurrence of lstm_scan_fwd.cuh
// (lstm_stack_fwd.cu).
//
// Per step t and layer l it computes the merged-gates contraction
//     gates = [in_t | h_{t-1}] @ [[Wx_l], [Wh_l]] + b_l      (gate order i,f,g,o)
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// with operands rounded to the compute dtype, float32 accumulation and a
// float32 c carry; layer l's input is layer l-1's h of the same step,
// rounded to the compute dtype, and the top layer's last h is returned in
// float32.
//
// Translation: on the TPU the grid walks time in order, the carry sits in
// VMEM scratch across grid steps and all weights stay resident in VMEM. Here
// blocks run in parallel and in no order, so each block owns a tile of rows
// (rows are independent sequences) and walks time and layers in a loop
// inside the block. Shared memory holds, per layer, the operand rows
// [in_t | h_{t-1}] (rounded to the compute dtype, the only form they are
// used in) and the c carry. Thread (g, j) owns hidden unit j of RPT rows and
// computes all four gates of that unit, so the cell update needs no exchange
// between threads; only the next contraction, which reads every unit of a
// row, needs a barrier.
//
// Bound: about 14.5 GFLOP for 512 rows of 24 steps, 4 layers of width 128,
// input 256 (0.22 ms at the card's float32 rate). The weights (about 2.4 MB
// in float32, half in bfloat16) do not fit in shared memory, so every block
// streams all of them from L2 once per step: T * L serial stages of one [K,
// 4H] weight matrix each. Loading them with per-thread loads right before
// use left the kernel bound by L2 latency (the row count barely changed its
// time). Here the whole block copies the weights in [kTileK, 4H] tiles with
// cp.async into a double buffer, one tile ahead of the tile being used,
// across stage boundaries (the tile sequence is static), so the copy of the
// next tile overlaps the FMAs on the current one. Row 4's layer-by-layer
// design (the input products hoisted onto gemm_nn.cu, Wh resident in a
// cluster's shared memory) is the one row 2 can take next.
#include "common.cuh"

namespace wf {
namespace {

constexpr int kTargetThreads = 256;
constexpr int kTileK = 16;                // weight rows per pipelined tile
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB opt-in per block

struct Dims {
  int T, R, C, H, L;
  __device__ int k(int l) const { return (l == 0 ? C : H) + H; }  // wcat_l rows
  __device__ int tiles(int l) const { return (k(l) + kTileK - 1) / kTileK; }
};

// Start copying tile `seq` of the static tile sequence (for t, for l, for
// each [kTileK, 4H] tile of wcat_l) into buffer seq % 2.
template <typename TW>
__device__ __forceinline__ void prefetch_tile(int seq, int tiles_per_step,
                                              const Dims& d, const TW* wcat0,
                                              const TW* wcatr, TW* wbuf) {
  const int g4 = 4 * d.H;
  int i = seq % tiles_per_step;
  int l = 0;
  while (i >= d.tiles(l)) i -= d.tiles(l++);
  const TW* w = l == 0 ? wcat0 : wcatr + (size_t)(l - 1) * 2 * d.H * g4;
  const int k0 = i * kTileK;
  const int rows = min(kTileK, d.k(l) - k0);
  // A tile is `rows` whole rows of wcat_l: contiguous in global memory.
  const char* src = reinterpret_cast<const char*>(w + (size_t)k0 * g4);
  char* dst = reinterpret_cast<char*>(wbuf + (size_t)(seq & 1) * kTileK * g4);
  const int chunks = rows * g4 * (int)sizeof(TW) / 16;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + 16 * c, src + 16 * c);
}

// x[t, r, c] lives at x[t * st + r * sr + c]; wcat0 is [C + H, 4H], wcatr
// [L-1, 2H, 4H] (both in the compute dtype TW), bias [L, 4H] float32,
// out [R, H] float32. C and H are multiples of 4.
template <typename TW, int RPT>
__global__ void lstm_stack_fwd_kernel(const float* __restrict__ x, long long st, long long sr,
                                      const TW* __restrict__ wcat0,
                                      const TW* __restrict__ wcatr,
                                      const float* __restrict__ bias,
                                      float* __restrict__ out, Dims d) {
  extern __shared__ float4 smem4[];
  const int H = d.H, C = d.C, L = d.L;
  const int g4 = 4 * H;
  const int rows_blk = (blockDim.x / H) * RPT;
  TW* wbuf = reinterpret_cast<TW*>(smem4);  // [2, kTileK, 4H]
  // Operand rows of layer l: [rows_blk, K_l] with K_l = (C or H) + H,
  // holding [input | own h of the previous step]; then the c carry.
  float* ins = reinterpret_cast<float*>(wbuf + 2 * kTileK * g4);
  const int in_floats = rows_blk * (C + H) + (L - 1) * rows_blk * 2 * H;
  float* cs = ins + in_floats;  // [L, rows_blk, H]
  const int tid = threadIdx.x;
  const int j = tid % H;
  const int r0 = (tid / H) * RPT;  // first local row of this thread
  const int row0 = blockIdx.x * rows_blk;

  int tiles_per_step = 0;
  for (int l = 0; l < L; ++l) tiles_per_step += d.tiles(l);
  const int total = d.T * tiles_per_step;
  int seq = 0;
  prefetch_tile<TW>(0, tiles_per_step, d, wcat0, wcatr, wbuf);
  cp_async_commit();

  for (int i = tid; i < in_floats + L * rows_blk * H; i += blockDim.x) ins[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    // Stage x_t into layer 0's input columns, rounded to the compute dtype.
    // (The first tile's barrier below publishes it.)
    for (int i = tid; i < rows_blk * C; i += blockDim.x) {
      const int r = i / C;
      const int c = i % C;
      const int row = row0 + r;
      ins[(size_t)r * (C + H) + c] =
          row < d.R ? round_to<TW>(x[t * st + row * sr + c]) : 0.f;
    }
    float* in_l = ins;
    for (int l = 0; l < L; ++l) {
      const int kin = l == 0 ? C : H;
      const int kl = kin + H;
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

      for (int k0 = 0; k0 < kl; k0 += kTileK, ++seq) {
        if (seq + 1 < total)
          prefetch_tile<TW>(seq + 1, tiles_per_step, d, wcat0, wcatr, wbuf);
        cp_async_commit();  // possibly empty: keeps the group count uniform
        cp_async_wait_all_but_newest();
        __syncthreads();  // tile seq (and the operand rows) visible to all
        const TW* wt = wbuf + (size_t)(seq & 1) * kTileK * g4 + j;
        const int rows = min(kTileK, kl - k0);
        for (int kk = 0; kk < rows; kk += 4) {
          float4 v[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            v[r] = *reinterpret_cast<const float4*>(in_l + (size_t)(r0 + r) * kl + k0 + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const TW* wk = wt + (size_t)(kk + u) * g4;
            const float w0 = to_float(wk[0]);
            const float w1 = to_float(wk[H]);
            const float w2 = to_float(wk[2 * H]);
            const float w3 = to_float(wk[3 * H]);
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const float a = u == 0 ? v[r].x : u == 1 ? v[r].y : u == 2 ? v[r].z : v[r].w;
              acc[r][0] = fmaf(a, w0, acc[r][0]);
              acc[r][1] = fmaf(a, w1, acc[r][1]);
              acc[r][2] = fmaf(a, w2, acc[r][2]);
              acc[r][3] = fmaf(a, w3, acc[r][3]);
            }
          }
        }
        __syncthreads();  // done with buffer seq % 2 and this stage's operands
      }

      const float* bl = bias + (size_t)l * g4;
      float* cl = cs + (size_t)l * rows_blk * H;
      float* in_next = in_l + (size_t)rows_blk * kl;  // layer l+1's rows
      const bool emit = l == L - 1 && t == d.T - 1;
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
        const float hr = round_to<TW>(h);
        in_l[(size_t)(r0 + r) * kl + kin + j] = hr;  // own recurrent input
        const int row = row0 + r0 + r;
        if (l + 1 < L) in_next[(size_t)(r0 + r) * 2 * H + j] = hr;  // next layer's input
        if (emit && row < d.R) out[(size_t)row * H + j] = h;
      }
      in_l = in_next;
    }
  }
}

template <typename TW, int RPT>
int launch(const float* x, long long st, long long sr, const void* wcat0, const void* wcatr,
           const float* bias, float* out, Dims d, cudaStream_t stream) {
  const int groups = d.H >= kTargetThreads ? 1 : kTargetThreads / d.H;
  const int threads = groups * d.H;
  const int rows_blk = groups * RPT;
  const size_t smem =
      2 * (size_t)kTileK * 4 * d.H * sizeof(TW) +
      ((size_t)rows_blk * (d.C + d.H) + (size_t)(d.L - 1) * rows_blk * 2 * d.H +
       (size_t)d.L * rows_blk * d.H) * sizeof(float);
  if (threads > 1024 || smem > kMaxSmemBytes || d.C % 4 || d.H % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_stack_fwd_kernel<TW, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.R + rows_blk - 1) / rows_blk);
  lstm_stack_fwd_kernel<TW, RPT><<<grid, threads, smem, stream>>>(
      x, st, sr, static_cast<const TW*>(wcat0), static_cast<const TW*>(wcatr), bias, out, d);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_rpt(int rpt, const float* x, long long st, long long sr, const void* wcat0,
               const void* wcatr, const float* bias, float* out, Dims d, cudaStream_t stream) {
  switch (rpt) {
    case 2:
      return launch<TW, 2>(x, st, sr, wcat0, wcatr, bias, out, d, stream);
    case 4:
      return launch<TW, 4>(x, st, sr, wcat0, wcatr, bias, out, d, stream);
    case 8:
      return launch<TW, 8>(x, st, sr, wcat0, wcatr, bias, out, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wf

// Eval forward of the whole LSTM stack. w_dt is the dtype code of the weights
// and the compute dtype (0 = float32, 1 = bfloat16); rows_per_thread (2, 4
// or 8) sets the row tile, a block holding 256 / H * rows_per_thread rows.
// Returns a cudaError_t code (0 on success).
extern "C" int wf_lstm_stack_last(int w_dt, int rows_per_thread,
                                  const float* x, long long st, long long sr,
                                  const void* wcat0, const void* wcatr,
                                  const float* bias, float* out, int T, int R,
                                  int C, int H, int L, void* stream) {
  if (T <= 0 || R <= 0 || C <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const wf::Dims d{T, R, C, H, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dt == wf::kF32)
    return wf::launch_rpt<float>(rows_per_thread, x, st, sr, wcat0, wcatr, bias, out, d, s);
  if (w_dt == wf::kBF16)
    return wf::launch_rpt<__nv_bfloat16>(rows_per_thread, x, st, sr, wcat0, wcatr, bias, out,
                                         d, s);
  return (int)cudaErrorInvalidValue;
}
