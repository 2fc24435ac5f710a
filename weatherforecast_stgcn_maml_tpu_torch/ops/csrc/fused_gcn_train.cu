// Fused GCN encoder stack, training forward and backward (kernel rows 6 and
// 7): the two passes of the backward that are not products. The products
// run on the pipelined core of gemm_nn.cu; ops/fused_gcn_train.py sequences
// them. The node-sharded sandwich layer's backward (row 13,
// ops/fused_gcn_shard.py `backward_schedule`) runs on the same pieces: its
// top-layer dz (with g1 + round(g2) @ round(W_next)^T as dh where both
// cotangents come) and the transpose of its adjacency rows, zero-padded.
//
// Replaces the Pallas kernels `_fwd_kernel` (+ `_fwd_kernel_nomask`) and
// `_bwd_kernel` (+ `_bwd_kernel_nomask`) of
// weatherforecast_stgcn_maml_tpu/ops/fused_gcn_train.py. Per layer l:
//   forward   hw = round(h) @ round(W_l), stored in the compute dtype;
//             h' = relu(A_hat @ hw + b_l) * mask_l / keep (gemm_nn.cu's
//             epilogue), stored in the compute dtype as the residual h_all[l];
//   backward  dz = dh * [h_all[l] > 0] * mask_l / keep, stored in the
//             compute dtype, with the float32 column sums of each 128-row
//             tile (db_l's partials): this file at the top layer, the input
//             product's relu-grad epilogue below it (gemm_nn.cu);
//             dhw = round(A_hat^T) @ round(dz) per slice (gemm_nn.cu, NN);
//             dW_l = round(h_in)^T @ dhw over all slices and nodes
//                                                   (gemm_nn.cu, TN, split K);
//             d_in = dhw @ round(W_l)^T, float32 at layer 0 (dx).
// round(A_hat)^T and round(W_l)^T (and x under bfloat16) are made once a
// call by one launch of this file's transpose-and-round pass.
// relu' comes from the post-dropout residual, compared in float32: where the
// mask is live h' > 0 iff the pre-activation is, and where it is 0 the mask
// factor zeroes the term anyway.
//
// Bound: about 17.9 GFLOP forward and 22.8 GFLOP backward at the training
// shapes (24 slices of 512 nodes, 4 layers of width 256), 0.27 and 0.34 ms
// at the card's float32 rate; both passes here move a few MB and are bound
// by device memory.
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

constexpr int kDzCols = 64;     // columns a block
constexpr int kDzGroups = 4;    // row groups a block, each summing its rows in order
constexpr int kDzThreads = kDzCols * kDzGroups;

// dz = (dh [+ add]) * [h_post > 0] (* mask * inv_keep) over rows x cols
// (row-major, unit stride; add float32 or null), stored as TZ; part[tile * ldp + col] = the float32 sum of dz
// over the tile's row_tile rows: each row group's rows in order, then the
// groups in order, so the result does not depend on the order blocks ran in.
template <typename TD, typename TH, typename TZ>
__global__ void __launch_bounds__(kDzThreads) dz_top_kernel(
    const TD* __restrict__ dh, const float* __restrict__ add, const TH* __restrict__ h_post,
    const int8_t* __restrict__ mask,
    float inv_keep, TZ* __restrict__ dz, float* __restrict__ part, int ldp, int rows, int cols,
    int row_tile) {
  __shared__ float red[kDzGroups][kDzCols];
  const int tc = threadIdx.x % kDzCols;
  const int rg = threadIdx.x / kDzCols;
  const int col = blockIdx.x * kDzCols + tc;
  const int r0 = blockIdx.y * row_tile;
  const int r1 = min(rows, r0 + row_tile);
  float s = 0.f;
  if (col < cols)
    for (int r = r0 + rg; r < r1; r += kDzGroups) {
      const long long i = (long long)r * cols + col;
      float v = to_float(dh[i]);
      if (add) v += add[i];
      v = v * (to_float(h_post[i]) > 0.f ? 1.f : 0.f);
      if (mask) v = v * ((float)mask[i] * inv_keep);
      dz[i] = from_float<TZ>(v);
      s += v;
    }
  red[rg][tc] = s;
  __syncthreads();
  if (rg == 0 && col < cols) {
    float t = red[0][tc];
#pragma unroll
    for (int g = 1; g < kDzGroups; ++g) t += red[g][tc];
    part[(long long)blockIdx.y * ldp + col] = t;
  }
}

template <typename TD, typename TH, typename TZ>
int launch_dz(const void* dh, const float* add, const void* h, const int8_t* mask,
              float inv_keep, void* dz, float* part, int ldp, int rows, int cols, int row_tile,
              cudaStream_t s) {
  const dim3 grid((cols + kDzCols - 1) / kDzCols, (rows + row_tile - 1) / row_tile);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  dz_top_kernel<TD, TH, TZ><<<grid, kDzThreads, 0, s>>>(
      static_cast<const TD*>(dh), add, static_cast<const TH*>(h), mask, inv_keep,
      static_cast<TZ*>(dz), part, ldp, rows, cols, row_tile);
  return (int)cudaGetLastError();
}

template <typename TD, typename TH>
int launch_dz_z(int z_dt, const void* dh, const float* add, const void* h, const int8_t* mask,
                float inv_keep, void* dz, float* part, int ldp, int rows, int cols,
                int row_tile, cudaStream_t s) {
  if (z_dt == kF32)
    return launch_dz<TD, TH, float>(dh, add, h, mask, inv_keep, dz, part, ldp, rows, cols,
                                    row_tile, s);
  if (z_dt == kBF16)
    return launch_dz<TD, TH, __nv_bfloat16>(dh, add, h, mask, inv_keep, dz, part, ldp, rows,
                                            cols, row_tile, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TD>
int launch_dz_h(int h_dt, int z_dt, const void* dh, const float* add, const void* h,
                const int8_t* mask, float inv_keep, void* dz, float* part, int ldp, int rows,
                int cols, int row_tile, cudaStream_t s) {
  if (h_dt == kF32)
    return launch_dz_z<TD, float>(z_dt, dh, add, h, mask, inv_keep, dz, part, ldp, rows, cols,
                                  row_tile, s);
  if (h_dt == kBF16)
    return launch_dz_z<TD, __nv_bfloat16>(z_dt, dh, add, h, mask, inv_keep, dz, part, ldp, rows,
                                          cols, row_tile, s);
  return (int)cudaErrorInvalidValue;
}

// Up to kMaxMats float32 matrices rounded to the compute dtype, each either
// transposed (dst [cols, drows], its columns past `rows` zero) or copied
// (dst [rows, cols]), in one launch: blockIdx.z picks the matrix, 32 x 32
// tiles go through shared memory.
constexpr int kMaxMats = 8;
constexpr int kTile = 32;

struct TransposeMat {
  const float* src;  // [rows, cols], row stride ld
  void* dst;         // contiguous
  int rows, cols, ld, trans;
  int drows;  // transposed: dst's row stride, rows <= drows (the rest zero-filled)
};

struct TransposeArgs {
  TransposeMat mat[kMaxMats];
};

template <typename T>
__global__ void __launch_bounds__(kTile * 8) transpose_round_kernel(TransposeArgs args) {
  __shared__ float tile[kTile][kTile + 1];
  const TransposeMat& m = args.mat[blockIdx.z];
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  if (r0 >= m.drows || c0 >= m.cols) return;  // this matrix is smaller than the grid
  T* dst = static_cast<T*>(m.dst);
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  for (int r = ty; r < kTile; r += 8) {
    const int row = r0 + r, col = c0 + tx;
    const bool ok = row < m.rows && col < m.cols;
    const float v = ok ? m.src[(long long)row * m.ld + col] : 0.f;
    if (!m.trans) {
      if (ok) dst[(long long)row * m.cols + col] = from_float<T>(v);
    } else {
      tile[r][tx] = v;
    }
  }
  if (!m.trans) return;
  __syncthreads();
  for (int r = ty; r < kTile; r += 8) {  // dst row = src column c0 + r
    const int row = c0 + r, col = r0 + tx;
    if (row < m.cols && col < m.drows)
      dst[(long long)row * m.drows + col] = from_float<T>(tile[tx][r]);
  }
}

}  // namespace
}  // namespace wf

// dz = (dh + add if add else dh) * [h_post > 0] * (mask * inv_keep if mask
// else 1) over rows x cols (contiguous; add float32), stored in z_dt, and part[t * ldp + c] = the float32 sum of
// dz's column c over rows [t * row_tile, (t + 1) * row_tile) in a fixed
// order. dh_dt / h_dt / z_dt are the dtype codes of dh, h_post and dz (0 =
// float32, 1 = bfloat16). Returns a cudaError_t code (0 on success).
extern "C" int wf_gcn_relu_mask_grad(int dh_dt, int h_dt, int z_dt, const void* dh,
                                     const float* add, const void* h_post, const int8_t* mask,
                                     float inv_keep, void* dz, float* part, int ldp, int rows,
                                     int cols, int row_tile, void* stream) {
  if (rows <= 0 || cols <= 0 || row_tile <= 0 || ldp < cols) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh_dt == wf::kF32)
    return wf::launch_dz_h<float>(h_dt, z_dt, dh, add, h_post, mask, inv_keep, dz, part, ldp,
                                  rows, cols, row_tile, s);
  if (dh_dt == wf::kBF16)
    return wf::launch_dz_h<__nv_bfloat16>(h_dt, z_dt, dh, add, h_post, mask, inv_keep, dz, part,
                                          ldp, rows, cols, row_tile, s);
  return (int)cudaErrorInvalidValue;
}

// count (1 .. 8) float32 matrices src[i] [rows[i], cols[i]] (row stride
// ld[i]) rounded to dt (0 = float32, 1 = bfloat16) into the contiguous
// dst[i]: transposed ([cols, drows[i]], columns past rows[i] zero) where
// trans[i], else as they are (drows[i] = rows[i]). One launch. Returns a
// cudaError_t code (0 on success).
extern "C" int wf_transpose_round(int dt, int count, const void* const* src, void* const* dst,
                                  const int* rows, const int* cols, const int* ld,
                                  const int* trans, const int* drows, void* stream) {
  using namespace wf;
  if (count <= 0 || count > kMaxMats) return (int)cudaErrorInvalidValue;
  TransposeArgs args{};
  int max_r = 0, max_c = 0;
  for (int i = 0; i < count; ++i) {
    if (rows[i] <= 0 || cols[i] <= 0 || ld[i] < cols[i] || drows[i] < rows[i] ||
        (!trans[i] && drows[i] != rows[i]))
      return (int)cudaErrorInvalidValue;
    args.mat[i] = TransposeMat{static_cast<const float*>(src[i]), dst[i], rows[i], cols[i],
                               ld[i], trans[i], drows[i]};
    max_r = max(max_r, drows[i]);
    max_c = max(max_c, cols[i]);
  }
  const dim3 grid((max_c + kTile - 1) / kTile, (max_r + kTile - 1) / kTile, count);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == kF32)
    transpose_round_kernel<float><<<grid, kTile * 8, 0, s>>>(args);
  else if (dt == kBF16)
    transpose_round_kernel<__nv_bfloat16><<<grid, kTile * 8, 0, s>>>(args);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
