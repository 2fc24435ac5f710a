// The eval LSTM stack as per-layer input projections and recurrences: kernel
// row 20.
//
// Replaces the Pallas kernel `_kernel` of weatherforecast_stgcn_maml_tpu/
// ops/fused_lstm.py (launched by `_pallas_forward`), which runs, for a tile
// of 64 rows and every layer l in turn,
//     xp = round(src) @ round(Wx_l) + b_l      one [tile * T, C] x [C, 4H] product
//     T recurrent steps from xp                (the cell of lstm_recurrence.cuh)
// where src is the input x [B, T, C] for layer 0 and layer l-1's float32 h
// sequence after, and returns the top layer's last h [B, H] float32. There
// is no dropout: the model takes this route in eval, and in train mode only
// at lstm_dropout = 0. The backward is not a kernel in JAX either: it
// differentiates the layerwise route (ops/fused_lstm.py).
//
// Translation: the TPU program keeps one tile's projection and h sequence in
// VMEM scratch between the product and the steps. A Hopper block has 227 KB
// of shared memory, and the product wants large tiles while the recurrence
// wants many small row tiles, so here each is its own launch and the
// intermediates live in device memory (xp [B, T, 4H] and h [B, T, H] float32
// scratch from the wrapper, 100 MB and 25 MB at B = 1536): per layer,
//   1. the projection, on the hand-written GEMM of gemm.cu (wf_gemm, the
//      bias added in its epilogue), over all B * T rows at once;
//   2. the recurrence (lstm_recurrence.cuh), reading xp batch-major and
//      writing the h sequence batch-major, so the next layer's projection
//      reads it as one [B * T, H] matrix; the top layer writes only its
//      last h.
// One C call runs all 2L launches.
//
// Bound at the serving shape [1536, 24, 256], 4 layers of 128: 43.5 GFLOP
// (the same function as row 2), 0.649 ms at the card's float32 rate. The
// scratch round trips (about 0.7 GB over the four layers) add ~0.2 ms of
// device memory time that row 2, which keeps every layer in one block,
// does not pay.
#include <cstdint>

#include "lstm_recurrence.cuh"

extern "C" int wf_gemm(int a_dt, int b_dt, int c_dt, int r_dt, const void* A,
                       long long sa, int lda, int trans_a, const int8_t* amask,
                       float ascale, const void* B, long long sb, int ldb,
                       int trans_b, void* C, long long sc, int ldc,
                       const float* bias, int relu, const int8_t* cmask,
                       float cscale, int M, int N, int K, int batch, int splits,
                       int kc, void* stream);

// x [B, T, C] float32 (contiguous) -> out [B, H] float32, the top layer's h
// at t = T-1. wx[l] ([C_l, 4H]) and bias[l] ([4H]) are float32, wh[l]
// ([H, 4H]) is in the compute dtype w_dt (0 = float32, 1 = bfloat16), every
// product rounding its operands to it. xp_scratch holds B * T * 4H floats
// and h_scratch B * T * H. rows_per_thread (2, 4 or 8) sets the
// recurrence's row tile, H is a multiple of 4, at most 256. Returns a
// cudaError_t code (0 on success) from the first launch that fails.
extern "C" int wf_fused_lstm_last(int w_dt, int rows_per_thread, const float* x,
                                  const void* const* wx, const void* const* wh,
                                  const float* const* bias, float* xp_scratch,
                                  float* h_scratch, float* out, int B, int T, int C,
                                  int H, int L, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0 || L <= 0 || !out)
    return (int)cudaErrorInvalidValue;
  const int g4 = 4 * H;
  const float* src = x;
  int c_in = C;
  for (int l = 0; l < L; ++l) {
    int err = wf_gemm(wf::kF32, wf::kF32, wf::kF32, w_dt, src, 0, c_in, 0, nullptr, 1.f,
                      wx[l], 0, g4, 0, xp_scratch, 0, g4, bias[l], 0, nullptr, 1.f,
                      B * T, g4, c_in, 1, 1, c_in, stream);
    if (err) return err;
    const bool top = l == L - 1;
    const wf::RecurrenceIO a{xp_scratch, g4, (long long)T * g4, wh[l],
                             top ? nullptr : h_scratch, nullptr, H, (long long)T * H,
                             nullptr, top ? out : nullptr, T, B, H};
    err = wf::launch_recurrence_dt(w_dt, rows_per_thread, a, static_cast<cudaStream_t>(stream));
    if (err) return err;
    src = h_scratch;
    c_in = H;
  }
  return 0;
}
