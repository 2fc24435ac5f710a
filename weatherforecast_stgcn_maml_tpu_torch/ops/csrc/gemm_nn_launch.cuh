// The launch arguments of gemm_nn.cu's NN and TN products, shared with the C
// entries of other sources that enqueue them (lstm_stack_fwd.cu: the input
// products of rows 4, 14 and 16; lstm_scan.cu: row 19's weight gradient).
#pragma once

// The arguments of one launch. Every field is 8 bytes wide, so the Python
// side packs them with one struct format and no padding (ops/gemm.py
// `_NN_LAUNCH`): one ctypes argument in place of thirty, a few microseconds
// less host time a launch.
struct NNLaunch {
  long long r_dt, epilogue;
  long long a1, sa1, lda1, a1_f32, b1, sb1, ldb1, k1;
  long long a2, sa2, lda2, a2_f32, b2, sb2, ldb2, k2, row_offset2;
  long long c, sc, ldc, c_bf16, bias, mask;
  double scale;
  long long M, N, batch, stream;
  long long res, res_bf16, colsum, ldp;
};
static_assert(sizeof(NNLaunch) == 34 * 8, "NNLaunch is 34 packed 8-byte fields");

// gemm_nn.cu: one NN launch (see the definition for the arguments); a
// cudaError_t code, or a negative refusal code without launching.
extern "C" int wf_gemm_nn(const NNLaunch* p);

// The arguments of one TN launch, 18 packed 8-byte fields (ops/gemm.py
// `_TN_LAUNCH`).
struct TNLaunch {
  long long r_dt, a, lda, b, ldb, c, sc, ldc, M, N, K, kc, stream;
  long long batch, sa, sb, st, a_off;
};
static_assert(sizeof(TNLaunch) == 18 * 8, "TNLaunch is 18 packed 8-byte fields");

// gemm_nn.cu: one TN launch; a cudaError_t code, or a negative refusal code
// without launching.
extern "C" int wf_gemm_tn(const TNLaunch* p);
