// The fixed-order reduction that finishes a split-K product: every
// split-K TN product of csrc/gemm_nn.cu's core (the weight gradients of rows
// 5, 7, 11, 13, 15, 17 and 19) and the LSTM recurrences' bias partials are
// added here by `wf_sum_splits`.
//
// A TPU kernel carries weight-gradient sums across its sequential grid; CUDA
// blocks run in no order. A long reduction (K = slices * N = 12,288 at the
// reference width) therefore splits K into chunks, each block writing its
// own float32 partial, and `wf_sum_splits` adds the partials in split order:
// the result does not depend on the order blocks ran in.
//
// Bound: device memory (each partial read once, the sum written once).
#include <cstdint>

#include "common.cuh"

namespace wf {
namespace {

// out[m*ldo + n] = sum over s in order of part[s*stride + m*N + n].
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  long long stride, float* __restrict__ out,
                                  int M, int N, int ldo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * N) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * stride + i];
  out[(i / N) * ldo + i % N] = v;
}

}  // namespace
}  // namespace wf

// out[m, n] (row stride ldo) = sum over the `splits` float32 partials
// part[s] ([M, N], `stride` floats apart), added in split order.
extern "C" int wf_sum_splits(const float* part, int splits, long long stride,
                             float* out, int M, int N, int ldo, void* stream) {
  if (M <= 0 || N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)M * N;
  wf::sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      part, splits, stride, out, M, N, ldo);
  return (int)cudaGetLastError();
}
