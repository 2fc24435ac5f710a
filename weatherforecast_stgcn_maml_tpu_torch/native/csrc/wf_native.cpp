// The port's native host pipeline: five single-pass C++ host functions,
// bound with ctypes by weatherforecast_stgcn_maml_tpu_torch/native, which
// builds this file with g++ at first use and keeps a numpy route beside
// each function for a machine without a compiler.
//
//   wf_knn_edges            brute-force kNN over grid node positions
//   wf_normalized_adjacency dense GCN-normalized adjacency with padding
//   wf_nan_fill_stats       fused NaN-fill + per-variable mean/std (one pass)
//   wf_normalize            in-place z-score over [T*N, C]
//   wf_gather_windows       materialize [S, W, N, C] / [S, H, N, Cy] window
//                           batches from a [T, N, C] feature tensor
//
// The functions are the JAX package's (native/wf_native.cpp at the root of
// the repository), line for line, so that the two packages' graphs and
// features are equal bit for bit where both libraries are on. They replace
// no TPU kernel: graph construction and feature preparation run on the
// host before any device work (the forecast request's host stages).
// All buffers are caller-allocated numpy arrays; no memory crosses the
// boundary in either direction.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Directed kNN over positions [n, 2] -> edges [n*k, 2] as (src, dst),
// self excluded, neighbors sorted by ascending distance (ties by index,
// matching the numpy argpartition+stable-sort path in graph.py).
void wf_knn_edges(const double* pos, int64_t n, int64_t k, int64_t* out_edges) {
  std::vector<std::pair<double, int64_t>> cand;
  for (int64_t i = 0; i < n; ++i) {
    cand.clear();
    cand.reserve(n - 1);
    const double yi = pos[2 * i], xi = pos[2 * i + 1];
    for (int64_t j = 0; j < n; ++j) {
      if (j == i) continue;
      const double dy = pos[2 * j] - yi, dx = pos[2 * j + 1] - xi;
      cand.emplace_back(dy * dy + dx * dx, j);
    }
    std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
    for (int64_t m = 0; m < k; ++m) {
      out_edges[2 * (i * k + m)] = cand[m].second;  // src
      out_edges[2 * (i * k + m) + 1] = i;           // dst
    }
  }
}

// Dense A_hat = D^-1/2 (A + I) D^-1/2 over `pad`x`pad` (rows/cols >= n zero).
// edges: [e, 2] (src, dst); A[dst, src] = 1.
void wf_normalized_adjacency(const int64_t* edges, int64_t e, int64_t n,
                             int64_t pad, float* out) {
  std::memset(out, 0, sizeof(float) * pad * pad);
  std::vector<double> a(n * n, 0.0);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t src = edges[2 * i], dst = edges[2 * i + 1];
    a[dst * n + src] = 1.0;
  }
  for (int64_t i = 0; i < n; ++i) a[i * n + i] += 1.0;
  std::vector<double> inv_sqrt(n);
  for (int64_t i = 0; i < n; ++i) {
    double deg = 0.0;
    for (int64_t j = 0; j < n; ++j) deg += a[i * n + j];
    inv_sqrt[i] = deg > 0 ? 1.0 / std::sqrt(deg) : 0.0;
  }
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      out[i * pad + j] = static_cast<float>(inv_sqrt[i] * a[i * n + j] * inv_sqrt[j]);
}

// Fused pass over data [rows, c]: replace NaNs with the per-column mean of
// the finite entries (0 if a column is all-NaN), then emit per-column mean
// and std (of the NaN-filled data, +1e-8). One read-modify pass + one
// reduction pass instead of numpy's four full-array traversals.
void wf_nan_fill_stats(float* data, int64_t rows, int64_t c, float* mean_out,
                       float* std_out) {
  std::vector<double> sum(c, 0.0), count(c, 0.0);
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = data + r * c;
    for (int64_t j = 0; j < c; ++j) {
      const float v = row[j];
      if (!std::isnan(v)) {
        sum[j] += v;
        count[j] += 1.0;
      }
    }
  }
  std::vector<double> fill(c);
  for (int64_t j = 0; j < c; ++j) fill[j] = count[j] > 0 ? sum[j] / count[j] : 0.0;

  std::vector<double> m2(c, 0.0), total(c, 0.0);
  for (int64_t r = 0; r < rows; ++r) {
    float* row = data + r * c;
    for (int64_t j = 0; j < c; ++j) {
      if (std::isnan(row[j])) row[j] = static_cast<float>(fill[j]);
      total[j] += row[j];
    }
  }
  for (int64_t j = 0; j < c; ++j) mean_out[j] = static_cast<float>(total[j] / rows);
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = data + r * c;
    for (int64_t j = 0; j < c; ++j) {
      const double d = row[j] - mean_out[j];
      m2[j] += d * d;
    }
  }
  for (int64_t j = 0; j < c; ++j)
    std_out[j] = static_cast<float>(std::sqrt(m2[j] / rows) + 1e-8);
}

// In-place z-score of data [rows, c] with given per-column mean/std.
void wf_normalize(float* data, int64_t rows, int64_t c, const float* mean,
                  const float* std_dev) {
  std::vector<float> inv(c);
  for (int64_t j = 0; j < c; ++j) inv[j] = 1.0f / std_dev[j];
  for (int64_t r = 0; r < rows; ++r) {
    float* row = data + r * c;
    for (int64_t j = 0; j < c; ++j) row[j] = (row[j] - mean[j]) * inv[j];
  }
}

// Materialize window batches from feats [t, n, c]:
//   x_out [s, w, n, c]  = feats[a-w : a]          for each anchor a
//   y_out [s, h, n, yc] = feats[a+1 : a+1+h, :, :yc]
void wf_gather_windows(const float* feats, int64_t t, int64_t n, int64_t c,
                       const int64_t* anchors, int64_t s, int64_t w, int64_t h,
                       int64_t yc, float* x_out, float* y_out) {
  const int64_t step = n * c;
  for (int64_t i = 0; i < s; ++i) {
    const int64_t a = anchors[i];
    std::memcpy(x_out + i * w * step, feats + (a - w) * step,
                sizeof(float) * w * step);
    float* ydst = y_out + i * h * n * yc;
    for (int64_t hh = 0; hh < h; ++hh) {
      const float* src = feats + (a + 1 + hh) * step;
      for (int64_t node = 0; node < n; ++node)
        std::memcpy(ydst + (hh * n + node) * yc, src + node * c,
                    sizeof(float) * yc);
    }
  }
}

}  // extern "C"
