// The sort engine's psi lookup for sm_90a: a binary search in the sorted
// sample buffer, two kernels on one search core.
//
// Replaces the sort-based lookup of naqs_tpu/ops/local_energy.py, which the
// JAX package runs where no rank table exists (over 32 qubits, or a sector of
// more than 2^26 states): pack_table (:170) and _lookup (:183), a
// searchsorted(method="sort") of the coupled states in the sorted buffer
// followed by a record gather, with the ratio/row-sum epilogue of
// _local_energy_chunk (:236-247) for sorted_ratio_rowsum and the lookup of
// _quadratic_energy_chunk (:363-372) for sorted_gather2. For chunk states
// s (C,), flip masks xy (K,), q = s[c] ^ xy[k], the sorted int64 buffer
// states (U,) with la, ph (U,) f32 beside it and n = min(*n_valid, U):
//
//   pos(q)   = the last index i < n with states[i] <= q (0 if none)
//   found(q) = n > 0 && states[pos] == q
//   sorted_ratio_rowsum: e_re[c] + i e_im[c] = sum_k h[c, k] * r[c, k], with
//                        r = found ? exp(clamp(la[pos] - my_la[c], -30, 30))
//                                    * (cos, sin)(ph[pos] - my_ph[c]) : 0
//   sorted_gather2:      (out_la, out_ph)[c, k] = found && live[c]
//                        ? (la[pos], ph[pos]) : (-200, 0)
//
// found equals JAX's (states[pos'] == q) & (pos' < n_valid) for pos' the
// searchsorted position in the whole buffer: the padding beyond n_valid is
// SENTINEL = INT64_MAX, which no query of a padded chunk row finds either.
// n_valid stays on the card: the kernels read it through a pointer, so a
// chunk loop never waits for the host.
//
// What bounds them: bytes, by the count of each input read once. At the N2
// 6-31G chunk (C = 128, K = 27,392, U = 100,000) sorted_ratio_rowsum must read
// h (14.0 MB), and of the table only the keys of the n_valid live states
// (about 21,000: 0.17 MB) and la, ph of the rows it finds; sorted_gather2 must
// write its two (C, K) outputs. What the design pays instead is the search:
// 15-17 dependent loads per coupled state, from L2 (the table stays resident
// in the 50 MB L2).
//
// Design (a first, simple kernel; a search structure that needs fewer
// dependent loads is later work):
// * The search is branchless and has the same trip count for every query,
//   so a warp never diverges in it; each thread keeps kUnroll (ratio) or
//   kRows (gather) searches in flight, one level of each at a time.
// * sorted_ratio_rowsum has rank_ratio_rowsum's shape (csrc/rank_gather.cu):
//   a block owns one whole row, columns k = tid + j * 256 in order per
//   thread, kUnroll columns' loads before their arithmetic, a warp-shuffle
//   tree, then the warps in order through shared memory. No (C, K) array
//   reaches device memory, there are no atomics, and on the same hits it
//   gives the rank kernel's bits.
// * sorted_gather2 tiles kRows rows x 256 columns a block: a thread loads its
//   flip mask once and writes each output row's 128 contiguous bytes per
//   warp with an evict-first hint.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/sort_lookup.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kUnroll = 8;     // sorted_ratio_rowsum: columns in flight per thread
constexpr int kRows = 4;       // sorted_gather2: rows a block owns
constexpr int kWarps = kThreads / 32;
constexpr float kQuadMiss = -200.0f;  // quadratic_energy's miss log-amp

// the number of states the search covers: *n_valid clamped to [0, n_states]
__device__ __forceinline__ int64_t live_count(const int64_t* __restrict__ n_valid,
                                              int n_states) {
  const int64_t n = __ldg(n_valid);
  return n < 0 ? 0 : (n > n_states ? n_states : n);
}

// kQ searches at once: base[u] = the last index i < n with states[i] <= q[u]
// (0 if none) and val[u] = states[base[u]] (~q[u] if n == 0, so that it never
// equals q[u]): found is val == q, with no load after the last level.
// Branchless, so every query takes the same ceil(log2(n)) levels.
template <int kQ>
__device__ __forceinline__ void search(const int64_t* __restrict__ states, int64_t n,
                                       const int64_t (&q)[kQ], int64_t (&base)[kQ],
                                       int64_t (&val)[kQ]) {
  const int64_t first = n > 0 ? __ldg(states) : 0;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    base[u] = 0;
    val[u] = n > 0 ? first : ~q[u];
  }
  for (int64_t len = n; len > 1;) {
    const int64_t half = len >> 1;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int64_t x = __ldg(states + base[u] + half);
      if (x <= q[u]) {
        base[u] += half;
        val[u] = x;
      }
    }
    len -= half;
  }
}

__global__ void __launch_bounds__(kThreads) sorted_ratio_rowsum_kernel(
    const int64_t* __restrict__ states, int n_states, const float* __restrict__ la,
    const float* __restrict__ ph, const int64_t* __restrict__ n_valid,
    const int64_t* __restrict__ s, const int64_t* __restrict__ xy, int n_cols,
    const float* __restrict__ my_la, const float* __restrict__ my_ph,
    const float* __restrict__ h, float* __restrict__ e_re, float* __restrict__ e_im) {
  __shared__ float partial[2][kWarps];
  const int c = blockIdx.x;
  const int64_t n = live_count(n_valid, n_states);
  const int64_t sc = s[c];
  const float la0 = my_la[c];
  const float ph0 = my_ph[c];
  const float* h_row = h + static_cast<size_t>(c) * n_cols;
  float acc_re = 0.f, acc_im = 0.f;

  for (int k0 = threadIdx.x; k0 < n_cols; k0 += kThreads * kUnroll) {
    int64_t q[kUnroll], pos[kUnroll], val[kUnroll];
    float hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kThreads;
      const bool in = k < n_cols;
      q[u] = in ? sc ^ __ldg(xy + k) : 0;
      hv[u] = in ? __ldcs(h_row + k) : 0.f;  // in flight during the search
    }
    search(states, n, q, pos, val);
    bool found[kUnroll];
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      found[u] = k0 + u * kThreads < n_cols && val[u] == q[u];
      v[u] = found[u] ? make_float2(__ldg(la + pos[u]), __ldg(ph + pos[u]))
                      : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (found[u]) {
        const float mag = expf(fminf(fmaxf(v[u].x - la0, -30.f), 30.f));
        float sn, cs;
        sincosf(v[u].y - ph0, &sn, &cs);
        acc_re += hv[u] * (mag * cs);
        acc_im += hv[u] * (mag * sn);
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_re += __shfl_xor_sync(0xFFFFFFFFu, acc_re, off);
    acc_im += __shfl_xor_sync(0xFFFFFFFFu, acc_im, off);
  }
  if (lane == 0) {
    partial[0][warp] = acc_re;
    partial[1][warp] = acc_im;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += partial[threadIdx.x][w];
    (threadIdx.x ? e_im : e_re)[c] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) sorted_gather2_kernel(
    const int64_t* __restrict__ states, int n_states, const float* __restrict__ la,
    const float* __restrict__ ph, const int64_t* __restrict__ n_valid,
    const int64_t* __restrict__ s, int n_rows, const int64_t* __restrict__ xy, int n_cols,
    const uint8_t* __restrict__ live, float* __restrict__ out_la,
    float* __restrict__ out_ph) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_cols) return;
  const int c0 = blockIdx.y * kRows;
  const int64_t n = live_count(n_valid, n_states);
  const int64_t cw = __ldg(xy + k);
  int64_t q[kRows], pos[kRows], val[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = c0 + r < n_rows ? __ldg(s + c0 + r) ^ cw : 0;
  search(states, n, q, pos, val);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = c0 + r;
    if (c >= n_rows) break;
    const bool found = live[c] && val[r] == q[r];
    const size_t at = static_cast<size_t>(c) * n_cols + k;
    __stcs(out_la + at, found ? __ldg(la + pos[r]) : kQuadMiss);
    __stcs(out_ph + at, found ? __ldg(ph + pos[r]) : 0.f);
  }
}

}  // namespace

extern "C" int sorted_ratio_rowsum(const void* states, int n_states, const void* la,
                                   const void* ph, const void* n_valid, const void* s,
                                   int n_rows, const void* xy, int n_cols, const void* my_la,
                                   const void* my_ph, const void* h, void* e_re, void* e_im,
                                   void* stream) {
  sorted_ratio_rowsum_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(states), n_states, static_cast<const float*>(la),
      static_cast<const float*>(ph), static_cast<const int64_t*>(n_valid),
      static_cast<const int64_t*>(s), static_cast<const int64_t*>(xy), n_cols,
      static_cast<const float*>(my_la), static_cast<const float*>(my_ph),
      static_cast<const float*>(h), static_cast<float*>(e_re), static_cast<float*>(e_im));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sorted_gather2(const void* states, int n_states, const void* la,
                              const void* ph, const void* n_valid, const void* s, int n_rows,
                              const void* xy, int n_cols, const void* live, void* out_la,
                              void* out_ph, void* stream) {
  const dim3 grid((n_cols + kThreads - 1) / kThreads, (n_rows + kRows - 1) / kRows);
  sorted_gather2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(states), n_states, static_cast<const float*>(la),
      static_cast<const float*>(ph), static_cast<const int64_t*>(n_valid),
      static_cast<const int64_t*>(s), n_rows, static_cast<const int64_t*>(xy), n_cols,
      static_cast<const uint8_t*>(live), static_cast<float*>(out_la),
      static_cast<float*>(out_ph));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sort_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
