// The sort engine's psi lookup for sm_90a: a binary search in the sorted
// sample buffer, four kernels on one search core.
//
// Replaces the sort-based lookup of naqs_tpu/ops/local_energy.py, which the
// JAX package runs where no rank table exists (over 32 qubits, or a sector of
// more than 2^26 states): pack_table (:170) and _lookup (:183), a
// searchsorted(method="sort") of the coupled states in the sorted buffer
// followed by a record gather, with the ratio/row-sum epilogue of
// _local_energy_chunk (:236-247) for sorted_ratio_rowsum, that epilogue with
// the segment-sum branch of _offdiag_h (:209-213) and diagonal_energy (:164)
// for sorted_local_energy, and the lookup of _quadratic_energy_chunk
// (:363-372) for sorted_gather2, with that chunk's epilogue (:330-381), the
// segment-sum H row and the diagonal for sorted_quadratic_energy. For chunk
// states s (C,), flip masks xy (K,),
// q = s[c] ^ xy[k], the sorted int64 buffer states (U,) with la, ph (U,) f32
// beside it and n = min(*n_valid, U):
//
//   pos(q)   = the last index i < n with states[i] <= q (0 if none)
//   found(q) = n > 0 && states[pos] == q
//   sorted_ratio_rowsum: e_re[c] + i e_im[c] = sum_k h[c, k] * r[c, k], with
//                        r = found ? exp(clamp(la[pos] - my_la[c], -30, 30))
//                                    * (cos, sin)(ph[pos] - my_ph[c]) : 0
//   sorted_gather2:      (out_la, out_ph)[c, k] = found && live[c]
//                        ? (la[pos], ph[pos]) : (-200, 0)
//   sorted_local_energy: for every query row, (double) the same sum with
//                        h[c, k] = sum over group k's terms of coeff *
//                        (-1)^popcount(s & yz) (csrc/offdiag_h.cu's sum),
//                        plus in f64 sum_d diag_coeff[d] *
//                        (-1)^popcount(s & diag_yz[d]) on the real part.
//   sorted_quadratic_energy: for every buffer row m below n, w_m and the
//                        numerator of <psi|H|psi> (csrc/row_energy.cuh's
//                        Quadratic epilogue, the same h); (0, 0) elsewhere.
//
// found equals JAX's (states[pos'] == q) & (pos' < n_valid) for pos' the
// searchsorted position in the whole buffer: the padding beyond n_valid is
// SENTINEL = INT64_MAX, which no query of a padded chunk row finds either.
// n_valid stays on the card: the kernels read it through a pointer, so a
// chunk loop never waits for the host.
//
// What bounds the first two: bytes, by the count of each input read once. At
// the N2 6-31G chunk (C = 128, K = 27,392, U = 100,000) sorted_ratio_rowsum
// must read h (14.0 MB), and of the table only the keys of the n_valid live
// states (about 21,000: 0.17 MB) and la, ph of the rows it finds;
// sorted_gather2 must write its two (C, K) outputs. What the design pays
// instead is the search: 15-17 dependent loads per coupled state, from L2
// (the table stays resident in the 50 MB L2).
//
// Design of sorted_ratio_rowsum and sorted_gather2 (first, simple kernels):
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
// sorted_local_energy is the whole E_loc call of the sort engine with no
// dense A in one launch, sorted_quadratic_energy the whole quadratic_energy
// call; both are row_energy_kernel (csrc/row_energy.cuh) with SearchLookup
// below, the first with the LocalEnergy epilogue, the second with Quadratic.
// What bounds them now: operations, per coupled state of a live row the xor
// and the filter's probe (csrc/row_energy.cuh), and a search only for the
// ~1% the filter passes; the bytes (the live keys, xy, the grouped terms, the
// rows and the outputs) are a few MB. Before the filter every coupled state
// was searched (568 M searches of 15 dependent loads a call on N2 6-31G, for
// 122,206 found states): the misses set the time. What held the two-kernel
// chunk loop back, and what this design does about it:
// * Padding rows. About four fifths of a capacity-100,000 buffer is SENTINEL,
//   and their off-diagonal part is exactly 0: for xy != 0, SENTINEL ^ xy has
//   bit 62 set, which no state of at most 62 qubits has, and xy == 0 is a
//   padded flip mask with no terms. A SENTINEL row costs one load and two
//   stores: its diagonal is computed once per block. Rows go to a persistent
//   grid (the blocks the card holds at once) by a stride, block b taking
//   rows b, b + gridDim.x, ..., so the live rows at the front of the buffer
//   spread over every SM; a block reads kThreads of its rows at once, writes
//   the padding rows' outputs and then walks its live rows.
// * H only for found pairs. No (C, K) H exists: a thread that finds a
//   coupled state walks that flip mask's terms (xy_ptr[k] .. xy_ptr[k+1]-1)
//   in index order with offdiag_h_terms_kernel's fp32 adds, so it gets the
//   same h bits, then adds h * r as sorted_ratio_rowsum_kernel does, in the
//   same per-thread order, shuffle tree and warp order: the off-diagonal
//   sums are that kernel's bits on the same h. An empty group (a padded flip
//   mask) is never looked up. Real hits are rare (a few per row of 27,257
//   flip masks on N2 6-31G), so a finding lane walks its group alone.
// * The filter. Each block hashes the n live keys into a 64 KB bitmap in
//   shared memory (csrc/row_energy.cuh); a coupled state that no sample holds
//   is dropped after one probe, and only the filter's hits are searched: at
//   N2 6-31G's ~20,850 live keys about 1% of the 27,257 flip masks a row,
//   against every one of them before. A table of more than 262,144 rows (the
//   full sector's table of exact mode) takes the unfiltered kernel, which
//   searches every pair, as before.
// * The search. The block stages the top of the table in shared memory once:
//   every 2^shift-th of the n live keys, with 2^shift >= 16 the smallest
//   power of two that fits the space it has (16 keys, one 128-byte line).
//   Beside the filter that is kTopKeys (16 KB: 16 up to 32,768 live keys,
//   128 at 262,144); in the unfiltered kernel kPlainTopKeys (32 KB, 2^9 at
//   the 1,656,369 keys of H2O 6-31G's sector). A query searches the top
//   there, then the one window of 2^shift keys of the global table below it,
//   which L1 and L2 hold: at N2 6-31G's ~20,000 live keys 11 levels in shared
//   memory and 4 in one line. The keys are strided, so the staging is a
//   gather by plain loads, all in flight at once, not a bulk copy.
// * No host loop. The diagonal is summed in f64 in the same launch, each
//   thread its terms d = tid + j * 256 in order, then a shuffle tree and the
//   warps in order; n_valid is read through its pointer. One launch per call.
// Every sum is in a fixed order with no atomics: bitwise repeatable.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/sort_lookup.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_energy.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kUnroll = 8;     // sorted_ratio_rowsum: columns in flight per thread
constexpr int kRows = 4;       // sorted_gather2: rows a block owns
constexpr int kWarps = kThreads / 32;
constexpr float kQuadMiss = -200.0f;  // quadratic_energy's miss log-amp

using row_energy::live_count;  // *n_valid clamped to [0, n_states]

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


// ------------------------------------------- the one-launch kernels' search

constexpr int kTopKeys = 2048;       // keys of the shared-memory top beside the filter: 16 KB
constexpr int kPlainTopKeys = 4096;  // the unfiltered kernel's top: 32 KB
constexpr int kMinShift = 4;         // windows of at least 16 keys: one 128-byte line

// kQ searches at once, as search() above, through the shared top: j = the last
// index < m with top[j] <= q (0 if none), then within the window of 2^shift
// keys from j << shift, positions at or past n counted as above every query.
// pos and val as search()'s; n > 0 (so m > 0).
template <int kQ>
__device__ __forceinline__ void search_top(const int64_t* top, int m, int shift,
                                           const int64_t* __restrict__ states, int64_t n,
                                           const int64_t (&q)[kQ], uint32_t (&pos)[kQ],
                                           int64_t (&val)[kQ]) {
  uint32_t j[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) j[u] = 0;
  for (int len = m; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (top[j[u] + half] <= q[u]) j[u] += half;
    }
    len -= half;
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    pos[u] = j[u] << shift;
    val[u] = top[j[u]];
  }
  const uint32_t end = static_cast<uint32_t>(n);
  for (uint32_t len = 1u << shift; len > 1;) {
    const uint32_t half = len >> 1;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const uint32_t i = pos[u] + half;
      const int64_t x = i < end ? __ldg(states + i) : row_energy::kSentinel;
      if (i < end && x <= q[u]) {
        pos[u] = i;
        val[u] = x;
      }
    }
    len -= half;
  }
}

// row_energy_kernel's lookup in the sorted sample buffer (csrc/row_energy.cuh):
// found = the last of the first n states <= q equals q; (la', ph') = (la, ph)
// there. The block stages the top of the table, every 2^shift-th live key,
// in the shared memory it is given once: kTopKeys (16 KB) beside the filter,
// where the filter's hits are the only searches (about one a thread and
// row); kPlainTopKeys (32 KB) in the unfiltered kernel. (The filtered kernel
// builds no filter only where n is 0: then nothing is staged or searched.)
struct SearchLookup {
  struct Table {
    const int64_t* states;  // the sorted buffer: the filter's keys
    const float* la;
    const float* ph;
  };
  struct Shared {};
  static constexpr int kSpareBytes = kTopKeys * 8;
  static constexpr int kPlainSpareBytes = kPlainTopKeys * 8;
  Table tab;
  const int64_t* top;
  int64_t n;
  int m, shift;

  __device__ void init(Shared&, const Table& t, int64_t n_live, void* spare, int spare_bytes) {
    tab = t;
    n = n_live;
    int64_t* sh = static_cast<int64_t*>(spare);
    top = sh;
    const int64_t cap = spare_bytes / 8;
    shift = kMinShift;
    while (n > (cap << shift)) ++shift;
    m = static_cast<int>((n + (int64_t{1} << shift) - 1) >> shift);
    for (int j = threadIdx.x; j < m; j += row_energy::kThreads)
      sh[j] = __ldg(t.states + (static_cast<int64_t>(j) << shift));
  }
  __device__ bool empty() const { return n == 0; }
  __device__ uint64_t key(int64_t q) const { return static_cast<uint64_t>(q); }
  __device__ bool screen(int64_t) const { return true; }
  template <int kQ>
  __device__ void find(const int64_t (&q)[kQ], const bool (&want)[kQ], bool (&found)[kQ],
                       float2 (&v)[kQ]) const {
    int64_t val[kQ];
    uint32_t pos[kQ];
    search_top(top, m, shift, tab.states, n, q, pos, val);
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      found[u] = want[u] && val[u] == q[u];
      v[u] = found[u] ? make_float2(__ldg(tab.la + pos[u]), __ldg(tab.ph + pos[u]))
                      : make_float2(0.f, 0.f);
    }
  }
};

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

extern "C" int sorted_local_energy(const void* states, int n_states, const void* la,
                                   const void* ph, const void* n_valid, const void* q_states,
                                   int n_rows, const void* q_la, const void* q_ph,
                                   const void* xy, const void* xy_ptr, int n_cols,
                                   const void* term_yz, const void* yz_unique,
                                   const void* term_coeff, const void* diag_yz,
                                   const void* diag_coeff, int n_diag, void* e_re, void* e_im,
                                   void* stream) {
  const SearchLookup::Table t = {static_cast<const int64_t*>(states),
                                 static_cast<const float*>(la), static_cast<const float*>(ph)};
  return row_energy::launch<SearchLookup, row_energy::LocalEnergy>(
      row_energy::make_rows(n_valid, n_states, q_states, n_rows, q_la, q_ph, xy, xy_ptr, n_cols,
              term_yz, yz_unique, term_coeff, diag_yz, diag_coeff, n_diag, e_re, e_im),
      t, static_cast<cudaStream_t>(stream));
}

extern "C" int sorted_quadratic_energy(const void* states, int n_states, const void* la,
                                       const void* ph, const void* n_valid, const void* xy,
                                       const void* xy_ptr, int n_cols, const void* term_yz,
                                       const void* yz_unique, const void* term_coeff,
                                       const void* diag_yz, const void* diag_coeff,
                                       int n_diag, void* num, void* w, void* stream) {
  const SearchLookup::Table t = {static_cast<const int64_t*>(states),
                                 static_cast<const float*>(la), static_cast<const float*>(ph)};
  return row_energy::launch<SearchLookup, row_energy::Quadratic>(
      row_energy::make_rows(n_valid, n_states, states, n_states, la, ph, xy, xy_ptr, n_cols,
              term_yz, yz_unique, term_coeff, diag_yz, diag_coeff, n_diag, num, w),
      t, static_cast<cudaStream_t>(stream));
}

extern "C" const char* sort_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
