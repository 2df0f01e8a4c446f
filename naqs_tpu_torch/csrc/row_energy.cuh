// One launch over query rows for sm_90a: each row's local energy, or its
// term of the quadratic energy <psi|H|psi>, with H summed only for the pairs
// whose coupled state is found. The kernel body that csrc/sort_lookup.cu (the
// search lookup) and csrc/rank_gather.cu (the rank lookup) instantiate: the
// lookup and the epilogue are its template parameters.
//
//   csrc/sort_lookup.cu  SearchLookup x LocalEnergy  sorted_local_energy
//                        SearchLookup x Quadratic    sorted_quadratic_energy
//   csrc/rank_gather.cu  RankLookup   x LocalEnergy  rank_local_energy
//                        RankLookup   x Quadratic    rank_quadratic_energy
//
// For a walked query row with state s, psi(s) = exp(la0 + i ph0), and every
// flip mask k with terms (xy_ptr[k] < xy_ptr[k+1]) whose coupled state s ^
// xy[k] the lookup finds, with (la', ph') read there:
//
//   h_k = sum over group k's terms t, in index order, of
//         term_coeff[t] * (-1)^popcount(s & yz_unique[term_yz[t]])
//         (offdiag_h_terms_kernel's fp32 adds, csrc/offdiag_h.cu: the same bits)
//   diag = sum_d diag_coeff[d] * (-1)^popcount(s & diag_yz[d])   (f64)
//
//   LocalEnergy: out0 = diag + (double) sum_k h_k * exp(clamp(la' - la0, -30, 30))
//                                       * cos(ph' - ph0),
//                out1 = (double) the same sum with sin: E_loc (re, im). A row is
//                walked unless its state is SENTINEL; a SENTINEL row gets
//                (diag(SENTINEL), 0), its diagonal computed once per block.
//   Quadratic:   w = exp(2 (double) la0), out0 = w * diag + (double) sum_k h_k *
//                exp(la' + la0) * cos(ph' - ph0), out1 = w: a row's terms of
//                sum num / sum w (naqs_tpu/ops/local_energy.py::
//                _quadratic_energy_chunk, per row). A row is walked if it lies
//                below n_valid; the others get (0, 0).
//
// The fp32 sums run as sorted_ratio_rowsum_kernel's do: each thread its
// columns k = tid + j * 256 in order, then a warp-shuffle tree and the warps in
// order through shared memory. No atomics: every run gives the same bits.
//
// Design (sorted_local_energy's, made generic):
// * A persistent grid over the query rows (the blocks the card holds at
//   once), rows handed out by stride, block b taking rows b, b + gridDim.x, ...,
//   so the live rows at the front of a buffer spread over every SM. A block
//   reads kThreads of its rows at once, writes the outputs of the rows it does
//   not walk, then walks its walked rows one after another with all threads.
// * H only for found pairs: a thread that finds a coupled state walks that
//   flip mask's grouped terms. No (rows, K) array reaches device memory.
// * The lookup: SearchLookup (csrc/sort_lookup.cu) searches the sorted
//   sample buffer through a shared-memory top of its keys; RankLookup
//   (csrc/rank_gather.cu) tests the coupled state's sector by two popcounts
//   and reads the dense rank table only for a state inside a sector.
// * n_valid stays on the card: read through its pointer.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace row_energy {

constexpr int kThreads = 256;              // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // coupled states in flight per thread
constexpr int kMaxDevices = 64;
constexpr int64_t kSentinel = INT64_MAX;   // naqs_tpu_torch/utils/bits.py's SENTINEL

// what every instantiation reads besides its table
struct Rows {
  const int64_t* n_valid;  // 0-d live count on the card, or null (then 0)
  int n_states;            // n_valid is clamped to [0, n_states]
  const int64_t* q_states;
  int n_rows;
  const float* q_la;
  const float* q_ph;
  const int64_t* xy;
  const int32_t* xy_ptr;
  int n_cols;
  const int32_t* term_yz;
  const int64_t* yz_unique;
  const float* term_coeff;
  const int64_t* diag_yz;
  const double* diag_coeff;
  int n_diag;
  double* out0;
  double* out1;
};

// the Rows of a C entry's untyped arguments
inline Rows make_rows(const void* n_valid, int n_states, const void* q_states, int n_rows,
                      const void* q_la, const void* q_ph, const void* xy, const void* xy_ptr,
                      int n_cols, const void* term_yz, const void* yz_unique,
                      const void* term_coeff, const void* diag_yz, const void* diag_coeff,
                      int n_diag, void* out0, void* out1) {
  return {static_cast<const int64_t*>(n_valid), n_states,
          static_cast<const int64_t*>(q_states), n_rows, static_cast<const float*>(q_la),
          static_cast<const float*>(q_ph), static_cast<const int64_t*>(xy),
          static_cast<const int32_t*>(xy_ptr), n_cols, static_cast<const int32_t*>(term_yz),
          static_cast<const int64_t*>(yz_unique), static_cast<const float*>(term_coeff),
          static_cast<const int64_t*>(diag_yz), static_cast<const double*>(diag_coeff),
          n_diag, static_cast<double*>(out0), static_cast<double*>(out1)};
}

// *n_valid clamped to [0, n_states]
__device__ __forceinline__ int64_t live_count(const int64_t* __restrict__ n_valid,
                                              int n_states) {
  const int64_t n = __ldg(n_valid);
  return n < 0 ? 0 : (n > n_states ? n_states : n);
}

// this thread's part of s's diagonal: its terms d = tid + j * kThreads, in order
__device__ __forceinline__ double diag_part(const Rows& a, int64_t s) {
  double d = 0.0;
  for (int k = threadIdx.x; k < a.n_diag; k += kThreads) {
    const double c = __ldg(a.diag_coeff + k);
    d += (__popcll(static_cast<uint64_t>(s & __ldg(a.diag_yz + k))) & 1) ? -c : c;
  }
  return d;
}

// h of flip-mask group [lo, hi) for state s: offdiag_h_terms_kernel's adds
__device__ __forceinline__ float group_h(const Rows& a, int64_t s, int lo, int hi) {
  float h = 0.f;
  for (int t = lo; t < hi; ++t) {
    const uint64_t yz = static_cast<uint64_t>(__ldg(a.yz_unique + __ldg(a.term_yz + t)));
    const uint32_t coeff = __float_as_uint(__ldg(a.term_coeff + t));
    const uint32_t sign = static_cast<uint32_t>(__popcll(static_cast<uint64_t>(s) & yz) & 1)
                          << 31;
    h += __uint_as_float(coeff ^ sign);
  }
  return h;
}

// the block's sums in a fixed order (each warp's shuffle tree, then the warps
// in order): valid on thread 0
struct RowSums {
  float re, im;
  double diag;
};

__device__ __forceinline__ RowSums block_sums(float re, float im, double diag,
                                              float (&part)[2][kWarps],
                                              double (&dpart)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_xor_sync(0xFFFFFFFFu, re, off);
    im += __shfl_xor_sync(0xFFFFFFFFu, im, off);
    diag += __shfl_xor_sync(0xFFFFFFFFu, diag, off);
  }
  if (lane == 0) {
    part[0][warp] = re;
    part[1][warp] = im;
    dpart[warp] = diag;
  }
  __syncthreads();
  RowSums out = {0.f, 0.f, 0.0};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      out.re += part[0][w];
      out.im += part[1][w];
      out.diag += dpart[w];
    }
  }
  __syncthreads();  // part and dpart are free for the next row
  return out;
}

// ------------------------------------------------------------------ epilogues

// E_loc: sum_k h_k psi(s ^ xy_k) / psi(s), plus the diagonal
struct LocalEnergy {
  static constexpr bool kPadDiag = true;  // a row not walked gets diag(SENTINEL)
  __device__ static bool walks(int64_t /*row*/, int64_t s, int64_t /*n*/) {
    return s != kSentinel;
  }
  __device__ static void pair(float h, float2 v, float la0, float ph0, float& re, float& im) {
    const float mag = expf(fminf(fmaxf(v.x - la0, -30.f), 30.f));
    float sn, cs;
    sincosf(v.y - ph0, &sn, &cs);
    re += h * (mag * cs);
    im += h * (mag * sn);
  }
  __device__ static void write(const Rows& a, int64_t row, const RowSums& r, float /*la0*/) {
    a.out0[row] = r.diag + static_cast<double>(r.re);
    a.out1[row] = static_cast<double>(r.im);
  }
  __device__ static void skip(const Rows& a, int64_t row, double pad_diag) {
    a.out0[row] = pad_diag;
    a.out1[row] = 0.0;
  }
};

// <psi|H|psi>: a row's w = |psi|^2 and its numerator, the symmetric product
// form with log-amps shifted so that the live maximum is 0
struct Quadratic {
  static constexpr bool kPadDiag = false;
  __device__ static bool walks(int64_t row, int64_t /*s*/, int64_t n) { return row < n; }
  __device__ static void pair(float h, float2 v, float la0, float ph0, float& re, float&) {
    re += h * (expf(v.x + la0) * cosf(v.y - ph0));
  }
  __device__ static void write(const Rows& a, int64_t row, const RowSums& r, float la0) {
    const double w = exp(2.0 * static_cast<double>(la0));
    a.out0[row] = w * r.diag + static_cast<double>(r.re);
    a.out1[row] = w;
  }
  __device__ static void skip(const Rows& a, int64_t row, double) {
    a.out0[row] = 0.0;
    a.out1[row] = 0.0;
  }
};

// ------------------------------------------------------------------ the body

// Lookup: a default-constructible type with
//   Table                      the table's arguments (by value)
//   Shared                     its shared memory
//   init(Shared&, Table, n)    per block, before the rows (the body syncs after)
//   empty()                    nothing can be found (no row sum is walked)
//   find(q, want, found, v)    kUnroll coupled states at once: found[u] only
//                              where want[u]; v[u] = (la', ph') where found
template <class Lookup, class Epilogue>
__global__ void __launch_bounds__(kThreads, 4) row_energy_kernel(const Rows a,
                                                                 const typename Lookup::Table t) {
  __shared__ typename Lookup::Shared lsh;
  __shared__ int64_t batch[kThreads];
  __shared__ bool walk[kThreads];
  __shared__ float part[2][kWarps];
  __shared__ double dpart[kWarps];
  __shared__ double pad_diag;
  const int64_t n = a.n_valid ? live_count(a.n_valid, a.n_states) : 0;
  Lookup look;
  look.init(lsh, t, n);
  if constexpr (Epilogue::kPadDiag) {
    const RowSums pad = block_sums(0.f, 0.f, diag_part(a, kSentinel), part, dpart);
    if (threadIdx.x == 0) pad_diag = pad.diag;
  } else if (threadIdx.x == 0) {
    pad_diag = 0.0;
  }
  __syncthreads();  // the lookup's shared memory and pad_diag

  const int64_t stride = gridDim.x;
  for (int64_t i0 = blockIdx.x; i0 < a.n_rows; i0 += stride * kThreads) {
    // kThreads of this block's rows at once: the outputs of rows not walked here
    const int64_t c = i0 + threadIdx.x * stride;
    int64_t s = kSentinel;
    bool walked = false;
    if (c < a.n_rows) {
      s = __ldg(a.q_states + c);
      walked = Epilogue::walks(c, s, n);
      if (!walked) Epilogue::skip(a, c, pad_diag);
    }
    batch[threadIdx.x] = s;
    walk[threadIdx.x] = walked;
    __syncthreads();
    for (int r = 0; r < kThreads; ++r) {
      if (!walk[r]) continue;  // the same for the whole block
      const int64_t sc = batch[r];
      const int64_t row = i0 + r * stride;
      const float la0 = __ldg(a.q_la + row);
      const float ph0 = __ldg(a.q_ph + row);
      float acc_re = 0.f, acc_im = 0.f;
      for (int k0 = threadIdx.x; !look.empty() && k0 < a.n_cols; k0 += kThreads * kUnroll) {
        int64_t q[kUnroll];
        int lo[kUnroll], hi[kUnroll];
        bool want[kUnroll], found[kUnroll];
        float2 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * kThreads;
          const bool in = k < a.n_cols;
          lo[u] = in ? __ldg(a.xy_ptr + k) : 0;
          hi[u] = in ? __ldg(a.xy_ptr + k + 1) : 0;
          q[u] = in ? sc ^ __ldg(a.xy + k) : 0;
          want[u] = lo[u] < hi[u];  // a flip mask with terms (never a padded one)
        }
        look.find(q, want, found, v);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (found[u]) Epilogue::pair(group_h(a, sc, lo[u], hi[u]), v[u], la0, ph0, acc_re,
                                       acc_im);
        }
      }
      const RowSums sums = block_sums(acc_re, acc_im, diag_part(a, sc), part, dpart);
      if (threadIdx.x == 0) Epilogue::write(a, row, sums, la0);
    }
    __syncthreads();  // batch[] and walk[] are rewritten next
  }
}

// one launch of row_energy_kernel<Lookup, Epilogue> on the persistent grid
// (the blocks the card holds at once, asked once per device and instantiation)
template <class Lookup, class Epilogue>
int launch(const Rows& a, const typename Lookup::Table& t, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_energy_kernel<Lookup, Epilogue>, kThreads, 0);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    resident[device] = per_sm * sms;
  }
  const int blocks = resident[device] < a.n_rows ? resident[device] : a.n_rows;
  if (blocks <= 0) return 0;
  row_energy_kernel<Lookup, Epilogue><<<blocks, kThreads, 0, stream>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_energy
