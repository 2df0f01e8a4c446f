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
// order through shared memory. No atomics in any sum: every run gives the same
// bits, and the bits of the first design (before the filter below), which
// added the same found pairs in the same order.
//
// What bounds the kernels: the coupled states that no sample holds. Nearly
// every lookup misses (N2 6-31G: 568 M searches of 15 dependent loads for
// 122,206 found states, 0.02%; frozen-core N2 6-31G: 101 M random 8-byte reads
// of a 153 MB table, out of L2, for 2.47 M found), so a miss's cost set the
// time, not a found pair's terms. The filter drops a miss for a few integer
// operations and one shared-memory load. What bounds them now: those
// probes, ~20 integer instructions and a shared load a pair at 2 blocks an
// SM, which take about two thirds of sorted_local_energy's time at N2
// 6-31G's shape, and the searches of the filter's hits the rest (the rank
// table: the sector test on every pair, the probe inside a sector, and the
// hits' table reads); measured in PERF.md §6 with tools/row_timing.py.
//
// Design:
// * A persistent grid over the query rows (the blocks the card holds at
//   once), rows handed out by stride, block b taking rows b, b + gridDim.x, ...,
//   so the live rows at the front of a buffer spread over every SM. A block
//   reads kThreads of its rows at once, writes the outputs of the rows it does
//   not walk, then walks its walked rows.
// * The filter of the sampled states. Each block hashes the table's n live
//   keys (Lookup::key: the state, or for the rank table its low 2S bits) into
//   a bitmap of kFilterWords 32-bit words in dynamic shared memory with shared
//   atomicOr (the same bits in any order): key * kFilterMul (mod 2^64), its
//   top kFilterLog2Words bits pick the word, the next two 5-bit fields two
//   bits in it (naqs_tpu_torch/ops/live_filter.py is its plain version, with
//   the same constants). A coupled state passes when both its bits are set:
//   every live key passes, and a state that is not one passes at a rate of
//   about 1% at 20,000-26,000 live keys. Rows are walked kRows at a time: a
//   thread loads its flip masks once for the kRows rows, tests each pair
//   (Lookup::screen first: the rank table's sector test), and queues the
//   passing pairs (column and row) in shared memory, kQueue a thread. When a
//   lane's queue may overflow, and after the last column, the warp flushes:
//   each lane takes its queued pairs in order, kQ at a time, loads their
//   groups' bounds and runs the lookup on them. So a lane adds its found
//   pairs in column order, as before, and the lookups of a warp run together
//   instead of one lane's at a time.
// * Two instantiations of each lookup and epilogue, one launch a call: the
//   filter's 64 KB and the queue's 16 KB leave room for 2 blocks an SM, and
//   a walk with no filter wants the first design's 4 (its lookups are
//   latency-bound: measured 1.8x slower at 2). So a table of at most
//   kFilterTableMax = kFilterKeys rows (2 bits a key; a sampled batch) takes
//   the filtered kernel, and a larger one (exact mode's sector tables) the
//   unfiltered kernel, the first design's walk at its occupancy. The host
//   chooses by the table's shape and reads nothing back; even at 2-3 bits a
//   key the filter measured faster than none. The filtered kernel reads n on
//   the card and builds no filter where n is 0 (nothing can be found): its
//   blocks then walk their rows one at a time as the first design did, every
//   pair with terms going to the lookup, kUnroll at once.
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
constexpr int kUnroll = 4;                 // unfiltered walk: coupled states in flight
constexpr int kRowBits = 2;                // filtered walk: 2^kRowBits rows at once
constexpr int kRows = 1 << kRowBits;
constexpr int kCols = 4;                   // filtered walk: flip masks loaded at once
constexpr int kQueue = 16;                 // filtered walk: queued pairs a thread
constexpr int kQ = 4;                      // filtered walk: lookups in flight a lane
constexpr int kMaxDevices = 64;
constexpr int64_t kSentinel = INT64_MAX;   // naqs_tpu_torch/utils/bits.py's SENTINEL

// the filter (naqs_tpu_torch/ops/live_filter.py holds the same constants)
constexpr int kFilterLog2Words = 14;
constexpr int kFilterWords = 1 << kFilterLog2Words;          // 64 KB
constexpr int64_t kFilterKeys = int64_t{kFilterWords} * 32 / 2;  // 2 bits a key: 262,144
constexpr uint64_t kFilterMul = 0x9E3779B97F4A7C15ull;       // odd
constexpr int kFilterBytes = kFilterWords * 4;
constexpr int kQueueBytes = kQueue * kThreads * 4;
// tables of at most this many rows take the filtered kernel (2 blocks an SM:
// the filter's shared memory), larger ones the unfiltered kernel (4 blocks an
// SM, the first design's walk): a choice by shape, made on the host
constexpr int kFilterTableMax = static_cast<int>(kFilterKeys);

// what every instantiation reads besides its table
struct Rows {
  const int64_t* n_valid;  // 0-d live count of the table's keys on the card
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

// ------------------------------------------------------------------ the filter

// the word of a key and the mask of its two bits
struct FilterBits {
  uint32_t word, mask;
};

__device__ __forceinline__ FilterBits filter_bits(uint64_t key) {
  const uint32_t hi = static_cast<uint32_t>((key * kFilterMul) >> 32);
  return {hi >> (32 - kFilterLog2Words),
          (1u << ((hi >> (27 - kFilterLog2Words)) & 31u)) |
              (1u << ((hi >> (22 - kFilterLog2Words)) & 31u))};
}

// the block's filter of keys[0, n) (the caller syncs before a probe)
template <class Lookup>
__device__ __forceinline__ void build_filter(uint32_t* f, const Lookup& look,
                                             const int64_t* __restrict__ keys, int64_t n) {
  uint4* f4 = reinterpret_cast<uint4*>(f);
  for (int i = threadIdx.x; i < kFilterWords / 4; i += kThreads) f4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const FilterBits b = filter_bits(look.key(__ldg(keys + i)));
    atomicOr(f + b.word, b.mask);
  }
}

__device__ __forceinline__ bool in_filter(const uint32_t* f, uint64_t key) {
  const FilterBits b = filter_bits(key);
  return (f[b.word] & b.mask) == b.mask;
}

// ------------------------------------------------------------------ row pieces

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

// x[r] for a row r known only at run time, by selects (no local memory)
template <class T, int R>
__device__ __forceinline__ T pick(const T (&x)[R], int r) {
  T out = x[0];
#pragma unroll
  for (int i = 1; i < R; ++i) out = r == i ? x[i] : out;
  return out;
}

// a block's sums of R rows in a fixed order (each warp's shuffle tree, then
// the warps in order): valid on thread 0
struct RowSums {
  float re, im;
  double diag;
};

struct SumScratch {
  float part[2][kRows][kWarps];
  double dpart[kRows][kWarps];
};

// one row's (the unfiltered walk's and the padding rows' diagonal)
__device__ __forceinline__ RowSums block_sums(float re, float im, double diag, SumScratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    re += __shfl_xor_sync(0xFFFFFFFFu, re, off);
    im += __shfl_xor_sync(0xFFFFFFFFu, im, off);
    diag += __shfl_xor_sync(0xFFFFFFFFu, diag, off);
  }
  if (lane == 0) {
    sc.part[0][0][warp] = re;
    sc.part[1][0][warp] = im;
    sc.dpart[0][warp] = diag;
  }
  __syncthreads();
  RowSums out = {0.f, 0.f, 0.0};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      out.re += sc.part[0][0][w];
      out.im += sc.part[1][0][w];
      out.diag += sc.dpart[0][w];
    }
  }
  __syncthreads();  // the scratch is free for the next row
  return out;
}

// R rows' at once (the filtered walk's), each in the one-row order
template <int R>
__device__ __forceinline__ void block_sums(float (&re)[R], float (&im)[R], double (&dg)[R],
                                           SumScratch& sc, RowSums (&out)[R]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re[r] += __shfl_xor_sync(0xFFFFFFFFu, re[r], off);
      im[r] += __shfl_xor_sync(0xFFFFFFFFu, im[r], off);
      dg[r] += __shfl_xor_sync(0xFFFFFFFFu, dg[r], off);
    }
    if (lane == 0) {
      sc.part[0][r][warp] = re[r];
      sc.part[1][r][warp] = im[r];
      sc.dpart[r][warp] = dg[r];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[r] = {0.f, 0.f, 0.0};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        out[r].re += sc.part[0][r][w];
        out[r].im += sc.part[1][r][w];
        out[r].diag += sc.dpart[r][w];
      }
    }
  }
  __syncthreads();  // the scratch is free for the next rows
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

// dynamic shared memory of an instantiation: the filter, the queue and the
// lookup's spare; the unfiltered kernel only the lookup's spare for its
// unfiltered walk (the search's top: Lookup::kPlainSpareBytes)
template <class Lookup, bool kFiltered>
__host__ __device__ constexpr int dyn_bytes() {
  return kFiltered ? kFilterBytes + kQueueBytes + Lookup::kSpareBytes
                   : Lookup::kPlainSpareBytes;
}

// ------------------------------------------------------------------ the walks

// The batch's walked rows one at a time, every pair with terms looked up,
// kUnroll at once: the unfiltered kernel's walk (the first design's, in its
// scalar form), and the filtered kernel's where n is 0.
template <class Lookup, class Epilogue>
__device__ __forceinline__ void walk_each(const Rows& a, const Lookup& look, int64_t i0,
                                          int64_t stride, const int64_t* batch,
                                          const bool* walk, SumScratch& sc) {
  for (int r = 0; r < kThreads; ++r) {
    if (!walk[r]) continue;  // the same for the whole block
    const int64_t s = batch[r];
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
        q[u] = in ? s ^ __ldg(a.xy + k) : 0;
        want[u] = lo[u] < hi[u];  // a flip mask with terms (never a padded one)
      }
      look.find(q, want, found, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (found[u]) Epilogue::pair(group_h(a, s, lo[u], hi[u]), v[u], la0, ph0, acc_re,
                                     acc_im);
      }
    }
    const RowSums sums = block_sums(acc_re, acc_im, diag_part(a, s), sc);
    if (threadIdx.x == 0) Epilogue::write(a, row, sums, la0);
  }
}

// A lane's queued pairs, in queue order, kQ at a time: the lookup, then for a
// found pair its group's h and the epilogue into its row's sums.
template <class Lookup, class Epilogue>
__device__ __forceinline__ void flush(const Rows& a, const Lookup& look, const int32_t* queue,
                                      int count, const int64_t (&s)[kRows],
                                      const float (&la0)[kRows], const float (&ph0)[kRows],
                                      float (&re)[kRows], float (&im)[kRows]) {
  for (int i0 = 0; __any_sync(0xFFFFFFFFu, i0 < count); i0 += kQ) {
    int64_t q[kQ];
    int lo[kQ], hi[kQ], rr[kQ];
    bool want[kQ], found[kQ];
    float2 v[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const bool in = i0 + u < count;
      const int c = in ? queue[(i0 + u) * kThreads + threadIdx.x] : 0;
      const int k = c >> kRowBits;
      rr[u] = c & (kRows - 1);
      lo[u] = in ? __ldg(a.xy_ptr + k) : 0;
      hi[u] = in ? __ldg(a.xy_ptr + k + 1) : 0;
      q[u] = in ? pick(s, rr[u]) ^ __ldg(a.xy + k) : 0;
      want[u] = lo[u] < hi[u];
    }
    look.find(q, want, found, v);
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (found[u]) {
        const int r = rr[u];
        float pr = pick(re, r), pi = pick(im, r);
        Epilogue::pair(group_h(a, pick(s, r), lo[u], hi[u]), v[u], pick(la0, r), pick(ph0, r),
                       pr, pi);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          re[j] = r == j ? pr : re[j];
          im[j] = r == j ? pi : im[j];
        }
      }
    }
  }
}

// The batch's walked rows kRows at a time through the filter (0 < n <=
// kFilterKeys). order[] lists the walked rows of the batch in order.
template <class Lookup, class Epilogue>
__device__ __forceinline__ void walk_filtered(const Rows& a, const Lookup& look,
                                              const uint32_t* filter, int32_t* queue,
                                              int64_t i0, int64_t stride, const int64_t* batch,
                                              const int* order, int n_walked, SumScratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp_k = threadIdx.x & ~31;
  for (int g = 0; g < n_walked; g += kRows) {  // the same for the whole block
    const int nr = n_walked - g < kRows ? n_walked - g : kRows;
    int64_t s[kRows];
    float la0[kRows], ph0[kRows], re[kRows], im[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool in = r < nr;
      const int b = in ? order[g + r] : 0;
      s[r] = in ? batch[b] : kSentinel;
      la0[r] = in ? __ldg(a.q_la + i0 + b * stride) : 0.f;
      ph0[r] = in ? __ldg(a.q_ph + i0 + b * stride) : 0.f;
      re[r] = 0.f;
      im[r] = 0.f;
    }
    int count = 0;  // this lane's queued pairs
    // the warp's columns warp_k + lane + j * kThreads: its loop is the same
    // for all 32 lanes, so the warp votes together. The next kCols flip masks
    // are loaded while this kCols are probed.
    int64_t next[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int k = warp_k + lane + u * kThreads;
      next[u] = k < a.n_cols ? __ldg(a.xy + k) : 0;
    }
    for (int kb = warp_k; kb < a.n_cols; kb += kThreads * kCols) {
      int64_t x[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + kThreads * kCols + lane + u * kThreads;
        x[u] = next[u];
        next[u] = k < a.n_cols ? __ldg(a.xy + k) : 0;
      }
      // every probe of the kCols x kRows pairs first, with no branch between
      // them (so their loads overlap), then the queueing in column order
      bool pass[kCols][kRows];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int64_t q = s[r] ^ x[u];
          pass[u][r] = look.screen(q) & in_filter(filter, look.key(q));
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + lane + u * kThreads;
        // a zero flip mask is padding (no terms) unless its group says otherwise:
        // its coupled state is the row itself, which the filter always passes
        const bool col = k < a.n_cols &&
                         (x[u] != 0 || __ldg(a.xy_ptr + k) < __ldg(a.xy_ptr + k + 1));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (col && r < nr && pass[u][r]) {
            queue[count * kThreads + threadIdx.x] = (k << kRowBits) | r;
            ++count;
          }
        }
        if (__any_sync(0xFFFFFFFFu, count > kQueue - kRows)) {
          flush<Lookup, Epilogue>(a, look, queue, count, s, la0, ph0, re, im);
          count = 0;
        }
      }
    }
    flush<Lookup, Epilogue>(a, look, queue, count, s, la0, ph0, re, im);
    double dg[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dg[r] = r < nr ? diag_part(a, s[r]) : 0.0;
    RowSums sums[kRows];
    block_sums(re, im, dg, sc, sums);
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r)
        Epilogue::write(a, i0 + order[g + r] * stride, sums[r], la0[r]);
    }
  }
}

// ------------------------------------------------------------------ the body

// Lookup: a default-constructible type with
//   Table                      the table's arguments (by value); its `states`
//                              are the keys the filter is built from
//   Shared                     its static shared memory
//   kSpareBytes                dynamic shared memory it wants beside the
//                              filter and the queue
//   kPlainSpareBytes           the same in the unfiltered kernel
//   init(Shared&, Table, n, spare, spare_bytes)
//                              per block, before the rows (the body syncs
//                              after); spare: its dynamic shared memory, all
//                              of it where the filter is not built
//   empty()                    nothing can be found (no row sum is walked)
//   key(q)                     q's key in the filter
//   screen(q)                  false: q cannot be found (tested before the
//                              filter; the rank lookup's sector test)
//   find(q, want, found, v)    kQ coupled states at once: found[u] only
//                              where want[u]; v[u] = (la', ph') where found
template <class Lookup, class Epilogue, bool kFiltered>
__global__ void __launch_bounds__(kThreads, kFiltered ? 2 : 4) row_energy_kernel(
    const Rows a, const typename Lookup::Table t) {
  extern __shared__ __align__(16) unsigned char dyn[];  // filter, queue, lookup's spare
  __shared__ typename Lookup::Shared lsh;
  __shared__ int64_t batch[kThreads];
  __shared__ bool walk[kThreads];
  __shared__ int order[kFiltered ? kThreads : 1];
  __shared__ int walked_in_warp[kWarps];
  __shared__ SumScratch sc;
  __shared__ double pad_diag;
  const int64_t n = a.n_valid ? live_count(a.n_valid, a.n_states) : 0;
  // the same for every block
  const bool filtered = kFiltered && n > 0 && n <= kFilterKeys;
  uint32_t* filter = reinterpret_cast<uint32_t*>(dyn);
  int32_t* queue = reinterpret_cast<int32_t*>(dyn + kFilterBytes);
  Lookup look;
  if (filtered) {
    look.init(lsh, t, n, dyn + kFilterBytes + kQueueBytes, Lookup::kSpareBytes);
    build_filter(filter, look, t.states, n);
  } else {
    look.init(lsh, t, n, dyn, dyn_bytes<Lookup, kFiltered>());
  }
  if constexpr (Epilogue::kPadDiag) {
    const RowSums pad = block_sums(0.f, 0.f, diag_part(a, kSentinel), sc);
    if (threadIdx.x == 0) pad_diag = pad.diag;
  } else if (threadIdx.x == 0) {
    pad_diag = 0.0;
  }
  __syncthreads();  // the filter, the lookup's shared memory and pad_diag

  const int64_t stride = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, walked);
    if (lane == 0) walked_in_warp[warp] = __popc(ballot);
    __syncthreads();
    if constexpr (kFiltered) {
      if (filtered) {
        // the walked rows in order
        int before = 0, n_walked = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          before += w < warp ? walked_in_warp[w] : 0;
          n_walked += walked_in_warp[w];
        }
        if (walked) order[before + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
        __syncthreads();
        walk_filtered<Lookup, Epilogue>(a, look, filter, queue, i0, stride, batch, order,
                                        n_walked, sc);
      } else {
        walk_each<Lookup, Epilogue>(a, look, i0, stride, batch, walk, sc);
      }
    } else {
      walk_each<Lookup, Epilogue>(a, look, i0, stride, batch, walk, sc);
    }
    __syncthreads();  // batch[], walk[] and order[] are rewritten next
  }
}

// one launch of row_energy_kernel<Lookup, Epilogue, kFiltered> on the
// persistent grid (the blocks the card holds at once with its dynamic shared
// memory, asked once per device and instantiation)
template <class Lookup, class Epilogue, bool kFiltered>
int launch_grid(const Rows& a, const typename Lookup::Table& t, cudaStream_t stream) {
  constexpr int kDynBytes = dyn_bytes<Lookup, kFiltered>();
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    rc = cudaFuncSetAttribute(row_energy_kernel<Lookup, Epilogue, kFiltered>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kDynBytes);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_energy_kernel<Lookup, Epilogue, kFiltered>, kThreads, kDynBytes);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    resident[device] = per_sm * sms;
  }
  const int blocks = resident[device] < a.n_rows ? resident[device] : a.n_rows;
  if (blocks <= 0) return 0;
  row_energy_kernel<Lookup, Epilogue, kFiltered><<<blocks, kThreads, kDynBytes, stream>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

// One launch a call: the filtered kernel where the table has at most
// kFilterTableMax rows (it builds its filter where 0 < n <= kFilterKeys),
// else the unfiltered one. n_states: the table's rows.
template <class Lookup, class Epilogue>
int launch(const Rows& a, const typename Lookup::Table& t, cudaStream_t stream) {
  if (a.n_cols >= (1 << (31 - kRowBits))) return static_cast<int>(cudaErrorInvalidValue);
  return a.n_states <= kFilterTableMax ? launch_grid<Lookup, Epilogue, true>(a, t, stream)
                                       : launch_grid<Lookup, Epilogue, false>(a, t, stream);
}

}  // namespace row_energy
