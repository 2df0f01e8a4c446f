// Two-electron repulsion integrals over contracted Cartesian Gaussians, for sm_90a.
//
// Replaces no TPU kernel. The JAX package computes the ERIs on the host in
// numpy (naqs_tpu/chem/integrals.py:251-325): build_integrals' pure-Python
// 8-fold loop over the unique contracted quartets calls _prim_eri once per
// primitive quartet, and that loop takes nearly all of rhf's time (H2O 6-31G:
// 126,753 primitive quartets; N2 6-31G: 551,556). This kernel computes the
// same function:
//
//   (ij|kl) = sum_{abcd} c_a c_b c_c c_d [ab|cd],
//   [ab|cd] = 2 pi^2.5 / (p q sqrt(p + q))
//             * sum_{tuv} E^{ab}_{tuv} sum_{t'u'v'} (-1)^{t'+u'+v'} E^{cd}_{t'u'v'}
//               R_{t+t', u+u', v+v'}(alpha, P - Q),
//
// (McMurchie-Davidson: E the Hermite expansion coefficients of a primitive
// pair, per direction, R the Hermite Coulomb tensor from the Boys function),
// for every unique quartet i, j <= i, k <= i, l <= (j if k == i else k), and
// writes it to the eight symmetric positions of the (n, n, n, n) f64 tensor in
// chemist order, before the spherical-d transform. Different unique quartets
// own disjoint sets of positions.
//
// What bounds it: f64 operations. The output is n^4 x 8 bytes (H2O 6-31G:
// 228 KB), against some hundred operations per primitive quartet (the Boys
// series, the R recursion and the contraction), and the H100 has no f64
// tensor-core path for scalar recursions (34 TFLOP/s f64). At the sizes the
// port reaches (at most 56 qubits) the work is a few hundred thousand to a
// few million primitive quartets, so the latency of each thread's chain of
// loads and its instruction count set the time more than the f64 operations
// do.
//
// Design (the second; the first took one warp a quartet and one launch a
// class):
// * The primitive-pair table (naqs_tpu_torch/chem/integrals.py::pair_table,
//   built on the host once per PackedBasis): a row of 16 doubles per
//   function pair (i, j <= i) and primitive pair (a, b): p, the centre P, and
//   the pair's Hermite weights c_a c_b / p E^x_t E^y_u E^z_v over the box
//   t <= lx_i + lx_j, u <= ..., v <= ... (t outer, v inner; at most 12), the
//   exp(-ab/p |AB|^2) factor inside E_0; stored by column, so that lanes
//   reading neighbouring rows read neighbouring words. A primitive quartet
//   reads a bra row and a ket row and computes only alpha, the Boys values, R
//   and the contraction: no exp, division or E recursion beyond the Boys
//   function's own.
// * The Boys series stops at its first term below 2^-53 of the sum so far
//   (11.7 terms on average at H2O 6-31G's x, not 56). A lane's values do not
//   depend on its neighbours; a warp runs as long as its slowest lane.
// * On a basis whose bras and kets all have exponent sums of at most 2 (every
//   s/p basis) each quartet runs prim_fixed, one instantiation per pair of
//   shapes (55: the host puts the bra's shape first), unrolled: R, the Boys
//   values and the ket's weights in registers, no loop or index arithmetic.
//   On any other basis each quartet runs prim_quartet: loops bounded at run
//   time over R in shared memory, in each thread's own column of the block's
//   (box, kThreads) array (conflict-free), the box sized by the basis'
//   largest.
// * Work: one launch for every class. A work item is a chunk of up to
//   `chunk` consecutive primitive quartets of one unique quartet, one thread
//   an item; the items of a quartet are consecutive, the quartets ordered by
//   class (heaviest first) and then by shape, so that the lanes of a warp
//   mostly share a shape. A warp sums its lanes by quartet (a segmented
//   shuffle scan); a quartet inside one warp is written by the segment's
//   last lane, one across warps leaves each warp's partial in its slot (slot
//   0 for the segment holding lane 0, slot 1 for the one holding lane 31) and
//   takes an arrival ticket; the last warp to arrive adds the partials in
//   warp order. Every sum has a fixed order, so the output is bitwise
//   repeatable. The arrival counters (one int32 a quartet) are zero between
//   launches: the wrapper makes them zero once and the last warp of each
//   quartet sets its counter back to 0.
// * Two instantiations: eri_kernel<false>, prim_fixed (no shared memory,
//   built for kBlocksFixed blocks an SM), and eri_kernel<true>, prim_quartet
//   (2 blocks an SM: the shared R columns of a d basis, 48 doubles a thread,
//   take 96 KB a block).
//
// Boys function F_n(x) = int_0^1 t^2n exp(-x t^2) dt, no gammainc on the card:
// for x < kSeriesMax, F_L = e^-x sum_k (2x)^k / ((2L+1)(2L+3)...(2L+2k+1))
// (positive terms, at most kSeriesTerms: stop before the first term below
// 2^-53 of the sum so far, which the sum would round away but for the last
// bit; the rest of the tail is smaller still, the ratio being below one by
// then) and the downward recursion F_n = (2x F_{n+1} + e^-x) / (2n+1), which
// adds positive terms only; for x >= kSeriesMax, F_0 = sqrt(pi)/2 erf(sqrt x)
// / sqrt x and the upward recursion F_{n+1} = ((2n+1) F_n - e^-x) / 2x, whose
// cancellation magnifies an error by P(1/2, x) / P(L+1/2, x) <= 1.14 there
// (L <= 8). naqs_tpu_torch/chem/integrals.py::boys_ref is its plain torch twin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/chem/integrals.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 8;             // a quartet's total angular momentum: d functions
constexpr int kSeriesTerms = 56;     // the most terms of the Boys series
constexpr double kSeriesMax = 12.0;  // the series below, erf and upward recursion at and above
constexpr double kSeriesStop = 1.1102230246251565e-16;  // 2^-53: the series' stopping ratio
constexpr int kThreads = 256;        // threads a block, one work item each
constexpr int kBlocksFixed = 4;      // blocks an SM the fixed-shape kernel is built for
constexpr int kShapeBits = 3;        // bits of one exponent sum in a quartet's shape code
constexpr unsigned kFull = 0xffffffffu;
constexpr double kHalfSqrtPi = 0.8862269254527579;   // sqrt(pi) / 2
constexpr double kTwoPi25 = 34.986836655249725;      // 2 pi^2.5

#define INV_ODD4(m) 1.0 / (2 * (m) + 1), 1.0 / (2 * (m) + 3), 1.0 / (2 * (m) + 5), \
                    1.0 / (2 * (m) + 7)
// 1 / (2m + 1), m < 64: the series reaches index kMaxL + kSeriesTerms - 1
__constant__ double kInvOdd[64] = {
    INV_ODD4(0),  INV_ODD4(4),  INV_ODD4(8),  INV_ODD4(12), INV_ODD4(16), INV_ODD4(20),
    INV_ODD4(24), INV_ODD4(28), INV_ODD4(32), INV_ODD4(36), INV_ODD4(40), INV_ODD4(44),
    INV_ODD4(48), INV_ODD4(52), INV_ODD4(56), INV_ODD4(60)};
#undef INV_ODD4

// F_0..F_L at x
template <int L>
__device__ __forceinline__ void boys(double x, double* f) {
  const double two_x = 2.0 * x;
  const double ex = exp(-x);
  if (x < kSeriesMax) {
    double term = kInvOdd[L];
    double sum = term;
    for (int k = 1; k < kSeriesTerms; ++k) {
      term *= two_x * kInvOdd[L + k];
      if (term < kSeriesStop * sum) break;
      sum += term;
    }
    f[L] = ex * sum;
#pragma unroll
    for (int n = L - 1; n >= 0; --n) f[n] = (two_x * f[n + 1] + ex) * kInvOdd[n];
  } else {
    const double sx = sqrt(x);
    f[0] = kHalfSqrtPi * erf(sx) / sx;
    const double inv_2x = 0.5 / x;
#pragma unroll
    for (int n = 0; n < L; ++n) f[n + 1] = ((2 * n + 1) * f[n] - ex) * inv_2x;
  }
}

struct Shape {  // the exponent sums of a quartet's bra (t1, u1, v1) and ket (t2, u2, v2)
  int t1, u1, v1, t2, u2, v2;
};

__device__ __forceinline__ Shape decode_shape(int code) {
  constexpr int m = (1 << kShapeBits) - 1;
  return {code & m, (code >> kShapeBits) & m, (code >> 2 * kShapeBits) & m,
          (code >> 3 * kShapeBits) & m, (code >> 4 * kShapeBits) & m,
          (code >> 5 * kShapeBits) & m};
}

// The start of a primitive quartet from its bra and ket rows of the
// column-major pair table (column c of a row at c * rows past its first):
// P - Q into X, Y, Z and R^n_000 = (-2 alpha)^n F_n(alpha |P - Q|^2), n <= L,
// into f; returns the prefactor 2 pi^2.5 / sqrt(p + q) (1/p and 1/q are in the
// rows' weights)
template <int L>
__device__ __forceinline__ double quartet_start(const double* __restrict__ bra,
                                                const double* __restrict__ ket, int rows,
                                                double& X, double& Y, double& Z, double* f) {
  const double p = __ldg(bra), q = __ldg(ket);
  X = __ldg(bra + rows) - __ldg(ket + rows);
  Y = __ldg(bra + 2 * rows) - __ldg(ket + 2 * rows);
  Z = __ldg(bra + 3 * rows) - __ldg(ket + 3 * rows);
  const double alpha = p * q * __drcp_rn(p + q);
  boys<L>(alpha * (X * X + Y * Y + Z * Z), f);
  double pw = 1.0;
#pragma unroll
  for (int n = 0; n <= L; ++n) {
    f[n] *= pw;
    pw *= -2.0 * alpha;
  }
  return kTwoPi25 * rsqrt(p + q);
}

// c_a c_b c_c c_d [ab|cd] of one primitive quartet from its bra and ket rows;
// r is this thread's column of the block's R array (stride kThreads)
template <int L>
__device__ __forceinline__ double prim_quartet(const double* __restrict__ bra,
                                               const double* __restrict__ ket, int rows,
                                               const Shape& s, double* r) {
  double X, Y, Z, f[L + 1];
  const double pref = quartet_start<L>(bra, ket, rows, X, Y, Z, f);

  const int tm = s.t1 + s.t2, um = s.u1 + s.u2, vm = s.v1 + s.v2;  // tm + um + vm == L
  const int V = vm + 1, UV = (um + 1) * V;
  r[0] = f[L];
  // level n from level n + 1, in place: totals descending, so a total's
  // sources (totals s - 1, s - 2) still hold level n + 1 when it is written
#pragma unroll
  for (int n = L - 1; n >= 0; --n) {
    for (int tot = L - n; tot >= 1; --tot) {
      for (int t = min(tot, tm); t >= 0; --t) {
        for (int u = min(tot - t, um); u >= 0; --u) {
          const int v = tot - t - u;
          if (v > vm) break;
          double val;
          if (t > 0) {
            const int at = ((t - 1) * UV + u * V + v) * kThreads;
            val = X * r[at];
            if (t > 1) val += (t - 1) * r[at - UV * kThreads];
          } else if (u > 0) {
            const int at = ((u - 1) * V + v) * kThreads;
            val = Y * r[at];
            if (u > 1) val += (u - 1) * r[at - V * kThreads];
          } else {
            const int at = (v - 1) * kThreads;
            val = Z * r[at];
            if (v > 1) val += (v - 1) * r[at - kThreads];
          }
          r[(t * UV + u * V + v) * kThreads] = val;
        }
      }
    }
    r[0] = f[n];
  }

  double val = 0.0;
  int eb = 4 * rows;
  for (int t = 0; t <= s.t1; ++t)
    for (int u = 0; u <= s.u1; ++u)
      for (int v = 0; v <= s.v1; ++v, eb += rows) {
        const double wb = __ldg(bra + eb);
        if (wb == 0.0) continue;
        const int base = t * UV + u * V + v;
        double inner = 0.0;
        int ek = 4 * rows;
        for (int tt = 0; tt <= s.t2; ++tt)
          for (int uu = 0; uu <= s.u2; ++uu)
            for (int vv = 0; vv <= s.v2; ++vv, ek += rows) {
              const double wk = __ldg(ket + ek);
              if (wk == 0.0) continue;
              const double term = wk * r[(base + tt * UV + uu * V + vv) * kThreads];
              inner += ((tt + uu + vv) & 1) ? -term : term;
            }
        val += wb * inner;
      }
  return val * pref;
}

// prim_quartet of class L
__device__ __forceinline__ double prim_quartet_of_class(int L, const double* bra,
                                                        const double* ket, int rows,
                                                        const Shape& s, double* r) {
  switch (L) {
    case 0: return prim_quartet<0>(bra, ket, rows, s, r);
    case 1: return prim_quartet<1>(bra, ket, rows, s, r);
    case 2: return prim_quartet<2>(bra, ket, rows, s, r);
    case 3: return prim_quartet<3>(bra, ket, rows, s, r);
    case 4: return prim_quartet<4>(bra, ket, rows, s, r);
    case 5: return prim_quartet<5>(bra, ket, rows, s, r);
    case 6: return prim_quartet<6>(bra, ket, rows, s, r);
    case 7: return prim_quartet<7>(bra, ket, rows, s, r);
    default: return prim_quartet<8>(bra, ket, rows, s, r);
  }
}

// The shapes a bra or ket of exponent sum at most 2 can take (t, u, v): every
// pair of s and p functions, and s with d. A quartet of two such pairs is
// evaluated by prim_fixed, unrolled for its shape; the host stores it with the
// bra's shape not after the ket's ((ij|kl) = (kl|ij)), so 55 of the 100
// shape pairs are built, and names both by their place in this list
// (naqs_tpu_torch/chem/integrals.py ERI_PAIR_SHAPES, the same list).
#define ERI_PAIR_SHAPES(X) \
  X(0, 0, 0, 0) X(1, 1, 0, 0) X(2, 0, 1, 0) X(3, 0, 0, 1) X(4, 2, 0, 0) \
  X(5, 0, 2, 0) X(6, 0, 0, 2) X(7, 1, 1, 0) X(8, 1, 0, 1) X(9, 0, 1, 1)

// prim_quartet for one shape known at compile time: the loops unrolled, R and
// the weights in registers, no zero tests (a zero weight adds a zero)
template <int T1, int U1, int V1, int T2, int U2, int V2>
__device__ __forceinline__ double prim_fixed(const double* __restrict__ bra,
                                             const double* __restrict__ ket, int rows) {
  constexpr int L = T1 + U1 + V1 + T2 + U2 + V2;
  constexpr int TM = T1 + T2, UM = U1 + U2, VM = V1 + V2;
  constexpr int V = VM + 1, UV = (UM + 1) * V;
  constexpr int NB = (T1 + 1) * (U1 + 1) * (V1 + 1), NK = (T2 + 1) * (U2 + 1) * (V2 + 1);
  double X, Y, Z, f[L + 1], wk[NK];
#pragma unroll
  for (int e = 0; e < NK; ++e) wk[e] = __ldg(ket + (4 + e) * rows);
  const double pref = quartet_start<L>(bra, ket, rows, X, Y, Z, f);
  double r[(TM + 1) * UV];
  r[0] = f[L];
#pragma unroll
  for (int n = L - 1; n >= 0; --n) {  // as prim_quartet: totals descending
#pragma unroll
    for (int tot = L - n; tot >= 1; --tot) {
#pragma unroll
      for (int t = TM; t >= 0; --t) {
#pragma unroll
        for (int u = UM; u >= 0; --u) {
          const int v = tot - t - u;
          if (v < 0 || v > VM) continue;
          double val;
          if (t > 0) {
            val = X * r[(t - 1) * UV + u * V + v];
            if (t > 1) val += (t - 1) * r[(t - 2) * UV + u * V + v];
          } else if (u > 0) {
            val = Y * r[(u - 1) * V + v];
            if (u > 1) val += (u - 1) * r[(u - 2) * V + v];
          } else {
            val = Z * r[v - 1];
            if (v > 1) val += (v - 1) * r[v - 2];
          }
          r[t * UV + u * V + v] = val;
        }
      }
    }
    r[0] = f[n];
  }
  double val = 0.0;
#pragma unroll
  for (int eb = 0; eb < NB; ++eb) {
    const int t = eb / ((U1 + 1) * (V1 + 1)), u = eb / (V1 + 1) % (U1 + 1), v = eb % (V1 + 1);
    double inner = 0.0;
#pragma unroll
    for (int ek = 0; ek < NK; ++ek) {
      const int tt = ek / ((U2 + 1) * (V2 + 1)), uu = ek / (V2 + 1) % (U2 + 1), vv = ek % (V2 + 1);
      const double term = wk[ek] * r[(t + tt) * UV + (u + uu) * V + v + vv];
      inner += ((tt + uu + vv) & 1) ? -term : term;
    }
    val += __ldg(bra + (4 + eb) * rows) * inner;
  }
  return val * pref;
}

template <int BS, int T1, int U1, int V1>
__device__ __forceinline__ double prim_fixed_ket(int ks, const double* bra, const double* ket,
                                                 int rows) {
#define ERI_KET(i, t, u, v) \
  case i:                   \
    if constexpr (i >= BS) return prim_fixed<T1, U1, V1, t, u, v>(bra, ket, rows); \
    break;
  switch (ks) { ERI_PAIR_SHAPES(ERI_KET) }
#undef ERI_KET
  return 0.0;
}

// c_a c_b c_c c_d [ab|cd] of a quartet whose bra and ket shapes are bs <= ks
__device__ __forceinline__ double prim_fixed_of_shape(int bs, int ks, const double* bra,
                                                      const double* ket, int rows) {
#define ERI_BRA(i, t, u, v) \
  case i: return prim_fixed_ket<i, t, u, v>(ks, bra, ket, rows);
  switch (bs) { ERI_PAIR_SHAPES(ERI_BRA) }
#undef ERI_BRA
  return 0.0;
}

__device__ __forceinline__ void write_images(const int4 q, int n, double v,
                                             double* __restrict__ out) {
  const int perm[8][4] = {{q.x, q.y, q.z, q.w}, {q.y, q.x, q.z, q.w}, {q.x, q.y, q.w, q.z},
                          {q.y, q.x, q.w, q.z}, {q.z, q.w, q.x, q.y}, {q.w, q.z, q.x, q.y},
                          {q.z, q.w, q.y, q.x}, {q.w, q.z, q.y, q.x}};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[((static_cast<size_t>(perm[k][0]) * n + perm[k][1]) * n + perm[k][2]) * n + perm[k][3]] = v;
}

// pairs (16, rows) f64, column-major; qdesc (Q, 4) int32: bra row, ket row, primitive
// quartets, ket primitive pairs | shape << 8, the shape the quartet's shape
// code (kGeneral) or its bra's and ket's places in ERI_PAIR_SHAPES, bs | ks << 4
// (else); qitems (Q, 2) int32: first
// item, items; quartets (Q, 4) int32; items (n_items, 2) int32: quartet, first
// primitive quartet; partial (2 * warps) f64; arrivals (Q,) int32, zero.
// kGeneral: some bra or ket has an exponent sum above 2 (a d function beside
// a p or d): every quartet takes prim_quartet, R in shared memory (the
// unrolled shapes gain nothing on such a basis); else every quartet takes
// prim_fixed
template <bool kGeneral>
__global__ void __launch_bounds__(kThreads, kGeneral ? 2 : kBlocksFixed) eri_kernel(
    const double* __restrict__ pairs, int rows, const int4* __restrict__ qdesc,
    const int2* __restrict__ qitems, const int4* __restrict__ quartets,
    const int2* __restrict__ items, int n_items, int chunk, int n, double* __restrict__ partial,
    int* __restrict__ arrivals, double* __restrict__ out) {
  extern __shared__ double s_r[];
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item - lane >= n_items) return;  // the whole warp has no item
  double acc = 0.0;
  int qi = -1;
  if (item < n_items) {
    const int2 it = __ldg(items + item);
    qi = it.x;
    const int4 d = __ldg(qdesc + qi);
    const int nk = d.w & 0xff;
    const int shape = d.w >> 8;
    const Shape s = kGeneral ? decode_shape(shape) : Shape{};
    const int m_end = min(it.y + chunk, d.z);
    int b = it.y / nk, k = it.y - b * nk;
    for (int m = it.y; m < m_end; ++m) {
      const double *bra = pairs + d.x + b, *ket = pairs + d.y + k;
      if constexpr (kGeneral)
        acc += prim_quartet_of_class(s.t1 + s.u1 + s.v1 + s.t2 + s.u2 + s.v2, bra, ket, rows, s,
                                     s_r + threadIdx.x);
      else
        acc += prim_fixed_of_shape(shape & 15, shape >> 4, bra, ket, rows);
      if (++k == nk) {
        k = 0;
        ++b;
      }
    }
  }
  // the lanes' sums by quartet: an inclusive scan within each run of equal qi
  const int q_prev = __shfl_up_sync(kFull, qi, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || q_prev != qi);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(kFull, acc, off);
    if (lane - off >= start) acc += y;
  }
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (!last || qi < 0) return;
  const int2 span = __ldg(qitems + qi);
  const int w0 = span.x >> 5, w1 = (span.x + span.y - 1) >> 5;
  if (w0 != w1) {  // the quartet's items span warps w0..w1
    const int w = item >> 5;
    partial[2 * w + (start == 0 ? 0 : 1)] = acc;
    __threadfence();
    if (atomicAdd(arrivals + qi, 1) != w1 - w0) return;
    __threadfence();
    acc = __ldcg(partial + 2 * w0 + ((span.x & 31) ? 1 : 0));
    for (int v = w0 + 1; v <= w1; ++v) acc += __ldcg(partial + 2 * v);
    arrivals[qi] = 0;  // every warp has arrived: ready for the next launch
  }
  write_images(__ldg(quartets + qi), n, acc, out);
}

// F_0..F_n_max at each x with the kernel's own routine, for checks
__global__ void eri_boys_kernel(const double* __restrict__ x, int n_x, int n_max,
                                double* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_x) return;
  double f[kMaxL + 1];
  const double xi = x[idx];
  switch (n_max) {
    case 0: boys<0>(xi, f); break;
    case 1: boys<1>(xi, f); break;
    case 2: boys<2>(xi, f); break;
    case 3: boys<3>(xi, f); break;
    case 4: boys<4>(xi, f); break;
    case 5: boys<5>(xi, f); break;
    case 6: boys<6>(xi, f); break;
    case 7: boys<7>(xi, f); break;
    default: boys<8>(xi, f); break;
  }
  for (int m = 0; m <= n_max; ++m) out[static_cast<size_t>(m) * n_x + idx] = f[m];
}

template <bool kGeneral>
cudaError_t launch_eri(const void* pairs, int rows, const void* qdesc, const void* qitems,
                       const void* quartets, const void* items, int n_items, int chunk, int n,
                       int box, void* partial, void* arrivals, void* out, cudaStream_t stream) {
  const size_t smem = kGeneral ? static_cast<size_t>(box) * kThreads * sizeof(double) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        eri_kernel<kGeneral>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int blocks = (n_items + kThreads - 1) / kThreads;
  eri_kernel<kGeneral><<<blocks, kThreads, smem, stream>>>(
      static_cast<const double*>(pairs), rows, static_cast<const int4*>(qdesc),
      static_cast<const int2*>(qitems), static_cast<const int4*>(quartets),
      static_cast<const int2*>(items), n_items, chunk, n, static_cast<double*>(partial),
      static_cast<int*>(arrivals), static_cast<double*>(out));
  return cudaGetLastError();
}

}  // namespace

// One launch: every unique quartet of the packed basis into the (n, n, n, n)
// f64 output; the pair table is (16, rows) column-major. general: some bra
// or ket has an exponent sum above 2; box: then the largest R box
// (tm + 1)(um + 1)(vm + 1) of its quartets.
extern "C" int eri_launch(const void* pairs, int rows, const void* qdesc, const void* qitems,
                          const void* quartets, const void* items, int n_items, int chunk, int n,
                          int general, int box, void* partial, void* arrivals, void* out,
                          void* stream) {
  if (n_items == 0) return 0;
  if (chunk < 1 || (general && (box < 1 || box > 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      general ? launch_eri<true>(pairs, rows, qdesc, qitems, quartets, items, n_items, chunk, n,
                                 box, partial, arrivals, out, s)
              : launch_eri<false>(pairs, rows, qdesc, qitems, quartets, items, n_items, chunk, n,
                                  box, partial, arrivals, out, s));
}

extern "C" int eri_boys(const void* x, int n_x, int n_max, void* out, void* stream) {
  if (n_max < 0 || n_max > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  if (n_x == 0) return 0;
  eri_boys_kernel<<<(n_x + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), n_x, n_max, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* eri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
