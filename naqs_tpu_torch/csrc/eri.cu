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
// own disjoint sets of positions, so no atomics touch the output.
//
// What bounds it: f64 operations. The output is n^4 x 8 bytes (H2O 6-31G:
// 228 KB), against a few hundred operations per primitive quartet (the Boys
// series, the R recursion, the E coefficients and the contraction), and the
// H100 has no f64 tensor-core path for scalar recursions (34 TFLOP/s f64).
//
// Design (a first, simple kernel): one warp per unique quartet. Its lanes
// stride over the quartet's primitive quartets (the flattened index a b c d),
// each building the six E rows, the Boys values F_0..F_L, R_tuv over the
// box t <= t_max, u <= u_max, v <= v_max in place (level n descending, each
// level's totals descending) and the contraction; a butterfly of shuffles sums
// the lane partials in a fixed order (bitwise repeatable), and lanes 0-7 each
// write one of the eight positions. One kernel per angular class L = the
// quartet's total angular momentum (template), so local arrays are sized by
// the class (d shells reach L = 8); the host sorts the quartets by class, the
// heaviest first within a class, and launches each class that has quartets.
//
// Boys function F_n(x) = int_0^1 t^2n exp(-x t^2) dt, no gammainc on the card:
// for x < kSeriesMax, F_L = e^-x sum_k (2x)^k / ((2L+1)(2L+3)...(2L+2k+1))
// (kSeriesTerms positive terms: the last is below 2^-60 of the sum at x = 12,
// L = 0) and the downward recursion F_n = (2x F_{n+1} + e^-x) / (2n+1), which
// adds positive terms only; for x >= kSeriesMax, F_0 = sqrt(pi)/2 erf(sqrt x) /
// sqrt x and the upward recursion F_{n+1} = ((2n+1) F_n - e^-x) / 2x, whose
// cancellation magnifies an error by P(1/2, x) / P(L+1/2, x) <= 1.14 there
// (L <= 8). naqs_tpu_torch/chem/integrals.py::boys_ref is its plain torch twin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/chem/integrals.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 8;             // a quartet's total angular momentum: d functions
constexpr int kMaxLmn = 2;           // a function's exponent in one direction
constexpr int kSeriesTerms = 56;     // terms of the Boys series
constexpr double kSeriesMax = 12.0;  // the series below, erf and upward recursion at and above
constexpr int kWarps = 8;            // warps a block, one quartet each
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

// the most entries of an R box t <= a, u <= b, v <= c with a + b + c = L
__host__ __device__ constexpr int box_size(int L) {
  int best = 1;
  for (int a = 0; a <= L; ++a)
    for (int b = 0; a + b <= L; ++b) {
      const int c = L - a - b;
      if ((a + 1) * (b + 1) * (c + 1) > best) best = (a + 1) * (b + 1) * (c + 1);
    }
  return best;
}

// F_0..F_L at x
template <int L>
__device__ __forceinline__ void boys(double x, double* f) {
  const double two_x = 2.0 * x;
  const double ex = exp(-x);
  if (x < kSeriesMax) {
    double term = kInvOdd[L];
    double sum = term;
#pragma unroll 8
    for (int k = 1; k < kSeriesTerms; ++k) {
      term *= two_x * kInvOdd[L + k];
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

// E^{la lb}_t, t <= la + lb, of one direction (the recurrences of _e_coeffs:
// up in i at j = 0, then up in j at i = la); ab = A - B in that direction
__device__ __forceinline__ void hermite_e(int la, int lb, double a, double b, double ab,
                                          double* e) {
  const double p = a + b;
  const double inv_2p = 0.5 / p;
  const double pa = -(b / p) * ab;  // P - A
  const double pb = (a / p) * ab;   // P - B
  double cur[2 * kMaxLmn + 1] = {exp(-(a * b / p) * ab * ab), 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int s = 1; s <= 2 * kMaxLmn; ++s) {  // step s raises i (s <= la) or j
    if (s > la + lb) break;
    const double x = s <= la ? pa : pb;
    double nxt[2 * kMaxLmn + 1];
#pragma unroll
    for (int t = 0; t <= s; ++t) {
      double v = t >= 1 ? cur[t - 1] * inv_2p : 0.0;
      v += x * cur[t];
      if (t + 1 <= s - 1) v += (t + 1) * cur[t + 1];
      nxt[t] = v;
    }
#pragma unroll
    for (int t = 0; t <= s; ++t) cur[t] = nxt[t];
  }
#pragma unroll
  for (int t = 0; t <= 2 * kMaxLmn; ++t) e[t] = cur[t];
}

struct Fn {  // one contracted function
  double x, y, z;
  int lx, ly, lz, p0, np;
};

__device__ __forceinline__ Fn load_fn(int i, const double* centers, const int32_t* lmn,
                                      const int32_t* prim_ptr) {
  Fn f;
  f.x = __ldg(centers + 3 * i);
  f.y = __ldg(centers + 3 * i + 1);
  f.z = __ldg(centers + 3 * i + 2);
  f.lx = __ldg(lmn + 3 * i);
  f.ly = __ldg(lmn + 3 * i + 1);
  f.lz = __ldg(lmn + 3 * i + 2);
  f.p0 = __ldg(prim_ptr + i);
  f.np = __ldg(prim_ptr + i + 1) - f.p0;
  return f;
}

// [ab|cd] of one primitive quartet, unnormalised primitives
template <int L>
__device__ double prim_eri(const Fn& fa, double a, const Fn& fb, double b, const Fn& fc,
                           double c, const Fn& fd, double d) {
  constexpr int kE = 2 * kMaxLmn + 1;
  double ebx[kE], eby[kE], ebz[kE], ekx[kE], eky[kE], ekz[kE];
  hermite_e(fa.lx, fb.lx, a, b, fa.x - fb.x, ebx);
  hermite_e(fa.ly, fb.ly, a, b, fa.y - fb.y, eby);
  hermite_e(fa.lz, fb.lz, a, b, fa.z - fb.z, ebz);
  hermite_e(fc.lx, fd.lx, c, d, fc.x - fd.x, ekx);
  hermite_e(fc.ly, fd.ly, c, d, fc.y - fd.y, eky);
  hermite_e(fc.lz, fd.lz, c, d, fc.z - fd.z, ekz);
  const double p = a + b, q = c + d;
  const double alpha = p * q / (p + q);
  const double px = (a * fa.x + b * fb.x) / p, py = (a * fa.y + b * fb.y) / p,
               pz = (a * fa.z + b * fb.z) / p;
  const double qx = (c * fc.x + d * fd.x) / q, qy = (c * fc.y + d * fd.y) / q,
               qz = (c * fc.z + d * fd.z) / q;
  const double X = px - qx, Y = py - qy, Z = pz - qz;

  double f[L + 1];
  boys<L>(alpha * (X * X + Y * Y + Z * Z), f);
  double pw = 1.0;
#pragma unroll
  for (int n = 0; n <= L; ++n) {  // R^n_000 = (-2 alpha)^n F_n
    f[n] *= pw;
    pw *= -2.0 * alpha;
  }

  const int t1 = fa.lx + fb.lx, u1 = fa.ly + fb.ly, v1 = fa.lz + fb.lz;
  const int t2 = fc.lx + fd.lx, u2 = fc.ly + fd.ly, v2 = fc.lz + fd.lz;
  const int tm = t1 + t2, um = u1 + u2, vm = v1 + v2;  // tm + um + vm == L
  const int V = vm + 1, UV = (um + 1) * V;
  double r[box_size(L)];
  r[0] = f[L];
  // level n from level n + 1, in place: totals descending, so a total's
  // sources (totals s - 1, s - 2) still hold level n + 1 when it is written
  for (int n = L - 1; n >= 0; --n) {
    for (int s = L - n; s >= 1; --s) {
      for (int t = min(s, tm); t >= 0; --t) {
        for (int u = min(s - t, um); u >= 0; --u) {
          const int v = s - t - u;
          if (v > vm) break;
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
  for (int t = 0; t <= t1; ++t)
    for (int u = 0; u <= u1; ++u)
      for (int v = 0; v <= v1; ++v) {
        const double e_bra = ebx[t] * eby[u] * ebz[v];
        if (e_bra == 0.0) continue;
        for (int tt = 0; tt <= t2; ++tt)
          for (int uu = 0; uu <= u2; ++uu)
            for (int vv = 0; vv <= v2; ++vv) {
              const double e_ket = ekx[tt] * eky[uu] * ekz[vv];
              if (e_ket == 0.0) continue;
              const double sgn = ((tt + uu + vv) & 1) ? -1.0 : 1.0;
              val += e_bra * e_ket * sgn * r[(t + tt) * UV + (u + uu) * V + v + vv];
            }
      }
  return val * kTwoPi25 / (p * q * sqrt(p + q));
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32) eri_class_kernel(
    const double* __restrict__ centers, const int32_t* __restrict__ lmn,
    const int32_t* __restrict__ prim_ptr, const double* __restrict__ alphas,
    const double* __restrict__ cn, const int32_t* __restrict__ quartets, int n, int q0, int q1,
    double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int q = q0 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= q1) return;  // the whole warp leaves together
  const int i = __ldg(quartets + 4 * q), j = __ldg(quartets + 4 * q + 1),
            k = __ldg(quartets + 4 * q + 2), l = __ldg(quartets + 4 * q + 3);
  const Fn fi = load_fn(i, centers, lmn, prim_ptr), fj = load_fn(j, centers, lmn, prim_ptr),
           fk = load_fn(k, centers, lmn, prim_ptr), fl = load_fn(l, centers, lmn, prim_ptr);
  const int n_prim = fi.np * fj.np * fk.np * fl.np;
  double acc = 0.0;
  for (int m = lane; m < n_prim; m += 32) {
    int rest = m;
    const int pd = fl.p0 + rest % fl.np;
    rest /= fl.np;
    const int pc = fk.p0 + rest % fk.np;
    rest /= fk.np;
    const int pb = fj.p0 + rest % fj.np;
    const int pa = fi.p0 + rest / fj.np;
    const double coef = __ldg(cn + pa) * __ldg(cn + pb) * __ldg(cn + pc) * __ldg(cn + pd);
    acc += coef * prim_eri<L>(fi, __ldg(alphas + pa), fj, __ldg(alphas + pb), fk,
                              __ldg(alphas + pc), fl, __ldg(alphas + pd));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane < 8) {  // the eight symmetric positions, one a lane
    const int perm[8][4] = {{i, j, k, l}, {j, i, k, l}, {i, j, l, k}, {j, i, l, k},
                            {k, l, i, j}, {l, k, i, j}, {k, l, j, i}, {l, k, j, i}};
    const int* w = perm[lane];
    out[((static_cast<size_t>(w[0]) * n + w[1]) * n + w[2]) * n + w[3]] = acc;
  }
}

// F_0..F_n_max at each x with the kernels' own routine, for checks
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

template <int L>
cudaError_t launch_class(const void* centers, const void* lmn, const void* prim_ptr,
                         const void* alphas, const void* cn, const void* quartets, int n,
                         int q0, int q1, void* out, cudaStream_t stream) {
  const int blocks = (q1 - q0 + kWarps - 1) / kWarps;
  eri_class_kernel<L><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const double*>(centers), static_cast<const int32_t*>(lmn),
      static_cast<const int32_t*>(prim_ptr), static_cast<const double*>(alphas),
      static_cast<const double*>(cn), static_cast<const int32_t*>(quartets), n, q0, q1,
      static_cast<double*>(out));
  return cudaGetLastError();
}

}  // namespace

// One launch: the quartets q0 .. q1-1 (all of angular class L) of the
// (Q, 4) int32 list, into the (n, n, n, n) f64 output.
extern "C" int eri_class(const void* centers, const void* lmn, const void* prim_ptr,
                         const void* alphas, const void* cn, const void* quartets, int n, int q0,
                         int q1, int L, void* out, void* stream) {
  if (q1 <= q0) return 0;
  if (L < 0 || L > kMaxL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (L) {
    case 0: rc = launch_class<0>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 1: rc = launch_class<1>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 2: rc = launch_class<2>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 3: rc = launch_class<3>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 4: rc = launch_class<4>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 5: rc = launch_class<5>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 6: rc = launch_class<6>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    case 7: rc = launch_class<7>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
    default: rc = launch_class<8>(centers, lmn, prim_ptr, alphas, cn, quartets, n, q0, q1, out, s); break;
  }
  return static_cast<int>(rc);
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
