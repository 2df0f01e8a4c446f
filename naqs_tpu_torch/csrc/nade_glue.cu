// The model's fused glue for sm_90a: four kernels in one source.
//
// They replace work that has no Pallas counterpart: the JAX package leaves it
// to XLA, which fuses it into the jitted sample() scan over shells and into the
// jitted log_psi and its derivatives. In naqs_tpu/models/nade.py:
//
//   shell_features: the head of amp_conditional_shell (:522-541, with ca and
//     cb of :559-560): for one shell j and a frontier of packed prefix ints
//     a, b (bit t = the alpha / beta occupation of model shell t), the MLP
//     input x (rows, in_width), the exchange order flag and the prefix counts.
//     pa = a & (2^j - 1) and ca = popcount(pa): no bit is unpacked.
//   shell_epilogue: its tail (:556-575): the symmetrized logits, the OR over
//     sectors of the occupation mask, partial masking's unmasked last shell,
//     0.5 log_softmax(2x) with BIG_NEG on masked options and probs =
//     exp(2 log_amp), from the amp trunk's raw outputs of that shell.
//   state_features: split_spins, prefix_stats and shell_inputs (:209-275)
//     with log_psi's occupation (:470): for packed states, every model shell's
//     input x (rows, S, in_width), a second input where the phase net's spin
//     symmetry differs from the amp's, and one int32 code per (row, shell):
//     order flag (bits 0-1), occupation alpha + 2 beta (2-3), the phase
//     symmetry's pi shift of the row (4, last shell only), ca (8-15), cb
//     (16-23).
//   tables_epilogue: the tail of _tables (:423-449) with log_psi's gather and
//     sum over shells (:464-473), from the raw amp and phase outputs and the
//     codes, in three modes: the forward (log|psi|, arg psi), the vjp
//     (cotangents of both -> gradients of the raw outputs) and the jvp
//     (tangents of the raw outputs -> tangents of both).
//
// Every NAQSConfig option is a field of GlueConfig, which the C entries read
// from host memory and pass to the kernel by value. The arithmetic is the plain
// versions' (ops/nade_glue.py) in the compute dtype (float or double), one
// operation for each of theirs, with CUDA's IEEE expf/logf/tanhf/sinf/cosf; the
// sums over shells and the log-softmax's sum run in another order than torch's,
// so the two agree within a few ulps, not bit for bit. A masked option's
// exp(2 log_amp) is exp(-1e9 - ...) = +0 exactly, and a row with no allowed
// option gives 0.5 BIG_NEG and a zero gradient, as in the plain version.
//
// What bounds them: bytes. At H2O 6-31G's full width (13 shells, in_width 24)
// and 100,000 rows state_features writes x, 124.8 MB in float32 (about 37 us
// at 3.35 TB/s), tables_epilogue reads 32 B of raw outputs and 4 B of code a
// (row, shell), and the sampler's two kernels move 9-12 MB a shell; their
// operations are a few tens a value. Design: one thread a value of x in
// shell_features (coalesced stores), one a row in shell_epilogue; in
// state_features a block of 32 rows first packs each row's model-order
// alpha and beta bits into shared memory (the shell order is a permutation),
// then its threads write the block's codes and inputs in storage order; in
// tables_epilogue one thread a (row, shell), rows whole inside a block of
// floor(256 / S) rows, and the forward and jvp sum a row's shells in order
// from shared memory (no atomics: bitwise repeatable). No kernel allocates,
// synchronizes or reads anything back: each is one launch on the caller's
// stream, so a CUDA graph can capture it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSectors = 16;
constexpr int kMaxShells = 31;       // int64 states of at most 62 qubits
constexpr int kThreads = 256;
constexpr int kFeatureRows = 32;     // state_features: rows a block
constexpr double kBigNeg = -1e9;     // models/nade.py::BIG_NEG
constexpr double kPi = 3.14159265358979323846;

enum Masking { kMaskNone = 0, kMaskPartial = 1, kMaskFull = 2 };
enum Activation { kActNone = 0, kSoftsign = 1, kTanh = 2, kHardtanh = 3, kSin = 4, kSigmoid = 5 };
enum Mode { kForward = 0, kVjp = 1, kJvp = 2 };
// where tables_epilogue finds the raw phase outputs
enum PhaseLayout { kPhaseInAmp = 0, kPhasePerShell = 1, kPhaseGlobal = 2 };

// Mirrored field by field by ops/nade_glue.py::_Config.
struct GlueConfig {
  int32_t n_shells;
  int32_t in_width;
  int32_t integer_inputs;   // input_encoding == "integer"
  int32_t amp_sym;          // use_amp_spin_sym: 5 raw amp outputs, else 4
  int32_t phase_sym;        // use_phase_spin_sym: 3 raw phase outputs, else 4
  int32_t masking;          // Masking
  int32_t activation;       // Activation (phase_activation)
  int32_t n_amp_out;        // 5 or 4
  int32_t n_out;            // the amp trunk's outputs: n_amp_out (+ the phase's if combined)
  int32_t n_sectors;
  int32_t sectors[2 * kMaxSectors];        // (n_alpha, n_beta) of each sector
  int32_t shell_order[kMaxShells + 1];     // model shell j <- state shell shell_order[j]
};

__host__ __device__ inline float f_exp(float x) { return expf(x); }
__host__ __device__ inline double f_exp(double x) { return exp(x); }
__host__ __device__ inline float f_log(float x) { return logf(x); }
__host__ __device__ inline double f_log(double x) { return log(x); }
__host__ __device__ inline float f_tanh(float x) { return tanhf(x); }
__host__ __device__ inline double f_tanh(double x) { return tanh(x); }
__host__ __device__ inline float f_sin(float x) { return sinf(x); }
__host__ __device__ inline double f_sin(double x) { return sin(x); }
__host__ __device__ inline float f_cos(float x) { return cosf(x); }
__host__ __device__ inline double f_cos(double x) { return cos(x); }

__host__ __device__ inline int popc64(int64_t x) {
#ifdef __CUDA_ARCH__
  return __popcll(static_cast<unsigned long long>(x));
#else
  return __builtin_popcountll(static_cast<unsigned long long>(x));
#endif
}

__host__ __device__ inline int64_t low_bits(int j) { return (int64_t(1) << j) - 1; }

// 0: pa > pb (the spin substrings swap), 1: pa == pb, 2: pa < pb, over the
// shells before j
__host__ __device__ inline int order3_of(int64_t a, int64_t b, int j) {
  const int64_t pa = a & low_bits(j), pb = b & low_bits(j);
  return pa > pb ? 0 : (pa == pb ? 1 : 2);
}

// _SYM_BASE = (0, 1, 1, 2) and _SYM_GATHER[order3] = ((0, 3, 4, 2), (0, 1, 1,
// 2), (0, 4, 3, 2)): which raw logits symmetrize into occupation k
__host__ __device__ inline int sym_base(int k) { return k == 0 ? 0 : (k == 3 ? 2 : 1); }
__host__ __device__ inline int sym_gather(int order3, int k) {
  if (k == 0) return 0;
  if (k == 3) return 2;
  if (order3 == 1) return 1;
  return ((k == 1) == (order3 == 0)) ? 3 : 4;
}

// Input `col` of shell j from the row's model-order bits (shell_inputs): the
// signed bits of the shells before j, first substring then second (the smaller
// one first when canonical), or one integer a row with the integer encoding;
// times 0 or 1 as the plain version's causal mask multiplies (so -0.0 too).
template <typename T>
__host__ __device__ inline T input_value(const GlueConfig& c, int64_t a, int64_t b, int j,
                                         int col, bool canonical) {
  if (c.integer_inputs) {
    const int av = static_cast<int>((a >> col) & 1), bv = static_cast<int>((b >> col) & 1);
    const int v = canonical ? av + bv - 1 : 2 * av + bv;
    return T(static_cast<float>(v)) * T(col < j);
  }
  const int half = c.n_shells - 1;
  const bool second = col >= half;
  const int t = second ? col - half : col;
  const bool swap = canonical && order3_of(a, b, j) == 0;
  const int64_t src = (second != swap) ? b : a;
  return T(static_cast<float>(2 * static_cast<int>((src >> t) & 1) - 1)) * T(t < j);
}

// state_features' code of (row, shell j), from the row's model-order bits
__host__ __device__ inline int32_t shell_code(const GlueConfig& c, int64_t a, int64_t b,
                                              int j) {
  const int64_t lo = low_bits(j);
  const int occ = static_cast<int>((a >> j) & 1) | static_cast<int>((b >> j) & 1) << 1;
  // the exchange phase shift pi (N01 mod 2) where the full pa < pb
  const int shift = (j == c.n_shells - 1 && a < b && (popc64(~a & b) & 1)) ? 1 : 0;
  return order3_of(a, b, j) | occ << 2 | shift << 4 | popc64(a & lo) << 8 |
         popc64(b & lo) << 16;
}

// occupation_mask: bit k (k = alpha + 2 beta) where some sector's electron
// budgets allow occupation k at shell j after ca, cb up-spins
__host__ __device__ inline unsigned occupation_mask(const GlueConfig& c, int ca, int cb, int j) {
  const int s = c.n_shells, da = j - ca, db = j - cb;
  unsigned m = 0;
  for (int i = 0; i < c.n_sectors; ++i) {
    const int na = c.sectors[2 * i], nb = c.sectors[2 * i + 1];
    if (!(ca <= na && da <= s - na && cb <= nb && db <= s - nb)) continue;
    const unsigned a1 = ca < na, a0 = da < s - na, b1 = cb < nb, b0 = db < s - nb;
    m |= (a0 & b0) | (a1 & b0) << 1 | (a0 & b1) << 2 | (a1 & b1) << 3;
  }
  return m;
}

// the mask the log-softmax applies: every option where masking is "none" and
// at partial masking's last shell
__host__ __device__ inline unsigned applied_mask(const GlueConfig& c, unsigned m, int j) {
  return (c.masking == kMaskNone || (c.masking == kMaskPartial && j == c.n_shells - 1)) ? 0xFu
                                                                                        : m;
}

// symmetrize_amp (or the raw logits): l[k] = 0.5 (raw[base_k] + raw[gather_k])
template <typename T>
__host__ __device__ inline void amp_logits(const GlueConfig& c, const T* raw, int order3,
                                           T l[4]) {
  for (int k = 0; k < 4; ++k)
    l[k] = c.amp_sym ? T(0.5) * (raw[sym_base(k)] + raw[sym_gather(order3, k)]) : raw[k];
}

// log_softmax(z) of z = 2 l where the mask allows, BIG_NEG elsewhere; false
// (and lsm untouched) for a row with no allowed option
template <typename T>
__host__ __device__ inline bool log_softmax4(const T l[4], unsigned mask, T lsm[4]) {
  if (!mask) return false;
  T z[4];
  for (int k = 0; k < 4; ++k) z[k] = ((mask >> k) & 1) ? T(2) * l[k] : T(kBigNeg);
  const T m01 = z[0] > z[1] ? z[0] : z[1], m23 = z[2] > z[3] ? z[2] : z[3];
  const T m = m01 > m23 ? m01 : m23;
  const T ls = f_log(f_exp(z[0] - m) + f_exp(z[1] - m) + f_exp(z[2] - m) + f_exp(z[3] - m));
  for (int k = 0; k < 4; ++k) lsm[k] = (z[k] - m) - ls;
  return true;
}

// log_amp = 0.5 log_softmax, or 0.5 BIG_NEG on a row with no allowed option
template <typename T>
__host__ __device__ inline T log_amp_of(bool any, const T lsm[4], int k) {
  return any ? T(0.5) * lsm[k] : T(0.5 * kBigNeg);
}

// scaled_phase_activation without the pinning, and its derivative
template <typename T>
__host__ __device__ inline T activate(int act, T x) {
  const T pi = T(kPi);
  switch (act) {
    case kSoftsign: return pi * x / (T(1) + (x < T(0) ? -x : x));
    case kTanh: return pi * f_tanh(x);
    case kHardtanh: return pi * (x < T(-1) ? T(-1) : (x > T(1) ? T(1) : x));
    case kSin: { const T s = f_sin(x); return pi * (s * s); }
    case kSigmoid: return pi * (T(1) / (T(1) + f_exp(-x)));
    default: return x;
  }
}

template <typename T>
__host__ __device__ inline T activate_grad(int act, T x) {
  const T pi = T(kPi);
  switch (act) {
    case kSoftsign: { const T d = T(1) + (x < T(0) ? -x : x); return pi / (d * d); }
    case kTanh: { const T t = f_tanh(x); return pi * (T(1) - t * t); }
    case kHardtanh: return (x >= T(-1) && x <= T(1)) ? pi : T(0);
    case kSin: return pi * (T(2) * f_sin(x) * f_cos(x));
    case kSigmoid: { const T s = T(1) / (T(1) + f_exp(-x)); return pi * (s * (T(1) - s)); }
    default: return T(1);
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<double> {
  __device__ static void store(double* p, const double v[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

// ---------------------------------------------------------------- kernels

template <typename T>
__global__ void __launch_bounds__(kThreads)
shell_features_kernel(GlueConfig c, const int64_t* __restrict__ a,
                      const int64_t* __restrict__ b, int j, int n_rows, T* __restrict__ x,
                      int32_t* __restrict__ meta) {
  const int n = n_rows * c.in_width;   // below 2^31: the C entry's check
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int r = e / c.in_width, col = e - r * c.in_width;
    const int64_t ar = a[r], br = b[r];
    x[e] = input_value<T>(c, ar, br, j, col, c.amp_sym);
    if (col == 0) {
      meta[r] = order3_of(ar, br, j);
      meta[n_rows + r] = popc64(ar & low_bits(j));
      meta[2 * int64_t(n_rows) + r] = popc64(br & low_bits(j));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shell_epilogue_kernel(GlueConfig c, const T* __restrict__ raw, const int32_t* __restrict__ meta,
                      int j, int n_rows, T* __restrict__ log_amp, uint8_t* __restrict__ mask,
                      T* __restrict__ probs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int order3 = meta[r], ca = meta[n_rows + r], cb = meta[2 * int64_t(n_rows) + r];
  T l[4], lsm[4] = {T(0), T(0), T(0), T(0)}, out[4], p[4];
  amp_logits(c, raw + int64_t(r) * c.n_out, order3, l);
  const unsigned m = occupation_mask(c, ca, cb, j);
  const bool any = log_softmax4(l, applied_mask(c, m, j), lsm);
  for (int k = 0; k < 4; ++k) {
    out[k] = log_amp_of(any, lsm, k);
    p[k] = f_exp(T(2) * out[k]);
  }
  Vec4<T>::store(log_amp + 4 * int64_t(r), out);
  Vec4<T>::store(probs + 4 * int64_t(r), p);
  reinterpret_cast<uchar4*>(mask)[r] =
      make_uchar4(m & 1, (m >> 1) & 1, (m >> 2) & 1, (m >> 3) & 1);
}

// second: 0 no second input; 1 the phase net's, the last shell's only (rows,
// in_width); 2 every shell's (rows, S, in_width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
state_features_kernel(GlueConfig c, const int64_t* __restrict__ states, int n_rows,
                      T* __restrict__ x, T* __restrict__ x2, int second,
                      int32_t* __restrict__ code) {
  __shared__ int64_t sa[kFeatureRows], sb[kFeatureRows];
  const int s = c.n_shells, w = c.in_width, sw = s * w;
  const int row0 = blockIdx.x * kFeatureRows;
  const int rows = min(kFeatureRows, n_rows - row0);
  const int t = threadIdx.x;
  if (t < rows) {   // the row's bits in model order: bit j = shell shell_order[j]
    const int64_t st = states[row0 + t];
    int64_t a = 0, b = 0;
    for (int j = 0; j < s; ++j) {
      const int q = 2 * c.shell_order[j];
      a |= ((st >> q) & 1) << j;
      b |= ((st >> (q + 1)) & 1) << j;
    }
    sa[t] = a;
    sb[t] = b;
  }
  __syncthreads();
  for (int e = t; e < rows * s; e += blockDim.x) {
    const int r = e / s;
    code[int64_t(row0) * s + e] = shell_code(c, sa[r], sb[r], e - r * s);
  }
  for (int e = t; e < rows * sw; e += blockDim.x) {
    const int r = e / sw, k = e - r * sw, j = k / w;
    x[int64_t(row0) * sw + e] = input_value<T>(c, sa[r], sb[r], j, k - j * w, c.amp_sym);
    if (second == 2)
      x2[int64_t(row0) * sw + e] = input_value<T>(c, sa[r], sb[r], j, k - j * w, c.phase_sym);
  }
  if (second == 1)
    for (int e = t; e < rows * w; e += blockDim.x) {
      const int r = e / w;
      x2[int64_t(row0) * w + e] = input_value<T>(c, sa[r], sb[r], s - 1, e - r * w, c.phase_sym);
    }
}

template <typename T>
struct TablesArgs {
  const T* raw;         // the amp trunk's outputs (rows, S, n_out)
  const T* phase;       // the phase outputs: in raw (kPhaseInAmp), (rows, S, P) or (rows, P)
  int phase_layout;     // PhaseLayout
  const int32_t* code;  // (rows, S)
  const T* cot_la;      // vjp: cotangents (rows,)
  const T* cot_ph;
  const T* tan_raw;     // jvp: tangents laid out as raw and phase; null: zero
  const T* tan_phase;
  T* out0;              // forward, jvp: (rows,) of log|psi| and arg psi or their tangents;
  T* out1;              // vjp: the gradients, laid out as raw and phase
  int n_rows;
};

// the offset of (row, shell j)'s first raw phase output, or -1 where the
// global net has none (every shell but the last)
__host__ __device__ inline int64_t phase_offset(const GlueConfig& c, int layout, int64_t row,
                                                int j) {
  const int s = c.n_shells, p = c.phase_sym ? 3 : 4;
  switch (layout) {
    case kPhaseInAmp: return (row * s + j) * c.n_out + c.n_amp_out;
    case kPhasePerShell: return (row * s + j) * p;
    default: return j == s - 1 ? row * p : -1;
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
tables_epilogue_kernel(GlueConfig c, TablesArgs<T> q) {
  const int s = c.n_shells, rows_per_block = kThreads / s;
  const int t = threadIdx.x, rr = t / s, j = t - rr * s;
  const int64_t row = int64_t(blockIdx.x) * rows_per_block + rr;
  T va = T(0), vb = T(0);
  if (rr < rows_per_block && row < q.n_rows) {
    const int32_t code = q.code[row * s + j];
    const int order3 = code & 3, occ = (code >> 2) & 3;
    const bool shifted = (code >> 4) & 1;
    const unsigned m = applied_mask(c, occupation_mask(c, (code >> 8) & 0xFF,
                                                       (code >> 16) & 0xFF, j), j);
    const int64_t at = (row * s + j) * c.n_out;
    T l[4], lsm[4] = {T(0), T(0), T(0), T(0)};
    amp_logits(c, q.raw + at, order3, l);
    const bool any = log_softmax4(l, m, lsm);
    // the raw phase entry that occupation occ reads, and whether the
    // activation pins it to 0 (its shell's mask leaves occ as the one option)
    const int pk = c.phase_sym ? sym_base(occ) : occ;
    const bool pinned = c.activation != kActNone && !c.phase_sym && popc64(m) == 1 &&
                        ((m >> pk) & 1);
    const int64_t ph_at = phase_offset(c, q.phase_layout, row, j);
    const T xp = ph_at >= 0 ? q.phase[ph_at + pk] : T(0);
    if constexpr (kMode == kForward) {
      va = log_amp_of(any, lsm, occ);
      vb = pinned ? T(0) : activate(c.activation, xp);
      if (c.phase_sym && j == s - 1 && shifted) vb = vb + T(kPi);
    } else if constexpr (kMode == kJvp) {
      if (any && q.tan_raw) {
        T tl[4], sum = T(0), dz[4];
        amp_logits(c, q.tan_raw + at, order3, tl);
        for (int k = 0; k < 4; ++k) {
          dz[k] = ((m >> k) & 1) ? T(2) * tl[k] : T(0);
          sum += f_exp(lsm[k]) * dz[k];
        }
        va = T(0.5) * (dz[occ] - sum);
      }
      if (ph_at >= 0 && q.tan_phase && !pinned)
        vb = activate_grad(c.activation, xp) * q.tan_phase[ph_at + pk];
    } else {   // kVjp: write the gradients of this (row, shell)'s raw outputs
      const T h = T(0.5) * q.cot_la[row];
      T dl[4] = {T(0), T(0), T(0), T(0)};
      if (any)
        for (int k = 0; k < 4; ++k)
          if ((m >> k) & 1) dl[k] = T(2) * ((k == occ ? h : T(0)) - f_exp(lsm[k]) * h);
      T* d = q.out1 + at;
      if (c.amp_sym) {
        T d5[5] = {T(0), T(0), T(0), T(0), T(0)};
        for (int k = 0; k < 4; ++k) {
          d5[sym_base(k)] += T(0.5) * dl[k];
          d5[sym_gather(order3, k)] += T(0.5) * dl[k];
        }
        for (int k = 0; k < 5; ++k) d[k] = d5[k];
      } else {
        for (int k = 0; k < 4; ++k) d[k] = dl[k];
      }
      if (ph_at >= 0) {
        T* dp = (q.phase_layout == kPhaseInAmp ? q.out1 : q.out0) + ph_at;
        const T g = pinned ? T(0) : q.cot_ph[row] * activate_grad(c.activation, xp);
        for (int k = 0; k < (c.phase_sym ? 3 : 4); ++k) dp[k] = k == pk ? g : T(0);
      }
    }
  }
  if constexpr (kMode != kVjp) {   // sum each row's shells in order
    __shared__ T sa[kThreads], sb[kThreads];
    sa[t] = va;
    sb[t] = vb;
    __syncthreads();
    const int64_t r = int64_t(blockIdx.x) * rows_per_block + t;
    if (t < rows_per_block && r < q.n_rows) {
      T suma = sa[t * s], sumb = sb[t * s];
      for (int k = 1; k < s; ++k) {
        suma += sa[t * s + k];
        sumb += sb[t * s + k];
      }
      q.out0[r] = suma;
      q.out1[r] = sumb;
    }
  }
}

bool config_ok(const GlueConfig& c) {
  if (c.n_shells < 2 || c.n_shells > kMaxShells || c.n_sectors < 0 ||
      c.n_sectors > kMaxSectors || c.masking < kMaskNone || c.masking > kMaskFull ||
      c.activation < kActNone || c.activation > kSigmoid)
    return false;
  const int width = c.integer_inputs ? c.n_shells - 1 : 2 * (c.n_shells - 1);
  return c.in_width == width && c.n_amp_out == (c.amp_sym ? 5 : 4) && c.n_out >= c.n_amp_out;
}

int blocks_for(int64_t n, int per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

template <typename T>
int tables_epilogue_as(const GlueConfig& c, int mode, const TablesArgs<T>& q, cudaStream_t s) {
  const int rows_per_block = kThreads / c.n_shells;
  const int blocks = blocks_for(q.n_rows, rows_per_block), threads = rows_per_block * c.n_shells;
  if (mode == kForward)
    tables_epilogue_kernel<T, kForward><<<blocks, threads, 0, s>>>(c, q);
  else if (mode == kVjp)
    tables_epilogue_kernel<T, kVjp><<<blocks, threads, 0, s>>>(c, q);
  else
    tables_epilogue_kernel<T, kJvp><<<blocks, threads, 0, s>>>(c, q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
TablesArgs<T> tables_args(const void* raw, const void* phase, int layout, const void* code,
                          const void* cot_la, const void* cot_ph, const void* tan_raw,
                          const void* tan_phase, void* out0, void* out1, int n_rows) {
  return {static_cast<const T*>(raw),    static_cast<const T*>(phase),
          layout,                        static_cast<const int32_t*>(code),
          static_cast<const T*>(cot_la), static_cast<const T*>(cot_ph),
          static_cast<const T*>(tan_raw), static_cast<const T*>(tan_phase),
          static_cast<T*>(out0),         static_cast<T*>(out1),
          n_rows};
}

}  // namespace

// Every entry: cfg points at a GlueConfig in host memory, read before the
// launch; f64 selects the double instantiation (a float64 model), else float;
// n_rows = 0 launches nothing. Returns a cudaError_t.

// x: (n_rows, in_width); meta: (3, n_rows) int32 rows order3, ca, cb.
extern "C" int shell_features(const void* cfg, const void* a, const void* b, int j, int n_rows,
                              void* x, void* meta, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || j < 0 || j >= c.n_shells || n_rows < 0 ||
      int64_t(n_rows) * c.in_width >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int blocks = blocks_for(int64_t(n_rows) * c.in_width, kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* pa = static_cast<const int64_t*>(a);
  const int64_t* pb = static_cast<const int64_t*>(b);
  if (f64)
    shell_features_kernel<double><<<blocks, kThreads, 0, s>>>(
        c, pa, pb, j, n_rows, static_cast<double*>(x), static_cast<int32_t*>(meta));
  else
    shell_features_kernel<float><<<blocks, kThreads, 0, s>>>(
        c, pa, pb, j, n_rows, static_cast<float*>(x), static_cast<int32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

// raw: (n_rows, n_out), the amp columns first; log_amp, probs: (n_rows, 4);
// mask: (n_rows, 4) bool.
extern "C" int shell_epilogue(const void* cfg, const void* raw, const void* meta, int j,
                              int n_rows, void* log_amp, void* mask, void* probs, int f64,
                              void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || j < 0 || j >= c.n_shells || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int blocks = blocks_for(n_rows, kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pm = static_cast<const int32_t*>(meta);
  uint8_t* pk = static_cast<uint8_t*>(mask);
  if (f64)
    shell_epilogue_kernel<double><<<blocks, kThreads, 0, s>>>(
        c, static_cast<const double*>(raw), pm, j, n_rows, static_cast<double*>(log_amp), pk,
        static_cast<double*>(probs));
  else
    shell_epilogue_kernel<float><<<blocks, kThreads, 0, s>>>(
        c, static_cast<const float*>(raw), pm, j, n_rows, static_cast<float*>(log_amp), pk,
        static_cast<float*>(probs));
  return static_cast<int>(cudaGetLastError());
}

// x: (n_rows, S, in_width); x2 as `second` says (null for 0); code: (n_rows, S).
extern "C" int state_features(const void* cfg, const void* states, int n_rows, void* x,
                              void* x2, int second, void* code, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || n_rows < 0 || second < 0 || second > 2 || (second && !x2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int blocks = blocks_for(n_rows, kFeatureRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* st = static_cast<const int64_t*>(states);
  int32_t* pc = static_cast<int32_t*>(code);
  if (f64)
    state_features_kernel<double><<<blocks, kThreads, 0, s>>>(
        c, st, n_rows, static_cast<double*>(x), static_cast<double*>(x2), second, pc);
  else
    state_features_kernel<float><<<blocks, kThreads, 0, s>>>(
        c, st, n_rows, static_cast<float*>(x), static_cast<float*>(x2), second, pc);
  return static_cast<int>(cudaGetLastError());
}

// mode 0 forward: out0, out1 = log|psi|, arg psi (n_rows,); 1 vjp: from the
// cotangents cot_la, cot_ph (n_rows,) the gradients of raw into out1 and of a
// separate phase into out0, each laid out as its input (every entry written);
// 2 jvp: from tan_raw, tan_phase (laid out as raw and phase; null: zero) the
// tangents of both into out0, out1. raw: (n_rows, S, n_out); phase_layout 0:
// the phase outputs are raw's columns from n_amp_out on (phase unused), 1:
// phase is (n_rows, S, P), 2: phase is the global net's (n_rows, P), read at
// the last shell.
extern "C" int tables_epilogue(const void* cfg, int mode, const void* raw, const void* phase,
                               int phase_layout, const void* code, const void* cot_la,
                               const void* cot_ph, const void* tan_raw, const void* tan_phase,
                               void* out0, void* out1, int n_rows, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || mode < kForward || mode > kJvp || phase_layout < kPhaseInAmp ||
      phase_layout > kPhaseGlobal || n_rows < 0 || (mode == kVjp && (!cot_la || !cot_ph)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  if (phase_layout == kPhaseInAmp) {
    phase = raw;
    if (tan_raw) tan_phase = tan_raw;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return tables_epilogue_as<double>(c, mode, tables_args<double>(
        raw, phase, phase_layout, code, cot_la, cot_ph, tan_raw, tan_phase, out0, out1,
        n_rows), s);
  return tables_epilogue_as<float>(c, mode, tables_args<float>(
      raw, phase, phase_layout, code, cot_la, cot_ph, tan_raw, tan_phase, out0, out1, n_rows),
      s);
}

extern "C" const char* nade_glue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
