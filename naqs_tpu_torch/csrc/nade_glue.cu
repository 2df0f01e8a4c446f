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
// at 3.35 TB/s), tables_epilogue reads 20 B of raw outputs and 4 B of code a
// (row, shell), and the sampler's two kernels move 7-12 MB a shell.
//
// The two feature kernels write dense outputs of a few values a byte of input,
// so what held their first design (one thread a value) back was instructions:
// two run-time divisions, two shared-memory loads and the order flag again for
// every 4-byte value, and one store of 4 bytes. Their design since: one block
// a tile of kTileRows = 256 rows, one thread a row. The row's model-order bits
// are packed once (state_features: every thread its own row's permutation
// loop) into one 64-bit word of line bits and its swapped twin, the same for
// every shell of the row, and a swap mask (bit j: order3 == 0 at shell j); the
// codes (or meta) are computed once a (row, shell) and written coalesced. Then
// the tile's x, contiguous (rows x S x in_width, or rows x in_width), leaves
// as 16-byte chunks, thread i taking chunks i, i + 256, ...: a chunk's values
// come from at most two lines' words by shifts under the shell's causal mask,
// each value's bits built directly (no division: the step between a thread's
// chunks is precomputed on the host, `Walk`), and one 16-byte store each, so
// a warp writes 512 contiguous bytes. A route that staged the values in shared
// memory and wrote them by bulk asynchronous stores (cp.async.bulk, two
// buffers, one thread issuing) was as fast or slower at every shape timed
// (PERF.md), and was removed.
//
// shell_epilogue takes one thread a row. tables_epilogue has two mappings,
// chosen at launch from the row count and raw's layout, with the same bits.
// Its first design (one thread a (row, shell), floor(256 / S) rows a block,
// the forward's and jvp's sums by 1 thread of S after a barrier, local arrays
// indexed at run time on the stack) ran at 47% of its bound on 100,000 rows.
// The row tiles: a block takes kEpiRows rows, its codes come into shared
// memory by 16-byte loads, and each thread walks its row's shells in order,
// loading a group of shells' inputs at once before their arithmetic, and
// sums in registers, shell 0 first, as the shared-memory sum does: the same
// bits. On fewer rows than the wrapper's threshold (an SR update's live rows)
// one thread a row leaves most of the card idle, and on row-major raw a
// warp's loads would be strided: there one thread a (row, shell) in raw's
// memory order, the sums from shared memory in the same order. The run-time
// choices (the occupation's entry, the order flag's gather, the vjp's
// five-way scatter) are selects; the forward and the jvp read the applied
// mask of (shell, ca, cb) from a table the wrapper makes once per
// configuration in place of the sectors' loop (the vjp keeps the loop: timed
// faster). It reads the raw outputs where the nets leave them, at a row and
// a shell stride (the per-shell products give (rows, S, n_out) shell major,
// strides (n_out, rows n_out, 1)), and the vjp writes the gradient at the
// strides of the tensor its wrapper allocates like raw. Timed and not kept
// (PERF.md): stores through a warp's shared-memory slab and loads staged by
// cp.async, both slower. No kernel allocates, synchronizes or reads anything
// back: each is one launch on the caller's stream, so a CUDA graph can
// capture it.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSectors = 16;
constexpr int kMaxShells = 31;       // int64 states of at most 62 qubits
constexpr int kThreads = 256;
constexpr int kTileRows = 256;       // shell_features, state_features: rows a block
constexpr int kEpiRows = 128;        // tables_epilogue's row tiles: rows a block, one thread a row
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

__host__ __device__ inline double bits_to_double(uint64_t u) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(static_cast<long long>(u));
#else
  double d;
  memcpy(&d, &u, sizeof d);
  return d;
#endif
}

__host__ __device__ inline int popc64(int64_t x) {
#ifdef __CUDA_ARCH__
  return __popcll(static_cast<unsigned long long>(x));
#else
  return __builtin_popcountll(static_cast<unsigned long long>(x));
#endif
}

__host__ __device__ inline float bits_to_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
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

// ------------------------------------------------- the features' building blocks
//
// A row's model-order bits a, b (bit t = the alpha / beta occupation of model
// shell t) make one 64-bit word of line bits, the same for every shell of the
// row: with the binary encoding the first substring's S - 1 bits at [0, h) and
// the second's at [h, 2h) (h = S - 1), with the integer encoding a's at [0, h)
// and b's at [32, 32 + h). A line of in_width values (one (row, shell) of x) is
// that word, swapped where the canonical input puts b first (order3 == 0 at
// the shell: one bit of the row's swap mask), read at position t under the
// shell's causal mask.

// 0: pa > pb (the spin substrings swap), 1: pa == pb, 2: pa < pb, for the
// prefixes pa, pb of the shells before j
__host__ __device__ inline int order3_of(uint32_t pa, uint32_t pb) {
  return pa > pb ? 0 : (pa == pb ? 1 : 2);
}

__host__ __device__ inline uint64_t low64(int n) { return (uint64_t(1) << n) - 1; }

// The row's line bits, and the same with the two substrings swapped (the
// integer encoding has no swap: both the same)
struct alignas(16) RowBits {
  uint64_t plain, swapped;
};

__host__ __device__ inline RowBits row_bits(const GlueConfig& c, uint32_t a, uint32_t b) {
  const int h = c.n_shells - 1;
  const uint64_t m = low64(h), ma = a & m, mb = b & m;
  if (c.integer_inputs) return {ma | mb << 32, ma | mb << 32};
  return {ma | mb << h, mb | ma << h};
}

// Where a stream of lines finds its bits: per row of the tile its RowBits and
// a swap mask (bit j: order3 == 0 at shell j); the line (r, j) is shell
// shell0 + j of row r.
struct Source {
  const RowBits* bits;
  const uint32_t* swaps;
  int shell0, h;
  bool integer, canonical;
};

// +-1 as the binary encoding's (2 bit - 1) times the causal mask gives it
// (-0.0 where the bit is 0 and the value masked), built from its bits
template <typename T>
__host__ __device__ inline T signed_bit(uint32_t bit, uint32_t on);
template <>
__host__ __device__ inline float signed_bit<float>(uint32_t bit, uint32_t on) {
  return bits_to_float((bit ^ 1u) << 31 | (on ? 0x3F800000u : 0u));
}
template <>
__host__ __device__ inline double signed_bit<double>(uint32_t bit, uint32_t on) {
  return bits_to_double(uint64_t((bit ^ 1u) << 31 | (on ? 0x3FF00000u : 0u)) << 32);
}

// One line's bits, swapped as its input asks, and its shell's causal mask
struct Line {
  uint64_t p, live;

  __host__ __device__ Line(const Source& s, int r, int j) {
    const int shell = s.shell0 + j;
    p = s.canonical && ((s.swaps[r] >> shell) & 1u) ? s.bits[r].swapped : s.bits[r].plain;
    const uint64_t lo = low64(shell);
    live = s.integer ? lo : lo | lo << s.h;
  }

  // the bits of values t, t + 1, ... at bits 0, 1, ...: the binary encoding's
  // bit (or the integer encoding's a), the integer encoding's b, the mask
  __host__ __device__ void at(const Source& s, int t, uint32_t& pa, uint32_t& pb,
                              uint32_t& on) const {
    pa = static_cast<uint32_t>(p >> t);
    pb = s.integer ? static_cast<uint32_t>(p >> (32 + t)) : 0u;
    on = static_cast<uint32_t>(live >> t);
  }
};

// N values from the bits `Line::at` gives, as the plain version computes
// them: (2 bit - 1) times the causal mask, or the integer a + b - 1
// (canonical) / 2a + b times the mask
template <typename T, int N>
__host__ __device__ inline void emit(const Source& s, uint32_t pa, uint32_t pb, uint32_t on,
                                     T* v) {
  if (s.integer) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int av = (pa >> k) & 1, bv = (pb >> k) & 1;
      v[k] = T(static_cast<float>(s.canonical ? av + bv - 1 : 2 * av + bv) *
               static_cast<float>((on >> k) & 1u));
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = signed_bit<T>((pa >> k) & 1u, (on >> k) & 1u);
  }
}

// A tile's output as lines of w values, `period` lines a row (S for every
// shell's input, 1 for one shell's). Thread i of a block emits the 16-byte
// chunks i, i + kThreads, ...; `Walk` holds the step between them, computed
// once on the host, so that no thread divides: d_t, d_j, d_row advance
// (t, j, row) by kThreads chunks, and magic_w, magic_p are ceil(2^32 / w) and
// ceil(2^32 / period), exact quotients of the first chunk's offset (below
// 2^10) by multiplication.
struct Walk {
  int w, period, d_t, d_j, d_row;
  uint64_t magic_w, magic_p;
};

// A thread's position at the start of its current chunk; V values a chunk
template <typename T>
struct Cursor {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  int row, j, t;

  __host__ __device__ Cursor(const Walk& wk, uint32_t e0) {
    const uint32_t line = static_cast<uint32_t>((e0 * wk.magic_w) >> 32);
    t = static_cast<int>(e0 - line * wk.w);
    row = static_cast<int>((line * wk.magic_p) >> 32);
    j = static_cast<int>(line) - row * wk.period;
  }

  // the chunk's V values; a line ends inside it when w is not a multiple of
  // V (the next line's bits are loaded only inside the tile's rows)
  __host__ __device__ void values(const Walk& wk, const Source& s, int rows, T v[V]) const {
    uint32_t pa, pb, on;
    if (wk.w >= V - 1) {   // the chunk lies in at most two lines
      Line(s, row, j).at(s, t, pa, pb, on);
      const int m = wk.w - t;
      if (m < V) {   // it runs into the next line: that line's bits from bit m on
        int r = row, jj = j + 1;
        if (jj == wk.period) {
          jj = 0;
          ++r;
        }
        if (r < rows) {
          uint32_t na, nb, non;
          Line(s, r, jj).at(s, 0, na, nb, non);
          const uint32_t keep = (1u << m) - 1u;
          pa = (pa & keep) | na << m;
          pb = (pb & keep) | nb << m;
          on = (on & keep) | non << m;
        }
      }
      emit<T, V>(s, pa, pb, on, v);
      return;
    }
    int r = row, jj = j, tt = t;   // lines of fewer than V - 1 values
    Line ln(s, r, jj);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (tt == wk.w) {
        tt = 0;
        if (++jj == wk.period) {
          jj = 0;
          ++r;
        }
        if (r < rows) ln = Line(s, r, jj);
      }
      ln.at(s, tt, pa, pb, on);
      emit<T, 1>(s, pa, pb, on, v + k);
      ++tt;
    }
  }

  __host__ __device__ void advance(const Walk& wk) {
    t += wk.d_t;
    j += wk.d_j;
    row += wk.d_row;
    if (t >= wk.w) {
      t -= wk.w;
      ++j;
    }
    if (j >= wk.period) {
      j -= wk.period;
      ++row;
    }
  }
};

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

// A 16-byte store of a chunk's values
__device__ inline void store16(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store16(double* p, const double v[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// The tile's n values of lines, from out (16-byte aligned): each thread its
// chunks, computed in registers and stored as one 16-byte store each, so a
// warp writes 512 contiguous bytes; the tile's last chunk, where n is not a
// multiple of V, value by value.
template <typename T>
__device__ void stream_lines(const Walk& wk, const Source& s, int rows, T* out, int n) {
  constexpr int V = Cursor<T>::V;
  Cursor<T> cur(wk, threadIdx.x * V);
  for (int e = threadIdx.x * V; e < n; e += kThreads * V, cur.advance(wk)) {
    T v[V];
    cur.values(wk, s, rows, v);
    if (e + V <= n) {
      store16(out + e, v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k < n - e) out[e + k] = v[k];
    }
  }
}

// n int32 words from shared memory to out (16-byte aligned), 16 bytes a thread
__device__ void copy_words(const int32_t* src, int32_t* out, int n) {
  const int n4 = n / 4;
  for (int i = threadIdx.x; i < n4; i += kThreads)
    reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(src)[i];
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) out[i] = src[i];
}

// The shell_order permutation into shared memory, each entry by a constant
// index (a runtime index into the kernel's parameter would copy it to the stack)
__device__ void load_order(const GlueConfig& c, int* order) {
#pragma unroll
  for (int i = 0; i < kMaxShells + 1; ++i)
    if (threadIdx.x == i) order[i] = c.shell_order[i];
}

// One block a tile of kTileRows frontier rows, one thread a row: a, b are read
// once, order3, ca and cb written to meta's three rows (coalesced), the line
// bits and the swap flag kept in shared memory; then the tile's x (rows x
// in_width, contiguous) leaves in 16-byte chunks (stream_lines).
template <typename T>
__global__ void __launch_bounds__(kThreads)
shell_features_kernel(GlueConfig c, Walk wk, const int64_t* __restrict__ a,
                      const int64_t* __restrict__ b, int j, int n_rows, T* __restrict__ x,
                      int32_t* __restrict__ meta) {
  __shared__ RowBits s_bits[kTileRows];
  __shared__ uint32_t s_swap[kTileRows];
  const int64_t row0 = int64_t(blockIdx.x) * kTileRows;
  const int rows = n_rows - row0 < kTileRows ? static_cast<int>(n_rows - row0) : kTileRows;
  const int r = threadIdx.x;
  if (r < rows) {
    const uint32_t ar = static_cast<uint32_t>(a[row0 + r]), br = static_cast<uint32_t>(b[row0 + r]);
    const uint32_t lo = (1u << j) - 1u, pa = ar & lo, pb = br & lo;
    const int order3 = order3_of(pa, pb);
    meta[row0 + r] = order3;
    meta[n_rows + row0 + r] = popc64(pa);
    meta[2 * int64_t(n_rows) + row0 + r] = popc64(pb);
    s_bits[r] = row_bits(c, ar, br);
    s_swap[r] = static_cast<uint32_t>(order3 == 0) << j;
  }
  __syncthreads();
  const Source s{s_bits, s_swap, j, c.n_shells - 1, c.integer_inputs != 0, c.amp_sym != 0};
  stream_lines(wk, s, rows, x + row0 * c.in_width, rows * c.in_width);
}

// One block a tile of kTileRows states, one thread a row: the row's bits in
// model order (bit j = state shell shell_order[j]), its S codes into shared
// memory, its line bits and swap mask; then the codes (rows x S int32) and x
// (rows x S x in_width), and x2 as `second` says, leave in 16-byte chunks.
// second: 0 no second input; 1 the phase net's, the last shell's only (rows,
// in_width); 2 every shell's (rows, S, in_width). Dynamic shared memory:
// state_features_smem_bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
state_features_kernel(GlueConfig c, Walk wk_all, Walk wk_last,
                      const int64_t* __restrict__ states, int n_rows, T* __restrict__ x,
                      T* __restrict__ x2, int second, int32_t* __restrict__ code) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_order[kMaxShells + 1];
  RowBits* s_bits = reinterpret_cast<RowBits*>(smem);
  uint32_t* s_swap = reinterpret_cast<uint32_t*>(s_bits + kTileRows);
  int32_t* s_code = reinterpret_cast<int32_t*>(s_swap + kTileRows);
  const int s = c.n_shells, w = c.in_width;
  const int64_t row0 = int64_t(blockIdx.x) * kTileRows;
  const int rows = n_rows - row0 < kTileRows ? static_cast<int>(n_rows - row0) : kTileRows;
  const int r = threadIdx.x;
  load_order(c, s_order);
  __syncthreads();
  if (r < rows) {
    const int64_t st = states[row0 + r];
    uint32_t a = 0, b = 0, swaps = 0;
    for (int j = 0; j < s; ++j) {
      const uint32_t pair = static_cast<uint32_t>(st >> (2 * s_order[j])) & 3u;
      a |= (pair & 1u) << j;
      b |= (pair >> 1) << j;
    }
    int32_t* cd = s_code + r * s;
    for (int j = 0; j < s; ++j) {
      const uint32_t lo = (1u << j) - 1u, pa = a & lo, pb = b & lo;
      const int order3 = order3_of(pa, pb);
      swaps |= static_cast<uint32_t>(order3 == 0) << j;
      cd[j] = order3 | static_cast<int>((a >> j) & 1u) << 2 | static_cast<int>((b >> j) & 1u) << 3 |
              popc64(pa) << 8 | popc64(pb) << 16;
    }
    // the exchange phase shift pi (N01 mod 2) where the full pa < pb
    if (a < b && (popc64(~a & b) & 1)) cd[s - 1] |= 1 << 4;
    s_bits[r] = row_bits(c, a, b);
    s_swap[r] = swaps;
  }
  __syncthreads();
  copy_words(s_code, code + row0 * s, rows * s);
  const int h = s - 1;
  const bool integer = c.integer_inputs != 0;
  stream_lines(wk_all, Source{s_bits, s_swap, 0, h, integer, c.amp_sym != 0}, rows,
               x + row0 * s * w, rows * s * w);
  if (second == 2)
    stream_lines(wk_all, Source{s_bits, s_swap, 0, h, integer, c.phase_sym != 0}, rows,
                 x2 + row0 * s * w, rows * s * w);
  else if (second == 1)
    stream_lines(wk_last, Source{s_bits, s_swap, s - 1, h, integer, c.phase_sym != 0}, rows,
                 x2 + row0 * w, rows * w);
}

// An operand of tables_epilogue at (row, shell): elements at p + row * row_stride
// + shell * shell_stride + k, the last stride 1. The nets' outputs come shell
// major, (rows, S, w) with strides (w, rows * w, 1), as the per-shell products
// leave them; the LUT shells' and the tests' are row major. A global phase
// net's (rows, P) is read at the last shell only (its shell stride unused).
template <typename T>
struct Strided {
  T* p;
  int64_t row, shell;

  __host__ __device__ T* at(int64_t r, int j) const { return p + r * row + j * shell; }
};

template <typename T>
struct TablesArgs {
  Strided<const T> raw;    // the amp trunk's outputs (rows, S, n_out)
  Strided<const T> phase;  // the phase outputs: raw's columns from n_amp_out on
                           // (kPhaseInAmp), (rows, S, P) or (rows, P)
  int phase_layout;        // PhaseLayout
  const int32_t* code;     // (rows, S), contiguous, 16-byte aligned
  const uint8_t* masks;    // (S, S, S): the applied mask of shell j after ca, cb up-spins at
                           // [(j S + ca) S + cb], bit k occupation k
  const T* cot_la;         // vjp: cotangents (rows,)
  const T* cot_ph;
  Strided<const T> tan_raw;    // jvp: tangents laid out as raw and phase; p null: zero
  Strided<const T> tan_phase;
  Strided<T> out0;         // forward, jvp: (rows,) of log|psi| and arg psi or their tangents;
  Strided<T> out1;         // vjp: the gradients of phase (out0) and raw (out1), each at its
                           // own strides
  int n_rows;
};

// v[k] for a run-time k in 0..3, by selects: an array indexed at run time
// would live on the stack
template <typename T>
__host__ __device__ inline T pick4(const T v[4], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

// amp_logits on five values held in registers: the gather of order3 by selects
template <typename T>
__host__ __device__ inline void amp_logits_of(bool sym, const T a[5], int order3, T l[4]) {
  if (!sym) {
    for (int k = 0; k < 4; ++k) l[k] = a[k];
    return;
  }
  const T g1 = order3 == 1 ? a[1] : (order3 == 0 ? a[3] : a[4]);
  const T g2 = order3 == 1 ? a[1] : (order3 == 0 ? a[4] : a[3]);
  l[0] = T(0.5) * (a[0] + a[0]);
  l[1] = T(0.5) * (a[1] + g1);
  l[2] = T(0.5) * (a[1] + g2);
  l[3] = T(0.5) * (a[2] + a[2]);
}

// The five raw amp gradients from the four logits' dl, each half added to
// its base and its gathered raw entry in the order of the scatter over k =
// 0..3 into zeros (0 + x, not x: a -0 gradient sums to +0 there too)
template <typename T>
__host__ __device__ inline void amp_grads_of(const T dl[4], int order3, T d[5]) {
  const T h0 = T(0.5) * dl[0], h1 = T(0.5) * dl[1], h2 = T(0.5) * dl[2], h3 = T(0.5) * dl[3];
  d[0] = (T(0) + h0) + h0;
  d[2] = (T(0) + h3) + h3;
  if (order3 == 1) {
    d[1] = (((T(0) + h1) + h1) + h2) + h2;
    d[3] = T(0);
    d[4] = T(0);
  } else {
    d[1] = (T(0) + h1) + h2;
    d[3] = T(0) + (order3 == 0 ? h1 : h2);
    d[4] = T(0) + (order3 == 0 ? h2 : h1);
  }
}

// A read of memory no kernel writes while it runs (the read-only path)
template <typename T>
__device__ __forceinline__ T load_ro(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// One (row, shell)'s inputs: the code word, the amp outputs, the one phase
// entry the occupation reads (xp, with ph_ok where there is one) and, for the
// jvp, their tangents
template <typename T, int kMode>
struct ShellIn {
  int32_t code;
  T a[5], xp;
  T ta[5], txp;
  bool ph_ok;

  __device__ __forceinline__ void load(const GlueConfig& c, const TablesArgs<T>& q, int64_t row,
                                      int j, int32_t cd) {
    code = cd;
    const int occ = (cd >> 2) & 3, pk = c.phase_sym ? sym_base(occ) : occ;
    const T* r = q.raw.at(row, j);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = r[k];
    a[4] = c.amp_sym ? r[4] : T(0);
    ph_ok = q.phase_layout != kPhaseGlobal || j == c.n_shells - 1;
    xp = ph_ok ? q.phase.at(row, j)[pk] : T(0);
    if constexpr (kMode == kJvp) {
      if (q.tan_raw.p) {
        const T* t = q.tan_raw.at(row, j);
#pragma unroll
        for (int k = 0; k < 4; ++k) ta[k] = t[k];
        ta[4] = c.amp_sym ? t[4] : T(0);
      }
      txp = ph_ok && q.tan_phase.p ? q.tan_phase.at(row, j)[pk] : T(0);
    }
  }
};

// One (row, shell)'s share of the forward (va, vb: log|psi| and arg psi) or
// of the jvp (their tangents), or its gradients written at the vjp's output
// strides (h = cot_la / 2, cot_ph: the row's cotangents)
template <typename T, int kMode>
__device__ __forceinline__ void shell_epilogue_of(const GlueConfig& c, const TablesArgs<T>& q,
                                         const ShellIn<T, kMode>& x, int64_t row, int j, T h,
                                         T cot_ph, T& va, T& vb) {
  const int s = c.n_shells;
  const int order3 = x.code & 3, occ = (x.code >> 2) & 3;
  const bool shifted = (x.code >> 4) & 1;
  const int ca = (x.code >> 8) & 0xFF, cb = (x.code >> 16) & 0xFF;
  // the table where the mode reads it (the vjp computes the mask: timed faster)
  const unsigned m = kMode != kVjp && ca < s && cb < s
                         ? load_ro(q.masks + (j * s + ca) * s + cb)
                         : applied_mask(c, occupation_mask(c, ca, cb, j), j);
  T l[4], lsm[4] = {T(0), T(0), T(0), T(0)};
  amp_logits_of(c.amp_sym != 0, x.a, order3, l);
  const bool any = log_softmax4(l, m, lsm);
  // the raw phase entry that occupation occ reads, and whether the
  // activation pins it to 0 (its shell's mask leaves occ as the one option)
  const int pk = c.phase_sym ? sym_base(occ) : occ;
  const bool pinned = c.activation != kActNone && !c.phase_sym && popc64(m) == 1 &&
                      ((m >> pk) & 1);
  va = T(0);
  vb = T(0);
  if constexpr (kMode == kForward) {
    va = any ? T(0.5) * pick4(lsm, occ) : T(0.5 * kBigNeg);
    vb = pinned ? T(0) : activate(c.activation, x.xp);
    if (c.phase_sym && j == s - 1 && shifted) vb = vb + T(kPi);
  } else if constexpr (kMode == kJvp) {
    if (any && q.tan_raw.p) {
      T tl[4], sum = T(0), dz[4];
      amp_logits_of(c.amp_sym != 0, x.ta, order3, tl);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dz[k] = ((m >> k) & 1) ? T(2) * tl[k] : T(0);
        sum += f_exp(lsm[k]) * dz[k];
      }
      va = T(0.5) * (pick4(dz, occ) - sum);
    }
    if (x.ph_ok && q.tan_phase.p && !pinned) vb = activate_grad(c.activation, x.xp) * x.txp;
  } else {   // kVjp: write the gradients of this (row, shell)'s raw outputs
    T dl[4] = {T(0), T(0), T(0), T(0)};
    if (any)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((m >> k) & 1) dl[k] = T(2) * ((k == occ ? h : T(0)) - f_exp(lsm[k]) * h);
    T* d = q.out1.at(row, j);
    if (c.amp_sym) {
      T d5[5];
      amp_grads_of(dl, order3, d5);
      for (int k = 0; k < 5; ++k) d[k] = d5[k];
    } else {
      for (int k = 0; k < 4; ++k) d[k] = dl[k];
    }
    if (x.ph_ok) {
      T* dp = q.phase_layout == kPhaseInAmp ? d + c.n_amp_out : q.out0.at(row, j);
      const T g = pinned ? T(0) : cot_ph * activate_grad(c.activation, x.xp);
      for (int k = 0; k < 3; ++k) dp[k] = k == pk ? g : T(0);
      if (!c.phase_sym) dp[3] = pk == 3 ? g : T(0);
    }
  }
}

// Shells a thread of the row tiles has in flight together: 2 in float, 1 in
// double (more were slower, PERF.md)
template <typename T>
constexpr int kEpiGroup = sizeof(T) == 8 ? 1 : 2;

// One block a tile of kEpiRows rows, one thread a row: the tile's codes
// ((rows, S) int32, contiguous) come into shared memory by 16-byte loads,
// then each thread walks its row's shells in order, loading a group of
// kEpiGroup shells' inputs at once before their arithmetic. The forward and
// the jvp sum a row's shells in registers, shell 0 first (the order of the
// first design's shared-memory sum: the same bits). The vjp writes each
// (row, shell)'s gradients where the rows of a shell lie together (the nets'
// shell-major layout: a warp's 32 rows at one shell are contiguous). No
// barrier after the codes, no local array indexed at run time, no atomics.
template <typename T, int kMode>
__global__ void __launch_bounds__(kEpiRows)
tables_epilogue_kernel(GlueConfig c, TablesArgs<T> q) {
  __shared__ __align__(16) int32_t s_code[kEpiRows * kMaxShells];
  constexpr int G = kEpiGroup<T>;
  const int s = c.n_shells;
  const int64_t row0 = int64_t(blockIdx.x) * kEpiRows;
  const int rows = q.n_rows - row0 < kEpiRows ? static_cast<int>(q.n_rows - row0) : kEpiRows;
  {
    const int n = rows * s, n4 = n / 4;
    const int32_t* src = q.code + row0 * s;
    for (int i = threadIdx.x; i < n4; i += kEpiRows)
      reinterpret_cast<int4*>(s_code)[i] = reinterpret_cast<const int4*>(src)[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kEpiRows) s_code[i] = src[i];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const int64_t row = row0 + r;
  const int32_t* cd = s_code + r * s;
  T sum_a = T(0), sum_b = T(0);
  T h = T(0), cot_ph = T(0);
  if constexpr (kMode == kVjp) {
    h = T(0.5) * q.cot_la[row];
    cot_ph = q.cot_ph[row];
  }
  for (int j0 = 0; j0 < s; j0 += G) {
    ShellIn<T, kMode> in[G];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (j0 + u < s) in[u].load(c, q, row, j0 + u, cd[j0 + u]);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = j0 + u;
      if (j >= s) break;
      T va, vb;
      shell_epilogue_of(c, q, in[u], row, j, h, cot_ph, va, vb);
      if constexpr (kMode != kVjp) {
        sum_a = j == 0 ? va : sum_a + va;
        sum_b = j == 0 ? vb : sum_b + vb;
      }
    }
  }
  if constexpr (kMode != kVjp) {
    q.out0.p[row] = sum_a;
    q.out1.p[row] = sum_b;
  }
}

// One thread a (row, shell), floor(kThreads / S) rows whole in a block, the
// threads in the order of raw's entries: shell by shell where a shell's rows
// lie together (the nets' shell-major layout), row by row where a row's
// shells do (row-major: the LUT shells', the tests'), so that a warp's loads
// and the vjp's stores are contiguous in both. The forward and the jvp sum a
// row's shells from shared memory, one thread a row, shell 0 first: the row
// tiles' bits. Launched below the wrapper's row count for the row tiles, where
// one thread a row would leave most of the card idle, and on row-major raw.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
tables_epilogue_kernel_pairs(GlueConfig c, TablesArgs<T> q, bool shell_order) {
  const int s = c.n_shells, per_block = kThreads / s, t = threadIdx.x;
  const int rr = shell_order ? t % per_block : t / s, j = shell_order ? t / per_block : t % s;
  const int64_t row0 = int64_t(blockIdx.x) * per_block, row = row0 + rr;
  T va = T(0), vb = T(0);
  if (row < q.n_rows) {
    ShellIn<T, kMode> x;
    x.load(c, q, row, j, q.code[row * s + j]);
    T h = T(0), cot_ph = T(0);
    if constexpr (kMode == kVjp) {
      h = T(0.5) * q.cot_la[row];
      cot_ph = q.cot_ph[row];
    }
    shell_epilogue_of(c, q, x, row, j, h, cot_ph, va, vb);
  }
  if constexpr (kMode != kVjp) {
    __shared__ T sa[kThreads], sb[kThreads];
    sa[t] = va;
    sb[t] = vb;
    __syncthreads();
    if (t < per_block && row0 + t < q.n_rows) {
      const int first = shell_order ? t : t * s, step = shell_order ? per_block : 1;
      T sum_a = sa[first], sum_b = sb[first];
      for (int k = 1; k < s; ++k) {
        sum_a += sa[first + k * step];
        sum_b += sb[first + k * step];
      }
      q.out0.p[row0 + t] = sum_a;
      q.out1.p[row0 + t] = sum_b;
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

// ceil(2^32 / d): (x * magic(d)) >> 32 is x / d for every x with x d < 2^32
uint64_t magic(int d) { return ((uint64_t(1) << 32) + d - 1) / d; }

// the step of kThreads chunks of v values over lines of w values, `period` a row
Walk make_walk(int w, int period, int v) {
  const int step = kThreads * v, lines = step / w;
  return {w, period, step % w, lines % period, lines / period, magic(w), magic(period)};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int shell_features_as(const GlueConfig& c, const int64_t* a, const int64_t* b, int j,
                      int n_rows, void* x, void* meta, cudaStream_t s) {
  const Walk wk = make_walk(c.in_width, 1, Cursor<T>::V);
  shell_features_kernel<T><<<blocks_for(n_rows, kTileRows), kThreads, 0, s>>>(
      c, wk, a, b, j, n_rows, static_cast<T*>(x), static_cast<int32_t*>(meta));
  return static_cast<int>(cudaGetLastError());
}

// state_features_kernel's dynamic shared memory a block: each row's RowBits,
// swap mask and S codes; below 48 KB for S <= 31.
int state_features_smem_bytes(const GlueConfig& c) {
  return kTileRows * static_cast<int>(sizeof(RowBits) + sizeof(uint32_t) +
                                      sizeof(int32_t) * c.n_shells);
}

template <typename T>
int state_features_as(const GlueConfig& c, const int64_t* states, int n_rows, void* x,
                      void* x2, int second, void* code, cudaStream_t s) {
  const Walk all = make_walk(c.in_width, c.n_shells, Cursor<T>::V);
  const Walk last = make_walk(c.in_width, 1, Cursor<T>::V);
  const int smem = state_features_smem_bytes(c);
  state_features_kernel<T><<<blocks_for(n_rows, kTileRows), kThreads, smem, s>>>(
      c, all, last, states, n_rows, static_cast<T*>(x), static_cast<T*>(x2), second,
      static_cast<int32_t*>(code));
  return static_cast<int>(cudaGetLastError());
}

// The row tiles where the wrapper asks for them (row_tiles: enough rows to
// fill the card one thread a row) and raw is shell-major; else one thread a
// (row, shell). Both give the same bits.
template <typename T>
int tables_epilogue_as(const GlueConfig& c, int mode, const TablesArgs<T>& q, bool row_tiles,
                       cudaStream_t s) {
  const bool shell_major = q.raw.shell >= q.raw.row;
  if (row_tiles && shell_major) {
    const int blocks = blocks_for(q.n_rows, kEpiRows);
    if (mode == kForward)
      tables_epilogue_kernel<T, kForward><<<blocks, kEpiRows, 0, s>>>(c, q);
    else if (mode == kJvp)
      tables_epilogue_kernel<T, kJvp><<<blocks, kEpiRows, 0, s>>>(c, q);
    else
      tables_epilogue_kernel<T, kVjp><<<blocks, kEpiRows, 0, s>>>(c, q);
  } else {
    const int per_block = kThreads / c.n_shells, threads = per_block * c.n_shells;
    const int blocks = blocks_for(q.n_rows, per_block);
    if (mode == kForward)
      tables_epilogue_kernel_pairs<T, kForward><<<blocks, threads, 0, s>>>(c, q, shell_major);
    else if (mode == kJvp)
      tables_epilogue_kernel_pairs<T, kJvp><<<blocks, threads, 0, s>>>(c, q, shell_major);
    else
      tables_epilogue_kernel_pairs<T, kVjp><<<blocks, threads, 0, s>>>(c, q, shell_major);
  }
  return static_cast<int>(cudaGetLastError());
}

// strides: (row, shell) pairs of raw, phase, tan_raw, tan_phase, out0 and
// out1, in elements; a pointer that is null, or an output the mode does not
// write at strides, has its pair unread
template <typename T>
TablesArgs<T> tables_args(const GlueConfig& c, const void* raw, const void* phase, int layout,
                          const void* code, const void* masks, const void* cot_la,
                          const void* cot_ph,
                          const void* tan_raw, const void* tan_phase, void* out0, void* out1,
                          const int64_t* st, int n_rows) {
  const Strided<const T> r{static_cast<const T*>(raw), st[0], st[1]};
  const Strided<const T> tr{static_cast<const T*>(tan_raw), st[4], st[5]};
  const bool in_amp = layout == kPhaseInAmp;
  return {r,
          in_amp ? Strided<const T>{r.p + c.n_amp_out, r.row, r.shell}
                 : Strided<const T>{static_cast<const T*>(phase), st[2], st[3]},
          layout,
          static_cast<const int32_t*>(code),
          static_cast<const uint8_t*>(masks),
          static_cast<const T*>(cot_la),
          static_cast<const T*>(cot_ph),
          tr,
          in_amp ? Strided<const T>{tr.p ? tr.p + c.n_amp_out : nullptr, tr.row, tr.shell}
                 : Strided<const T>{static_cast<const T*>(tan_phase), st[6], st[7]},
          Strided<T>{static_cast<T*>(out0), st[8], st[9]},
          Strided<T>{static_cast<T*>(out1), st[10], st[11]},
          n_rows};
}

}  // namespace

// Every entry: cfg points at a GlueConfig in host memory, read before the
// launch; f64 selects the double instantiation (a float64 model), else float;
// n_rows = 0 launches nothing. Returns a cudaError_t.

// x: (n_rows, in_width), 16-byte aligned; meta: (3, n_rows) int32 rows order3,
// ca, cb.
extern "C" int shell_features(const void* cfg, const void* a, const void* b, int j, int n_rows,
                              void* x, void* meta, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || j < 0 || j >= c.n_shells || n_rows < 0 || !aligned16(x) ||
      int64_t(n_rows) * c.in_width >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* pa = static_cast<const int64_t*>(a);
  const int64_t* pb = static_cast<const int64_t*>(b);
  return f64 ? shell_features_as<double>(c, pa, pb, j, n_rows, x, meta, s)
             : shell_features_as<float>(c, pa, pb, j, n_rows, x, meta, s);
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

// x: (n_rows, S, in_width); x2 as `second` says (null for 0); code: (n_rows, S);
// each 16-byte aligned.
extern "C" int state_features(const void* cfg, const void* states, int n_rows, void* x,
                              void* x2, int second, void* code, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || n_rows < 0 || second < 0 || second > 2 || (second && !x2) ||
      !aligned16(x) || !aligned16(x2) || !aligned16(code))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* st = static_cast<const int64_t*>(states);
  return f64 ? state_features_as<double>(c, st, n_rows, x, x2, second, code, s)
             : state_features_as<float>(c, st, n_rows, x, x2, second, code, s);
}

// The bytes of dynamic shared memory a block of state_features' kernel
// launches with (the other three kernels launch with none); -1 for a
// configuration the entries refuse.
extern "C" int state_features_smem(const void* cfg) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  return config_ok(c) ? state_features_smem_bytes(c) : -1;
}

// mode 0 forward: out0, out1 = log|psi|, arg psi (n_rows,); 1 vjp: from the
// cotangents cot_la, cot_ph (n_rows,) the gradients of raw into out1 and of a
// separate phase into out0, every entry written; 2 jvp: from tan_raw,
// tan_phase (null: zero) the tangents of both into out0, out1. raw: (n_rows,
// S, n_out); phase_layout 0: the phase outputs are raw's columns from
// n_amp_out on (phase and tan_phase unused), 1: phase is (n_rows, S, P), 2:
// phase is the global net's (n_rows, P), read at the last shell. strides: 12
// int64 in host memory, the (row, shell) strides in elements of raw, phase,
// tan_raw, tan_phase, out0 and out1 (the vjp's; the forward's and the jvp's
// outputs are contiguous (n_rows,)), each operand's last stride 1 and its
// pairs such that no two written entries meet. code: (n_rows, S)
// contiguous, 16-byte aligned; masks: (S, S, S) uint8, the applied mask of
// shell j after ca, cb up-spins at [j, ca, cb] (bit k occupation k).
// row_tiles: one thread a row where raw is shell-major (the caller's choice
// from n_rows), else one thread a (row, shell); the same bits.
extern "C" int tables_epilogue(const void* cfg, int mode, const void* raw, const void* phase,
                               int phase_layout, const void* code, const void* masks,
                               const void* cot_la,
                               const void* cot_ph, const void* tan_raw, const void* tan_phase,
                               void* out0, void* out1, const int64_t* strides, int n_rows,
                               int row_tiles, int f64, void* stream) {
  const GlueConfig& c = *static_cast<const GlueConfig*>(cfg);
  if (!config_ok(c) || mode < kForward || mode > kJvp || phase_layout < kPhaseInAmp ||
      phase_layout > kPhaseGlobal || n_rows < 0 || (mode == kVjp && (!cot_la || !cot_ph)) ||
      !strides || !masks || !aligned16(code))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    return tables_epilogue_as<double>(c, mode, tables_args<double>(
        c, raw, phase, phase_layout, code, masks, cot_la, cot_ph, tan_raw, tan_phase, out0,
        out1, strides, n_rows), row_tiles != 0, s);
  return tables_epilogue_as<float>(c, mode, tables_args<float>(
      c, raw, phase, phase_layout, code, masks, cot_la, cot_ph, tan_raw, tan_phase, out0, out1,
      strides, n_rows), row_tiles != 0, s);
}

extern "C" const char* nade_glue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
