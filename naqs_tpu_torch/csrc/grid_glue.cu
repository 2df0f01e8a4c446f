// The grid and rank engines' E_loc glue for sm_90a: three kernels around the
// accumulations of csrc/grid_engine.cu and the rank engine's row kernels.
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA
// (naqs_tpu/ops/rank.py::rank_index and build_value_table;
// naqs_tpu/ops/dense_engine.py: the value grids of dense_local_energy
// :250-268, factored_local_energy :477-493 and factored_xl_local_energy
// :860-875, _xl_blocked_idx :822-831, and the readouts :294-310, :526-541 and
// :940-956 with the XL engine's true diagonal :950-955). In eager PyTorch
// each was a chain of ten to a few hundred launches per E_loc call (the
// rank index a Python loop over the shells); here each is one or two.
//
//   rank_index:    idx[i] = the colex rank of states[i] (csrc/rank.cuh's
//                  rank_of), or `size` outside every sector; with the XL
//                  engine's maps, (a_hat, b_hat) = (perm_a[ra], perm_b[rb])
//                  with ra = min(idx / Sb_full, Sa_full), rb = idx >= Sa_full
//                  Sb_full ? Sb_full : idx % Sb_full.
//   grid_scatter:  two launches. (i) fills the output (the grid with zeros,
//                  the table with (miss, 0)) and, for a grid, takes ref, the
//                  maximum of the live rows' log_amp, by an order-preserving
//                  integer atomicMax (the same result in any order); (ii)
//                  writes each live row's value at its cell: for a grid
//                  (w cos ph, w sin ph) with w = exp(log_amp - ref) in the
//                  input's type, then f32; for the table (log_amp, phase) as
//                  f32. Live: below n_valid (a 0-d int64 device tensor) and,
//                  for the dense and factored grids, inside the sector. A row
//                  that is not live, or whose cell lies outside the grid or
//                  the table, writes nothing: no two live rows of a buffer
//                  share a cell, so no write races.
//   grid_readout:  one thread a query row: the cell, the numerator (the dense
//                  grid's (Sb, Sa) entry, the factored engine's row, the XL
//                  staircase's packed cell), ratio = exp(clamp(ref - q_la,
//                  -30, 30)) in the input's type, then f32, the rotation by
//                  cos and sin of q_ph, and e_re = e_diag + f64(ratio (n0 c +
//                  n1 s)), e_im = f64(ratio (n1 c - n0 s)). An XL row outside
//                  the staircase takes the true diagonal, sum_k diag_coeff[k]
//                  (-1)^popc(s & diag_yz[k]) in f64, from diag_yz/diag_coeff
//                  staged in shared memory (no (U, Kd) temporary).
//
// The arithmetic is the plain versions' (ops/grid_glue.py) operation for
// operation: the same libdevice transcendentals in the same types (no fast
// math), products and sums as separate roundings (__fmul_rn, __fadd_rn: no
// contraction into fma), so the outputs are the plain chain's bits on the
// card, except the XL true diagonal, whose f64 sum runs in term order where
// torch.sum runs in its own.
//
// What bounds them: bytes. rank_index reads 8 bytes and writes 8 (16 with the
// XL maps) a state; the scatter writes the whole grid or table (the XL grid
// is 204.5 MB) and reads a few words a row; the readout reads a row's index,
// log-amp, phase, numerator and diagonal and writes 16 bytes, plus, for an XL
// row outside the staircase, its Kd terms from shared memory. Design: one
// thread a state or row, coalesced; the fill is a grid-stride loop of 16-byte
// stores; the spec table (at most 10.5 KB) is staged per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/grid_glue.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFillBlocks = 4096;  // grid-stride fill: at most this many blocks
constexpr int kDiagChunk = 256;    // readout: diagonal terms staged at once
// the largest spec table (16 shells), in int32s
constexpr int kMaxSpecInts = 4 * (16 + 1) + (1 << 8) + (1 << 8) * (8 + 1);

// scatter modes (ops/grid_glue.py::_SCATTER)
constexpr int kGrid = 0;   // rank indices of an (Sa, Sb) sector -> (Sa+1, Sb+1) grid
constexpr int kXl = 1;     // (a_hat, b_hat) pairs -> (Sa*+1, Sb*+1) grid
constexpr int kTable = 2;  // rank indices -> (size+1) table
// readout modes (ops/grid_glue.py::_READOUT)
constexpr int kDense = 0;  // numerator grid (Sb, Sa)
constexpr int kRows = 1;   // numerator per row
constexpr int kStair = 2;  // numerator per packed staircase cell

// the input type's transcendentals: libdevice's, as torch's own kernels call
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_cos(float x) { return cosf(x); }
__device__ __forceinline__ double t_cos(double x) { return cos(x); }
__device__ __forceinline__ float t_sin(float x) { return sinf(x); }
__device__ __forceinline__ double t_sin(double x) { return sin(x); }

// an unsigned key in the order of the values, 0 for none: -0 < +0, and a NaN
// above every number (torch.max returns NaN where one is live)
__device__ __forceinline__ unsigned long long order_key(float v) {
  if (v != v) return 0xFFFFFFFFull;
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long order_key(double v) {
  if (v != v) return ~0ull;
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | (1ull << 63));
}

// the value of a key; -inf for 0 (no live row)
__device__ __forceinline__ void from_key(unsigned long long k, float* v) {
  const uint32_t u = static_cast<uint32_t>(k);
  *v = __uint_as_float(k == 0 ? 0xFF800000u : (u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ void from_key(unsigned long long k, double* v) {
  *v = __longlong_as_double(static_cast<long long>(
      k == 0 ? 0xFFF0000000000000ull : (k >> 63) ? (k ^ (1ull << 63)) : ~k));
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// *n_valid clamped to [0, n_rows] (csrc/row_energy.cuh's live_count)
__device__ __forceinline__ int64_t live_count(const int64_t* __restrict__ n_valid,
                                              int n_rows) {
  const int64_t n = __ldg(n_valid);
  return n < 0 ? 0 : (n > n_rows ? n_rows : n);
}

// ------------------------------------------------------------ A: rank_index

__global__ void __launch_bounds__(kThreads) glue_rank_index_kernel(
    const int32_t* __restrict__ spec, int n_spec, int n_shells, int lo_bits, uint32_t qmask,
    int size, const int64_t* __restrict__ states, int n, const int32_t* __restrict__ perm_a,
    const int32_t* __restrict__ perm_b, int sa_full, int sb_full, int64_t* __restrict__ out0,
    int64_t* __restrict__ out1) {
  extern __shared__ int4 sh_spec[];
  const Spec sp = stage_spec(sh_spec, spec, n_spec, n_shells, lo_bits, size);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int idx = rank_of(sp, spin_words(__ldg(states + i), qmask));
  if (perm_a == nullptr) {
    out0[i] = idx;
    return;
  }
  const int full = sa_full * sb_full;
  const int ra = min(idx / sb_full, sa_full);
  const int rb = idx >= full ? sb_full : idx % sb_full;
  out0[i] = __ldg(perm_a + ra);
  out1[i] = __ldg(perm_b + rb);
}

// ---------------------------------------------------------- B: grid_scatter

// whether live row i's log-amp enters ref: every live row of the XL buffer;
// for the dense and factored grids a live row inside the sector
__device__ __forceinline__ bool in_ref(int mode, const int64_t* __restrict__ c0, int64_t i,
                                       int64_t cells) {
  return mode == kXl || __ldg(c0 + i) < cells;
}

// (i): the fill, and ref's key
template <class T>
__global__ void __launch_bounds__(kThreads) glue_scatter_fill_kernel(
    int mode, const int64_t* __restrict__ c0, int n_rows, const int64_t* __restrict__ n_valid,
    const T* __restrict__ la, int sa, int sb, float2* __restrict__ out, int64_t n_out,
    float2 fill, unsigned long long* __restrict__ key) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);  // 16-byte aligned: the wrapper's allocation
  const float4 f4 = make_float4(fill.x, fill.y, fill.x, fill.y);
  for (int64_t i = tid; i < n_out / 2; i += stride) out4[i] = f4;
  if (tid == 0 && (n_out & 1)) out[n_out - 1] = fill;
  if (mode == kTable) return;
  const int64_t n = live_count(n_valid, n_rows);
  const int64_t cells = static_cast<int64_t>(sa) * sb;
  unsigned long long best = 0;
  for (int64_t i = tid; i < n; i += stride)
    if (in_ref(mode, c0, i, cells)) best = key_max(best, order_key(__ldg(la + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = key_max(best, __shfl_xor_sync(0xFFFFFFFFu, best, off));
  if ((threadIdx.x & 31) == 0 && best != 0) atomicMax(key, best);
}

// (ii): each live row's value at its cell; block 0 writes ref
template <class T>
__global__ void __launch_bounds__(kThreads) glue_scatter_kernel(
    int mode, const int64_t* __restrict__ c0, const int64_t* __restrict__ c1, int n_rows,
    const int64_t* __restrict__ n_valid, const T* __restrict__ la, const T* __restrict__ ph,
    int sa, int sb, float2* __restrict__ out, const unsigned long long* __restrict__ key,
    T* __restrict__ ref_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (mode == kTable) {  // sa: the table's size; the sentinel row keeps the miss
    if (i >= live_count(n_valid, n_rows)) return;
    const int64_t idx = __ldg(c0 + i);
    if (idx < 0 || idx >= sa) return;
    out[idx] = make_float2(static_cast<float>(__ldg(la + i)), static_cast<float>(__ldg(ph + i)));
    return;
  }
  T ref;
  from_key(*key, &ref);
  if (i == 0) *ref_out = ref;
  if (i >= live_count(n_valid, n_rows)) return;
  int64_t pos;
  if (mode == kGrid) {
    const int64_t idx = __ldg(c0 + i);
    if (idx < 0 || idx >= static_cast<int64_t>(sa) * sb) return;
    pos = idx / sb * (sb + 1) + idx % sb;
  } else {
    const int64_t ah = __ldg(c0 + i), bh = __ldg(c1 + i);
    if (ah < 0 || ah >= sa || bh < 0 || bh >= sb) return;
    pos = ah * (sb + 1) + bh;
  }
  const T p = __ldg(ph + i);
  const float w = static_cast<float>(t_exp(__ldg(la + i) - ref));
  out[pos] = make_float2(__fmul_rn(w, static_cast<float>(t_cos(p))),
                         __fmul_rn(w, static_cast<float>(t_sin(p))));
}

// --------------------------------------------------------- C: grid_readout

template <class T>
__global__ void __launch_bounds__(kThreads) glue_readout_kernel(
    int mode, int n_rows, const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
    const T* __restrict__ q_la, const T* __restrict__ q_ph, const T* __restrict__ ref_p,
    const float2* __restrict__ num, const double* __restrict__ e_diag, int sa, int sb,
    const int32_t* __restrict__ width, const int32_t* __restrict__ cells_off, int n_cells,
    const int64_t* __restrict__ q_states, const int64_t* __restrict__ diag_yz,
    const double* __restrict__ diag_coeff, int n_diag, double* __restrict__ e_re,
    double* __restrict__ e_im) {
  __shared__ long long s_yz[kDiagChunk];
  __shared__ double s_c[kDiagChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n_rows;
  float n0 = 0.f, n1 = 0.f;  // an empty cell reads +0, as the plain zero row
  double ed = 0.0;
  bool need = false;  // an XL row outside the staircase, with diagonal terms
  if (in) {
    if (mode == kStair) {
      const int64_t ah = __ldg(c0 + i), bh = __ldg(c1 + i);
      const int64_t row = ah < sa ? ah : sa;
      const bool valid = ah < sa && bh < __ldg(width + row);
      const int64_t cell = valid ? __ldg(cells_off + row) + bh : n_cells;
      if (valid) {
        const float2 v = __ldg(num + cell);
        n0 = v.x;
        n1 = v.y;
      }
      ed = __ldg(e_diag + cell);
      need = !valid && n_diag > 0;
    } else {
      const int64_t idx = __ldg(c0 + i);
      const int64_t cells = static_cast<int64_t>(sa) * sb;
      if (mode == kRows || idx < cells) {
        const float2 v = __ldg(num + (mode == kRows ? i : idx % sb * sa + idx / sb));
        n0 = v.x;
        n1 = v.y;
      }
      ed = __ldg(e_diag + (idx < cells ? idx : cells));
    }
  }
  if (mode == kStair && __syncthreads_or(need)) {
    const long long s = need ? __ldg(q_states + i) : 0;
    double d = 0.0;
    for (int base = 0; base < n_diag; base += kDiagChunk) {
      const int m = min(kDiagChunk, n_diag - base);
      if (threadIdx.x < m) {
        s_yz[threadIdx.x] = __ldg(diag_yz + base + threadIdx.x);
        s_c[threadIdx.x] = __ldg(diag_coeff + base + threadIdx.x);
      }
      __syncthreads();
      if (need) {
        for (int k = 0; k < m; ++k) {
          const double c = s_c[k];
          d += (__popcll(static_cast<unsigned long long>(s & s_yz[k])) & 1) ? -c : c;
        }
      }
      __syncthreads();
    }
    if (need) ed = d;
  }
  if (!in) return;
  T x = *ref_p - __ldg(q_la + i);
  x = x < T(-30) ? T(-30) : (x > T(30) ? T(30) : x);  // torch.clamp: a NaN stays NaN
  const float ratio = static_cast<float>(t_exp(x));
  const T p = __ldg(q_ph + i);
  const float c = static_cast<float>(t_cos(p)), s = static_cast<float>(t_sin(p));
  const float re = __fmul_rn(ratio, __fadd_rn(__fmul_rn(n0, c), __fmul_rn(n1, s)));
  const float im = __fmul_rn(ratio, __fsub_rn(__fmul_rn(n1, c), __fmul_rn(n0, s)));
  e_re[i] = __dadd_rn(ed, static_cast<double>(re));
  e_im[i] = static_cast<double>(im);
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : b);
}

template <class T>
int scatter_launch(int mode, const void* c0, const void* c1, int n_rows, const void* n_valid,
                   const void* la, const void* ph, int sa, int sb, float miss, void* out,
                   long long n_out, void* key, void* ref, cudaStream_t s) {
  const int64_t fill_work = n_out / 2 > n_rows ? n_out / 2 : n_rows;
  const int fill_blocks = blocks_for(fill_work) < kFillBlocks ? blocks_for(fill_work)
                                                              : kFillBlocks;
  auto* k = static_cast<unsigned long long*>(key);
  if (mode != kTable) {
    const cudaError_t rc = cudaMemsetAsync(k, 0, sizeof(unsigned long long), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const float2 fill = make_float2(mode == kTable ? miss : 0.f, 0.f);
  glue_scatter_fill_kernel<T><<<fill_blocks, kThreads, 0, s>>>(
      mode, static_cast<const int64_t*>(c0), n_rows, static_cast<const int64_t*>(n_valid),
      static_cast<const T*>(la), sa, sb, static_cast<float2*>(out), n_out, fill, k);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  glue_scatter_kernel<T><<<blocks_for(n_rows), kThreads, 0, s>>>(
      mode, static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1), n_rows,
      static_cast<const int64_t*>(n_valid), static_cast<const T*>(la),
      static_cast<const T*>(ph), sa, sb, static_cast<float2*>(out), k, static_cast<T*>(ref));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int readout_launch(int mode, int n_rows, const void* c0, const void* c1, const void* q_la,
                   const void* q_ph, const void* ref, const void* num, const void* e_diag,
                   int sa, int sb, const void* width, const void* cells_off, int n_cells,
                   const void* q_states, const void* diag_yz, const void* diag_coeff,
                   int n_diag, void* e_re, void* e_im, cudaStream_t s) {
  glue_readout_kernel<T><<<blocks_for(n_rows), kThreads, 0, s>>>(
      mode, n_rows, static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const T*>(q_la), static_cast<const T*>(q_ph), static_cast<const T*>(ref),
      static_cast<const float2*>(num), static_cast<const double*>(e_diag), sa, sb,
      static_cast<const int32_t*>(width), static_cast<const int32_t*>(cells_off), n_cells,
      static_cast<const int64_t*>(q_states), static_cast<const int64_t*>(diag_yz),
      static_cast<const double*>(diag_coeff), n_diag, static_cast<double*>(e_re),
      static_cast<double*>(e_im));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states (n,) int64 -> out0 (n,) int64 rank indices; with perm_a and perm_b
// (not null), out0 = a_hat and out1 = b_hat
extern "C" int rank_index(const void* spec, int n_spec, int n_shells, int lo_bits,
                          unsigned qmask, int size, const void* states, int n,
                          const void* perm_a, const void* perm_b, int sa_full, int sb_full,
                          void* out0, void* out1, void* stream) {
  if (n_spec > kMaxSpecInts || n_shells > 16 || (perm_a != nullptr && sb_full < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(n_spec);
  glue_rank_index_kernel<<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(spec), n_spec, n_shells, lo_bits, qmask, size,
      static_cast<const int64_t*>(states), n, static_cast<const int32_t*>(perm_a),
      static_cast<const int32_t*>(perm_b), sa_full, sb_full, static_cast<int64_t*>(out0),
      static_cast<int64_t*>(out1));
  return static_cast<int>(cudaGetLastError());
}

// mode kGrid / kXl / kTable; out: n_out float2 (16-byte aligned); key: one
// 8-byte scratch word (cleared here), ref: a 0-d value of the input's type
// (unwritten for the table)
extern "C" int grid_scatter(int mode, int f64, const void* c0, const void* c1, int n_rows,
                            const void* n_valid, const void* la, const void* ph, int sa, int sb,
                            float miss, void* out, long long n_out, void* key, void* ref,
                            void* stream) {
  if (mode < kGrid || mode > kTable || (mode != kTable && sb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? scatter_launch<double>(mode, c0, c1, n_rows, n_valid, la, ph, sa, sb, miss, out,
                                      n_out, key, ref, s)
             : scatter_launch<float>(mode, c0, c1, n_rows, n_valid, la, ph, sa, sb, miss, out,
                                     n_out, key, ref, s);
}

// mode kDense / kRows / kStair; e_re, e_im (n_rows,) f64
extern "C" int grid_readout(int mode, int f64, int n_rows, const void* c0, const void* c1,
                            const void* q_la, const void* q_ph, const void* ref, const void* num,
                            const void* e_diag, int sa, int sb, const void* width,
                            const void* cells_off, int n_cells, const void* q_states,
                            const void* diag_yz, const void* diag_coeff, int n_diag,
                            void* e_re, void* e_im, void* stream) {
  if (mode < kDense || mode > kStair || (mode == kDense && sb < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? readout_launch<double>(mode, n_rows, c0, c1, q_la, q_ph, ref, num, e_diag, sa, sb,
                                      width, cells_off, n_cells, q_states, diag_yz, diag_coeff,
                                      n_diag, e_re, e_im, s)
             : readout_launch<float>(mode, n_rows, c0, c1, q_la, q_ph, ref, num, e_diag, sa, sb,
                                     width, cells_off, n_cells, q_states, diag_yz, diag_coeff,
                                     n_diag, e_re, e_im, s);
}

extern "C" const char* grid_glue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
