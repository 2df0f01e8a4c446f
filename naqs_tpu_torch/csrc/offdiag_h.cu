// The off-diagonal H row for sm_90a, summed term by term per flip mask.
//
// Replaces the per-term segment-sum branch of naqs_tpu/ops/local_energy.py::
// _offdiag_h (:209-213), which the JAX package takes where a dense (Kyz, Kxy)
// coupling matrix A would be too large (over 2^26 entries: N2 6-31G's would
// hold 736 M): a (C, Kyz) parity matrix, a (C, K) gather of it times the
// coefficients, and a segment sum into the Kxy flip-mask groups. Here, for
// chunk states s (C,) and the terms grouped by flip mask as CSR (terms
// xy_ptr[g] .. xy_ptr[g+1] - 1 of group g, each a sign mask yz_unique[
// term_yz[k]] and an f32 coefficient):
//
//   h[c, g] = sum_k term_coeff[k] * (-1)^popcount(s[c] & yz_unique[term_yz[k]])
//
// summed over a group's terms in index order. No parity matrix and no (C, K)
// product reach device memory, and no atomics touch a sum, so every run gives
// the same bits. Each product is exact (the coefficient with its sign bit
// flipped), so only the order of the adds differs from the plain segment sum.
//
// What bounds it: bytes. At the N2 6-31G chunk (C = 128, Kxy = 27,392 padded,
// K = 137,872 terms) it must write h, 14.0 MB, against 17.6 M popcount-and-adds.
//
// Design (a first, simple kernel): a block owns 256 consecutive groups and
// kRows chunk rows (their states in shared memory); a thread walks its group's
// terms once, loading each term's mask and coefficient once for all kRows rows,
// and writes its kRows sums, a warp 128 contiguous bytes of each output row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/offdiag_h.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // groups a block owns, one a thread
constexpr int kRows = 16;      // chunk rows a block owns

__global__ void __launch_bounds__(kThreads) offdiag_h_terms_kernel(
    const int64_t* __restrict__ s, int n_rows, const int64_t* __restrict__ yz_unique,
    const int32_t* __restrict__ xy_ptr, int n_groups, const int32_t* __restrict__ term_yz,
    const float* __restrict__ term_coeff, float* __restrict__ h) {
  __shared__ uint64_t rows[kRows];
  const int c0 = blockIdx.y * kRows;
  if (threadIdx.x < kRows) {
    const int c = c0 + threadIdx.x;
    rows[threadIdx.x] = c < n_rows ? static_cast<uint64_t>(s[c]) : 0u;
  }
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const int end = __ldg(xy_ptr + g + 1);
  for (int k = __ldg(xy_ptr + g); k < end; ++k) {
    const uint64_t yz = static_cast<uint64_t>(__ldg(yz_unique + __ldg(term_yz + k)));
    const uint32_t coeff = __float_as_uint(__ldg(term_coeff + k));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t sign = static_cast<uint32_t>(__popcll(rows[r] & yz) & 1) << 31;
      acc[r] += __uint_as_float(coeff ^ sign);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (c0 + r < n_rows) h[static_cast<size_t>(c0 + r) * n_groups + g] = acc[r];
  }
}

}  // namespace

extern "C" int offdiag_h_terms(const void* s, int n_rows, const void* yz_unique,
                               const void* xy_ptr, int n_groups, const void* term_yz,
                               const void* term_coeff, void* h, void* stream) {
  const dim3 grid((n_groups + kThreads - 1) / kThreads, (n_rows + kRows - 1) / kRows);
  offdiag_h_terms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), n_rows, static_cast<const int64_t*>(yz_unique),
      static_cast<const int32_t*>(xy_ptr), n_groups, static_cast<const int32_t*>(term_yz),
      static_cast<const float*>(term_coeff), static_cast<float*>(h));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* offdiag_h_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
