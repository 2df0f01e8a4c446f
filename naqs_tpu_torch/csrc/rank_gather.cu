// rank_gather2: fused combinadic rank + two-channel table gather, sm_90a.
//
// Replaces the TPU kernel naqs_tpu/ops/dyn_gather.py::table_gather2
// (_gather2_kernel) together with the rank_index that fed it
// (naqs_tpu/ops/local_energy.py::_local_energy_chunk). For chunk states
// s (C,) and flip masks xy (K,) it writes
//
//     out_la[c, k] = la_tab[rank(s[c] ^ xy[k])],  out_ph likewise,
//
// where rank() is the colex rank of ops/rank.py and invalid states map to
// the sentinel slot `size` (which holds the miss marker).
//
// What bounds it: the (C, K) outputs, 8 B per element, written once; the
// table reads are random 4 B loads, but the tables (2 x 4 B x (size+1),
// 13.3 MB for H2O 6-31G) stay resident in the 50 MB L2. The integer rank
// arithmetic is O(n_shells) per element and far under the card's rate.
// Design: one thread per (c, k), so the (C, K) index array of the TPU
// version never reaches device memory; the binomial and sector tables
// (at most 16 x 18 + 3 x 18 ints) are staged in shared memory once per
// block; the grid strides over the flat (C, K) range so neighbouring threads
// write neighbouring outputs. No tile sweep: Hopper loads per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/dyn_gather.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rank_gather2_kernel(
    const int64_t* __restrict__ s, int64_t n_rows,
    const int64_t* __restrict__ xy, int64_t n_cols,
    const int32_t* __restrict__ spec, int n_shells, int32_t size,
    const float* __restrict__ la_tab, const float* __restrict__ ph_tab,
    float* __restrict__ out_la, float* __restrict__ out_ph) {
  // spec layout: binom (S, S+2) row-major, then offset, stride, expected_nb
  // (S+2 each), as built by ops/rank.py::spec_arrays
  extern __shared__ int32_t sh[];
  const int w = n_shells + 2;
  const int n_spec = n_shells * w + 3 * w;
  for (int i = threadIdx.x; i < n_spec; i += blockDim.x) sh[i] = spec[i];
  __syncthreads();
  const int32_t* binom = sh;
  const int32_t* offset = sh + n_shells * w;
  const int32_t* stride = offset + w;
  const int32_t* exp_nb = stride + w;

  const int64_t total = n_rows * n_cols;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t c = e / n_cols;
    const int64_t k = e - c * n_cols;
    const uint64_t x = (uint64_t)(s[c] ^ xy[k]);
    int ca = 0, cb = 0, ra = 0, rb = 0;
    for (int j = 0; j < n_shells; ++j) {
      const int ba = (int)((x >> (2 * j)) & 1u);
      const int bb = (int)((x >> (2 * j + 1)) & 1u);
      ca += ba;
      cb += bb;
      ra += ba * binom[j * w + ca];
      rb += bb * binom[j * w + cb];
    }
    const int nb = exp_nb[ca];
    const int32_t idx =
        (nb >= 0 && nb == cb) ? offset[ca] + ra * stride[ca] + rb : size;
    out_la[e] = la_tab[idx];
    out_ph[e] = ph_tab[idx];
  }
}

}  // namespace

extern "C" int rank_gather2(const void* s, int64_t n_rows, const void* xy,
                            int64_t n_cols, const void* spec, int n_shells,
                            int size, const void* la_tab, const void* ph_tab,
                            void* out_la, void* out_ph, int n_blocks,
                            void* stream) {
  const int threads = 256;
  const size_t smem = sizeof(int32_t) * (size_t)(n_shells + 2) * (n_shells + 3);
  rank_gather2_kernel<<<n_blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)s, n_rows, (const int64_t*)xy, n_cols,
      (const int32_t*)spec, n_shells, (int32_t)size, (const float*)la_tab,
      (const float*)ph_tab, (float*)out_la, (float*)out_ph);
  return (int)cudaGetLastError();
}

extern "C" const char* rank_gather2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
