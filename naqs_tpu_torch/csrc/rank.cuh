// The colex rank of ops/rank.py in device code, for sm_90a: shared by the
// rank engine's kernels (csrc/rank_gather.cu) and the grid engines' glue
// (csrc/grid_glue.cu). rank_of gives, for the spin words of a packed state,
// its row of the dense rank-indexed table, or `size` for a state outside
// every sector: rank_index's integer, from the tables of
// ops/rank.py::spec_table.
//
// No per-bit loop, division or modulo: alpha (even) and beta (odd) bits are
// compacted into S-bit words with mask/shift steps (S <= 16 shells), and
// colex(w) is two lookups in a small shared-memory table: lo[w & (2^L - 1)]
// + hi[w >> L][popc(low)]. One 16-byte record per n_alpha (offset, stride,
// expected n_beta) decides the sector.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Spec table (int32), built by ops/rank.py::spec_table:
//   sect[S + 1] int4: per n_alpha (offset, stride, expected n_beta or -1, 0)
//   lo[2^L]:          colex rank of the low L bits of a spin word
//   hi[2^(S-L)][L+1]: colex rank of its high bits, given popc of the low bits
struct Spec {
  const int4* sect;
  const int32_t* lo;
  const int32_t* hi;
  uint32_t lo_mask;
  int lo_bits;
  int size;
};

// the block copies the spec table into shared memory `sh` (every thread
// takes part: it syncs)
__device__ __forceinline__ Spec stage_spec(int4* sh, const int32_t* __restrict__ spec,
                                           int n_spec, int n_shells, int lo_bits,
                                           int size) {
  int32_t* dst = reinterpret_cast<int32_t*>(sh);
  for (int i = threadIdx.x; i < n_spec; i += blockDim.x) dst[i] = spec[i];
  __syncthreads();
  Spec sp;
  sp.sect = sh;
  sp.lo = dst + 4 * (n_shells + 1);
  sp.hi = sp.lo + (1 << lo_bits);
  sp.lo_mask = (1u << lo_bits) - 1u;
  sp.lo_bits = lo_bits;
  sp.size = size;
  return sp;
}

// the even bits of x, packed into the low 16 bits
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

// alpha word | beta word << 16 of the low 2S bits (qmask) of a packed state
__device__ __forceinline__ uint32_t spin_words(int64_t state, uint32_t qmask) {
  const uint32_t x = static_cast<uint32_t>(static_cast<uint64_t>(state)) & qmask;
  return even_bits(x) | (even_bits(x >> 1) << 16);
}

__device__ __forceinline__ int colex(const Spec& sp, uint32_t w) {
  const uint32_t low = w & sp.lo_mask;
  return sp.lo[low] + sp.hi[(w >> sp.lo_bits) * (sp.lo_bits + 1) + __popc(low)];
}

// dense-table row of the state whose spin words are w
__device__ __forceinline__ int rank_of(const Spec& sp, uint32_t w) {
  const uint32_t a = w & 0xFFFFu;
  const uint32_t b = w >> 16;
  const int4 r = sp.sect[__popc(a)];
  if (r.z != __popc(b)) return sp.size;  // r.z == -1: no sector with this n_alpha
  return r.x + colex(sp, a) * r.y + colex(sp, b);
}

}  // namespace
