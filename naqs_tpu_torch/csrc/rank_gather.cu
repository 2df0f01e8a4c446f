// The rank engine's psi lookup for sm_90a: four kernels on one device core.
//
// Replaces the TPU kernel naqs_tpu/ops/dyn_gather.py::table_gather2
// (_gather2_kernel; pl.pallas_call at :106) together with the rank_index that
// fed it and, for rank_ratio_rowsum, the ratio/row-sum epilogue that followed
// it (naqs_tpu/ops/local_energy.py::_local_energy_chunk). For chunk states
// s (C,), flip masks xy (K,), x = s[c] ^ xy[k] and tab the packed (size+1, 2)
// f32 value table of ops/rank.py::build_value_table (log_amp, phase):
//
//   rank_gather2:      (out_la[c, k], out_ph[c, k]) = tab[rank(x)]
//   rank_ratio_rowsum: e_re[c] + i e_im[c] = sum_k h[c, k] * r[c, k], with
//                      r = la' > -1e29 ? exp(clamp(la' - my_la[c], -30, 30))
//                                        * (cos, sin)(ph' - my_ph[c]) : 0
//
// rank() is the colex rank of ops/rank.py; states outside every sector map
// to the sentinel row `size`, which holds the miss marker.
//
// rank_local_energy and rank_quadratic_energy are row_energy_kernel
// (csrc/row_energy.cuh) with RankLookup below: a whole local_energy call of
// the rank engine, with a dense A or without (replacing the chunk loop of the
// diagonal, the H row and rank_ratio_rowsum; JAX: naqs_tpu/ops/
// local_energy.py:216-247 with _offdiag_h :199-213 and diagonal_energy :164),
// and a whole quadratic_energy call (replacing the chunk loop of
// rank_gather2, the H row and the eager epilogue; JAX: :330-381). The two
// chunk kernels above run on no path.
// What bounded them: the table reads. A coupled state of a live row with terms
// is tested against the sectors by two popcounts (most leave them) before any
// rank arithmetic; each one inside a sector read its 8-byte table row, at
// random: at 32 qubits the table (19 M rows, 153 MB) is larger than the
// 50 MB L2, so those reads came from HBM (frozen-core N2 6-31G: 101 M reads
// a call for 2.47 M found states). Now a state inside a sector is first
// probed in the block's filter of the table's live keys (csrc/row_energy.cuh):
// only its hits, the found states and ~1% of the rest, are ranked and read,
// so what bounds them is the sector test and the probe, integer operations
// on every pair. A table of more than 262,144 rows (exact mode's full-sector
// tables) takes the unfiltered kernel: every state inside a sector reads its
// row, as before.
//
// The two chunk kernels' bound: bytes. At the main path's chunk (C = 512,
// K = 4,608, H2O 6-31G) rank_gather2 must write 18.9 MB of outputs and read
// each touched table row (8 B) once, about 20.5 MB; rank_ratio_rowsum must read h
// (9.4 MB) and the touched rows and write 8 B per row, about 11.1 MB. The
// table (13.3 MB) stays resident in the 50 MB L2. The rank arithmetic is a
// few dozen integer operations per element, under the byte time.
//
// Design:
// * No per-element loop, division or modulo: the rank is csrc/rank.cuh's
//   (spin words compacted by mask/shift steps, colex by two shared-memory
//   lookups, one 16-byte record per n_alpha). Compaction commutes with xor,
//   so it runs once per state and once per flip mask; per element, x's words
//   are one xor of the two.
// * One 8-byte load (float2) reads both channels of a table row.
// * rank_gather2: a persistent grid, sized to what the card keeps resident,
//   walks tiles of kTileRows rows x 256 columns. A thread owns one column of
//   a tile: its flip mask is loaded once per tile, the tile's states once
//   (compacted into shared memory), and a warp stores 128 contiguous bytes
//   per channel and row, with an evict-first hint so the outputs do not push
//   the table out of L2. The spec tables are staged in shared memory once
//   per block.
// * rank_ratio_rowsum: a block owns kRowsPerBlock whole rows, so nothing of
//   size (C, K) reaches device memory and each row's sum has a fixed order
//   (columns in order per thread, a warp-shuffle tree, then the warps in
//   order through shared memory): no atomics, the same result every run.
//   h is read once, coalesced, with an evict-first hint; kUnroll columns'
//   loads are issued before their arithmetic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/dyn_gather.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "rank.cuh"
#include "row_energy.cuh"

namespace {

// Tile shapes, chosen by timing variants on the card (PERF.md).
constexpr int kThreads = 256;    // threads per block of rank_gather2
constexpr int kTileRows = 4;     // rank_gather2 tile: kTileRows x kThreads
constexpr int kRowsPerBlock = 1; // rank_ratio_rowsum: rows a block owns,
constexpr int kUnroll = 8;       // columns in flight per thread,
constexpr int kRrThreads = 256;  // threads per block
constexpr int kRrWarps = kRrThreads / 32;
constexpr float kMiss = -1.0e30f;
constexpr float kMissThreshold = -1.0e29f;

// (log_amp, phase): the table row of the state whose spin words are w, in one
// 8-byte load
__device__ __forceinline__ float2 lookup(const Spec& sp, const float2* __restrict__ tab,
                                         uint32_t w) {
  return __ldg(tab + rank_of(sp, w));
}

__global__ void __launch_bounds__(kThreads) rank_gather2_kernel(
    const int64_t* __restrict__ s, int n_rows, const int64_t* __restrict__ xy,
    int n_cols, const int32_t* __restrict__ spec, int n_spec, int n_shells,
    int lo_bits, uint32_t qmask, int size, const float2* __restrict__ tab,
    float* __restrict__ out_la, float* __restrict__ out_ph, int n_col_tiles,
    int n_tiles) {
  extern __shared__ int4 sh_spec[];
  __shared__ uint32_t row_w[kTileRows];
  const Spec sp = stage_spec(sh_spec, spec, n_spec, n_shells, lo_bits, size);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int rt = t / n_col_tiles;  // once per tile, not per element
    const int c0 = rt * kTileRows;
    const int k = (t - rt * n_col_tiles) * kThreads + threadIdx.x;
    if (threadIdx.x < kTileRows) {
      const int c = c0 + threadIdx.x;
      row_w[threadIdx.x] = c < n_rows ? spin_words(s[c], qmask) : 0u;
    }
    __syncthreads();
    if (k < n_cols) {
      const uint32_t cw = spin_words(xy[k], qmask);
      const size_t base = static_cast<size_t>(c0) * n_cols + k;
      const int n = min(kTileRows, n_rows - c0);
      if (n == kTileRows) {
        float2 v[kTileRows];
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) v[r] = lookup(sp, tab, row_w[r] ^ cw);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          __stcs(out_la + base + static_cast<size_t>(r) * n_cols, v[r].x);
          __stcs(out_ph + base + static_cast<size_t>(r) * n_cols, v[r].y);
        }
      } else {
        for (int r = 0; r < n; ++r) {
          const float2 v = lookup(sp, tab, row_w[r] ^ cw);
          __stcs(out_la + base + static_cast<size_t>(r) * n_cols, v.x);
          __stcs(out_ph + base + static_cast<size_t>(r) * n_cols, v.y);
        }
      }
    }
    __syncthreads();  // row_w is rewritten by the next tile
  }
}

__global__ void __launch_bounds__(kRrThreads) rank_ratio_rowsum_kernel(
    const int64_t* __restrict__ s, int n_rows, const int64_t* __restrict__ xy,
    int n_cols, const int32_t* __restrict__ spec, int n_spec, int n_shells,
    int lo_bits, uint32_t qmask, int size, const float2* __restrict__ tab,
    const float* __restrict__ my_la, const float* __restrict__ my_ph,
    const float* __restrict__ h, float* __restrict__ e_re,
    float* __restrict__ e_im) {
  extern __shared__ int4 sh_spec[];
  __shared__ float partial[2 * kRowsPerBlock][kRrWarps];
  const Spec sp = stage_spec(sh_spec, spec, n_spec, n_shells, lo_bits, size);
  const int c0 = blockIdx.x * kRowsPerBlock;

  bool live[kRowsPerBlock];
  uint32_t rw[kRowsPerBlock];
  float la0[kRowsPerBlock], ph0[kRowsPerBlock];
  const float* h_row[kRowsPerBlock];
  float acc_re[kRowsPerBlock], acc_im[kRowsPerBlock];
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    const int c = c0 + r;
    live[r] = c < n_rows;
    rw[r] = live[r] ? spin_words(s[c], qmask) : 0u;
    la0[r] = live[r] ? my_la[c] : 0.f;
    ph0[r] = live[r] ? my_ph[c] : 0.f;
    h_row[r] = h + static_cast<size_t>(live[r] ? c : 0) * n_cols;
    acc_re[r] = 0.f;
    acc_im[r] = 0.f;
  }

  for (int k0 = threadIdx.x; k0 < n_cols; k0 += kRrThreads * kUnroll) {
    // issue every load of kUnroll columns before the arithmetic
    float2 v[kUnroll][kRowsPerBlock];
    float hv[kUnroll][kRowsPerBlock];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kRrThreads;
      const bool in = k < n_cols;
      const uint32_t cw = in ? spin_words(xy[k], qmask) : 0u;
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        const bool ok = in && live[r];
        v[u][r] = ok ? lookup(sp, tab, rw[r] ^ cw) : make_float2(kMiss, 0.f);
        hv[u][r] = ok ? __ldcs(h_row[r] + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        if (v[u][r].x > kMissThreshold) {
          const float mag = expf(fminf(fmaxf(v[u][r].x - la0[r], -30.f), 30.f));
          float sn, cs;
          sincosf(v[u][r].y - ph0[r], &sn, &cs);
          acc_re[r] += hv[u][r] * (mag * cs);
          acc_im[r] += hv[u][r] * (mag * sn);
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_re[r] += __shfl_xor_sync(0xFFFFFFFFu, acc_re[r], off);
      acc_im[r] += __shfl_xor_sync(0xFFFFFFFFu, acc_im[r], off);
    }
    if (lane == 0) {
      partial[2 * r][warp] = acc_re[r];
      partial[2 * r + 1][warp] = acc_im[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kRowsPerBlock) {
    const int q = threadIdx.x;
    const int c = c0 + q / 2;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRrWarps; ++w) sum += partial[q][w];
    if (c < n_rows) (q & 1 ? e_im : e_re)[c] = sum;
  }
}

// rank_gather2 blocks the card keeps resident at once, with the largest spec
// table (16 shells) in shared memory: asked once per process, as the launch
// sizes its persistent grid from it (the grid's size changes no result)
int resident_blocks() {
  constexpr size_t kMaxSpecBytes =
      sizeof(int32_t) * (4 * (16 + 1) + (1 << 8) + (1 << 8) * (8 + 1));
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_gather2_kernel, kThreads,
                                                kMaxSpecBytes);
  return per_sm * n_sm > 0 ? per_sm * n_sm : 1;
}


// ------------------------------------------------ the one-launch kernels' lookup

// the largest spec table (16 shells), in int32s
constexpr int kMaxSpecInts = 4 * (16 + 1) + (1 << 8) + (1 << 8) * (8 + 1);

// row_energy_kernel's lookup in the dense rank table (csrc/row_energy.cuh).
// A coupled state's sector is tested by two popcounts of its packed bits
// first (screen); then, where the body keeps a filter of the live keys, its
// probe; only a state that passes both is ranked and its table row read (one
// 8-byte load), and it is found where the row's log-amp is above
// found_above (the table's miss marker lies at or below it). The filter's
// keys are the table's own states (their low 2S bits, as the rank reads
// them), so it passes every state the table finds.
struct RankLookup {
  struct Table {
    const int64_t* states;  // the states the table was built from: the filter's keys
    const int32_t* spec;
    int n_spec, n_shells, lo_bits;
    uint32_t qmask;
    int size;
    const float2* tab;
    float found_above;
  };
  struct Shared {
    int4 spec[(kMaxSpecInts + 3) / 4];
  };
  static constexpr int kSpareBytes = 0;
  static constexpr int kPlainSpareBytes = 0;
  Spec sp;
  const float2* tab;
  uint32_t qmask;
  float found_above;

  __device__ void init(Shared& sh, const Table& t, int64_t, void*, int) {
    sp = stage_spec(sh.spec, t.spec, t.n_spec, t.n_shells, t.lo_bits, t.size);
    tab = t.tab;
    qmask = t.qmask;
    found_above = t.found_above;
  }
  __device__ bool empty() const { return false; }
  __device__ uint64_t key(int64_t q) const {
    return static_cast<uint32_t>(static_cast<uint64_t>(q)) & qmask;
  }
  // q lies in a sector (r.z == -1: no sector with its n_alpha)
  __device__ bool screen(int64_t q) const {
    const uint32_t x = static_cast<uint32_t>(static_cast<uint64_t>(q)) & qmask;
    return sp.sect[__popc(x & 0x55555555u)].z == __popc(x & 0xAAAAAAAAu);
  }
  template <int kQ>
  __device__ void find(const int64_t (&q)[kQ], const bool (&want)[kQ], bool (&found)[kQ],
                       float2 (&v)[kQ]) const {
    bool in[kQ];
    int idx[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const uint32_t x = static_cast<uint32_t>(static_cast<uint64_t>(q[u])) & qmask;
      in[u] = false;
      idx[u] = 0;
      if (want[u]) {
        const int4 r = sp.sect[__popc(x & 0x55555555u)];
        if (r.z == __popc(x & 0xAAAAAAAAu)) {  // r.z == -1: no sector with this n_alpha
          const uint32_t w = even_bits(x) | (even_bits(x >> 1) << 16);
          idx[u] = r.x + colex(sp, w & 0xFFFFu) * r.y + colex(sp, w >> 16);
          in[u] = true;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u) v[u] = in[u] ? __ldg(tab + idx[u]) : make_float2(kMiss, 0.f);
#pragma unroll
    for (int u = 0; u < kQ; ++u) found[u] = in[u] && v[u].x > found_above;
  }
};

int row_energy_launch(bool quadratic, const void* spec, int n_spec, int n_shells,
                      int lo_bits, unsigned qmask, int size, const void* tab, float found_above,
                      const void* states, const row_energy::Rows& a, void* stream) {
  if (n_spec > kMaxSpecInts || n_shells > 16) return static_cast<int>(cudaErrorInvalidValue);
  const RankLookup::Table t = {static_cast<const int64_t*>(states),
                               static_cast<const int32_t*>(spec), n_spec, n_shells, lo_bits,
                               qmask, size, static_cast<const float2*>(tab), found_above};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quadratic ? row_energy::launch<RankLookup, row_energy::Quadratic>(a, t, s)
                   : row_energy::launch<RankLookup, row_energy::LocalEnergy>(a, t, s);
}

}  // namespace

extern "C" int rank_gather2(const void* s, int n_rows, const void* xy, int n_cols,
                            const void* spec, int n_spec, int n_shells, int lo_bits,
                            unsigned qmask, int size, const void* tab, void* out_la,
                            void* out_ph, void* stream) {
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(n_spec);
  const int n_col_tiles = (n_cols + kThreads - 1) / kThreads;
  const int n_tiles = n_col_tiles * ((n_rows + kTileRows - 1) / kTileRows);
  // as many blocks as stay resident, each walking the same number of tiles
  static const int max_blocks = resident_blocks();
  const int rounds = (n_tiles + max_blocks - 1) / max_blocks;
  const int grid = (n_tiles + rounds - 1) / rounds;
  rank_gather2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), n_rows, static_cast<const int64_t*>(xy), n_cols,
      static_cast<const int32_t*>(spec), n_spec, n_shells, lo_bits, qmask, size,
      static_cast<const float2*>(tab), static_cast<float*>(out_la),
      static_cast<float*>(out_ph), n_col_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rank_ratio_rowsum(const void* s, int n_rows, const void* xy, int n_cols,
                                 const void* spec, int n_spec, int n_shells,
                                 int lo_bits, unsigned qmask, int size, const void* tab,
                                 const void* my_la, const void* my_ph, const void* h,
                                 void* e_re, void* e_im, void* stream) {
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(n_spec);
  const int grid = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rank_ratio_rowsum_kernel<<<grid, kRrThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(s), n_rows, static_cast<const int64_t*>(xy), n_cols,
      static_cast<const int32_t*>(spec), n_spec, n_shells, lo_bits, qmask, size,
      static_cast<const float2*>(tab), static_cast<const float*>(my_la),
      static_cast<const float*>(my_ph), static_cast<const float*>(h),
      static_cast<float*>(e_re), static_cast<float*>(e_im));
  return static_cast<int>(cudaGetLastError());
}

// states (n_states,) and n_valid: what the table was built from (its first
// n_valid states), the filter's keys
extern "C" int rank_local_energy(const void* spec, int n_spec, int n_shells, int lo_bits,
                                 unsigned qmask, int size, const void* tab,
                                 const void* states, int n_states, const void* n_valid,
                                 const void* q_states, int n_rows, const void* q_la,
                                 const void* q_ph, const void* xy, const void* xy_ptr,
                                 int n_cols, const void* term_yz, const void* yz_unique,
                                 const void* term_coeff, const void* diag_yz,
                                 const void* diag_coeff, int n_diag, void* e_re, void* e_im,
                                 void* stream) {
  const row_energy::Rows a = row_energy::make_rows(
      n_valid, n_states, q_states, n_rows, q_la, q_ph, xy, xy_ptr, n_cols, term_yz, yz_unique,
      term_coeff, diag_yz, diag_coeff, n_diag, e_re, e_im);
  return row_energy_launch(false, spec, n_spec, n_shells, lo_bits, qmask, size, tab,
                           kMissThreshold, states, a, stream);
}

// quad_miss: the log-amp the table holds for a miss (quadratic_energy's -200);
// a coupled state at or below it would add exactly 0 and counts as a miss
extern "C" int rank_quadratic_energy(const void* spec, int n_spec, int n_shells, int lo_bits,
                                     unsigned qmask, int size, const void* tab,
                                     float quad_miss, const void* n_valid,
                                     const void* states, int n_rows, const void* la,
                                     const void* ph, const void* xy, const void* xy_ptr,
                                     int n_cols, const void* term_yz, const void* yz_unique,
                                     const void* term_coeff, const void* diag_yz,
                                     const void* diag_coeff, int n_diag, void* num, void* w,
                                     void* stream) {
  const row_energy::Rows a = row_energy::make_rows(
      n_valid, n_rows, states, n_rows, la, ph, xy, xy_ptr, n_cols, term_yz, yz_unique,
      term_coeff, diag_yz, diag_coeff, n_diag, num, w);
  return row_energy_launch(true, spec, n_spec, n_shells, lo_bits, qmask, size, tab, quad_miss,
                           states, a, stream);
}

extern "C" const char* rank_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
