// The grid E_loc engines' accumulation for sm_90a: three kernels in one source.
//
// They replace the term-chunk scans of naqs_tpu/ops/dense_engine.py
// (factored_local_energy :507-522 with the alpha gather and transpose of
// :496-497, dense_local_energy :279-289 with :270-271) and the two stages per
// alpha-flip group of factored_xl_local_energy (:877-928). Those have no
// Pallas counterpart: the JAX package left them to XLA. For every cell
// (rb, ra) of the (Sb, Sa) sector grid
//
//   out[rb, ra, :] = sum_k H_k(rb, ra) * T_k(rb, ra, :)
//   T_k(rb, ra, :) = grid[pa_idx[ka, ra], pb, :],  row_map[k, rb] = ka*(Sb+1) + pb
//
// where grid is the (Sa+1, Sb+1, 2) f32 table of psi / max|psi| with a zero
// pad row and column (an invalid alpha image reads row Sa, an invalid beta
// image column Sb, so both read psi = 0), and
//
//   factored_grid_accumulate: H_k = sum_{r < n_fact[k]} fcoeff[k, r]
//                                   * par_b[fb_idx[k, r], rb] * par_a[fa_idx[k, r], ra]
//   dense_grid_accumulate:    H_k = h_dense[k, rb, ra]
//
// Neither H as a (Kxy, Sb, Sa) tensor (29.9 GB for H2O 6-31G), nor the
// alpha-permuted copy R1t (Ka, Sb+1, Sa, 2) that the JAX code materialises
// (6.15 GB there), nor the (KC, Sb, Sa, 2) chunk gather reaches device
// memory: T is read straight from the grid, which is 13.3 MB for H2O 6-31G
// and stays in the 50 MB L2. The kernels take the grid transposed,
// (Sb+1, Sa+1, 2): a block works on one rb, so all its reads for one mask
// fall into one row of Sa+1 cells, each cell of which is read at most once.
//
// What bounds them: the factored kernel, operations (for H2O 6-31G 14.1 G
// multiply-adds on the valid (mask, cell) pairs against tables that fit L2);
// the dense kernel, bytes (h_dense is read once from device memory).
//
// xl_grid_accumulate does the factored kernel's sum on the staircase of an
// n_exc_max-filtered sector (ops/dense_engine.py::FactorTermsXL): alpha and
// beta combinations in (excitations, colex) order, the cells (ra, rb) with
// rb < width[ra] written packed at cells_off[ra] + rb, the grid that of the
// restricted rectangle. On Li2O STO-3G CISDTQ it is bound by operations too
// (3.73 G multiply-adds for 644,365 cells: 0.150 ms, against 0.032 ms for
// the 108 MB it must move), but its grid, (5,056, 5,056, 2) f32 = 204.5 MB,
// no longer fits L2; the valid pairs read 9.9 M of its 25.6 M cells.
// The staircase is skewed: 2,450 of its 5,055 beta columns hold one cell
// and 1,960 hold 57, so a block per column (the factored kernel's layout)
// would build a program of 3,115 masks for one cell and leave most lanes
// idle. Since exc_a + exc_b <= E, every cell has exc_b <= E / 2 or
// exc_a < E - E / 2: the wrapper's tile table (FactorTermsXL.tiles) runs the
// columns of at most E / 2 beta excitations as the factored kernel does (a
// program per column, the threads over its >= 645 alpha rows, reading the
// transposed grid), and the rest as rows (a program per alpha row, the
// threads over its >= 1,960 beta columns, reading the grid as it is): 820
// column and 175 row blocks of at most 672 cells, no program for fewer than
// 630 cells. Both orientations walk the factored kernel's program
// (accumulate_program below, one device function): masks in index order,
// the sign by popcount, the sums in registers in a fixed order, no atomics.
//
// Design, both kernels:
// * A block works on one rb and a tile of ra, neighbouring threads on
//   neighbouring ra: pa_idx rows and h_dense rows are read coalesced, and
//   row_map[k, rb], the factor list of mask k and par_b[., rb] are the same
//   for the whole block.
// * What is zero is skipped: a mask with an invalid beta image (the whole
//   block skips it), padded masks and padded factor slots (the factor list
//   ends at n_fact[k]) and, in the factored kernel, a mask for which no lane
//   of a warp has a valid alpha image; there a lane with an invalid alpha
//   image in a warp that goes on reads the grid's zero pad cell. The dense
//   kernel skips per lane. No result depends on what was skipped.
// * Each thread sums its cells' masks in index order and each mask's factors
//   in slot order, in fp32 registers; the dense kernel then adds its mask
//   ranges' partial sums in range order. No atomic touches a sum, so every
//   run gives the same bits.
//
// factored_grid_accumulate (chosen by timing variants on the card, PERF.md:
// the factor loop took most of a first design's time, and its cost was the
// count of load and shuffle instructions per factor, not bytes or latency):
// * The sign par_a[fa, ra] = (-1)^popc(alpha_words[ra] & ya_words[fa]) is
//   computed from the cell's alpha word, which sits in a register, and the
//   factor's sign mask: no load of par_a. A factor costs an and, a popc, a
//   shift, an xor into the coefficient's sign bit and an add.
// * The block writes a tile of 32 masks as a program into shared memory:
//   warp 0 looks the masks up (lane j: the beta image of rb under mask
//   k0 + j by one division, its factor count; a ballot and a prefix sum lay
//   the valid masks out), then the warps expand the factor lists, one mask
//   each, into (sign mask, fcoeff * par_b[fb, rb]) pairs. Every thread then
//   walks the program; one 16-byte shared-memory load brings two factors to
//   a whole warp. An odd list is padded with a (0, +0.0) pair.
// * A thread owns kCells cells, ra apart by the block's width: the program,
//   its loads and the mask walk are shared by kCells times more cells, and
//   the cells' loads of pa_idx and T are independent and in flight together.
//
// dense_grid_accumulate (one block per rb walking all masks would give N2
// STO-3G 120 blocks, each waiting on one chain of loads per mask):
// * The mask axis is cut into n_ranges contiguous ranges (the wrapper takes
//   the JAX package's term chunks, 256 masks), one block per (range, rb,
//   tile of ra): 960 blocks for N2 STO-3G.
// * Each warp streams its cells' h_dense values and alpha images into a
//   two-stage ring in shared memory with 4-byte cp.async, one stage per 32
//   masks: lane j looks up mask k0 + j, a ballot lists the masks with a valid
//   beta image, and every lane copies its own cell of each listed mask
//   (h_dense with an L2 evict-first hint: it is read once). While one stage
//   lands, the warp sums the other and the row_map lookup of the stage after
//   is in flight; each lane reads back only what it copied itself, so the
//   ring needs no __syncthreads. A lane with an invalid alpha image skips the
//   grid load and the multiply-add.
// * Each block writes its range's (Sa tile) partial sums to a scratch
//   (n_ranges, Sb, Sa, 2) tensor; the last block of each (rb, tile) to arrive
//   (a __threadfence, then an atomicAdd on its arrival counter) adds the
//   partials in range order 0 .. n_ranges-1, writes out and sets the counter
//   back to 0, so the counters need no clearing launch.
// * Timed against variants on the card (PERF.md): batching a lane's grid
//   loads, copying h_dense in 16-byte pieces, loading the alpha images with
//   __ldg instead of staging them, or ordering the blocks range-major gained
//   at most 5%, or lost.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Plain C interface, bound with ctypes by naqs_tpu_torch/ops/grid_kernels.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Threads per block: a row of sa cells is cut into the fewest tiles of at most
// max_threads threads with `cells` cells each, every tile a whole number of
// warps (1,287 cells: 6 tiles of 224 threads, or 2 of 224 with 3 cells each).
int block_threads(int sa, int cells, int max_threads = kMaxThreads) {
  const int tiles = (sa + max_threads * cells - 1) / (max_threads * cells);
  const int per = (sa + tiles * cells - 1) / (tiles * cells);
  return ((per + 31) / 32) * 32;
}

constexpr int kCells = 3;   // cells a thread of the factored and XL kernels owns
constexpr int kTile = 32;   // masks per shared-memory program: one per lane of warp 0

// coefficient with its sign flipped where the word has odd parity
__device__ __forceinline__ float signed_by_parity(int coeff_bits, int word) {
  return __int_as_float(coeff_bits ^ (__popc(word) << 31));
}

// The factor program shared by the factored and the XL kernels. A block
// fixes one index p of one spin (the program's spin); each thread owns kCells
// indices q[j] of the other spin (the cells' spin), in[j] false past the
// block's cells. For every mask in index order with a valid image of p, the
// block writes the mask's factors into shared memory as (sign mask, fcoeff *
// par_p[fp, p]) pairs, 32 masks at a time, and every thread adds
// H * T for its cells, H = sum of the pairs with the coefficient's sign
// flipped by the parity of q_words & sign mask, T = grid_p[image of p,
// q_img[g, q]] (grid_p (S_p + 1, sq + 1) float2, its pad column sq zero).
//   lookup(kk, &g, &img): mask kk's row g of q_img and the image of p; false
//     when that image is outside its spin's range (the mask adds nothing);
//   factor(f): the pair of flat factor slot f = k * n_slots + r.
template <class Lookup, class Factor>
__device__ __forceinline__ void accumulate_program(
    const Lookup& lookup, const Factor& factor, const int32_t* __restrict__ n_fact,
    int n_masks, int n_slots, const int32_t* __restrict__ q_img, int sq,
    const float2* __restrict__ grid_p, const int (&q)[kCells], const bool (&in)[kCells],
    const int (&qw)[kCells], float (&acc_re)[kCells], float (&acc_im)[kCells]) {
  // the tile's program: (sign mask, coefficient bits) pairs, an even number per mask
  extern __shared__ int4 program_pairs[];
  int2* prog = reinterpret_cast<int2*>(program_pairs);
  // the tile's valid masks: row of q_img, image of p, mask, start in prog
  __shared__ int t_g[kTile], t_img[kTile], t_k[kTile], t_off[kTile + 1];
  __shared__ int s_valid;

  const int n_warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < n_masks; k0 += kTile) {
    __syncthreads();  // the previous tile's program is consumed
    if (warp == 0) {
      const int kk = k0 + lane;
      int g = 0, img = 0, nf = 0;
      bool ok = false;
      if (kk < n_masks) {
        ok = lookup(kk, &g, &img);
        nf = __ldg(n_fact + kk);
      }
      const bool valid = ok && nf > 0;
      const unsigned todo = __ballot_sync(kFull, valid);
      const int room = valid ? (nf + 1) & ~1 : 0;  // pairs, rounded up to 16 bytes
      int end = room;                              // inclusive prefix sum over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, end, d);
        if (lane >= d) end += v;
      }
      const int m = __popc(todo & ((1u << lane) - 1u));
      if (valid) {
        t_g[m] = g;
        t_img[m] = img;
        t_k[m] = kk;
        t_off[m] = end - room;
      }
      if (lane == 31) {
        t_off[__popc(todo)] = end;
        s_valid = __popc(todo);
      }
    }
    __syncthreads();
    const int n_valid = s_valid;
    for (int m = warp; m < n_valid; m += n_warps) {
      const int k = t_k[m];
      const int off = t_off[m];
      const int nf = __ldg(n_fact + k);
      const int room = t_off[m + 1] - off;
      for (int r = lane; r < room; r += 32)   // the pad pair of an odd list adds +0
        prog[off + r] = r < nf ? factor(static_cast<size_t>(k) * n_slots + r) : make_int2(0, 0);
    }
    __syncthreads();
    for (int m = 0; m < n_valid; ++m) {
      int qi[kCells];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        qi[j] = in[j] ? __ldg(q_img + static_cast<size_t>(t_g[m]) * sq + q[j]) : sq;
        any = any || qi[j] < sq;
      }
      if (!__any_sync(kFull, any)) continue;
      float2 t[kCells];
      float h[kCells];
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        t[j] = __ldg(grid_p + static_cast<size_t>(t_img[m]) * (sq + 1) + qi[j]);
        h[j] = 0.f;
      }
      const int4* p = reinterpret_cast<const int4*>(prog + t_off[m]);
      const int4* p_end = reinterpret_cast<const int4*>(prog + t_off[m + 1]);
      for (; p < p_end; ++p) {
        const int4 two = *p;  // the same address in every lane: one broadcast
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          h[j] += signed_by_parity(two.y, qw[j] & two.x);
          h[j] += signed_by_parity(two.w, qw[j] & two.z);
        }
      }
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        acc_re[j] = fmaf(h[j], t[j].x, acc_re[j]);
        acc_im[j] = fmaf(h[j], t[j].y, acc_im[j]);
      }
    }
  }
}

// the factored kernel: the program's spin is beta (p = rb, one per blockIdx.x),
// the cells' spin alpha (tiles of ra along blockIdx.y), over the whole grid
__global__ void __launch_bounds__(kMaxThreads) factored_grid_accumulate_kernel(
    const int32_t* __restrict__ pa_idx, const int32_t* __restrict__ row_map,
    const int32_t* __restrict__ alpha_words, const int32_t* __restrict__ ya_words,
    const float* __restrict__ par_b, const int32_t* __restrict__ fa_idx,
    const int32_t* __restrict__ fb_idx, const float* __restrict__ fcoeff,
    const int32_t* __restrict__ n_fact, const float2* __restrict__ grid_t,
    float2* __restrict__ out, int n_masks, int n_slots, int sa, int sb) {
  const int rb = blockIdx.x;
  int ra[kCells], aw[kCells];
  bool in[kCells];
  float acc_re[kCells], acc_im[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    ra[j] = (blockIdx.y * kCells + j) * blockDim.x + threadIdx.x;
    in[j] = ra[j] < sa;
    aw[j] = __ldg(alpha_words + (in[j] ? ra[j] : sa - 1));
    acc_re[j] = acc_im[j] = 0.f;
  }
  // lane j's look at mask kk: (ka, pb) of row_map[kk, rb]; pb = sb is the pad column
  const auto lookup = [&](int kk, int* ka, int* pb) {
    const int rm = __ldg(row_map + static_cast<size_t>(kk) * sb + rb);
    *ka = rm / (sb + 1);
    *pb = rm - *ka * (sb + 1);
    return *pb < sb;
  };
  const auto factor = [&](size_t f) {
    const int ya = __ldg(ya_words + __ldg(fa_idx + f));
    const float cb = __ldg(fcoeff + f) * __ldg(par_b + static_cast<size_t>(__ldg(fb_idx + f)) * sb + rb);
    return make_int2(ya, __float_as_int(cb));
  };
  accumulate_program(lookup, factor, n_fact, n_masks, n_slots, pa_idx, sa, grid_t, ra, in, aw,
                     acc_re, acc_im);
#pragma unroll
  for (int j = 0; j < kCells; ++j)
    if (in[j]) out[static_cast<size_t>(rb) * sa + ra[j]] = make_float2(acc_re[j], acc_im[j]);
}

struct XlProgram {
  const int32_t *ga, *gb, *pa_idx, *pb_idx, *alpha_words, *beta_words, *ya_words, *yb_words;
  const float *par_a, *par_b;
  const int32_t *fa_idx, *fb_idx;
  const float* fcoeff;
  const int32_t *n_fact, *cells_off;
  const int4* tiles;          // (orientation, p, q_lo, q_hi) per block
  const float2 *grid, *grid_t;
  float2* out;                // (n_cells,) packed staircase cells
  int n_masks, n_slots, sa, sb;
};

// the staircase kernel: block b takes tile b. A column tile (orientation 0)
// fixes rb and gives its threads the alpha rows [q_lo, q_hi), reading the
// transposed grid as the factored kernel does; a row tile fixes ra and gives
// its threads the beta columns, reading the grid as it is. Cell (ra, rb) is
// written at cells_off[ra] + rb.
__global__ void __launch_bounds__(kMaxThreads) xl_grid_accumulate_kernel(const XlProgram x) {
  const int4 tile = __ldg(x.tiles + blockIdx.x);
  const bool column = tile.x == 0;
  const int p = tile.y;
  const int sq = column ? x.sa : x.sb;
  const int32_t* q_words = column ? x.alpha_words : x.beta_words;
  int q[kCells], qw[kCells];
  bool in[kCells];
  float acc_re[kCells], acc_im[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    q[j] = tile.z + j * blockDim.x + threadIdx.x;
    in[j] = q[j] < tile.w;
    qw[j] = __ldg(q_words + (in[j] ? q[j] : tile.z));
    acc_re[j] = acc_im[j] = 0.f;
  }
  if (column) {   // p = rb: beta images and par_b in the program, alpha in the cells
    const auto lookup = [&](int kk, int* g, int* img) {
      *g = __ldg(x.ga + kk);
      *img = __ldg(x.pb_idx + static_cast<size_t>(__ldg(x.gb + kk)) * x.sb + p);
      return *img < x.sb;
    };
    const auto factor = [&](size_t f) {
      const int ya = __ldg(x.ya_words + __ldg(x.fa_idx + f));
      const float cb = __ldg(x.fcoeff + f) *
                       __ldg(x.par_b + static_cast<size_t>(__ldg(x.fb_idx + f)) * x.sb + p);
      return make_int2(ya, __float_as_int(cb));
    };
    accumulate_program(lookup, factor, x.n_fact, x.n_masks, x.n_slots, x.pa_idx, sq, x.grid_t,
                       q, in, qw, acc_re, acc_im);
  } else {        // p = ra: alpha images and par_a in the program, beta in the cells
    const auto lookup = [&](int kk, int* g, int* img) {
      *g = __ldg(x.gb + kk);
      *img = __ldg(x.pa_idx + static_cast<size_t>(__ldg(x.ga + kk)) * x.sa + p);
      return *img < x.sa;
    };
    const auto factor = [&](size_t f) {
      const int yb = __ldg(x.yb_words + __ldg(x.fb_idx + f));
      const float ca = __ldg(x.fcoeff + f) *
                       __ldg(x.par_a + static_cast<size_t>(__ldg(x.fa_idx + f)) * x.sa + p);
      return make_int2(yb, __float_as_int(ca));
    };
    accumulate_program(lookup, factor, x.n_fact, x.n_masks, x.n_slots, x.pb_idx, sq, x.grid,
                       q, in, qw, acc_re, acc_im);
  }
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    if (!in[j]) continue;
    const int ra = column ? q[j] : p;
    const int rb = column ? p : q[j];
    x.out[__ldg(x.cells_off + ra) + rb] = make_float2(acc_re[j], acc_im[j]);
  }
}

constexpr int kDenseThreads = 128;  // at most 4 warps a dense block: a 65 KB ring
constexpr int kStage = 32;          // masks a ring stage looks up: one per lane
static_assert(kStage == 32, "a stage's lookup gives each lane of the warp one mask");

// One warp's stage of the dense ring: for each mask of the stage with a valid
// beta image, in index order, every lane's h_dense value and alpha image, and
// the mask's beta image.
struct DenseStage {
  float h[kStage][32];
  int pa[kStage][32];
  int pb[kStage];
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(shared_address(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_evict_first(void* dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
               ::"r"(shared_address(dst)), "l"(src), "l"(policy) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` of this thread's committed copy groups are in flight
template <int pending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

__global__ void __launch_bounds__(kDenseThreads) dense_grid_accumulate_kernel(
    const int32_t* __restrict__ r1_idx, const int32_t* __restrict__ row_map,
    const float* __restrict__ h_dense, const float2* __restrict__ grid_t,
    float2* __restrict__ out, float2* __restrict__ partial, unsigned* __restrict__ arrivals,
    int n_masks, int n_ranges, int sa, int sb) {
  extern __shared__ int4 ring_words[];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  DenseStage* ring = reinterpret_cast<DenseStage*>(ring_words) + 2 * (threadIdx.x >> 5);
  // blockIdx.x = (rb * n_tiles + tile) * n_ranges + range: a cell's ranges are neighbours
  const int range = blockIdx.x % n_ranges;
  const int slot = blockIdx.x / n_ranges;   // (rb, tile of ra): one arrival counter
  const int n_tiles = (sa + blockDim.x - 1) / blockDim.x;
  const int rb = slot / n_tiles;
  const int ra = (slot - rb * n_tiles) * blockDim.x + threadIdx.x;
  // lanes past the row's end stay in the warp for its ballots, copying nothing
  const bool in = ra < sa;
  const int k_begin = static_cast<int>(static_cast<int64_t>(range) * n_masks / n_ranges);
  const int k_end = static_cast<int>(static_cast<int64_t>(range + 1) * n_masks / n_ranges);
  const uint64_t policy = evict_first_policy();

  // lane j's row_map entry for mask k0 + j of the range; -1 past its end
  auto lookup = [&](int k0) {
    const int kk = k0 + lane;
    return kk < k_end ? __ldg(row_map + static_cast<size_t>(kk) * sb + rb) : -1;
  };
  // lists the stage's masks with a valid beta image (the lookups `rm` of masks
  // k0 + lane) and starts the copies of this lane's cell of each; returns the
  // count, the same in every lane
  auto fill = [&](int rm, int k0, DenseStage& st) {
    __syncwarp();   // every lane is done with this stage's previous list
    const int ka = rm >= 0 ? rm / (sb + 1) : 0;
    const int pb = rm >= 0 ? rm - ka * (sb + 1) : sb;
    const unsigned todo = __ballot_sync(kFull, pb < sb);
    if (pb < sb) st.pb[__popc(todo & ((1u << lane) - 1u))] = pb;
    int m = 0;
    for (unsigned left = todo; left; left &= left - 1, ++m) {
      const int j = __ffs(left) - 1;
      const int ka_j = __shfl_sync(kFull, ka, j);
      if (in) {
        copy4_evict_first(&st.h[m][lane],
                          h_dense + (static_cast<size_t>(k0 + j) * sb + rb) * sa + ra, policy);
        copy4(&st.pa[m][lane], r1_idx + static_cast<size_t>(ka_j) * sa + ra);
      }
    }
    copies_commit();
    return __popc(todo);
  };

  float acc_re = 0.f, acc_im = 0.f;
  int n_cur = fill(lookup(k_begin), k_begin, ring[0]);
  int rm = lookup(k_begin + kStage);
  for (int k0 = k_begin, s = 0; k0 < k_end; k0 += kStage, s ^= 1) {
    const int n_next = fill(rm, k0 + kStage, ring[s ^ 1]);
    rm = lookup(k0 + 2 * kStage);
    copies_wait<1>();   // this lane's copies of stage s have landed
    __syncwarp();       // and the stage's list, written by other lanes, is seen
    if (in) {
      const DenseStage& st = ring[s];
#pragma unroll 4
      for (int m = 0; m < n_cur; ++m) {
        const int pa = st.pa[m][lane];
        if (pa < sa) {
          const float h = st.h[m][lane];
          const float2 t = __ldg(grid_t + static_cast<size_t>(st.pb[m]) * (sa + 1) + pa);
          acc_re = fmaf(h, t.x, acc_re);
          acc_im = fmaf(h, t.y, acc_im);
        }
      }
    }
    n_cur = n_next;
  }
  copies_wait<0>();

  // the range's partial sums; the last block of the cell tile to arrive adds
  // all ranges' in range order
  const size_t cell = static_cast<size_t>(rb) * sa + ra;
  const size_t plane = static_cast<size_t>(sb) * sa;
  if (in) partial[range * plane + cell] = make_float2(acc_re, acc_im);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrivals + slot, 1u) == static_cast<unsigned>(n_ranges - 1);
  __syncthreads();
  if (!s_last) return;
  if (in) {
    float2 sum = __ldcg(partial + cell);
    for (int r = 1; r < n_ranges; ++r) {
      const float2 p = __ldcg(partial + r * plane + cell);
      sum.x += p.x;
      sum.y += p.y;
    }
    out[cell] = sum;
  }
  if (threadIdx.x == 0) arrivals[slot] = 0u;   // every range has arrived: ready for the next launch
}

dim3 cell_blocks(int sa, int sb, int cells_per_block) {
  return dim3(static_cast<unsigned>(sb),
              static_cast<unsigned>((sa + cells_per_block - 1) / cells_per_block));
}

}  // namespace

extern "C" int factored_grid_accumulate(const void* pa_idx, const void* row_map,
                                        const void* alpha_words, const void* ya_words,
                                        const void* par_b, const void* fa_idx,
                                        const void* fb_idx, const void* fcoeff,
                                        const void* n_fact, const void* grid_t, void* out,
                                        int n_masks, int n_slots, int sa, int sb,
                                        void* stream) {
  const int threads = block_threads(sa, kCells);
  const size_t smem = sizeof(int2) * kTile * static_cast<size_t>(n_slots + 1);
  factored_grid_accumulate_kernel<<<cell_blocks(sa, sb, threads * kCells), threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pa_idx), static_cast<const int32_t*>(row_map),
      static_cast<const int32_t*>(alpha_words), static_cast<const int32_t*>(ya_words),
      static_cast<const float*>(par_b), static_cast<const int32_t*>(fa_idx),
      static_cast<const int32_t*>(fb_idx), static_cast<const float*>(fcoeff),
      static_cast<const int32_t*>(n_fact), static_cast<const float2*>(grid_t),
      static_cast<float2*>(out), n_masks, n_slots, sa, sb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_grid_accumulate(const void* r1_idx, const void* row_map,
                                     const void* h_dense, const void* grid_t, void* out,
                                     void* partial, void* arrivals, int n_masks, int n_ranges,
                                     int sa, int sb, void* stream) {
  const int threads = block_threads(sa, 1, kDenseThreads);
  const int tiles = (sa + threads - 1) / threads;
  const int ring = static_cast<int>(sizeof(DenseStage)) * 2 * (threads / 32);
  cudaError_t rc = cudaFuncSetAttribute(dense_grid_accumulate_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>(sb) * tiles * n_ranges;
  dense_grid_accumulate_kernel<<<blocks, threads, ring, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(r1_idx), static_cast<const int32_t*>(row_map),
      static_cast<const float*>(h_dense), static_cast<const float2*>(grid_t),
      static_cast<float2*>(out), static_cast<float2*>(partial),
      static_cast<unsigned*>(arrivals), n_masks, n_ranges, sa, sb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xl_grid_accumulate(const void* ga, const void* gb, const void* pa_idx,
                                  const void* pb_idx, const void* alpha_words,
                                  const void* beta_words, const void* ya_words,
                                  const void* yb_words, const void* par_a, const void* par_b,
                                  const void* fa_idx, const void* fb_idx, const void* fcoeff,
                                  const void* n_fact, const void* cells_off, const void* tiles,
                                  const void* grid, const void* grid_t, void* out, int n_masks,
                                  int n_slots, int sa, int sb, int n_tiles, int tile_cells,
                                  void* stream) {
  // a block of tile_cells / kCells threads, a whole number of warps, covers a tile
  const int threads = tile_cells / kCells;
  if (tile_cells % (kCells * 32) != 0 || threads > kMaxThreads || n_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  XlProgram x;
  x.ga = static_cast<const int32_t*>(ga);
  x.gb = static_cast<const int32_t*>(gb);
  x.pa_idx = static_cast<const int32_t*>(pa_idx);
  x.pb_idx = static_cast<const int32_t*>(pb_idx);
  x.alpha_words = static_cast<const int32_t*>(alpha_words);
  x.beta_words = static_cast<const int32_t*>(beta_words);
  x.ya_words = static_cast<const int32_t*>(ya_words);
  x.yb_words = static_cast<const int32_t*>(yb_words);
  x.par_a = static_cast<const float*>(par_a);
  x.par_b = static_cast<const float*>(par_b);
  x.fa_idx = static_cast<const int32_t*>(fa_idx);
  x.fb_idx = static_cast<const int32_t*>(fb_idx);
  x.fcoeff = static_cast<const float*>(fcoeff);
  x.n_fact = static_cast<const int32_t*>(n_fact);
  x.cells_off = static_cast<const int32_t*>(cells_off);
  x.tiles = static_cast<const int4*>(tiles);
  x.grid = static_cast<const float2*>(grid);
  x.grid_t = static_cast<const float2*>(grid_t);
  x.out = static_cast<float2*>(out);
  x.n_masks = n_masks;
  x.n_slots = n_slots;
  x.sa = sa;
  x.sb = sb;
  const size_t smem = sizeof(int2) * kTile * static_cast<size_t>(n_slots + 1);
  xl_grid_accumulate_kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grid_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
