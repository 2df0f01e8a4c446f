// The grid E_loc engines' accumulation for sm_90a: three kernels in one source.
//
// They replace, in naqs_tpu/ops/dense_engine.py, the term-chunk scan of
// factored_local_energy (:496-522) read at the cells its readout reads
// (:526-540), the scan of dense_local_energy (:279-289 with :270-271) and the
// two stages per alpha-flip group of factored_xl_local_energy (:877-928).
// Those have no Pallas counterpart: the JAX package left them to XLA. With
// grid the (Sa+1, Sb+1, 2) f32 table of psi / max|psi| (a zero pad row and
// column: an invalid alpha image reads row Sa, an invalid beta image column
// Sb, so both read psi = 0) and a mask's images of a cell (ra, rb),
// ia = pa_idx[ga_k, ra] and ib = pb_idx[gb_k, rb],
//
//   factored_cells_accumulate: for buffer row i below n_rows whose rank index
//     is a cell (ra, rb) of the sector,
//       out[i, :] = sum_k H_k(ra, rb) * grid[ia, ib, :],
//       H_k = sum_{r < n_fact[k]} fcoeff[k, r] * par_a[fa_idx[k, r], ra]
//                                              * par_b[fb_idx[k, r], rb],
//     and (0, 0) for every other row;
//   dense_grid_accumulate: for every cell of the grid,
//       out[rb, ra, :] = sum_k h_dense[k, rb, ra] * grid[ia, ib, :].
//
// Neither H as a (Kxy, Sb, Sa) tensor (29.9 GB for H2O 6-31G), nor the
// alpha-permuted copy R1t (Ka, Sb+1, Sa, 2) that the JAX code materialises
// (6.15 GB there), nor a (KC, Sb, Sa, 2) chunk gather reaches device memory:
// T is read straight from the grid, which is 13.3 MB for H2O 6-31G and stays
// in the 50 MB L2.
//
// factored_cells_accumulate. The JAX scan computes the numerator on all
// 1,287 x 1,287 cells of H2O 6-31G's grid: 2.17 G valid (mask, cell) pairs
// and 14.1 G factor multiply-adds. E_loc reads it at the live buffer rows
// only (about 26,000 cells, 1.6% of the grid), and there T is zero wherever
// the image was not sampled (about 90% of the valid pairs). So the kernel's
// work follows the cells E_loc reads, and within them the sampled images:
// * One warp owns one live row at a time, rows w, w + W, ... on a persistent
//   grid; rows at or past n_rows (a 0-d device tensor, never read back) and
//   rows with no cell are written (0, 0) on the way.
// * The warp stages the cell's alpha-image row and beta-image row (the image
//   maps transposed, FactorTerms.pa_t / pb_t, rows of whole 16-byte pieces)
//   with two 1-D bulk copies (cp.async.bulk) into one of its two stages,
//   complete_tx on the stage's mbarrier: the next row's images land while
//   this row is summed. The block stages every mask's (ga, gb) once (36 KB for
//   H2O 6-31G) where it fits beside the stages, else reads them through the
//   read-only cache (3.6% slower on H2O 6-31G, PERF.md) and runs as many
//   warps as the stages leave room for.
// * Lane j walks masks j, j + 32, ..., kCellsBatch at a time (their grid
//   loads in flight together): both images from the stage, and one 8-byte
//   grid load only where both lie in the sector. A pair whose T is (0, 0)
//   adds nothing and runs no factor loop.
// * The found pairs join the warp's ring in mask order; every 32 of them (and
//   the rest at the row's end) are summed one a lane: H_k from the mask's
//   packed slots (FactorTerms.slots: alpha sign word, beta sign word,
//   coefficient), each sign (-1)^popc((aw & ya) ^ (bw & yb)) from the cell's
//   two words, with no par_a or par_b load; then two fused multiply-adds.
//   Found pair p of a row goes to lane p % 32, each lane adds its pairs in
//   mask order and the lanes' sums are added in a fixed xor tree: the same
//   bits in every run, no atomics.
// What bounds it: bytes, 17 MB on H2O 6-31G's sampled batch (the image rows
// of the live cells' distinct ra and rb, the masks, the slots of the masks
// of found pairs, the 1.56 M grid cells the valid pairs read), 0.005 ms,
// against 0.3 G operations (4 a valid pair, 2 a factor and 4 a found pair of
// 51 M valid and 5.2 M found pairs), 0.0046 ms; the kernel takes some 0.95 ms
// (PERF.md). How that splits between the look-ups with their grid loads from
// L2 and the found pairs' factor loops is not measured (no ncu there).
// Timed against variants on the card (PERF.md): running a found pair's
// factor loop in the lane that found it (the lanes of a warp wait on the
// longest loop of each round) took twice as long; the live rows ordered by
// beta rank, so that the warps of a block stage the same beta-image row,
// gained 1%.
//
// xl_grid_accumulate does the factored kernel's sum on the staircase of an
// n_exc_max-filtered sector (ops/dense_engine.py::FactorTermsXL): alpha and
// beta combinations in (excitations, colex) order, the cells (ra, rb) with
// rb < width[ra] written packed at cells_off[ra] + rb, the grid that of the
// restricted rectangle, read as it is (no transposed copy). It has code of
// its own (below the dense kernel). On Li2O STO-3G CISDTQ the grid is (5,056,
// 5,056, 2) f32 = 204.5 MB, which L2 cannot hold, and a sampled batch sets
// about 13,600 of its 25.6 M cells: of the 639.4 M valid (mask, cell) pairs
// only 1.2 M (0.19%) read a set cell; every other pair adds exactly zero.
// The earlier dense design ran the factor loop and the T load on every valid
// pair; on the card (PERF.md, step 0 of this design) skipping the factor loop
// took 1.69 ms of its 4.11 ms, a constant T 0.54 ms, both 2.62 ms, while a
// persistent grid was slower. And since the sampled cells lie in most beta columns, skipping only
// the masks whose fixed image has no set cell would still leave nearly a
// probe a valid pair: work has to follow the set cells themselves. So:
// * Phase 1 packs the set cells (either part nonzero) into two bitmaps, one
//   row per alpha image (bits over beta) and one per beta image (bits over
//   alpha), rows of whole 16-byte pieces, flags the rows that are not all
//   clear, and writes the set cells, transposed, into a scratch grid_t,
//   where column tiles read T along a row (down a grid column, each 8-byte
//   cell would cost a 32-byte sector with no reuse). It reads the grid once.
//   A grid-wide barrier (one cooperative launch of the blocks the card
//   holds) ends it.
// * The tile table (FactorTermsXL.tiles) is the dense design's: columns of
//   at most E / 2 beta excitations (rb fixed, cells over ra) and rows for
//   the rest (ra fixed, cells over rb), at most 672 cells each; block b takes
//   tiles b, b + gridDim.x, ... in that static order. The static program
//   (FactorTermsXL.prog, built once) holds per orientation the masks ordered
//   by the row of the fixed spin's image map, each as a header and its
//   factors (cells' sign word, fixed sign word, coefficient): a factor's sign
//   is the parity of both words against the cell's, so no par_a or par_b is
//   read. Its chunks are runs of one map row of at most 64 int4s.
// * A producer warp stages, for each chunk whose image of the tile's fixed
//   index has a non-clear bitmap row, that row and the chunk's mask headers
//   with two 1-D bulk copies (cp.async.bulk, complete_tx on the stage's full
//   mbarrier; a chunk of one mask, the most common, needs no headers), chunk
//   i into the ring of consumer warp i % 7, six stages deep; the warp frees
//   a stage through its empty mbarrier. No __syncthreads per tile, and a
//   warp that is busy summing holds up the others only once its ring is full.
// * A consumer warp takes a row of at most 128 set cells (and no pad cell),
//   as a sampled batch's rows nearly all are, by its set cells: each set
//   cell q' is mapped back by the mask's flip, q = map[q'] (a flip is its own
//   inverse), and kept when q lies in the tile, the (mask, set cell) entries
//   of a chunk looked up 32 at a time. These set pairs join the warp's queue
//   in order; 64 at a time, two a lane, each runs its factor loop and T load
//   (the factors from device memory), and the lanes of one cell add their
//   terms into the warp's sum of that cell in lane order (__match_any_sync),
//   so no lane idles on a clear pair.
// * A fuller row (as every row of a grid that holds the whole staircase) is
//   probed: the queue is summed first, then each lane tests 7 cells of the
//   tile at a time (a tile's 672 cells are 3 such rounds) and sums a set pair
//   at once, the mask's header and factors the same for the whole warp, the
//   next round's map lookups in flight. A queued pair waits on its own
//   header and factor loads, which a fuller row cannot afford.
// * Each cell's terms arrive in the static order (chunks, masks),
//   and at the tile's end the 7 warps' sums of a cell are added in warp
//   order: the same bits in every run, no atomics on a sum.
// What bounds it: the bytes of the grid cells the valid pairs can read
// (9.95 M cells, 79.6 MB, 0.03 ms), against 10.5 M listed entries and 1.2 M
// set pairs of a sampled grid (PERF.md has the times, on a grid of every
// staircase cell too).
//
// Design of the dense kernel:
// * A block works on one rb and a tile of ra, neighbouring threads on
//   neighbouring ra: r1_idx rows and h_dense rows are read coalesced, and
//   row_map[k, rb] is the same for the whole block. The kernel takes the grid
//   transposed, (Sb+1, Sa+1, 2): all a block's reads for one mask fall into
//   one row of Sa+1 cells.
// * What is zero is skipped: a mask with an invalid beta image (the whole
//   block skips it), and per lane an invalid alpha image. No result depends
//   on what was skipped.
// * Each thread sums its cell's masks in index order in fp32 registers, then
//   the mask ranges' partial sums are added in range order. No atomic
//   touches a sum, so every run gives the same bits.
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

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Threads per block: a row of sa cells is cut into the fewest tiles of at most
// max_threads threads, every tile a whole number of warps (N2 STO-3G's 120
// cells: one tile of 128 threads).
int block_threads(int sa, int max_threads) {
  const int tiles = (sa + max_threads - 1) / max_threads;
  const int per = (sa + tiles - 1) / tiles;
  return ((per + 31) / 32) * 32;
}

// coefficient with its sign flipped where the word has odd parity
__device__ __forceinline__ float signed_by_parity(int coeff_bits, int word) {
  return __int_as_float(coeff_bits ^ (__popc(word) << 31));
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

// ---------------------------------------------------------------- staircase

constexpr int kXlWarps = 7;            // consumer warps
constexpr int kXlThreads = (kXlWarps + 1) * 32;   // and one producer warp
constexpr int kXlTileCells = 672;      // cells a tile holds at most (XL_TILE_CELLS)
constexpr int kRing = 6;               // stages of a consumer warp's ring, one chunk each
constexpr int kChunkInt4 = 64;         // int4s a chunk of several masks holds at most
                                       // (XL_CHUNK_INT4)
constexpr int kChunkHeads = kChunkInt4 / 2;   // and so its headers: 2 or more int4s a mask
constexpr int kFlush = 2;              // set pairs a lane sums at once
constexpr int kQueue = 128;            // a warp's pending set pairs: < kFlush * 32 + 32
constexpr int kEnumMax = 128;          // set cells of a row that are listed, not probed
                                       // (XL_LIST_MAX)
constexpr int kDirect = 7;             // cells a lane probes and sums at once in a fuller row
constexpr int kDirectFactors = 4;      // factors loaded at once for them
constexpr int kFactors = 8;            // factor loads in flight a queued pair
constexpr int kHeadBits = 21;          // a queue entry: header index | cell << kHeadBits
static_assert((kQueue & (kQueue - 1)) == 0 && kQueue >= kFlush * 32 + 32 &&
              kXlTileCells <= 1 << (31 - kHeadBits), "the queue's entries");

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(shared_address(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(shared_address(bar)) : "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(shared_address(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(shared_address(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into this block's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(shared_address(dst)), "l"(src), "r"(bytes), "r"(shared_address(bar)) : "memory");
}

struct XlArgs {
  const int32_t *pa_idx, *pb_idx, *alpha_words, *beta_words, *cells_off;
  const int4* tiles;      // (orientation, p, q_lo, q_hi) per tile
  const int4* prog;       // static factor program: per chunk its masks' headers, then factors
  const int4* chunks;     // (image row, start, masks, first mask's cells' map row);
                          // column chunks first
  const float2* grid;     // (sa + 1, sb + 1)
  float2* grid_t;         // (sb + 1, sa + 1): phase 1 writes the set cells, transposed
  uint32_t* bits_a;       // (sa + 1, wb): bit c of word w of row a' is cell (a', 32 w + c)
  uint32_t* bits_b;       // (sb + 1, wa): bit i of word w of row b' is cell (32 w + i, b')
  int *any_a, *any_b;     // 1 where a row of bits_a (bits_b) is not all clear; zero on entry
  float2* out;            // (n_cells,) packed staircase cells
  int n_tiles, n_chunks, n_col_chunks, sa, sb, wa, wb;
};

// The shared memory of one consumer warp's ring: per stage the descriptor of
// its chunk (masks, image of p, start in the program, last) and its bitmap
// row and mask headers (in dynamic shared memory), and the full and empty
// barriers.
struct XlRing {
  int4 desc[kRing];
  uint64_t full[kRing], empty[kRing];
};

// Phase 1: both occupancy bitmaps of the grid. A warp reads 32 x 32 cells,
// 16 rows at a time (one ballot a row gives lane i the word of row a0 + i),
// and transposes them with 32 more ballots (lane c the word of column b0 + c).
// Every word of both bitmaps is written, the pad bits past sa and sb too. The
// set cells are also written into grid_t, transposed, where column tiles read
// them along a row; a clear cell of grid_t is never read, nor written.
__device__ void xl_occupancy(const XlArgs& x) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int n_tasks = x.wa * x.wb;
  for (int t = blockIdx.x * warps + (threadIdx.x >> 5); t < n_tasks; t += gridDim.x * warps) {
    const int wa_i = t / x.wb, wb_i = t - wa_i * x.wb;
    const int a0 = wa_i * 32, b = wb_i * 32 + lane;
    uint32_t rw = 0;
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += 16) {
      float2 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = a0 + i0 + i <= x.sa && b <= x.sb
                   ? __ldcs(x.grid + static_cast<size_t>(a0 + i0 + i) * (x.sb + 1) + b)
                   : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool set = v[i].x != 0.f || v[i].y != 0.f;
        const uint32_t w = __ballot_sync(kFull, set);
        if (lane == i0 + i) rw = w;
        if (set) x.grid_t[static_cast<size_t>(b) * (x.sa + 1) + a0 + i0 + i] = v[i];
      }
    }
    uint32_t cw = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const uint32_t w = __ballot_sync(kFull, (rw >> c) & 1u);
      if (lane == c) cw = w;
    }
    if (a0 + lane <= x.sa) {
      x.bits_a[static_cast<size_t>(a0 + lane) * x.wb + wb_i] = rw;
      if (rw) x.any_a[a0 + lane] = 1;
    }
    if (b <= x.sb) {
      x.bits_b[static_cast<size_t>(b) * x.wa + wa_i] = cw;
      if (cw) x.any_b[b] = 1;
    }
  }
}

// The producer warp: for each tile of this block, in order, the chunks of the
// tile's orientation whose image of the fixed index p has a bitmap row that
// is not all clear are staged, the i-th of them into the ring of consumer warp
// i % kXlWarps: that row and the chunk's mask headers, by two bulk copies
// completing on the stage's full barrier. (The factors are read only for set
// pairs, from device memory.) After the tile's chunks every ring gets a stage
// marked last. Lane w keeps the count of stages sent to warp w; the next 32
// chunks' descriptors and images are loaded while the current 32 are staged.
__device__ void xl_produce(const XlArgs& x, uint32_t* rows, int4* heads, int row_words,
                           XlRing* rings) {
  const int lane = threadIdx.x & 31;
  int sent = 0;   // lane w < kXlWarps: stages sent to consumer warp w
  // the next stage of warp w: wait until it is free; returns its index
  const auto take = [&](int w) {
    const int k = __shfl_sync(kFull, sent, w);
    const int st = k % kRing;
    bar_wait(rings[w].empty + st, ((k / kRing) & 1) ^ 1);
    if (lane == w) ++sent;
    return st;
  };
  for (int b = blockIdx.x; b < x.n_tiles; b += gridDim.x) {
    const int4 tile = __ldg(x.tiles + b);
    const bool column = tile.x == 0;
    const int p = tile.y;
    const int sp = column ? x.sb : x.sa;            // the fixed index's spin
    const int32_t* p_idx = column ? x.pb_idx : x.pa_idx;
    const uint32_t* bits = column ? x.bits_b : x.bits_a;
    const int src_words = column ? x.wa : x.wb;     // the words of one of its rows
    const int* any = column ? x.any_b : x.any_a;
    const int c_begin = column ? 0 : x.n_col_chunks;
    const int c_end = column ? x.n_col_chunks : x.n_chunks;
    // lane j's look at chunk c0 + j: its descriptor and its image of p
    const auto look = [&](int c0, int4& ch, int& img) {
      const int c = c0 + lane;
      ch = make_int4(0, 0, 0, 0);
      img = sp;
      if (c < c_end) {
        ch = __ldg(x.chunks + c);
        img = __ldg(p_idx + static_cast<size_t>(ch.x) * sp + p);
      }
    };
    int4 ch, ch_next;
    int img, img_next, ord = 0;
    look(c_begin, ch_next, img_next);
    for (int c0 = c_begin; c0 < c_end; c0 += 32) {
      ch = ch_next;
      img = img_next;
      const bool ok = c0 + lane < c_end && __ldcg(any + img) != 0;   // phase 1's: not __ldg
      if (c0 + 32 < c_end) look(c0 + 32, ch_next, img_next);
      for (unsigned left = __ballot_sync(kFull, ok); left; left &= left - 1, ++ord) {
        const int j = __ffs(left) - 1;
        const int start = __shfl_sync(kFull, ch.y, j);
        const int masks = __shfl_sync(kFull, ch.z, j);
        const int g_first = __shfl_sync(kFull, ch.w, j);
        const int img_j = __shfl_sync(kFull, img, j);
        const int w = ord % kXlWarps;
        const int st = take(w);
        if (lane == 0) {
          const int slot = w * kRing + st;
          const unsigned row_bytes = static_cast<unsigned>(src_words) * 4u;
          // a chunk of one mask needs no headers: its map row rides in the descriptor
          const unsigned head_bytes = masks > 1 ? static_cast<unsigned>(masks) * 16u : 0u;
          rings[w].desc[st] = make_int4(masks, img_j, start, g_first);
          bar_arrive_tx(rings[w].full + st, row_bytes + head_bytes);
          bulk_copy(rows + static_cast<size_t>(slot) * row_words,
                    bits + static_cast<size_t>(img_j) * src_words, row_bytes, rings[w].full + st);
          if (head_bytes)
            bulk_copy(heads + static_cast<size_t>(slot) * kChunkHeads, x.prog + start, head_bytes,
                      rings[w].full + st);
        }
      }
    }
    for (int w = 0; w < kXlWarps; ++w) {   // the tile's end
      const int st = take(w);
      if (lane == 0) {
        rings[w].desc[st] = make_int4(0, 0, 0, 0);   // no masks: the tile's end
        bar_arrive(rings[w].full + st);
      }
    }
  }
}

// The consumer warps. Warp w takes the chunks of its ring, in order, and adds
// their masks' terms into its own sums of every cell of the tile (acc_w,
// shared memory); at the tile's end the warps' sums of a cell are added in
// warp order. For each mask of a chunk the warp finds the pairs whose grid
// cell is set, in one of two ways, chosen per chunk from its staged bitmap
// row (the cells (image of p, .) of the grid):
// * the row holds at most kEnumMax set cells and not the pad cell: each set
//   cell q' of the row is an image of the cell q = q_idx[g, q'] under the
//   mask's flip (a flip is its own inverse), which is a pair of the tile when
//   q lies in [q_lo, q_hi). The work follows the set cells. The pairs join
//   the warp's queue in mask order, each as (the mask's header in the
//   program, the cell, the grid cell); every kFlush * 32 of them, and at the
//   tile's end, they are summed with kFlush pairs a lane: H by the mask's
//   factors, T from the grid, H * T added to the cell's sum in queue order
//   (lanes of one cell add in lane order);
// * otherwise the queue is summed, then every cell q of the tile probes bit
//   q_idx[g, q] of the row, kDirect cells a lane, and its lane sums a set
//   pair at once (the mask's factors are the same for the whole warp).
// So each cell adds its masks in a fixed order, with no atomics.
__device__ void xl_consume(const XlArgs& x, const uint32_t* rows, const int4* heads,
                           int row_words, XlRing* ring, float2* acc, int2* queue,
                           float4* contrib, int* bit_list) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  float2* acc_w = acc + warp * kXlTileCells;
  int2* queue_w = queue + warp * kQueue;
  float4* contrib_w = contrib + warp * 32;
  int* list_w = bit_list + warp * kEnumMax;
  int got = 0;   // stages taken from the ring
  for (int b = blockIdx.x; b < x.n_tiles; b += gridDim.x) {
    const int4 tile = __ldg(x.tiles + b);
    const bool column = tile.x == 0;
    const int p = tile.y, q_lo = tile.z, n_q = tile.w - tile.z;
    const int sq = column ? x.sa : x.sb;            // the cells' spin
    const int q_words_n = column ? x.wa : x.wb;     // words of a staged row
    const int32_t* q_idx = column ? x.pa_idx : x.pb_idx;
    const int32_t* q_words = column ? x.alpha_words : x.beta_words;
    const int pw = __ldg((column ? x.beta_words : x.alpha_words) + p);
    const float2* t_grid = column ? x.grid_t : x.grid;   // T of (image q', image of p) ...
    for (int c = lane; c < kXlTileCells; c += 32) acc_w[c] = make_float2(0.f, 0.f);
    int head = 0, count = 0;   // the queue's pending pairs, the same in every lane

    // sums queue entries head .. head + k - 1 (k <= kFlush * 32): each lane
    // loads kFlush of them, then they are added 32 at a time in queue order
    const auto flush = [&](int k) {
      float h[kFlush];
      float2 t[kFlush];
      int cell[kFlush];
#pragma unroll
      for (int i = 0; i < kFlush; ++i) {
        const int at = i * 32 + lane;
        h[i] = 0.f;
        t[i] = make_float2(0.f, 0.f);
        cell[i] = -1;
        if (at < k) {
          const int2 e = queue_w[(head + at) & (kQueue - 1)];
          cell[i] = e.x >> kHeadBits;
          t[i] = __ldcg(t_grid + e.y);   // grid_t is phase 1's: not __ldg
          const int4* hp = x.prog + (e.x & ((1 << kHeadBits) - 1));
          const int4 hd = __ldg(hp);   // (row of the cells' map, factors, mask, to the factors)
          const int cw = __ldg(q_words + q_lo + cell[i]);
          for (int r0 = 0; r0 < hd.y; r0 += kFactors) {
            int4 f[kFactors];
#pragma unroll
            for (int r = 0; r < kFactors; ++r)
              f[r] = r0 + r < hd.y ? __ldg(hp + hd.w + r0 + r) : make_int4(0, 0, 0, 0);
#pragma unroll
            for (int r = 0; r < kFactors; ++r)   // a pad factor adds +0
              h[i] += signed_by_parity(f[r].z, (cw & f[r].x) ^ (pw & f[r].y));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFlush; ++i) {
        if (i * 32 >= k) break;
        contrib_w[lane] = make_float4(h[i], t[i].x, t[i].y, 0.f);
        const unsigned peers = __match_any_sync(kFull, cell[i] >= 0 ? cell[i] : kXlTileCells + lane);
        __syncwarp();
        if (cell[i] >= 0 && lane == __ffs(peers) - 1) {
          float2 a = acc_w[cell[i]];
          for (unsigned left = peers; left; left &= left - 1) {
            const float4 c = contrib_w[__ffs(left) - 1];
            a.x = fmaf(c.x, c.y, a.x);
            a.y = fmaf(c.x, c.z, a.y);
          }
          acc_w[cell[i]] = a;
        }
        __syncwarp();
      }
      head += k;
      count -= k;
    };
    // queues the pair (mask whose header is prog[hd_at], cell, grid cell at)
    // of each lane with `hit`; sums kFlush * 32 when as many are pending
    const auto push = [&](bool hit, int hd_at, int cell, int at) {
      const unsigned who = __ballot_sync(kFull, hit);
      if (hit)
        queue_w[(head + count + __popc(who & below)) & (kQueue - 1)] =
            make_int2(hd_at | (cell << kHeadBits), at);
      count += __popc(who);
      __syncwarp();
      if (count >= kFlush * 32) flush(kFlush * 32);
    };

    for (;;) {
      const int st = got % kRing;
      bar_wait(ring->full + st, (got / kRing) & 1);
      ++got;
      // (masks, image of p, start in the program, the first mask's map row)
      const int4 d = ring->desc[st];
      if (d.x == 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(ring->empty + st);
        break;
      }
      const int slot = warp * kRing + st;
      const uint32_t* row = rows + static_cast<size_t>(slot) * row_words;
      const int4* hs = heads + static_cast<size_t>(slot) * kChunkHeads;
      const int img = d.y;
      // ... at t_grid[at(q')]: row img of grid_t or of the grid
      const auto at = [&](int qi) { return img * (column ? x.sa + 1 : x.sb + 1) + qi; };
      int mine = 0;
      for (int w = lane; w < q_words_n; w += 32) mine += __popc(row[w]);
      const int n_set = __reduce_add_sync(kFull, mine);
      const bool pad = (row[sq >> 5] >> (sq & 31)) & 1u;
      if (n_set <= kEnumMax && !pad) {
        int pos = mine;   // exclusive prefix of the lanes' counts
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int v = __shfl_up_sync(kFull, pos, dd);
          if (lane >= dd) pos += v;
        }
        pos -= mine;
        for (int w = lane; w < q_words_n; w += 32)
          for (uint32_t bits = row[w]; bits; bits &= bits - 1)
            list_w[pos++] = w * 32 + __ffs(bits) - 1;
        __syncwarp();
        // every (mask, set cell) of the chunk, mask-major, 32 at a time: the
        // map lookups of a round are in flight together
        const int n_e = d.x * n_set;
        for (int e0 = 0; e0 < n_e; e0 += 32) {
          const int e = e0 + lane;
          int m = 0, a = 0, t = -1;
          if (e < n_e) {
            m = e / n_set;
            a = list_w[e - m * n_set];
            t = __ldg(q_idx + static_cast<size_t>(m ? hs[m].x : d.w) * sq + a) - q_lo;
          }
          const bool hit = t >= 0 && t < n_q;
          push(hit, d.z + m, hit ? t : 0, at(a));
        }
      } else {
        // the queue's earlier pairs first: each cell keeps its masks' order
        while (count > 0) flush(count < kFlush * 32 ? count : kFlush * 32);
        // the masks' headers (staged for a chunk of several) and factors are the
        // same for the whole warp; a lane takes kDirect cells of the tile at a
        // time, and the next (mask, cells) item's map lookups are in flight while
        // this one's T and factor loads are
        const auto header = [&](int m) { return d.x > 1 ? hs[m] : __ldg(x.prog + d.z); };
        const auto lookups = [&](const int4& hd, int c0, int (&qi)[kDirect]) {
          const int32_t* map = q_idx + static_cast<size_t>(hd.x) * sq + q_lo;
#pragma unroll
          for (int j = 0; j < kDirect; ++j) {
            const int c = c0 + 32 * j + lane;
            qi[j] = c < n_q ? __ldg(map + c) : sq;
          }
        };
        int m = 0, c0 = 0;
        int4 hd = header(0);
        int qi[kDirect];
        lookups(hd, 0, qi);
        for (;;) {
          int m_next = m, c_next = c0 + 32 * kDirect;
          if (c_next >= n_q) {
            c_next = 0;
            ++m_next;
          }
          const bool more = m_next < d.x;
          const int4 hd_next = more && m_next != m ? header(m_next) : hd;
          int qi_next[kDirect];
          if (more) lookups(hd_next, c_next, qi_next);
          bool hit[kDirect];
          bool any = false;
#pragma unroll
          for (int j = 0; j < kDirect; ++j) {
            hit[j] = c0 + 32 * j + lane < n_q && ((row[qi[j] >> 5] >> (qi[j] & 31)) & 1u);
            any |= hit[j];
          }
          if (__any_sync(kFull, any)) {
            const int4* fp = x.prog + d.z + m + hd.w;
            float2 t[kDirect];
            int cw[kDirect];
            float h[kDirect];
#pragma unroll
            for (int j = 0; j < kDirect; ++j) {
              t[j] = hit[j] ? __ldcg(t_grid + at(qi[j])) : make_float2(0.f, 0.f);
              cw[j] = hit[j] ? __ldg(q_words + q_lo + c0 + 32 * j + lane) : 0;
              h[j] = 0.f;
            }
            for (int r0 = 0; r0 < hd.y; r0 += kDirectFactors) {
              int4 f[kDirectFactors];
#pragma unroll
              for (int r = 0; r < kDirectFactors; ++r)
                f[r] = r0 + r < hd.y ? __ldg(fp + r0 + r) : make_int4(0, 0, 0, 0);
#pragma unroll
              for (int r = 0; r < kDirectFactors; ++r) {   // a pad factor adds +0
                const int fixed = pw & f[r].y;
#pragma unroll
                for (int j = 0; j < kDirect; ++j)
                  h[j] += signed_by_parity(f[r].z, (cw[j] & f[r].x) ^ fixed);
              }
            }
#pragma unroll
            for (int j = 0; j < kDirect; ++j) {
              if (!hit[j]) continue;
              float2& a = acc_w[c0 + 32 * j + lane];
              a.x = fmaf(h[j], t[j].x, a.x);
              a.y = fmaf(h[j], t[j].y, a.y);
            }
          }
          if (!more) break;
          m = m_next;
          c0 = c_next;
          hd = hd_next;
#pragma unroll
          for (int j = 0; j < kDirect; ++j) qi[j] = qi_next[j];
        }
      }
      __syncwarp();   // the row, headers and list are read before the stage is freed
      if (lane == 0) bar_arrive(ring->empty + st);
    }
    while (count > 0) flush(count < kFlush * 32 ? count : kFlush * 32);
    // every consumer warp's sums are complete: add them in warp order
    asm volatile("bar.sync 1, %0;" ::"r"(kXlWarps * 32) : "memory");
    for (int c = threadIdx.x; c < n_q; c += kXlWarps * 32) {
      float2 sum = acc[c];
      for (int w = 1; w < kXlWarps; ++w) {
        const float2 v = acc[w * kXlTileCells + c];
        sum.x += v.x;
        sum.y += v.y;
      }
      const int ra = column ? q_lo + c : p;
      const int rb = column ? p : q_lo + c;
      x.out[__ldg(x.cells_off + ra) + rb] = sum;
    }
    asm volatile("bar.sync 1, %0;" ::"r"(kXlWarps * 32) : "memory");   // before they are cleared
  }
}

// One cooperative launch: phase 1 (both bitmaps), one grid-wide barrier, then
// every block walks the tiles b, b + gridDim.x, ... with its producer warp and
// kXlWarps consumer warps.
__global__ void __launch_bounds__(kXlThreads) xl_grid_accumulate_kernel(const XlArgs x) {
  extern __shared__ int4 xl_smem[];
  __shared__ XlRing rings[kXlWarps];
  __shared__ int2 queue[kXlWarps * kQueue];
  __shared__ float4 contrib[kXlWarps * 32];
  __shared__ int bit_list[kXlWarps * kEnumMax];
  const int row_words = x.wa > x.wb ? x.wa : x.wb;
  int4* heads = xl_smem;
  float2* acc = reinterpret_cast<float2*>(heads + kXlWarps * kRing * kChunkHeads);
  uint32_t* rows = reinterpret_cast<uint32_t*>(acc + kXlWarps * kXlTileCells);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kXlWarps; ++w)
      for (int i = 0; i < kRing; ++i) {
        bar_init(rings[w].full + i, 1);
        bar_init(rings[w].empty + i, 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  xl_occupancy(x);
  // the bitmaps' words, stored through the generic proxy, are read by bulk copies
  asm volatile("fence.proxy.async.global;" ::: "memory");
  cooperative_groups::this_grid().sync();
  if (threadIdx.x >> 5 == kXlWarps) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    xl_produce(x, rows, heads, row_words, rings);
  } else {
    xl_consume(x, rows, heads, row_words, rings + (threadIdx.x >> 5), acc, queue, contrib,
               bit_list);
  }
}

// ----------------------------------------------------------- factored cells

constexpr int kCellsWarps = 8;     // warps a block at most, one buffer row each at a time
constexpr int kCellsStages = 2;    // image-row stages a warp: the next row lands meanwhile
constexpr int kCellsBatch = 8;     // masks a lane looks up at once: their grid loads in flight
constexpr int kCellsQueue = 64;    // a warp's ring of found pairs: < 32 pending + 32 new
constexpr int kCellsFactors = 4;   // factor loads in flight for one found pair

struct CellsArgs {
  const int32_t *pa_t, *pb_t;      // (sa, ka4), (sb, kb4): the alpha (beta) images of ra (rb)
  const int32_t *ga, *gb;          // (n_masks,) each mask's column of pa_t and of pb_t
  const int32_t *alpha_words, *beta_words;
  const int32_t* slot_off;         // (n_masks + 1,) mask k's factors: slots[slot_off[k] ..]
  const int4* slots;               // (alpha sign word, beta sign word, coefficient bits, 0)
  const float2* grid;              // (sa + 1, sb + 1), zero pad row and column
  const int64_t* idx;              // (n_buf,) rank indices; sa * sb and up hold no cell
  const int64_t* n_rows;           // 0-d: only rows below it are summed
  float2* out;                     // (n_buf,)
  int n_masks, n_buf, sa, sb, ka4, kb4;
};

// H_k at the cell with words (aw, bw): mask k's packed factors in slot order,
// the sign of each the parity of both words against its sign words
__device__ __forceinline__ float cells_h(const CellsArgs& x, int k, int aw, int bw) {
  const int s0 = __ldg(x.slot_off + k), s1 = __ldg(x.slot_off + k + 1);
  float h = 0.f;
  for (int r0 = s0; r0 < s1; r0 += kCellsFactors) {
    int4 f[kCellsFactors];
#pragma unroll
    for (int r = 0; r < kCellsFactors; ++r)
      f[r] = r0 + r < s1 ? __ldg(x.slots + r0 + r) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kCellsFactors; ++r)   // a pad factor adds +0
      h += signed_by_parity(f[r].z, (aw & f[r].x) ^ (bw & f[r].y));
  }
  return h;
}

// One warp per buffer row that holds a cell, rows i = w, w + W, ... for warp w
// of the W the launch holds. The warp stages the cell's alpha-image and
// beta-image rows by two bulk copies into one of its two stages (the next
// row's land while this one is summed); lane j walks masks j, j + 32, ...
// in kCellsBatch look-ups at a time, reads (ga, gb) (from shared memory where
// the block staged them) and both images from the stage, and loads T from the
// grid only where both images lie in the sector. A pair whose T is (0, 0)
// adds nothing. The others join the warp's ring in mask order, and every 32
// of them (and the rest at the row's end) are summed one a lane, H_k from the
// packed factors: found pair p of the row goes to lane p % 32. Each lane adds
// its pairs in mask order, the lanes' sums are then added in a fixed xor
// tree: every run gives the same bits. Rows past n_rows, and rows whose index
// is no cell, get (0, 0).
template <bool kMasksShared>
__global__ void __launch_bounds__(kCellsWarps * 32) factored_cells_kernel(const CellsArgs x) {
  extern __shared__ int4 cells_smem[];
  __shared__ uint64_t full[kCellsWarps * kCellsStages];
  __shared__ int4 ring[kCellsWarps * kCellsQueue];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row_ints = x.ka4 + x.kb4;
  int2* masks = reinterpret_cast<int2*>(cells_smem);
  // 16-byte aligned: the masks take a whole number of int4s
  int* stage_rows = reinterpret_cast<int*>(cells_smem) +
                    (kMasksShared ? 2 * ((x.n_masks + 1) & ~1) : 0) +
                    warp * kCellsStages * row_ints;
  uint64_t* bars = full + warp * kCellsStages;
  if (kMasksShared)
    for (int k = threadIdx.x; k < x.n_masks; k += blockDim.x)
      masks[k] = make_int2(__ldg(x.ga + k), __ldg(x.gb + k));
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_warps * kCellsStages; ++i) bar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const auto mask = [&](int k) {
    return kMasksShared ? masks[k] : make_int2(__ldg(x.ga + k), __ldg(x.gb + k));
  };
  const int64_t n_req = *x.n_rows;
  const int n_live = static_cast<int>(n_req < 0 ? 0 : (n_req > x.n_buf ? x.n_buf : n_req));
  const int64_t n_cells = static_cast<int64_t>(x.sa) * x.sb;
  const int stride = gridDim.x * n_warps;
  // this warp's first row at or after i that holds a cell (n_buf if none) and
  // that cell; every row it passes gets (0, 0)
  const auto next = [&](int i, int64_t* c) {
    for (; i < x.n_buf; i += stride) {
      if (i < n_live) {
        *c = __ldg(x.idx + i);
        if (*c >= 0 && *c < n_cells) return i;
      }
      if (lane == 0) x.out[i] = make_float2(0.f, 0.f);
    }
    return x.n_buf;
  };
  // the images of cell c into stage st, counted on its barrier
  const auto stage = [&](int64_t c, int st) {
    if (lane == 0) {
      const int ra = static_cast<int>(c / x.sb);
      const int rb = static_cast<int>(c - static_cast<int64_t>(ra) * x.sb);
      int* dst = stage_rows + st * row_ints;
      // the stage's earlier reads were generic, the copy writes through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive_tx(bars + st, static_cast<unsigned>(row_ints) * 4u);
      bulk_copy(dst, x.pa_t + static_cast<size_t>(ra) * x.ka4, x.ka4 * 4u, bars + st);
      bulk_copy(dst + x.ka4, x.pb_t + static_cast<size_t>(rb) * x.kb4, x.kb4 * 4u, bars + st);
    }
  };

  int64_t c = 0;
  int i = next(blockIdx.x * n_warps + warp, &c);
  if (i < x.n_buf) stage(c, 0);
  for (int it = 0; i < x.n_buf; ++it) {
    int64_t c_next = 0;
    const int i_next = next(i + stride, &c_next);
    const int st = it & 1;
    if (i_next < x.n_buf) stage(c_next, st ^ 1);
    bar_wait(bars + st, (it >> 1) & 1);
    const int* pa_row = stage_rows + st * row_ints;
    const int* pb_row = pa_row + x.ka4;
    const int ra = static_cast<int>(c / x.sb);
    const int rb = static_cast<int>(c - static_cast<int64_t>(ra) * x.sb);
    const int aw = __ldg(x.alpha_words + ra), bw = __ldg(x.beta_words + rb);
    float re = 0.f, im = 0.f;
    int4* q = ring + warp * kCellsQueue;
    int head = 0, count = 0;   // the ring's pending pairs, the same in every lane
    // sums the next min(count, 32) pending pairs, one a lane
    const auto flush = [&]() {
      if (lane < count) {
        const int4 e = q[(head + lane) & (kCellsQueue - 1)];
        const float h = cells_h(x, e.x, aw, bw);
        re = fmaf(h, __int_as_float(e.y), re);
        im = fmaf(h, __int_as_float(e.z), im);
      }
      const int took = count < 32 ? count : 32;
      head += took;
      count -= took;
      __syncwarp();
    };
    for (int k0 = 0; k0 < x.n_masks; k0 += 32 * kCellsBatch) {
      float2 t[kCellsBatch];
#pragma unroll
      for (int b = 0; b < kCellsBatch; ++b) {
        const int k = k0 + 32 * b + lane;
        t[b] = make_float2(0.f, 0.f);
        if (k < x.n_masks) {
          const int2 g = mask(k);
          const int ia = pa_row[g.x], ib = pb_row[g.y];
          if (ia < x.sa && ib < x.sb)
            t[b] = __ldg(x.grid + static_cast<size_t>(ia) * (x.sb + 1) + ib);
        }
      }
#pragma unroll
      for (int b = 0; b < kCellsBatch; ++b) {
        const bool found = t[b].x != 0.f || t[b].y != 0.f;
        const unsigned who = __ballot_sync(kFull, found);
        if (found)
          q[(head + count + __popc(who & ((1u << lane) - 1u))) & (kCellsQueue - 1)] =
              make_int4(k0 + 32 * b + lane, __float_as_int(t[b].x), __float_as_int(t[b].y), 0);
        count += __popc(who);
        __syncwarp();
        if (count >= 32) flush();
      }
    }
    if (count > 0) flush();
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      re += __shfl_xor_sync(kFull, re, d);
      im += __shfl_xor_sync(kFull, im, d);
    }
    if (lane == 0) x.out[i] = make_float2(re, im);
    __syncwarp();   // the stage is read before a later row is staged into it
    i = i_next;
    c = c_next;
  }
}

template <bool kMasksShared>
int launch_cells(const CellsArgs& x, int warps, int smem, cudaStream_t stream) {
  const auto kernel = factored_cells_kernel<kMasksShared>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // a persistent grid: as many blocks as the card holds at once, no more warps than rows
  int device = 0, per_sm = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, smem);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int need = (x.n_buf + warps - 1) / warps;
  const int blocks = per_sm * sms < need ? per_sm * sms : need;
  kernel<<<blocks, warps * 32, smem, stream>>>(x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int factored_cells_accumulate(const void* pa_t, const void* pb_t, const void* ga,
                                         const void* gb, const void* alpha_words,
                                         const void* beta_words, const void* slot_off,
                                         const void* slots, const void* grid, const void* idx,
                                         const void* n_rows, void* out, int n_masks, int n_buf,
                                         int sa, int sb, int ka4, int kb4, void* stream) {
  // an image row is whole 16-byte pieces, for the bulk copies
  if (ka4 <= 0 || kb4 <= 0 || ka4 % 4 || kb4 % 4 || n_masks < 0 || n_buf < 0 ||
      static_cast<int64_t>(sa + 1) * (sb + 1) >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_buf == 0) return 0;
  CellsArgs x;
  x.pa_t = static_cast<const int32_t*>(pa_t);
  x.pb_t = static_cast<const int32_t*>(pb_t);
  x.ga = static_cast<const int32_t*>(ga);
  x.gb = static_cast<const int32_t*>(gb);
  x.alpha_words = static_cast<const int32_t*>(alpha_words);
  x.beta_words = static_cast<const int32_t*>(beta_words);
  x.slot_off = static_cast<const int32_t*>(slot_off);
  x.slots = static_cast<const int4*>(slots);
  x.grid = static_cast<const float2*>(grid);
  x.idx = static_cast<const int64_t*>(idx);
  x.n_rows = static_cast<const int64_t*>(n_rows);
  x.out = static_cast<float2*>(out);
  x.n_masks = n_masks;
  x.n_buf = n_buf;
  x.sa = sa;
  x.sb = sb;
  x.ka4 = ka4;
  x.kb4 = kb4;
  int device = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the masks' (ga, gb) go to shared memory where they fit beside every warp's
  // stages; else they are read through the read-only cache, and a block has
  // as many warps as their stages leave room for
  const int64_t room = optin - static_cast<int64_t>(sizeof(uint64_t)) * kCellsWarps * kCellsStages -
                       static_cast<int64_t>(sizeof(int4)) * kCellsWarps * kCellsQueue;
  const int64_t warp_bytes = int64_t{4} * (ka4 + kb4) * kCellsStages;
  const int64_t mask_bytes = int64_t{8} * ((n_masks + 1) & ~1);
  const bool masks_shared = mask_bytes + kCellsWarps * warp_bytes <= room;
  const int64_t fit = masks_shared ? kCellsWarps : room / warp_bytes;
  const int warps = static_cast<int>(fit < kCellsWarps ? fit : kCellsWarps);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>((masks_shared ? mask_bytes : 0) + warps * warp_bytes);
  const auto st = static_cast<cudaStream_t>(stream);
  return masks_shared ? launch_cells<true>(x, warps, smem, st)
                      : launch_cells<false>(x, warps, smem, st);
}

extern "C" int dense_grid_accumulate(const void* r1_idx, const void* row_map,
                                     const void* h_dense, const void* grid_t, void* out,
                                     void* partial, void* arrivals, int n_masks, int n_ranges,
                                     int sa, int sb, void* stream) {
  const int threads = block_threads(sa, kDenseThreads);
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

// words of a bitmap row of n bits: whole 16-byte pieces, for the bulk copies
int xl_row_words(int n_bits) { return (n_bits + 127) / 128 * 4; }

extern "C" int xl_grid_accumulate(const void* pa_idx, const void* pb_idx,
                                  const void* alpha_words, const void* beta_words,
                                  const void* cells_off, const void* tiles, const void* prog,
                                  const void* chunks, const void* grid, void* grid_t, void* bits_a,
                                  void* bits_b, void* any_a, void* any_b, void* out, int n_tiles,
                                  int n_chunks, int n_col_chunks, int n_prog, int sa, int sb,
                                  int tile_cells, int chunk_int4, void* stream) {
  // a tile is at most what the consumer warps own, a chunk's headers what a stage holds
  if (tile_cells != kXlTileCells || chunk_int4 != kChunkInt4 || n_tiles < 0 || n_col_chunks < 0 ||
      n_col_chunks > n_chunks || n_prog >= 1 << kHeadBits ||
      static_cast<int64_t>(sa + 1) * (sb + 1) >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  XlArgs x;
  x.pa_idx = static_cast<const int32_t*>(pa_idx);
  x.pb_idx = static_cast<const int32_t*>(pb_idx);
  x.alpha_words = static_cast<const int32_t*>(alpha_words);
  x.beta_words = static_cast<const int32_t*>(beta_words);
  x.cells_off = static_cast<const int32_t*>(cells_off);
  x.tiles = static_cast<const int4*>(tiles);
  x.prog = static_cast<const int4*>(prog);
  x.chunks = static_cast<const int4*>(chunks);
  x.grid = static_cast<const float2*>(grid);
  x.grid_t = static_cast<float2*>(grid_t);
  x.bits_a = static_cast<uint32_t*>(bits_a);
  x.bits_b = static_cast<uint32_t*>(bits_b);
  x.any_a = static_cast<int*>(any_a);
  x.any_b = static_cast<int*>(any_b);
  x.out = static_cast<float2*>(out);
  x.n_tiles = n_tiles;
  x.n_chunks = n_chunks;
  x.n_col_chunks = n_col_chunks;
  x.sa = sa;
  x.sb = sb;
  x.wa = xl_row_words(sa + 1);
  x.wb = xl_row_words(sb + 1);
  const int row_words = x.wa > x.wb ? x.wa : x.wb;
  const int smem = static_cast<int>(sizeof(int4)) * kXlWarps * kRing * kChunkHeads +
                   static_cast<int>(sizeof(float2)) * kXlWarps * kXlTileCells +
                   4 * kXlWarps * kRing * row_words;
  cudaError_t rc = cudaFuncSetAttribute(xl_grid_accumulate_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // as many blocks as the card holds at once: a cooperative launch may not ask for more
  int device = 0, per_sm = 0, sms = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xl_grid_accumulate_kernel,
                                                       kXlThreads, smem);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  void* params[] = {&x};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(xl_grid_accumulate_kernel), dim3(per_sm * sms),
      dim3(kXlThreads), params, smem, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* grid_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
