// naqs_host: native host-side kernels for the naqs_tpu framework.
//
// The TPU owns the training hot path (XLA/Pallas); these C++ kernels own the
// host-side heavy lifting the reference did in Cython/OpenMP (src_cpp/):
//   * restricted-basis enumeration      (hilbert_math.pyx equivalent)
//   * sparse Hamiltonian (COO) assembly (hamiltonian_math.pyx get_Hij_cy +
//     sparse-matrix construction equivalent), used by the sampled-subspace
//     FCI refinement (solve_H) and exact-diagonalization checks
//   * CSR x dense complex mat-vec       (sparse_math.pyx equivalent)
//
// Plain C ABI; Python binds with ctypes (no pybind11 dependency).
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC naqs_host.cpp -o libnaqs_host.so

#include <cstdint>
#include <cstring>
#include <atomic>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int parity_pm1(uint64_t x) {
    return 1 - 2 * (__builtin_popcountll(x) & 1);
}

// binary search; returns index of key in sorted arr or -1
inline int64_t bsearch_u64(const uint64_t* arr, int64_t n, uint64_t key) {
    int64_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int64_t mid = lo + ((hi - lo) >> 1);
        uint64_t v = arr[mid];
        if (v == key) return mid;
        if (v < key) lo = mid + 1; else hi = mid - 1;
    }
    return -1;
}

}  // namespace

extern "C" {

// Next bit-combination in lexicographic order (Gosper's hack semantics on
// compact slot indices is handled in enumerate_combinations directly).
//
// Enumerate all C(s, n) subsets of `s` slots, mapping slot i to weight[i];
// writes packed uint64 sums. Returns the count written.
int64_t naqs_enumerate_combinations(
    int32_t s, int32_t n, const uint64_t* weights, uint64_t* out, int64_t cap) {
    if (n < 0 || n > s) return 0;
    if (n == 0) { if (cap < 1) return -1; out[0] = 0; return 1; }
    int32_t idx[64];
    for (int32_t i = 0; i < n; ++i) idx[i] = i;
    int64_t count = 0;
    while (true) {
        if (count >= cap) return -1;
        uint64_t v = 0;
        for (int32_t i = 0; i < n; ++i) v += weights[idx[i]];
        out[count++] = v;
        // advance combination
        int32_t i = n - 1;
        while (i >= 0 && idx[i] == s - n + i) --i;
        if (i < 0) break;
        ++idx[i];
        for (int32_t j = i + 1; j < n; ++j) idx[j] = idx[j - 1] + 1;
    }
    return count;
}

// Parity of popcount(x & mask) as +-1 int8, elementwise (OpenMP).
void naqs_popcount_parity(
    const uint64_t* x, int64_t n, uint64_t mask, int8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) out[i] = (int8_t)parity_pm1(x[i] & mask);
}

// Assemble H over a sorted packed-state basis in COO form.
//
// Terms arrive grouped by unique flip mask: for group g in [0, n_groups):
// flip mask xy[g], terms k in [off[g], off[g+1]) with sign masks yz[k] and
// coefficients coeff[k]. Diagonal handled separately (diag_yz/diag_coeff).
// Couplings to states outside the basis are dropped (reference semantics).
//
// rows/cols/vals must have capacity cap. Returns nnz, or -1 on overflow.
// The _rows variant assembles only rows [row0, row1) (columns still search
// the FULL basis): peak COO memory becomes O(block), so arbitrarily large
// bases assemble in bounded memory (a 1.66M-state full assembly OOM-killed
// a 125 GB host through the single-shot worst-case capacity allocation).
int64_t naqs_assemble_h_rows(
    const uint64_t* basis, int64_t n, int64_t row0, int64_t row1,
    const uint64_t* xy, const int64_t* off, int64_t n_groups,
    const uint64_t* yz, const double* coeff,
    const uint64_t* diag_yz, const double* diag_coeff, int64_t n_diag,
    int64_t* rows, int64_t* cols, double* vals, int64_t cap) {
    std::atomic<int64_t> cursor(0);
    std::atomic<bool> overflow(false);

#pragma omp parallel
    {
        // thread-local staging to avoid per-entry atomics
        const int64_t BUF = 4096;
        int64_t r_buf[BUF], c_buf[BUF];
        double v_buf[BUF];
        int64_t nbuf = 0;

        auto flush = [&]() {
            if (nbuf == 0) return;
            int64_t base = cursor.fetch_add(nbuf);
            if (base + nbuf > cap) { overflow.store(true); nbuf = 0; return; }
            std::memcpy(rows + base, r_buf, nbuf * sizeof(int64_t));
            std::memcpy(cols + base, c_buf, nbuf * sizeof(int64_t));
            std::memcpy(vals + base, v_buf, nbuf * sizeof(double));
            nbuf = 0;
        };

#pragma omp for schedule(dynamic, 64)
        for (int64_t m = row0; m < row1; ++m) {
            if (overflow.load(std::memory_order_relaxed)) continue;
            const uint64_t s = basis[m];
            // diagonal
            double d = 0.0;
            for (int64_t k = 0; k < n_diag; ++k)
                d += diag_coeff[k] * parity_pm1(s & diag_yz[k]);
            r_buf[nbuf] = m; c_buf[nbuf] = m; v_buf[nbuf] = d;
            if (++nbuf == BUF) flush();
            // off-diagonal groups
            for (int64_t g = 0; g < n_groups; ++g) {
                const int64_t col = bsearch_u64(basis, n, s ^ xy[g]);
                if (col < 0) continue;
                double h = 0.0;
                for (int64_t k = off[g]; k < off[g + 1]; ++k)
                    h += coeff[k] * parity_pm1(s & yz[k]);
                r_buf[nbuf] = m; c_buf[nbuf] = col; v_buf[nbuf] = h;
                if (++nbuf == BUF) flush();
            }
        }
        flush();
    }
    if (overflow.load()) return -1;
    return cursor.load();
}

int64_t naqs_assemble_h(
    const uint64_t* basis, int64_t n,
    const uint64_t* xy, const int64_t* off, int64_t n_groups,
    const uint64_t* yz, const double* coeff,
    const uint64_t* diag_yz, const double* diag_coeff, int64_t n_diag,
    int64_t* rows, int64_t* cols, double* vals, int64_t cap) {
    return naqs_assemble_h_rows(basis, n, 0, n, xy, off, n_groups, yz, coeff,
                                diag_yz, diag_coeff, n_diag,
                                rows, cols, vals, cap);
}

// Local energies E_loc(m) = sum_g H[m, col(g)] * psi[col]/psi[m] over a
// sorted sample set with (re, im) amplitude arrays. Reference-equivalent
// CPU baseline path (sparse_math.pyx sparse_dense_mv fused with assembly).
void naqs_local_energy(
    const uint64_t* states, int64_t n,
    const double* psi_re, const double* psi_im,
    const uint64_t* xy, const int64_t* off, int64_t n_groups,
    const uint64_t* yz, const double* coeff,
    const uint64_t* diag_yz, const double* diag_coeff, int64_t n_diag,
    double* e_re, double* e_im) {
#pragma omp parallel for schedule(dynamic, 32)
    for (int64_t m = 0; m < n; ++m) {
        const uint64_t s = states[m];
        double acc_re = 0.0, acc_im = 0.0;
        for (int64_t k = 0; k < n_diag; ++k)
            acc_re += diag_coeff[k] * parity_pm1(s & diag_yz[k]);
        const double pr = psi_re[m], pi = psi_im[m];
        const double den = pr * pr + pi * pi;
        for (int64_t g = 0; g < n_groups; ++g) {
            const int64_t col = bsearch_u64(states, n, s ^ xy[g]);
            if (col < 0) continue;
            double h = 0.0;
            for (int64_t k = off[g]; k < off[g + 1]; ++k)
                h += coeff[k] * parity_pm1(s & yz[k]);
            // psi[col] / psi[m] = psi[col] * conj(psi[m]) / |psi[m]|^2
            const double rr = (psi_re[col] * pr + psi_im[col] * pi) / den;
            const double ri = (psi_im[col] * pr - psi_re[col] * pi) / den;
            acc_re += h * rr;
            acc_im += h * ri;
        }
        e_re[m] = acc_re;
        e_im[m] = acc_im;
    }
}

// CSR (real f64) x dense complex vector: y = M x  (reference sparse_dense_mv)
void naqs_csr_matvec_complex(
    const int64_t* indptr, const int64_t* indices, const double* data,
    int64_t n_rows,
    const double* x_re, const double* x_im,
    double* y_re, double* y_im) {
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t r = 0; r < n_rows; ++r) {
        double acc_re = 0.0, acc_im = 0.0;
        for (int64_t j = indptr[r]; j < indptr[r + 1]; ++j) {
            const double v = data[j];
            acc_re += v * x_re[indices[j]];
            acc_im += v * x_im[indices[j]];
        }
        y_re[r] = acc_re;
        y_im[r] = acc_im;
    }
}

}  // extern "C"
