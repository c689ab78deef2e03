// Batched eigen-decomposition of symmetric 3x3 float32 matrices through
// LAPACK's ssyevd, called by pointer.
//
// The reference's ``jnp.linalg.eigh`` on the CPU is jaxlib's LAPACK
// ``ssyevd`` (jobz 'V', uplo 'L'), and jaxlib takes that routine from
// scipy's ``scipy.linalg.cython_lapack``.  The caller passes the same
// routine's address (``native.ssyevd3_batch``), so values and vectors are
// the reference's bit for bit on the same host.  The loop is sequential:
// each matrix is independent, but LAPACK's thread safety under concurrent
// calls is not assumed.

#include <cstdint>
#include <cmath>
#include <limits>

namespace {

// scipy.linalg.cython_lapack's signature for ssyevd (LP64 ints).
typedef void (*ssyevd_t)(char* jobz, char* uplo, int* n, float* a, int* lda,
                         float* w, float* work, int* lwork, int* iwork,
                         int* liwork, int* info);

constexpr int kLwork = 1 + 6 * 3 + 2 * 3 * 3;   // 37: jobz 'V', n 3
constexpr int kLiwork = 3 + 5 * 3;              // 18

}  // namespace

extern "C" {

// cov: (n, 3, 3) row-major.  w: (n, 3) ascending eigenvalues.  v: (n, 3, 3)
// row-major with v[i, :, j] the j-th eigenvector, as jnp.linalg.eigh
// returns them.  A matrix whose ssyevd reports info != 0 gets NaN values
// and vectors, as jaxlib returns.  Returns the count of such matrices, or
// -1 on a bad argument.
int64_t rbv_ssyevd3_batch(void* ssyevd, const float* cov, int64_t n,
                          float* w, float* v) {
    if (ssyevd == nullptr || n < 0) return -1;
    ssyevd_t fn = reinterpret_cast<ssyevd_t>(ssyevd);
    const float nan = std::numeric_limits<float>::quiet_NaN();
    char jobz = 'V', uplo = 'L';
    int three = 3, lwork = kLwork, liwork = kLiwork;
    float work[kLwork];
    int iwork[kLiwork];
    int64_t failed = 0;
    for (int64_t m = 0; m < n; ++m) {
        const float* c = cov + 9 * m;
        float a[9];
        for (int r = 0; r < 3; ++r)
            for (int col = 0; col < 3; ++col)
                a[col * 3 + r] = c[r * 3 + col];   // column-major
        int info = 0;
        fn(&jobz, &uplo, &three, a, &three, w + 3 * m, work, &lwork, iwork,
           &liwork, &info);
        float* out = v + 9 * m;
        if (info != 0) {
            ++failed;
            for (int i = 0; i < 3; ++i) w[3 * m + i] = nan;
            for (int i = 0; i < 9; ++i) out[i] = nan;
            continue;
        }
        for (int r = 0; r < 3; ++r)
            for (int col = 0; col < 3; ++col)
                out[r * 3 + col] = a[col * 3 + r];  // back to row-major
    }
    return failed;
}

}  // extern "C"
