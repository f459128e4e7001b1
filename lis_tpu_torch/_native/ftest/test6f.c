/* Mirror of the reference's test/test6f.F90 call sequence through the
 * F77 ABI: dense m×n 2-D Laplacian in a column-major array, direct
 * solve via lis_array_solve, relative residual via array xpay/nrm2. */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "lisf_tpu.h"

static double wtime(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

int main(int argc, char** argv) {
    lisf_int ierr, m, n, nn, nnz, ins = LIS_INS_VALUE;
    double zero = 0.0, one = 1.0, neg1 = -1.0;
    double time, time0, resid_r, resid_b;

    lis_initialize_(&ierr);

    if (argc < 3) {
        printf("Usage: test6f m n\n");
        lis_finalize_(&ierr);
        return 1;
    }
    m = atol(argv[1]);
    n = atol(argv[2]);
    nn = m * n;

    double* a = malloc((size_t)(nn * nn) * sizeof(double));
    double* b = malloc((size_t)nn * sizeof(double));
    double* x = malloc((size_t)nn * sizeof(double));
    double* u = malloc((size_t)nn * sizeof(double));
    double* w = malloc((size_t)(nn * nn) * sizeof(double));

    lisf_int nn2 = nn * nn;
    lis_array_set_all_(&nn2, &zero, a, &ierr);

    nnz = 0;
    for (lisf_int ii = 0; ii < nn; ++ii) {
        lisf_int i = ii / m, j = ii - i * m, jj;
        if (i > 0)     { jj = ii - m; a[ii + nn * jj] = -1.0; ++nnz; }
        if (i < n - 1) { jj = ii + m; a[ii + nn * jj] = -1.0; ++nnz; }
        if (j > 0)     { jj = ii - 1; a[ii + nn * jj] = -1.0; ++nnz; }
        if (j < m - 1) { jj = ii + 1; a[ii + nn * jj] = -1.0; ++nnz; }
        a[ii + nn * ii] = 4.0; ++nnz;
    }
    printf("matrix size = %ld x %ld (%ld nonzero entries)\n\n",
           (long)nn, (long)nn, (long)nnz);

    lis_array_set_all_(&nn, &one, u, &ierr);
    lis_array_matvec_(&nn, a, u, b, &ins, &ierr);

    time0 = wtime();
    lis_array_solve_(&nn, a, b, x, w, &ierr);
    time = wtime() - time0;

    lis_array_xpay_(&nn, x, &neg1, u, &ierr);
    lis_array_nrm2_(&nn, u, &resid_r, &ierr);
    lis_array_nrm2_(&nn, b, &resid_b, &ierr);

    printf("Direct: elapsed time         = %e sec.\n", time);
    printf("Direct:   linear solver      = %e sec.\n", time);
    printf("Direct: relative residual    = %e\n\n", resid_r / resid_b);

    free(a); free(b); free(x); free(u); free(w);
    lis_finalize_(&ierr);
    return 0;
}
