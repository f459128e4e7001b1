/* Mirror of the reference's test/test2f.F90 call sequence through the
 * F77 ABI: assemble an m×n 2-D Laplacian directly via lis_matrix_set_csr
 * (caller-owned ptr/index/value buffers), convert to the requested
 * storage type, solve with command-line options, report, write solution
 * and residual history. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "lisf_tpu.h"

int main(int argc, char** argv) {
    lisf_int ierr, A, A0, b, x, u, solver;
    lisf_int comm = 0, zero = 0;
    lisf_int matrix_type, m, n, nn, nnz;
    lisf_int is, ie, iter, iter_double, iter_quad, nsol;
    double time, itime, ptime, p_c_time, p_i_time, resid, one = 1.0;
    char solvername[21];

    lis_initialize_(&ierr);

    if (argc < 6) {
        printf("Usage: test2f m n matrix_type solution_filename "
               "residual_filename [options]\n");
        lis_finalize_(&ierr);
        return 1;
    }
    m = atol(argv[1]);
    n = atol(argv[2]);
    matrix_type = atol(argv[3]);

    printf("\nnumber of processes = 1\n");

    nn = m * n;
    lis_matrix_create_(&comm, &A, &ierr);
    chkerr_(&ierr);
    lis_matrix_set_size_(&A, &zero, &nn, &ierr);
    chkerr_(&ierr);

    lisf_int* ptr = malloc((size_t)(nn + 1) * sizeof(lisf_int));
    lisf_int* index = malloc((size_t)(5 * nn) * sizeof(lisf_int));
    double* value = malloc((size_t)(5 * nn) * sizeof(double));

    lis_matrix_get_range_(&A, &is, &ie, &ierr);
    lisf_int ctr = 0;
    for (lisf_int ii = is - 1; ii <= ie - 2; ++ii) {
        lisf_int i = ii / m, j = ii - i * m;
        if (i > 0)     { index[ctr] = ii - m; value[ctr] = -1.0; ++ctr; }
        if (i < n - 1) { index[ctr] = ii + m; value[ctr] = -1.0; ++ctr; }
        if (j > 0)     { index[ctr] = ii - 1; value[ctr] = -1.0; ++ctr; }
        if (j < m - 1) { index[ctr] = ii + 1; value[ctr] = -1.0; ++ctr; }
        index[ctr] = ii; value[ctr] = 4.0; ++ctr;
        ptr[ii - (is - 1) + 1] = ctr;
    }
    ptr[0] = 0;
    lis_matrix_set_csr_(&ptr[ie - is], ptr, index, value, &A, &ierr);
    chkerr_(&ierr);
    lis_matrix_assemble_(&A, &ierr);
    chkerr_(&ierr);
    lis_matrix_get_nnz_(&A, &nnz, &ierr);

    printf("matrix size = %ld x %ld (%ld nonzero entries)\n\n",
           (long)nn, (long)nn, (long)nnz);

    lis_matrix_duplicate_(&A, &A0, &ierr);
    chkerr_(&ierr);
    lis_matrix_set_type_(&A0, &matrix_type, &ierr);
    lis_matrix_convert_(&A, &A0, &ierr);
    chkerr_(&ierr);
    lis_matrix_destroy_(&A, &ierr);
    A = A0;

    lis_vector_duplicate_(&A, &u, &ierr);
    chkerr_(&ierr);
    lis_vector_duplicate_(&A, &b, &ierr);
    chkerr_(&ierr);
    lis_vector_duplicate_(&A, &x, &ierr);
    chkerr_(&ierr);

    lis_vector_set_all_(&one, &u, &ierr);
    lis_matvec_(&A, &u, &b, &ierr);

    lis_solver_create_(&solver, &ierr);
    chkerr_(&ierr);
    lis_solver_set_option_("-print mem", &solver, &ierr, 10L);
    lis_solver_set_optionc_(&solver, &ierr);
    chkerr_(&ierr);

    lis_solve_(&A, &b, &x, &solver, &ierr);
    chkerr_(&ierr);

    lis_solver_get_iterex_(&solver, &iter, &iter_double, &iter_quad, &ierr);
    lis_solver_get_timeex_(&solver, &time, &itime, &ptime, &p_c_time,
                           &p_i_time, &ierr);
    lis_solver_get_residualnorm_(&solver, &resid, &ierr);
    lis_solver_get_solver_(&solver, &nsol, &ierr);
    lis_solver_get_solvername_(&nsol, solvername, &ierr, 20L);
    solvername[20] = '\0';
    for (int k = 19; k >= 0 && solvername[k] == ' '; --k) solvername[k] = 0;

    printf("%s: number of iterations = %ld\n", solvername, (long)iter);
    printf("%s:   double             = %ld\n", solvername,
           (long)iter_double);
    printf("%s:   quad               = %ld\n", solvername, (long)iter_quad);
    printf("%s: elapsed time         = %e sec.\n", solvername, time);
    printf("%s:   preconditioner     = %e sec.\n", solvername, ptime);
    printf("%s:     matrix creation  = %e sec.\n", solvername, p_c_time);
    printf("%s:   linear solver      = %e sec.\n", solvername, itime);
    printf("%s: relative residual    = %e\n\n", solvername, resid);

    lisf_int fmt_mm = LIS_FMT_MM;
    lis_output_vector_(&x, &fmt_mm, argv[4], &ierr, (long)strlen(argv[4]));
    lis_solver_output_rhistory_(&solver, argv[5], &ierr,
                                (long)strlen(argv[5]));

    lis_solver_destroy_(&solver, &ierr);
    lis_matrix_destroy_(&A, &ierr);
    lis_vector_destroy_(&u, &ierr);
    lis_vector_destroy_(&x, &ierr);
    lis_vector_destroy_(&b, &ierr);

    free(ptr); free(index); free(value);
    lis_finalize_(&ierr);
    return 0;
}
