/* Mirror of the reference's test/test1f.F call sequence through the F77
 * ABI (the calls a gfortran build of test1f would emit): file-driven
 * solve — read matrix (+ optional b/x), default b when the file carries
 * none, solve with command-line options, report iters/times/residual,
 * write the solution and residual history. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "lisf_tpu.h"

int main(int argc, char** argv) {
    lisf_int ierr, A, b, x, u, solver;
    lisf_int comm = 0, matrix_type = LIS_MATRIX_CSR, fmt_mm = LIS_FMT_MM;
    lisf_int n, gn, rhs, iter, iter_double, iter_quad, nsol;
    double time, itime, ptime, p_c_time, p_i_time, resid, one = 1.0;
    char solvername[21];

    lis_initialize_(&ierr);

    if (argc < 5) {
        printf("Usage: test1f matrix_filename rhs_setting "
               "solution_filename rhistory_filename [options]\n");
        lis_finalize_(&ierr);
        return 1;
    }
    rhs = strcmp(argv[2], "0") == 0 ? 0
        : strcmp(argv[2], "1") == 0 ? 1
        : strcmp(argv[2], "2") == 0 ? 2 : -1;

    printf("\nnumber of processes = 1\n");

    lis_matrix_create_(&comm, &A, &ierr);
    chkerr_(&ierr);
    lis_vector_create_(&comm, &b, &ierr);
    chkerr_(&ierr);
    lis_vector_create_(&comm, &x, &ierr);
    chkerr_(&ierr);
    lis_matrix_set_type_(&A, &matrix_type, &ierr);
    lis_input_(&A, &b, &x, argv[1], &ierr, (long)strlen(argv[1]));
    chkerr_(&ierr);

    lis_vector_duplicate_(&A, &u, &ierr);
    lis_matrix_get_size_(&A, &n, &gn, &ierr);
    chkerr_(&ierr);

    lis_vector_is_null_(&b, &ierr);
    if (ierr == LIS_TRUE) {
        lis_vector_destroy_(&b, &ierr);
        lis_vector_duplicate_(&A, &b, &ierr);
        chkerr_(&ierr);
        if (rhs == 0) {
            lis_finalize_(&ierr);
            return 0;
        } else if (rhs == 1) {
            lis_vector_set_all_(&one, &b, &ierr);
        } else {
            lis_vector_set_all_(&one, &u, &ierr);
            lis_matvec_(&A, &u, &b, &ierr);
        }
    }
    if (rhs == -1) {
        lis_input_vector_(&b, argv[2], &ierr, (long)strlen(argv[2]));
        chkerr_(&ierr);
    }

    lis_vector_is_null_(&x, &ierr);
    if (ierr == LIS_TRUE) {
        lis_vector_destroy_(&x, &ierr);
        lis_vector_duplicate_(&u, &x, &ierr);
        chkerr_(&ierr);
    }

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

    lis_output_vector_(&x, &fmt_mm, argv[3], &ierr, (long)strlen(argv[3]));
    lis_solver_output_rhistory_(&solver, argv[4], &ierr,
                                (long)strlen(argv[4]));

    lis_solver_destroy_(&solver, &ierr);
    lis_vector_destroy_(&u, &ierr);
    lis_vector_destroy_(&x, &ierr);
    lis_vector_destroy_(&b, &ierr);
    lis_matrix_destroy_(&A, &ierr);

    lis_finalize_(&ierr);
    return 0;
}
