/* Mirror of the reference's test/test8f.F90 PSD call sequence through
 * the F77 ABI: the Preconditioner-and-Solver-Decoupled workflow on the
 * 1-D diffusion operator test8f assembles — bind the matrix to the
 * solver, lis_precon_psd_create WITHOUT solving, lis_solve_kernel with
 * the external preconditioner, then a "nonlinear update" pass:
 * lis_matrix_psd_set_value on the assembled structure,
 * lis_precon_psd_update, psd_reset_scale, solve again.  (The reference
 * program wraps this flow in a nonlinear time loop and gnuplot output;
 * the lis API surface exercised is identical.) */
#include <stdio.h>
#include <stdlib.h>
#include "lisf_tpu.h"

int main(int argc, char** argv) {
    lisf_int ierr, A, bvec, xvec, solver, precon;
    lisf_int comm = 0, zero = 0, n = 50, is, ie, iter1, iter2;
    lisf_int ins = LIS_INS_VALUE, add = LIS_ADD_VALUE;
    double one = 1.0, diag = 2.5, off = -1.0, bump = 2.0, resid;

    lis_initialize_(&ierr); chkerr_(&ierr);
    if (argc > 1) n = atol(argv[1]);

    lis_matrix_create_(&comm, &A, &ierr); chkerr_(&ierr);
    lis_matrix_set_size_(&A, &zero, &n, &ierr); chkerr_(&ierr);
    lis_matrix_get_range_(&A, &is, &ie, &ierr); chkerr_(&ierr);
    for (lisf_int i = is - 1; i <= ie - 2; ++i) {   /* range is 1-based F77 */
        lisf_int jm = i - 1, jp = i + 1;
        if (i > 0)     lis_matrix_set_value_(&ins, &i, &jm, &off, &A, &ierr);
        if (i < n - 1) lis_matrix_set_value_(&ins, &i, &jp, &off, &A, &ierr);
        lis_matrix_set_value_(&ins, &i, &i, &diag, &A, &ierr);
    }
    lis_matrix_assemble_(&A, &ierr); chkerr_(&ierr);

    lis_vector_create_(&comm, &bvec, &ierr);
    lis_vector_set_size_(&bvec, &zero, &n, &ierr);
    lis_vector_set_all_(&one, &bvec, &ierr);
    lis_vector_duplicate_(&bvec, &xvec, &ierr); chkerr_(&ierr);

    lis_solver_create_(&solver, &ierr); chkerr_(&ierr);
    lis_solver_set_option_("-i bicgstab -p ilu -tol 1e-12", &solver, &ierr,
                           29);
    lis_solver_set_matrix_(&A, &solver, &ierr); chkerr_(&ierr);
    lis_precon_psd_create_(&solver, &precon, &ierr); chkerr_(&ierr);

    lis_solve_kernel_(&A, &bvec, &xvec, &solver, &precon, &ierr);
    chkerr_(&ierr);
    lis_solver_get_iter_(&solver, &iter1, &ierr);
    lis_solver_get_residualnorm_(&solver, &resid, &ierr);
    printf("pass 1: iters = %ld, resid = %e\n", (long)iter1, resid);

    /* nonlinear refresh: strengthen the diagonal in the assembled
     * structure, re-factor the preconditioner, reset scale flags */
    for (lisf_int i = 0; i < n; ++i) {
        lis_matrix_psd_set_value_(&add, &i, &i, &bump, &A, &ierr);
        chkerr_(&ierr);
    }
    lis_precon_psd_update_(&solver, &precon, &ierr); chkerr_(&ierr);
    lis_matrix_psd_reset_scale_(&A, &ierr); chkerr_(&ierr);
    lis_vector_psd_reset_scale_(&bvec, &ierr); chkerr_(&ierr);

    lis_solve_kernel_(&A, &bvec, &xvec, &solver, &precon, &ierr);
    chkerr_(&ierr);
    lis_solver_get_iter_(&solver, &iter2, &ierr);
    lis_solver_get_residualnorm_(&solver, &resid, &ierr);
    printf("pass 2: iters = %ld, resid = %e\n", (long)iter2, resid);

    lis_precon_destroy_(&precon, &ierr);
    lis_solver_destroy_(&solver, &ierr);
    lis_matrix_destroy_(&A, &ierr);
    lis_vector_destroy_(&bvec, &ierr);
    lis_vector_destroy_(&xvec, &ierr);
    lis_finalize_(&ierr);
    return 0;
}
