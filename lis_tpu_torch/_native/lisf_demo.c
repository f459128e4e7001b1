/* Drives liblisf_tpu.so through the FORTRAN ABI: trailing-underscore
 * symbols, all-by-reference args, hidden string lengths — i.e. the exact
 * call sequence a gfortran-compiled test4f.f would emit (the reference's
 * Fortran smoke test: 12x12 tridiagonal via set_value, CG solve). */
#include <stdio.h>
#include <stdlib.h>

typedef long lisf_int;
extern void lis_initialize_(lisf_int*);
extern void lis_finalize_(lisf_int*);
extern void lis_matrix_create_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_set_size_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_set_value_(lisf_int*, lisf_int*, lisf_int*, double*,
                                  lisf_int*, lisf_int*);
extern void lis_matrix_assemble_(lisf_int*, lisf_int*);
extern void lis_vector_create_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_vector_set_size_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_vector_set_all_(double*, lisf_int*, lisf_int*);
extern void lis_vector_get_value_(lisf_int*, lisf_int*, double*, lisf_int*);
extern void lis_solver_create_(lisf_int*, lisf_int*);
extern void lis_solver_set_option_(const char*, lisf_int*, lisf_int*, long);
extern void lis_solve_(lisf_int*, lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_iter_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_residualnorm_(lisf_int*, double*, lisf_int*);

int main(void) {
    lisf_int ierr, A, b, x, solver;
    lisf_int comm = 0, zero = 0, n = 12, ins = 0;
    double v, one = 1.0;

    lis_initialize_(&ierr);
    if (ierr) { printf("init failed\n"); return 1; }

    lis_matrix_create_(&comm, &A, &ierr);
    lis_matrix_set_size_(&A, &zero, &n, &ierr);
    for (lisf_int i = 0; i < n; ++i) {
        v = 2.0;
        lis_matrix_set_value_(&ins, &i, &i, &v, &A, &ierr);
        if (i > 0) {
            lisf_int j = i - 1; v = -1.0;
            lis_matrix_set_value_(&ins, &i, &j, &v, &A, &ierr);
        }
        if (i < n - 1) {
            lisf_int j = i + 1; v = -1.0;
            lis_matrix_set_value_(&ins, &i, &j, &v, &A, &ierr);
        }
    }
    lis_matrix_assemble_(&A, &ierr);

    lis_vector_create_(&comm, &b, &ierr);
    lis_vector_set_size_(&b, &zero, &n, &ierr);
    lis_vector_set_all_(&one, &b, &ierr);
    lis_vector_create_(&comm, &x, &ierr);
    lis_vector_set_size_(&x, &zero, &n, &ierr);

    lis_solver_create_(&solver, &ierr);
    {
        const char* opt = "-i cg -tol 1.0e-12";
        lis_solver_set_option_(opt, &solver, &ierr, (long)18);
    }
    lis_solve_(&A, &b, &x, &solver, &ierr);
    if (ierr != 0) { printf("solve status %ld\n", (long)ierr); return 2; }

    lisf_int iter;
    double resid;
    lis_solver_get_iter_(&solver, &iter, &ierr);
    lis_solver_get_residualnorm_(&solver, &resid, &ierr);
    lisf_int mid = n / 2;
    lis_vector_get_value_(&x, &mid, &v, &ierr);
    printf("iters=%ld resid=%e x[6]=%f\n", (long)iter, resid, v);
    /* exact solution x_i = (i+1)(n-i)/2; x[6]=7*6/2=21 */
    if (iter <= 0 || resid > 1e-10 || v < 20.9 || v > 21.1) return 3;
    printf("F77-ABI binding OK\n");
    lis_finalize_(&ierr);
    return 0;
}
