/* Mirror of the reference's test/etest4f.F call sequence through the
 * F77 ABI: assemble the 1-D Laplacian tridiag(-1, 2, -1) of size n via
 * lis_matrix_set_value over the matrix range, x := 1, eigensolve with
 * command-line options (-e via set_optionC), then the full getter set
 * (iterex, timeex, residualnorm, esolver name). */
#include <stdio.h>
#include <stdlib.h>
#include "lisf_tpu.h"

int main(int argc, char** argv) {
    lisf_int ierr, A, x, esolver;
    lisf_int comm = 0, zero = 0, n, gn, nnz, is, ie;
    lisf_int iter, iter_double, iter_quad, nsol;
    lisf_int ins = LIS_INS_VALUE;
    double evalue0, resid, time, itime, ptime, p_c_time, p_i_time;
    double one = 1.0, two = 2.0, neg1 = -1.0;
    char esolvername[21];

    lis_initialize_(&ierr); chkerr_(&ierr);

    if (argc < 2) {
        printf("etest4f n [options]\n");
        lis_finalize_(&ierr);
        return 1;
    }
    n = atol(argv[1]);
    printf("\nnumber of processes = 1\n");

    lis_matrix_create_(&comm, &A, &ierr); chkerr_(&ierr);
    lis_matrix_set_size_(&A, &zero, &n, &ierr); chkerr_(&ierr);
    lis_matrix_get_size_(&A, &n, &gn, &ierr);
    lis_matrix_get_range_(&A, &is, &ie, &ierr);
    for (lisf_int i = is - 1; i <= ie - 2; ++i) {   /* range is 1-based F77 */
        lisf_int jm = i - 1, jp = i + 1;
        if (i > 0)      lis_matrix_set_value_(&ins, &i, &jm, &neg1, &A, &ierr);
        if (i < gn - 1) lis_matrix_set_value_(&ins, &i, &jp, &neg1, &A, &ierr);
        lis_matrix_set_value_(&ins, &i, &i, &two, &A, &ierr);
    }
    lis_matrix_assemble_(&A, &ierr); chkerr_(&ierr);
    lis_matrix_get_nnz_(&A, &nnz, &ierr);
    printf("matrix size = %ld x %ld (%ld nonzero entries)\n\n",
           (long)n, (long)n, (long)nnz);

    lis_vector_duplicate_(&A, &x, &ierr); chkerr_(&ierr);
    lis_vector_set_all_(&one, &x, &ierr);

    lis_esolver_create_(&esolver, &ierr); chkerr_(&ierr);
    lis_esolver_set_option_("-eprint mem", &esolver, &ierr, 11);
    lis_esolver_set_optionc_(&esolver, &ierr); chkerr_(&ierr);
    lis_esolve_(&A, &x, &evalue0, &esolver, &ierr); chkerr_(&ierr);
    lis_esolver_get_iterex_(&esolver, &iter, &iter_double, &iter_quad,
                            &ierr);
    lis_esolver_get_timeex_(&esolver, &time, &itime, &ptime, &p_c_time,
                            &p_i_time, &ierr);
    lis_esolver_get_residualnorm_(&esolver, &resid, &ierr);
    lis_esolver_get_esolver_(&esolver, &nsol, &ierr);
    lis_esolver_get_esolvername_(&nsol, esolvername, &ierr, 20);
    esolvername[20] = '\0';
    for (int k = 19; k >= 0 && esolvername[k] == ' '; --k)
        esolvername[k] = '\0';

    printf("%s: mode number          = 0\n", esolvername);
    printf("%s: eigenvalue           = %14.7e\n", esolvername, evalue0);
    printf("%s: number of iterations = %ld\n", esolvername, (long)iter);
    printf("%s: elapsed time         = %14.7e sec.\n", esolvername, time);
    printf("%s:   preconditioner     = %14.7e sec.\n", esolvername, ptime);
    printf("%s:     matrix creation  = %14.7e sec.\n", esolvername,
           p_c_time);
    printf("%s:   linear solver      = %14.7e sec.\n", esolvername, itime);
    printf("%s: relative residual    = %14.7e\n", esolvername, resid);

    lis_esolver_destroy_(&esolver, &ierr);
    lis_matrix_destroy_(&A, &ierr);
    lis_vector_destroy_(&x, &ierr);
    lis_finalize_(&ierr);
    return 0;
}
