/* Mirror of the reference's test/etest1f.F call sequence through the F77
 * ABI: file-driven standard eigensolve — read matrix, x=1, esolve with
 * command-line options, report iters/times/residual/eigenvalue, write
 * the eigenvector and residual history. */
#include <stdio.h>
#include <string.h>
#include "lisf_tpu.h"

int main(int argc, char** argv) {
    lisf_int ierr, A, x, esolver;
    lisf_int comm = 0, matrix_type = LIS_MATRIX_CSR, fmt_mm = LIS_FMT_MM;
    lisf_int n, gn, iter, iter_double, iter_quad, nsol;
    double time, itime, ptime, p_c_time, p_i_time, resid;
    double evalue0, one = 1.0;
    char esolvername[21];

    lis_initialize_(&ierr);

    if (argc < 4) {
        printf("Usage: etest1f matrix_filename evector_filename "
               "rhistory_filename [options]\n");
        lis_finalize_(&ierr);
        return 1;
    }

    printf("\nnumber of processes = 1\n");

    lis_matrix_create_(&comm, &A, &ierr);
    chkerr_(&ierr);
    lis_matrix_set_type_(&A, &matrix_type, &ierr);
    lis_input_matrix_(&A, argv[1], &ierr, (long)strlen(argv[1]));
    chkerr_(&ierr);
    lis_matrix_get_size_(&A, &n, &gn, &ierr);

    lis_vector_duplicate_(&A, &x, &ierr);
    lis_vector_set_all_(&one, &x, &ierr);

    lis_esolver_create_(&esolver, &ierr);
    chkerr_(&ierr);
    lis_esolver_set_option_("-eprint mem", &esolver, &ierr, 11L);
    lis_esolver_set_optionc_(&esolver, &ierr);
    chkerr_(&ierr);
    lis_esolve_(&A, &x, &evalue0, &esolver, &ierr);
    chkerr_(&ierr);

    lis_esolver_get_iterex_(&esolver, &iter, &iter_double, &iter_quad,
                            &ierr);
    lis_esolver_get_timeex_(&esolver, &time, &itime, &ptime, &p_c_time,
                            &p_i_time, &ierr);
    lis_esolver_get_residualnorm_(&esolver, &resid, &ierr);
    lis_esolver_get_esolver_(&esolver, &nsol, &ierr);
    lis_esolver_get_esolvername_(&nsol, esolvername, &ierr, 20L);
    esolvername[20] = '\0';
    for (int k = 19; k >= 0 && esolvername[k] == ' '; --k)
        esolvername[k] = 0;

    printf("%s: mode number          = 0\n", esolvername);
    printf("%s: eigenvalue           = %e\n", esolvername, evalue0);
    printf("%s: number of iterations = %ld\n", esolvername, (long)iter);
    printf("%s: elapsed time         = %e sec.\n", esolvername, time);
    printf("%s: relative residual    = %e\n\n", esolvername, resid);

    lis_output_vector_(&x, &fmt_mm, argv[2], &ierr, (long)strlen(argv[2]));
    lis_esolver_output_rhistory_(&esolver, argv[3], &ierr,
                                 (long)strlen(argv[3]));

    lis_esolver_destroy_(&esolver, &ierr);
    lis_matrix_destroy_(&A, &ierr);
    lis_vector_destroy_(&x, &ierr);

    lis_finalize_(&ierr);
    return 0;
}
