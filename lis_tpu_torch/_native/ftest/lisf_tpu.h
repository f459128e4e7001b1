/* F77-ABI declarations for liblisf_tpu.so — the call surface a
 * gfortran-compiled reference test program (test/test1f.F etc.) emits:
 * trailing-underscore symbols, every argument by reference, character
 * arguments carrying a hidden trailing length.  Mirrors the reference's
 * include/lisf.h interface names. */
#ifndef LISF_TPU_H
#define LISF_TPU_H

typedef long lisf_int;

#define LIS_INS_VALUE 0
#define LIS_ADD_VALUE 1
#define LIS_MATRIX_CSR 1
#define LIS_FMT_MM 2            /* lis.h: LIS_FMT_PLAIN 1, LIS_FMT_MM 2 */
#define LIS_TRUE 1
#define LIS_FALSE 0

/* lifecycle */
extern void lis_initialize_(lisf_int*);
extern void lis_finalize_(lisf_int*);
extern void chkerr_(lisf_int*);

/* matrix */
extern void lis_matrix_create_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_destroy_(lisf_int*, lisf_int*);
extern void lis_matrix_set_size_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_set_type_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_set_value_(lisf_int*, lisf_int*, lisf_int*, double*,
                                  lisf_int*, lisf_int*);
extern void lis_matrix_set_csr_(lisf_int*, lisf_int*, lisf_int*, double*,
                                lisf_int*, lisf_int*);
extern void lis_matrix_assemble_(lisf_int*, lisf_int*);
extern void lis_matrix_get_size_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_get_range_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_get_nnz_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_duplicate_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matrix_convert_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_matvec_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);

/* vector */
extern void lis_vector_create_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_vector_destroy_(lisf_int*, lisf_int*);
extern void lis_vector_set_size_(lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_vector_set_all_(double*, lisf_int*, lisf_int*);
extern void lis_vector_set_value_(lisf_int*, lisf_int*, double*, lisf_int*,
                                  lisf_int*);
extern void lis_vector_get_value_(lisf_int*, lisf_int*, double*, lisf_int*);
extern void lis_vector_duplicate_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_vector_is_null_(lisf_int*, lisf_int*);
extern void lis_vector_nrm2_(lisf_int*, double*, lisf_int*);
extern void lis_vector_dot_(lisf_int*, lisf_int*, double*, lisf_int*);
extern void lis_vector_print_(lisf_int*, lisf_int*);
extern void lis_vector_conjugate_(lisf_int*, lisf_int*);

/* file I/O */
extern void lis_input_(lisf_int*, lisf_int*, lisf_int*, const char*,
                       lisf_int*, long);
extern void lis_input_matrix_(lisf_int*, const char*, lisf_int*, long);
extern void lis_input_vector_(lisf_int*, const char*, lisf_int*, long);
extern void lis_output_vector_(lisf_int*, lisf_int*, const char*, lisf_int*,
                               long);

/* solver */
extern void lis_solver_create_(lisf_int*, lisf_int*);
extern void lis_solver_destroy_(lisf_int*, lisf_int*);
extern void lis_solver_set_option_(const char*, lisf_int*, lisf_int*, long);
extern void lis_solver_set_optionc_(lisf_int*, lisf_int*);
extern void lis_solve_(lisf_int*, lisf_int*, lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_iter_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_iterex_(lisf_int*, lisf_int*, lisf_int*, lisf_int*,
                                   lisf_int*);
extern void lis_solver_get_timeex_(lisf_int*, double*, double*, double*,
                                   double*, double*, lisf_int*);
extern void lis_solver_get_residualnorm_(lisf_int*, double*, lisf_int*);
extern void lis_solver_get_status_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_solver_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_solver_get_solvername_(lisf_int*, char*, lisf_int*, long);
extern void lis_solver_output_rhistory_(lisf_int*, const char*, lisf_int*,
                                        long);

/* PSD: decoupled precon/solver (test8f.F90) */
extern void lis_solver_set_matrix_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_precon_psd_create_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_precon_psd_update_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_precon_destroy_(lisf_int*, lisf_int*);
extern void lis_solve_kernel_(lisf_int*, lisf_int*, lisf_int*, lisf_int*,
                              lisf_int*, lisf_int*);
extern void lis_matrix_psd_set_value_(lisf_int*, lisf_int*, lisf_int*,
                                      double*, lisf_int*, lisf_int*);
extern void lis_matrix_psd_reset_scale_(lisf_int*, lisf_int*);
extern void lis_vector_psd_reset_scale_(lisf_int*, lisf_int*);

/* eigensolver */
extern void lis_esolver_create_(lisf_int*, lisf_int*);
extern void lis_esolver_destroy_(lisf_int*, lisf_int*);
extern void lis_esolver_set_option_(const char*, lisf_int*, lisf_int*, long);
extern void lis_esolver_set_optionc_(lisf_int*, lisf_int*);
extern void lis_esolve_(lisf_int*, lisf_int*, double*, lisf_int*, lisf_int*);
extern void lis_esolver_get_iter_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_esolver_get_iterex_(lisf_int*, lisf_int*, lisf_int*,
                                    lisf_int*, lisf_int*);
extern void lis_esolver_get_timeex_(lisf_int*, double*, double*, double*,
                                    double*, double*, lisf_int*);
extern void lis_esolver_get_residualnorm_(lisf_int*, double*, lisf_int*);
extern void lis_esolver_get_esolver_(lisf_int*, lisf_int*, lisf_int*);
extern void lis_esolver_get_esolvername_(lisf_int*, char*, lisf_int*, long);
extern void lis_esolver_output_rhistory_(lisf_int*, const char*, lisf_int*,
                                         long);

/* dense array ops */
extern void lis_array_set_all_(lisf_int*, double*, double*, lisf_int*);
extern void lis_array_matvec_(lisf_int*, double*, double*, double*, lisf_int*,
                              lisf_int*);
extern void lis_array_solve_(lisf_int*, double*, double*, double*, double*,
                             lisf_int*);
extern void lis_array_xpay_(lisf_int*, double*, double*, double*, lisf_int*);
extern void lis_array_nrm2_(lisf_int*, double*, double*, lisf_int*);

#endif /* LISF_TPU_H */
