/* Mirror of the reference's test/test7f.F call sequence through the F77
 * ABI: vector create/set_all/print/conjugate/dot/nrm2.  The reference
 * gates the body behind #ifdef COMPLEX; the same API surface is driven
 * here real-valued (the port is a real-f64 library like the reference's
 * default build). */
#include <stdio.h>
#include <math.h>
#include "lisf_tpu.h"

int main(void) {
    lisf_int ierr, v, comm = 0, n = 10, ln = 0;
    double z = 2.0, dot, nrm2;

    lis_initialize_(&ierr);

    printf("number z = %f\n", z);

    lis_vector_create_(&comm, &v, &ierr);
    lis_vector_set_size_(&v, &ln, &n, &ierr);
    lis_vector_set_all_(&z, &v, &ierr);
    printf("vector v = \n");
    lis_vector_print_(&v, &ierr);
    lis_vector_conjugate_(&v, &ierr);
    printf("conj(v) = \n");
    lis_vector_print_(&v, &ierr);
    lis_vector_dot_(&v, &v, &dot, &ierr);
    lis_vector_nrm2_(&v, &nrm2, &ierr);
    printf("inner product (v,v) = %f\n", dot);
    printf("2-norm of v = %f\n", nrm2);
    printf("abs(z) = %f\n", fabs(z));
    lis_vector_destroy_(&v, &ierr);

    /* self-check: (v,v) = n*z^2 = 40, ||v|| = sqrt(40) */
    if (dot < 39.9 || dot > 40.1) return 3;
    if (nrm2 < sqrt(40.0) - 0.1 || nrm2 > sqrt(40.0) + 0.1) return 3;

    lis_finalize_(&ierr);
    return 0;
}
