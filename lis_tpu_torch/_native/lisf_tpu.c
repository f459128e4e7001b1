/* lisf_tpu — Fortran/C binding shim for lis_tpu_torch.
 *
 * The port's own copy of lis_tpu's _native/lisf_tpu.c, the
 * role-equivalent of the reference's src/fortran/lisf_*.c layer (e.g.
 * lisf_solver.c, lisf_init.F): C functions with Fortran calling
 * conventions — trailing-underscore symbols, every argument passed by
 * reference, character arguments carrying a hidden trailing length — so
 * F77/F90 programs call the port exactly like they call Lis:
 *
 *     call lis_initialize(ierr)
 *     call lis_matrix_create(0, A, ierr)
 *     call lis_matrix_set_value(LIS_INS_VALUE, i, j, v, A, ierr)
 *     call lis_solver_set_option('-i cg -tol 1.0e-12', solver, ierr)
 *     call lis_solve(A, b, x, solver, ierr)
 *
 * The compute lives in the embedded CPython interpreter (the port runs on
 * PyTorch, on the card unless LIS_TPU_TORCH_DEVICE names another device);
 * handles are integers mapping to objects held by
 * lis_tpu_torch.interop.fapi.  lis_tpu_torch._native.lisf.build() compiles
 * it with gcc, the include path and libpython from sysconfig, and defines
 *
 *   LISF_PYTHON  the interpreter whose installation (its venv included)
 *                the embedded interpreter takes as its own, and
 *   LISF_ROOT    the checkout that holds lis_tpu_torch, put first on
 *                sys.path.
 *
 * Each wrapper also has a no-underscore alias so plain C callers can use
 * the same library.
 */

#include <Python.h>
#include <string.h>

typedef long lisf_int;     /* LIS_INT analogue on the Fortran side */

static PyObject* g_api = NULL;   /* lis_tpu_torch.interop.fapi module */

static int start_python(void) {
#ifdef LISF_PYTHON
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                          LISF_PYTHON);
    if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) {
        fprintf(stderr, "lisf_tpu: cannot start Python: %s\n",
                st.err_msg ? st.err_msg : "?");
        return -1;
    }
#else
    Py_Initialize();
#endif
#ifdef LISF_ROOT
    PyObject* path = PySys_GetObject("path");          /* borrowed */
    PyObject* root = PyUnicode_FromString(LISF_ROOT);
    if (!path || !root || PyList_Insert(path, 0, root) != 0) {
        Py_XDECREF(root);
        PyErr_Print();
        return -1;
    }
    Py_DECREF(root);
#endif
    return 0;
}

static int ensure_python(void) {
    if (g_api) return 0;
    if (!Py_IsInitialized() && start_python()) return -1;
    g_api = PyImport_ImportModule("lis_tpu_torch.interop.fapi");
    if (!g_api) { PyErr_Print(); return -1; }
    return 0;
}

static lisf_int call_ll(const char* name, const char* fmt, ...) {
    /* call fapi.<name>(...) returning an integer (or -1 on error) */
    va_list ap;
    if (ensure_python()) return -1;
    PyObject* fn = PyObject_GetAttrString(g_api, name);
    if (!fn) { PyErr_Print(); return -1; }
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject* res = PyObject_CallObject(fn, args);
    Py_XDECREF(args);
    Py_DECREF(fn);
    if (!res) { PyErr_Print(); return -1; }
    lisf_int out = (lisf_int)PyLong_AsLong(res);
    Py_DECREF(res);
    return out;
}

static double call_dd(const char* name, const char* fmt, ...) {
    va_list ap;
    if (ensure_python()) return 0.0;
    PyObject* fn = PyObject_GetAttrString(g_api, name);
    if (!fn) { PyErr_Print(); return 0.0; }
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    PyObject* res = PyObject_CallObject(fn, args);
    Py_XDECREF(args);
    Py_DECREF(fn);
    if (!res) { PyErr_Print(); return 0.0; }
    double out = PyFloat_AsDouble(res);
    Py_DECREF(res);
    return out;
}

#define F77(name) void name##_

/* ---- lifecycle ---------------------------------------------------------- */

F77(lis_initialize)(lisf_int* ierr) {
    *ierr = call_ll("initialize", "()");
}

F77(lis_finalize)(lisf_int* ierr) {
    *ierr = call_ll("finalize", "()");
}

/* ---- matrix ------------------------------------------------------------- */

F77(lis_matrix_create)(lisf_int* comm, lisf_int* A, lisf_int* ierr) {
    *A = call_ll("matrix_create", "(l)", (long)*comm);
    *ierr = (*A > 0) ? 0 : -1;
}

F77(lis_matrix_destroy)(lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_destroy", "(l)", (long)*A);
}

F77(lis_matrix_set_size)(lisf_int* A, lisf_int* local_n, lisf_int* global_n,
                         lisf_int* ierr) {
    *ierr = call_ll("matrix_set_size", "(lll)", (long)*A, (long)*local_n,
                    (long)*global_n);
}

F77(lis_matrix_set_type)(lisf_int* A, lisf_int* mtype, lisf_int* ierr) {
    *ierr = call_ll("matrix_set_type", "(ll)", (long)*A, (long)*mtype);
}

F77(lis_matrix_set_value)(lisf_int* flag, lisf_int* i, lisf_int* j,
                          double* value, lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_set_value", "(llldl)", (long)*flag, (long)*i,
                    (long)*j, *value, (long)*A);
}

F77(lis_matrix_assemble)(lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_assemble", "(l)", (long)*A);
}

/* ---- vector ------------------------------------------------------------- */

F77(lis_vector_create)(lisf_int* comm, lisf_int* v, lisf_int* ierr) {
    *v = call_ll("vector_create", "(l)", (long)*comm);
    *ierr = (*v > 0) ? 0 : -1;
}

F77(lis_vector_destroy)(lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_destroy", "(l)", (long)*v);
}

F77(lis_vector_set_size)(lisf_int* v, lisf_int* local_n, lisf_int* global_n,
                         lisf_int* ierr) {
    *ierr = call_ll("vector_set_size", "(lll)", (long)*v, (long)*local_n,
                    (long)*global_n);
}

F77(lis_vector_set_all)(double* alpha, lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_set_all", "(dl)", *alpha, (long)*v);
}

F77(lis_vector_set_value)(lisf_int* flag, lisf_int* i, double* value,
                          lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_set_value", "(lldl)", (long)*flag, (long)*i,
                    *value, (long)*v);
}

F77(lis_vector_get_value)(lisf_int* v, lisf_int* i, double* value,
                          lisf_int* ierr) {
    *value = call_dd("vector_get_value", "(ll)", (long)*v, (long)*i);
    *ierr = 0;
}

F77(lis_vector_nrm2)(lisf_int* v, double* nrm, lisf_int* ierr) {
    *nrm = call_dd("vector_nrm2", "(l)", (long)*v);
    *ierr = 0;
}

/* ---- solver ------------------------------------------------------------- */

F77(lis_solver_create)(lisf_int* s, lisf_int* ierr) {
    *s = call_ll("solver_create", "()");
    *ierr = (*s > 0) ? 0 : -1;
}

F77(lis_solver_destroy)(lisf_int* s, lisf_int* ierr) {
    *ierr = call_ll("solver_destroy", "(l)", (long)*s);
}

/* Fortran character arg: pointer + hidden length appended after ierr */
F77(lis_solver_set_option)(const char* text, lisf_int* s, lisf_int* ierr,
                           long text_len) {
    char buf[1024];
    long n = text_len < 1023 ? text_len : 1023;
    memcpy(buf, text, (size_t)n);
    while (n > 0 && buf[n - 1] == ' ') --n;     /* trim F77 blank padding */
    buf[n] = '\0';
    *ierr = call_ll("solver_set_option", "(sl)", buf, (long)*s);
}

F77(lis_solve)(lisf_int* A, lisf_int* b, lisf_int* x, lisf_int* s,
               lisf_int* ierr) {
    *ierr = call_ll("solve", "(llll)", (long)*A, (long)*b, (long)*x,
                    (long)*s);
}

F77(lis_solver_get_iter)(lisf_int* s, lisf_int* iter, lisf_int* ierr) {
    *iter = call_ll("solver_get_iter", "(l)", (long)*s);
    *ierr = 0;
}

F77(lis_solver_get_residualnorm)(lisf_int* s, double* resid,
                                 lisf_int* ierr) {
    *resid = call_dd("solver_get_residualnorm", "(l)", (long)*s);
    *ierr = 0;
}

F77(lis_solver_get_status)(lisf_int* s, lisf_int* status, lisf_int* ierr) {
    *status = call_ll("solver_get_status", "(l)", (long)*s);
    *ierr = 0;
}

/* ---- eigensolver -------------------------------------------------------- */

F77(lis_esolver_create)(lisf_int* e, lisf_int* ierr) {
    *e = call_ll("esolver_create", "()");
    *ierr = (*e > 0) ? 0 : -1;
}

F77(lis_esolver_destroy)(lisf_int* e, lisf_int* ierr) {
    *ierr = call_ll("esolver_destroy", "(l)", (long)*e);
}

F77(lis_esolver_set_option)(const char* text, lisf_int* e, lisf_int* ierr,
                            long text_len) {
    char buf[1024];
    long n = text_len < 1023 ? text_len : 1023;
    memcpy(buf, text, (size_t)n);
    while (n > 0 && buf[n - 1] == ' ') --n;
    buf[n] = '\0';
    *ierr = call_ll("esolver_set_option", "(sl)", buf, (long)*e);
}

/* Reference ABI (src/fortran/lisf_esolver.c:93): evalue precedes the
 * esolver handle. */
F77(lis_esolve)(lisf_int* A, lisf_int* x, double* evalue, lisf_int* e,
                lisf_int* ierr) {
    *evalue = call_dd("esolve", "(lll)", (long)*A, (long)*x, (long)*e);
    *ierr = 0;
}

F77(lis_esolver_get_iter)(lisf_int* e, lisf_int* iter, lisf_int* ierr) {
    *iter = call_ll("esolver_get_iter", "(l)", (long)*e);
    *ierr = 0;
}

/* ---- strings and file I/O (src/fortran/lisf_system.c) ------------------- */

static void fstr_in(char* buf, size_t cap, const char* text, long len) {
    size_t n = (size_t)(len < (long)cap - 1 ? len : (long)cap - 1);
    memcpy(buf, text, n);
    while (n > 0 && buf[n - 1] == ' ') --n;     /* trim F77 blank padding */
    buf[n] = '\0';
}

static void fstr_out(char* dst, long cap, const char* src) {
    long n = (long)strlen(src);
    if (n > cap) n = cap;
    memcpy(dst, src, (size_t)n);
    memset(dst + n, ' ', (size_t)(cap - n));    /* F77 blank padding */
}

F77(lis_input)(lisf_int* A, lisf_int* b, lisf_int* x, const char* fname,
               lisf_int* ierr, long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("input", "(llls)", (long)*A, (long)*b, (long)*x, buf);
}

F77(lis_input_matrix)(lisf_int* A, const char* fname, lisf_int* ierr,
                      long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("input_matrix", "(ls)", (long)*A, buf);
}

F77(lis_input_vector)(lisf_int* v, const char* fname, lisf_int* ierr,
                      long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("input_vector", "(ls)", (long)*v, buf);
}

F77(lis_output_vector)(lisf_int* v, lisf_int* fmt, const char* fname,
                       lisf_int* ierr, long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("output_vector", "(lls)", (long)*v, (long)*fmt, buf);
}

F77(lis_solver_output_rhistory)(lisf_int* s, const char* fname,
                                lisf_int* ierr, long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("solver_output_rhistory", "(ls)", (long)*s, buf);
}

F77(lis_esolver_output_rhistory)(lisf_int* e, const char* fname,
                                 lisf_int* ierr, long fname_len) {
    char buf[1024];
    fstr_in(buf, sizeof buf, fname, fname_len);
    *ierr = call_ll("esolver_output_rhistory", "(ls)", (long)*e, buf);
}

/* ---- matrix extras (src/fortran/lisf_matrix.c) --------------------------- */

F77(lis_matrix_get_size)(lisf_int* A, lisf_int* n, lisf_int* gn,
                         lisf_int* ierr) {
    *n = call_ll("matrix_get_n", "(l)", (long)*A);
    *gn = call_ll("matrix_get_gn", "(l)", (long)*A);
    *ierr = 0;
}

F77(lis_matrix_get_range)(lisf_int* A, lisf_int* is, lisf_int* ie,
                          lisf_int* ierr) {
    *is = call_ll("matrix_get_range_is", "(l)", (long)*A);
    *ie = call_ll("matrix_get_range_ie", "(l)", (long)*A);
    *ierr = 0;
}

F77(lis_matrix_get_nnz)(lisf_int* A, lisf_int* nnz, lisf_int* ierr) {
    *nnz = call_ll("matrix_get_nnz", "(l)", (long)*A);
    *ierr = 0;
}

F77(lis_matrix_duplicate)(lisf_int* Ain, lisf_int* Aout, lisf_int* ierr) {
    *Aout = call_ll("matrix_duplicate", "(l)", (long)*Ain);
    *ierr = (*Aout > 0) ? 0 : -1;
}

F77(lis_matrix_convert)(lisf_int* Ain, lisf_int* Aout, lisf_int* ierr) {
    *ierr = call_ll("matrix_convert", "(ll)", (long)*Ain, (long)*Aout);
}

F77(lis_matrix_set_csr)(lisf_int* nnz, lisf_int* ptr, lisf_int* index,
                        double* value, lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_set_csr", "(lllll)", (long)*nnz,
                    (long)(uintptr_t)ptr, (long)(uintptr_t)index,
                    (long)(uintptr_t)value, (long)*A);
}

F77(lis_matvec)(lisf_int* A, lisf_int* x, lisf_int* y, lisf_int* ierr) {
    *ierr = call_ll("matvec", "(lll)", (long)*A, (long)*x, (long)*y);
}

/* ---- vector extras (src/fortran/lisf_vector.c) ---------------------------- */

F77(lis_vector_duplicate)(lisf_int* vin, lisf_int* vout, lisf_int* ierr) {
    *vout = call_ll("vector_duplicate", "(l)", (long)*vin);
    *ierr = (*vout > 0) ? 0 : -1;
}

F77(lis_vector_is_null)(lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_is_null", "(l)", (long)*v);
}

F77(lis_vector_dot)(lisf_int* u, lisf_int* v, double* dot, lisf_int* ierr) {
    *dot = call_dd("vector_dot", "(ll)", (long)*u, (long)*v);
    *ierr = 0;
}

F77(lis_vector_print)(lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_print", "(l)", (long)*v);
}

F77(lis_vector_conjugate)(lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_conjugate", "(l)", (long)*v);
}

/* ---- solver extras (src/fortran/lisf_solver.c) ----------------------------- */

F77(lis_solver_set_optionc)(lisf_int* s, lisf_int* ierr) {
    *ierr = call_ll("solver_set_optionC", "(l)", (long)*s);
}

F77(lis_solver_get_iterex)(lisf_int* s, lisf_int* iter, lisf_int* iter_double,
                           lisf_int* iter_quad, lisf_int* ierr) {
    *iter = call_ll("solver_get_iter", "(l)", (long)*s);
    *iter_double = call_ll("solver_get_iter_double", "(l)", (long)*s);
    *iter_quad = call_ll("solver_get_iter_quad", "(l)", (long)*s);
    *ierr = 0;
}

F77(lis_solver_get_timeex)(lisf_int* s, double* time, double* itime,
                           double* ptime, double* p_c_time, double* p_i_time,
                           lisf_int* ierr) {
    *time = call_dd("solver_get_time", "(l)", (long)*s);
    *itime = call_dd("solver_get_itime", "(l)", (long)*s);
    *ptime = call_dd("solver_get_ptime", "(l)", (long)*s);
    *p_c_time = 0.0;
    *p_i_time = 0.0;
    *ierr = 0;
}

F77(lis_solver_get_solver)(lisf_int* s, lisf_int* nsol, lisf_int* ierr) {
    *nsol = call_ll("solver_get_solver", "(l)", (long)*s);
    *ierr = 0;
}

static void get_name(const char* api, long nsol, char* name, long name_len) {
    if (ensure_python()) return;
    PyObject* fn = PyObject_GetAttrString(g_api, api);
    if (!fn) { PyErr_Print(); return; }
    PyObject* res = PyObject_CallFunction(fn, "(l)", nsol);
    Py_DECREF(fn);
    if (!res) { PyErr_Print(); return; }
    const char* s = PyUnicode_AsUTF8(res);
    fstr_out(name, name_len, s ? s : "");
    Py_DECREF(res);
}

F77(lis_solver_get_solvername)(lisf_int* nsol, char* name, lisf_int* ierr,
                               long name_len) {
    get_name("solver_get_solvername", (long)*nsol, name, name_len);
    *ierr = 0;
}

/* ---- esolver extras (src/fortran/lisf_esolver.c) --------------------------- */

F77(lis_esolver_set_optionc)(lisf_int* e, lisf_int* ierr) {
    *ierr = call_ll("esolver_set_optionC", "(l)", (long)*e);
}

F77(lis_esolver_get_iterex)(lisf_int* e, lisf_int* iter,
                            lisf_int* iter_double, lisf_int* iter_quad,
                            lisf_int* ierr) {
    *iter = call_ll("esolver_get_iter", "(l)", (long)*e);
    *iter_double = *iter;
    *iter_quad = 0;
    *ierr = 0;
}

F77(lis_esolver_get_timeex)(lisf_int* e, double* time, double* itime,
                            double* ptime, double* p_c_time,
                            double* p_i_time, lisf_int* ierr) {
    *time = call_dd("esolver_get_time", "(l)", (long)*e);
    *itime = *time;
    *ptime = 0.0;
    *p_c_time = 0.0;
    *p_i_time = 0.0;
    *ierr = 0;
}

F77(lis_esolver_get_residualnorm)(lisf_int* e, double* resid,
                                  lisf_int* ierr) {
    *resid = call_dd("esolver_get_residualnorm", "(l)", (long)*e);
    *ierr = 0;
}

F77(lis_esolver_get_esolver)(lisf_int* e, lisf_int* nsol, lisf_int* ierr) {
    *nsol = call_ll("esolver_get_esolver", "(l)", (long)*e);
    *ierr = 0;
}

F77(lis_esolver_get_esolvername)(lisf_int* nsol, char* name, lisf_int* ierr,
                                 long name_len) {
    get_name("esolver_get_esolvername", (long)*nsol, name, name_len);
    *ierr = 0;
}

/* ---- dense array ops (src/fortran/lisf_array.c) ----------------------------- */

F77(lis_array_set_all)(lisf_int* n, double* alpha, double* a,
                       lisf_int* ierr) {
    *ierr = call_ll("array_set_all", "(ldl)", (long)*n, *alpha,
                    (long)(uintptr_t)a);
}

F77(lis_array_matvec)(lisf_int* n, double* a, double* x, double* y,
                      lisf_int* flag, lisf_int* ierr) {
    *ierr = call_ll("array_matvec", "(lllll)", (long)*n,
                    (long)(uintptr_t)a, (long)(uintptr_t)x,
                    (long)(uintptr_t)y, (long)*flag);
}

F77(lis_array_solve)(lisf_int* n, double* a, double* b, double* x,
                     double* w, lisf_int* ierr) {
    *ierr = call_ll("array_solve", "(lllll)", (long)*n,
                    (long)(uintptr_t)a, (long)(uintptr_t)b,
                    (long)(uintptr_t)x, (long)(uintptr_t)w);
}

F77(lis_array_xpay)(lisf_int* n, double* x, double* alpha, double* y,
                    lisf_int* ierr) {
    *ierr = call_ll("array_xpay", "(lldl)", (long)*n, (long)(uintptr_t)x,
                    *alpha, (long)(uintptr_t)y);
}

F77(lis_array_nrm2)(lisf_int* n, double* x, double* nrm, lisf_int* ierr) {
    *nrm = call_dd("array_nrm2", "(ll)", (long)*n, (long)(uintptr_t)x);
    *ierr = 0;
}

/* ---- PSD: decoupled precon/solver (test8f.F90 workflow;
        src/fortran/lisf_precon.c:65-125, lisf_solver.c:93,254) ------------- */

F77(lis_solver_set_matrix)(lisf_int* A, lisf_int* s, lisf_int* ierr) {
    *ierr = call_ll("solver_set_matrix", "(ll)", (long)*A, (long)*s);
}

F77(lis_precon_psd_create)(lisf_int* s, lisf_int* p, lisf_int* ierr) {
    *p = call_ll("precon_create", "(l)", (long)*s);
    *ierr = (*p > 0) ? 0 : -1;
}

F77(lis_precon_psd_update)(lisf_int* s, lisf_int* p, lisf_int* ierr) {
    *ierr = call_ll("precon_psd_update", "(ll)", (long)*s, (long)*p);
}

F77(lis_precon_destroy)(lisf_int* p, lisf_int* ierr) {
    *ierr = call_ll("precon_destroy", "(l)", (long)*p);
}

F77(lis_solve_kernel)(lisf_int* A, lisf_int* b, lisf_int* x, lisf_int* s,
                      lisf_int* p, lisf_int* ierr) {
    *ierr = call_ll("solve_kernel", "(lllll)", (long)*A, (long)*b, (long)*x,
                    (long)*s, (long)*p);
}

F77(lis_matrix_psd_set_value)(lisf_int* flag, lisf_int* i, lisf_int* j,
                              double* value, lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_psd_set_value", "(llldl)", (long)*flag, (long)*i,
                    (long)*j, *value, (long)*A);
}

F77(lis_matrix_psd_reset_scale)(lisf_int* A, lisf_int* ierr) {
    *ierr = call_ll("matrix_psd_reset_scale", "(l)", (long)*A);
}

F77(lis_vector_psd_reset_scale)(lisf_int* v, lisf_int* ierr) {
    *ierr = call_ll("vector_psd_reset_scale", "(l)", (long)*v);
}

/* ---- CHKERR (test/lisf_init.F analogue) ------------------------------------ */

F77(chkerr)(lisf_int* ierr) {
    if (*ierr) {
        fprintf(stderr, "lisf_tpu: CHKERR failed with ierr=%ld\n",
                (long)*ierr);
        exit((int)*ierr);
    }
}
