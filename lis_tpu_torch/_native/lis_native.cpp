// lis_native — host-side runtime kernels.
//
// The reference implements its entire host layer in C (assembly,
// conversion, factorisation: src/matrix/*, src/precon/lis_precon_iluk.c
// etc.).  Here the device compute path is PyTorch and the hand-written
// CUDA kernels of csrc/; this library is the native half of the runtime:
// the irregular, sequential host algorithms that feed the device — ILU
// factorisations, triangular-solve level scheduling, Matrix Market
// parsing, Benes routing and SA-AMG aggregation — exposed through a plain
// C ABI consumed via ctypes (no pybind11 dependency).
//
// All CSR inputs are int32 indices / float64 values, matching the
// framework's host representation.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <map>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// ILU(k): level-of-fill symbolic+numeric factorisation (IKJ variant).
// Mirrors lis_symbolic_fact_csr + lis_numerical_fact_csr
// (src/precon/lis_precon_iluk.c:263,638) in a single pass.
// Returns 0 on success.  Output arrays are malloc'd; caller frees with
// lis_native_free.
// ---------------------------------------------------------------------------
int iluk_factor(int32_t n, const int32_t* ptr, const int32_t* index,
                const double* value, int32_t fill,
                int32_t** out_ptr, int32_t** out_index, double** out_value,
                int64_t* out_nnz) {
    std::vector<std::map<int32_t, double>> rows(n);
    std::vector<std::map<int32_t, int32_t>> levs(n);

    for (int32_t i = 0; i < n; ++i) {
        std::map<int32_t, double> work;
        std::map<int32_t, int32_t> lev;
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
            work[index[p]] += value[p];
            lev[index[p]] = 0;
        }
        if (work.find(i) == work.end()) { work[i] = 0.0; lev[i] = 0; }

        for (auto it = work.begin(); it != work.end() && it->first < i; ++it) {
            int32_t k = it->first;
            int32_t lk = lev[k];
            if (lk > fill) continue;
            auto dk = rows[k].find(k);
            if (dk == rows[k].end() || dk->second == 0.0) continue;
            double factor = it->second / dk->second;
            it->second = factor;
            for (auto& kv : rows[k]) {
                int32_t j = kv.first;
                if (j <= k) continue;
                int32_t nl = lk + levs[k][j] + 1;
                auto wj = work.find(j);
                if (wj != work.end()) {
                    wj->second -= factor * kv.second;
                    auto lj = lev.find(j);
                    if (nl < lj->second) lj->second = nl;
                } else if (nl <= fill) {
                    work[j] = -factor * kv.second;
                    lev[j] = nl;
                }
            }
        }
        // drop above fill level
        for (auto it = work.begin(); it != work.end();) {
            if (lev[it->first] > fill) it = work.erase(it);
            else ++it;
        }
        if (work[i] == 0.0) work[i] = 1.0;
        rows[i] = std::move(work);
        levs[i] = std::move(lev);
    }

    int64_t nnz = 0;
    for (auto& r : rows) nnz += (int64_t)r.size();
    *out_ptr = (int32_t*)malloc((n + 1) * sizeof(int32_t));
    *out_index = (int32_t*)malloc(nnz * sizeof(int32_t));
    *out_value = (double*)malloc(nnz * sizeof(double));
    int64_t pos = 0;
    (*out_ptr)[0] = 0;
    for (int32_t i = 0; i < n; ++i) {
        for (auto& kv : rows[i]) {
            (*out_index)[pos] = kv.first;
            (*out_value)[pos] = kv.second;
            ++pos;
        }
        (*out_ptr)[i + 1] = (int32_t)pos;
    }
    *out_nnz = nnz;
    return 0;
}

// ---------------------------------------------------------------------------
// ILUT(drop, rate): dual-threshold factorisation (Saad Alg. 10.6;
// reference lis_precon_ilut.c:67).
// ---------------------------------------------------------------------------
int ilut_factor(int32_t n, const int32_t* ptr, const int32_t* index,
                const double* value, double drop, double rate,
                int32_t** out_ptr, int32_t** out_index, double** out_value,
                int64_t* out_nnz) {
    std::vector<std::map<int32_t, double>> rows(n);
    std::vector<double> diag(n, 0.0);
    // reference rules (lis_precon_ilut.c:61-63,129-131,230-320):
    // mean-|a_ij| drop threshold gating only NEW update-term fill, the
    // elimination factor itself never dropped, final keep = top
    // lfil = (nnz/2n)*rate per side by magnitude (diagonal always kept)
    int64_t nnz_tot = ptr[n];
    int32_t lfil = std::max((int32_t)((double)nnz_tot / (2.0 * n) * rate), 1);

    for (int32_t i = 0; i < n; ++i) {
        std::map<int32_t, double> work;
        double nrm = 0.0;
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
            work[index[p]] += value[p];
            nrm += std::fabs(value[p]);
        }
        int32_t kc = std::max(ptr[i + 1] - ptr[i], 1);
        nrm = nrm / (double)kc;
        if (nrm == 0.0) nrm = 1.0;
        double tol_i = drop * nrm;

        // ascending-order elimination; std::map iteration picks up fill
        // inserted at later lower positions automatically
        for (auto it = work.begin(); it != work.end() && it->first < i;) {
            int32_t k = it->first;
            double dk = diag[k];
            if (dk == 0.0) { ++it; continue; }
            double fact = it->second / dk;
            it->second = fact;
            for (auto& kv : rows[k]) {
                if (kv.first <= k) continue;
                double lxu = -fact * kv.second;
                auto wj = work.find(kv.first);
                if (wj == work.end()) {
                    if (std::fabs(lxu) >= tol_i) work[kv.first] = lxu;
                } else {
                    wj->second += lxu;
                }
            }
            it = work.upper_bound(k);
        }

        double dv = 0.0;
        auto di = work.find(i);
        if (di != work.end()) dv = di->second;
        if (dv == 0.0) dv = nrm;
        std::vector<std::pair<double, int32_t>> lo, up;
        for (auto& kv : work) {
            if (kv.first == i) continue;
            if (kv.first < i) lo.push_back({std::fabs(kv.second), kv.first});
            else up.push_back({std::fabs(kv.second), kv.first});
        }
        auto keep_top = [&](std::vector<std::pair<double, int32_t>>& v) {
            if ((int32_t)v.size() > lfil) {
                std::partial_sort(v.begin(), v.begin() + lfil, v.end(),
                                  std::greater<>());
                v.resize(lfil);
            }
        };
        keep_top(lo);
        keep_top(up);
        std::map<int32_t, double> keep;
        for (auto& pr : lo) keep[pr.second] = work[pr.second];
        for (auto& pr : up) keep[pr.second] = work[pr.second];
        keep[i] = dv;
        diag[i] = dv;
        rows[i] = std::move(keep);
    }

    int64_t nnz = 0;
    for (auto& r : rows) nnz += (int64_t)r.size();
    *out_ptr = (int32_t*)malloc((n + 1) * sizeof(int32_t));
    *out_index = (int32_t*)malloc(nnz * sizeof(int32_t));
    *out_value = (double*)malloc(nnz * sizeof(double));
    int64_t pos = 0;
    (*out_ptr)[0] = 0;
    for (int32_t i = 0; i < n; ++i) {
        for (auto& kv : rows[i]) {
            (*out_index)[pos] = kv.first;
            (*out_value)[pos] = kv.second;
            ++pos;
        }
        (*out_ptr)[i + 1] = (int32_t)pos;
    }
    *out_nnz = nnz;
    return 0;
}

// ---------------------------------------------------------------------------
// Crout ILU (ILUC): at step k compute row k of U and column k of L
// (Li/Saad/Chow scheme; reference lis_precon_iluc.c:67 with -iluc_drop
// relative dropping and -iluc_rate fill growth bound).  U is kept by rows,
// L by columns; the "which rows of U have an entry in column k" /
// "which columns of L have an entry in row k" scans use the classic
// linked-list pointer structure, so the factorisation is O(nnz_F · avg
// row length), not O(n^2).  Output is combined-LU CSR like ilut_factor.
// ---------------------------------------------------------------------------
int iluc_factor(int32_t n, const int32_t* ptr, const int32_t* index,
                const double* value, double drop, double rate,
                int32_t** out_ptr, int32_t** out_index, double** out_value,
                int64_t* out_nnz) {
    // column access to A (strict lower part only) + row/col norms
    std::vector<int32_t> cnt(n, 0);
    for (int32_t i = 0; i < n; ++i)
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p)
            if (index[p] < i) ++cnt[index[p]];
    std::vector<int64_t> cptr(n + 1, 0);
    for (int32_t c = 0; c < n; ++c) cptr[c + 1] = cptr[c] + cnt[c];
    std::vector<int32_t> crow(cptr[n]);
    std::vector<double> cval(cptr[n]);
    std::vector<int64_t> fill_pos(cptr.begin(), cptr.end() - 1);
    std::vector<double> rownrm(n, 0.0), colnrm(n, 0.0);
    std::vector<int32_t> nnz_row(n, 0), nnz_col(n, 0);
    for (int32_t i = 0; i < n; ++i) {
        nnz_row[i] = ptr[i + 1] - ptr[i];
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
            double v = value[p];
            int32_t c = index[p];
            rownrm[i] += v * v;
            colnrm[c] += v * v;
            ++nnz_col[c];
            if (c < i) {
                crow[fill_pos[c]] = i;
                cval[fill_pos[c]] = v;
                ++fill_pos[c];
            }
        }
    }
    for (int32_t i = 0; i < n; ++i) {
        rownrm[i] = std::sqrt(rownrm[i]);
        if (rownrm[i] == 0.0) rownrm[i] = 1.0;
        colnrm[i] = std::sqrt(colnrm[i]);
        if (colnrm[i] == 0.0) colnrm[i] = 1.0;
    }

    // factors: U by rows (diag first), L by columns (strict, sorted by row)
    struct Ent { int32_t idx; double v; };
    std::vector<std::vector<Ent>> urows(n), lcols(n);
    // linked lists: uhead[c] = first row whose next-unconsumed U entry is
    // at column c; unext chains rows; upos[j] = that entry's position.
    std::vector<int32_t> uhead(n, -1), unext(n, -1), upos(n, 0);
    std::vector<int32_t> lhead(n, -1), lnext(n, -1), lpos(n, 0);

    // sparse accumulators
    std::vector<double> zv(n, 0.0), wv(n, 0.0);
    std::vector<int32_t> zmark(n, -1), wmark(n, -1);
    std::vector<int32_t> zidx, widx;
    zidx.reserve(256); widx.reserve(256);
    std::vector<std::pair<double, int32_t>> cand;

    for (int32_t k = 0; k < n; ++k) {
        // ---- z = A[k, k:n] ------------------------------------------------
        zidx.clear();
        for (int32_t p = ptr[k]; p < ptr[k + 1]; ++p) {
            int32_t c = index[p];
            if (c < k) continue;
            if (zmark[c] != k) { zmark[c] = k; zv[c] = 0.0; zidx.push_back(c); }
            zv[c] += value[p];
        }
        // z -= L[k][j] * U[j, k:n] for all j < k with L[k][j] != 0
        for (int32_t j = lhead[k]; j != -1; j = lnext[j]) {
            double lkj = lcols[j][lpos[j]].v;        // L entry at row k, col j
            const auto& ur = urows[j];
            for (size_t q = upos[j]; q < ur.size(); ++q) {
                int32_t c = ur[q].idx;               // c >= k by invariant
                if (zmark[c] != k) { zmark[c] = k; zv[c] = 0.0; zidx.push_back(c); }
                zv[c] -= lkj * ur[q].v;
            }
        }
        // ---- w = A[k+1:n, k] ---------------------------------------------
        widx.clear();
        for (int64_t p = cptr[k]; p < cptr[k + 1]; ++p) {
            int32_t r = crow[p];                     // r > k by construction
            if (wmark[r] != k) { wmark[r] = k; wv[r] = 0.0; widx.push_back(r); }
            wv[r] += cval[p];
        }
        // w -= U[j][k] * L[k+1:n, j] for all j < k with U[j][k] != 0
        for (int32_t j = uhead[k]; j != -1; j = unext[j]) {
            double ujk = urows[j][upos[j]].v;        // U entry at row j, col k
            const auto& lc = lcols[j];
            for (size_t q = lpos[j]; q < lc.size(); ++q) {
                int32_t r = lc[q].idx;
                if (r <= k) continue;                // row k went into z
                if (wmark[r] != k) { wmark[r] = k; wv[r] = 0.0; widx.push_back(r); }
                wv[r] -= ujk * lc[q].v;
            }
        }
        // ---- advance the chains past position k ---------------------------
        for (int32_t j = uhead[k]; j != -1;) {
            int32_t nj = unext[j];
            if ((size_t)(++upos[j]) < urows[j].size()) {
                int32_t c = urows[j][upos[j]].idx;
                unext[j] = uhead[c]; uhead[c] = j;
            }
            j = nj;
        }
        uhead[k] = -1;
        for (int32_t j = lhead[k]; j != -1;) {
            int32_t nj = lnext[j];
            if ((size_t)(++lpos[j]) < lcols[j].size()) {
                int32_t r = lcols[j][lpos[j]].idx;
                lnext[j] = lhead[r]; lhead[r] = j;
            }
            j = nj;
        }
        lhead[k] = -1;

        // ---- drop + store row k of U -------------------------------------
        double dv = (zmark[k] == k) ? zv[k] : 0.0;
        double tol_r = drop * rownrm[k];
        double tol_c = drop * colnrm[k];
        int32_t pf_r = std::max((int32_t)(rate * nnz_row[k]), 2);
        int32_t pf_c = std::max((int32_t)(rate * nnz_col[k]), 2);
        cand.clear();
        for (int32_t c : zidx)
            if (c > k && std::fabs(zv[c]) >= tol_r)
                cand.push_back({std::fabs(zv[c]), c});
        if ((int32_t)cand.size() > pf_r) {
            std::partial_sort(cand.begin(), cand.begin() + pf_r, cand.end(),
                              std::greater<>());
            cand.resize(pf_r);
        }
        std::sort(cand.begin(), cand.end(),
                  [](const auto& a, const auto& b) { return a.second < b.second; });
        if (dv == 0.0) dv = rownrm[k];
        auto& uk = urows[k];
        uk.reserve(cand.size() + 1);
        uk.push_back({k, dv});
        for (auto& pr : cand) uk.push_back({pr.second, zv[pr.second]});
        if (uk.size() > 1) {                         // chain strict-upper part
            upos[k] = 1;
            int32_t c = uk[1].idx;
            unext[k] = uhead[c]; uhead[c] = k;
        } else {
            upos[k] = 1;
        }
        // ---- drop + store column k of L (scaled by 1/dv) -----------------
        cand.clear();
        for (int32_t r : widx)
            if (std::fabs(wv[r]) >= tol_c)
                cand.push_back({std::fabs(wv[r]), r});
        if ((int32_t)cand.size() > pf_c) {
            std::partial_sort(cand.begin(), cand.begin() + pf_c, cand.end(),
                              std::greater<>());
            cand.resize(pf_c);
        }
        std::sort(cand.begin(), cand.end(),
                  [](const auto& a, const auto& b) { return a.second < b.second; });
        auto& lk = lcols[k];
        lk.reserve(cand.size());
        for (auto& pr : cand) lk.push_back({pr.second, wv[pr.second] / dv});
        if (!lk.empty()) {
            lpos[k] = 0;
            int32_t r = lk[0].idx;
            lnext[k] = lhead[r]; lhead[r] = k;
        }
    }

    // ---- emit combined-LU CSR (L strict lower + U incl. diagonal) --------
    std::vector<int32_t> lrow_cnt(n, 0);
    for (int32_t j = 0; j < n; ++j)
        for (auto& e : lcols[j]) ++lrow_cnt[e.idx];
    int64_t nnz = 0;
    for (int32_t i = 0; i < n; ++i)
        nnz += lrow_cnt[i] + (int64_t)urows[i].size();
    *out_ptr = (int32_t*)malloc((n + 1) * sizeof(int32_t));
    *out_index = (int32_t*)malloc(nnz * sizeof(int32_t));
    *out_value = (double*)malloc(nnz * sizeof(double));
    (*out_ptr)[0] = 0;
    for (int32_t i = 0; i < n; ++i)
        (*out_ptr)[i + 1] = (*out_ptr)[i] + lrow_cnt[i]
                            + (int32_t)urows[i].size();
    std::vector<int32_t> wpos(n);
    for (int32_t i = 0; i < n; ++i) wpos[i] = (*out_ptr)[i];
    for (int32_t j = 0; j < n; ++j)                  // L entries column-major
        for (auto& e : lcols[j]) {
            (*out_index)[wpos[e.idx]] = j;
            (*out_value)[wpos[e.idx]] = e.v;
            ++wpos[e.idx];
        }
    for (int32_t i = 0; i < n; ++i) {
        // L part is already in ascending column order (columns visited in
        // order); U part follows, diag first then sorted strict-upper
        for (auto& e : urows[i]) {
            (*out_index)[wpos[i]] = e.idx;
            (*out_value)[wpos[i]] = e.v;
            ++wpos[i];
        }
    }
    *out_nnz = nnz;
    return 0;
}

// ---------------------------------------------------------------------------
// SAINV: stabilised A-biconjugation  Wᵀ A Z = D  with sparse columns and
// update-term dropping (reference lis_precon_create_sainv_csr,
// src/precon/lis_precon_sainv.c:59: right-looking; at step i only the
// columns j>i where (A·Z_i)_j or (W_iᵀ·A)_j is nonzero are updated, and
// the update term drop((coef)·col_i, tol) is dropped entrywise).
// O(nnz-of-factors · avg column length) work, O(nnz) memory — no dense
// n×n anywhere.  Outputs Z and W as row-wise CSR (n×n, unit diagonal
// included) plus dinv[n].
// ---------------------------------------------------------------------------
int sainv_factor(int32_t n, const int32_t* ptr, const int32_t* index,
                 const double* value, double tol,
                 int32_t** zptr, int32_t** zidx, double** zval, int64_t* znnz,
                 int32_t** wptr, int32_t** widx, double** wval, int64_t* wnnz,
                 double* dinv) {
    // CSC of A for the l = A·Z_i product
    std::vector<int64_t> cptr(n + 1, 0);
    for (int32_t i = 0; i < n; ++i)
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) ++cptr[index[p] + 1];
    for (int32_t c = 0; c < n; ++c) cptr[c + 1] += cptr[c];
    std::vector<int32_t> crow(cptr[n]);
    std::vector<double> cval(cptr[n]);
    {
        std::vector<int64_t> fp(cptr.begin(), cptr.end() - 1);
        for (int32_t i = 0; i < n; ++i)
            for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
                int32_t c = index[p];
                crow[fp[c]] = i;
                cval[fp[c]] = value[p];
                ++fp[c];
            }
    }

    struct Ent { int32_t idx; double v; };
    std::vector<std::vector<Ent>> Zc(n), Wc(n);
    for (int32_t i = 0; i < n; ++i) {
        Zc[i].push_back({i, 1.0});
        Wc[i].push_back({i, 1.0});
    }

    std::vector<double> lv(n, 0.0), uv(n, 0.0), colv(n, 0.0);
    std::vector<int32_t> lmark(n, -1), umark(n, -1), colmark(n, -1);
    std::vector<int32_t> lidx, uidx, colidx;
    std::vector<Ent> merged;

    // sparse column update: col_j -= coef * col_i, dropping update-term
    // entries |coef*v| < tol (the diagonal of col_j is never dropped).
    // stamp is a fresh marker per call (j alone would collide between the
    // W and Z updates of the same step)
    int32_t stamp = 0;
    auto update_col = [&](std::vector<std::vector<Ent>>& C, int32_t j,
                          int32_t i, double coef) {
        ++stamp;
        colidx.clear();
        for (auto& e : C[j]) {
            colmark[e.idx] = stamp;
            colv[e.idx] = e.v;
            colidx.push_back(e.idx);
        }
        for (auto& e : C[i]) {
            double t = coef * e.v;
            if (std::fabs(t) < tol) continue;       // update-term drop
            if (colmark[e.idx] != stamp) {
                colmark[e.idx] = stamp;
                colv[e.idx] = 0.0;
                colidx.push_back(e.idx);
            }
            colv[e.idx] -= t;
        }
        merged.clear();
        merged.reserve(colidx.size());
        std::sort(colidx.begin(), colidx.end());
        for (int32_t r : colidx) {
            if (r != j && colv[r] == 0.0) continue;
            merged.push_back({r, colv[r]});
        }
        C[j].assign(merged.begin(), merged.end());
    };

    for (int32_t i = 0; i < n; ++i) {
        // l = A · Z_i (sparse, via CSC columns of A)
        lidx.clear();
        for (auto& e : Zc[i])
            for (int64_t p = cptr[e.idx]; p < cptr[e.idx + 1]; ++p) {
                int32_t r = crow[p];
                if (lmark[r] != i) { lmark[r] = i; lv[r] = 0.0; lidx.push_back(r); }
                lv[r] += cval[p] * e.v;
            }
        // u = W_iᵀ · A (sparse, via CSR rows of A)
        uidx.clear();
        for (auto& e : Wc[i])
            for (int32_t p = ptr[e.idx]; p < ptr[e.idx + 1]; ++p) {
                int32_t c = index[p];
                if (umark[c] != i) { umark[c] = i; uv[c] = 0.0; uidx.push_back(c); }
                uv[c] += e.v * value[p];
            }
        // D_ii = u · Z_i
        double dd = 0.0;
        for (auto& e : Zc[i])
            if (umark[e.idx] == i) dd += uv[e.idx] * e.v;
        if (dd == 0.0) { dinv[i] = 1.0; continue; }
        dinv[i] = 1.0 / dd;

        for (int32_t j : lidx)
            if (j > i && lv[j] != 0.0) update_col(Wc, j, i, lv[j] / dd);
        for (int32_t j : uidx)
            if (j > i && uv[j] != 0.0) update_col(Zc, j, i, uv[j] / dd);
    }

    // emit both factors as row-wise CSR (transpose of the column store)
    auto emit = [&](std::vector<std::vector<Ent>>& C, int32_t** optr,
                    int32_t** oidx, double** oval, int64_t* onnz) {
        std::vector<int32_t> rcnt(n, 0);
        int64_t nnz = 0;
        for (int32_t j = 0; j < n; ++j) {
            nnz += (int64_t)C[j].size();
            for (auto& e : C[j]) ++rcnt[e.idx];
        }
        *optr = (int32_t*)malloc((n + 1) * sizeof(int32_t));
        *oidx = (int32_t*)malloc(nnz * sizeof(int32_t));
        *oval = (double*)malloc(nnz * sizeof(double));
        (*optr)[0] = 0;
        for (int32_t r = 0; r < n; ++r) (*optr)[r + 1] = (*optr)[r] + rcnt[r];
        std::vector<int32_t> wp(*optr, *optr + n);
        for (int32_t j = 0; j < n; ++j)
            for (auto& e : C[j]) {
                (*oidx)[wp[e.idx]] = j;
                (*oval)[wp[e.idx]] = e.v;
                ++wp[e.idx];
            }
        *onnz = nnz;
    };
    emit(Zc, zptr, zidx, zval, znnz);
    emit(Wc, wptr, widx, wval, wnnz);
    return 0;
}

// ---------------------------------------------------------------------------
// SA-AMG greedy independent-set aggregation (reference aggregate_mod,
// src/fortran/amg/lis_m_aggregate_mod.F90:45).  Input: the strength graph
// as CSR (pattern only).  Phase 1: unaggregated nodes whose strong
// neighborhood is unaggregated become roots and absorb it; phase 2:
// stragglers attach to an adjacent aggregate (or become singletons).
// Returns the number of aggregates; fills agg[n].
// ---------------------------------------------------------------------------
int32_t amg_aggregate(int32_t n, const int32_t* ptr, const int32_t* index,
                      int32_t* agg) {
    for (int32_t i = 0; i < n; ++i) agg[i] = -1;
    int32_t nagg = 0;
    for (int32_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        int all_free = 1;
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p)
            if (agg[index[p]] != -1) { all_free = 0; break; }
        if (!all_free) continue;
        agg[i] = nagg;
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p)
            agg[index[p]] = nagg;
        ++nagg;
    }
    for (int32_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        int32_t hit = -1;
        for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p)
            if (agg[index[p]] != -1) { hit = agg[index[p]]; break; }
        agg[i] = (hit != -1) ? hit : nagg++;
    }
    return nagg;
}

// ---------------------------------------------------------------------------
// Level scheduling for triangular solves: lev[i] = 1 + max(lev[deps]).
// direction: 1 = lower (ascending rows), 0 = upper (descending).
// Returns the number of levels; fills lev[n].
// ---------------------------------------------------------------------------
int32_t level_schedule(int32_t n, const int32_t* ptr, const int32_t* index,
                       int32_t lower, int32_t* lev) {
    int32_t maxlev = 0;
    if (lower) {
        for (int32_t i = 0; i < n; ++i) {
            int32_t l = 0;
            for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
                int32_t d = lev[index[p]] + 1;
                if (d > l) l = d;
            }
            lev[i] = l;
            if (l > maxlev) maxlev = l;
        }
    } else {
        for (int32_t i = n - 1; i >= 0; --i) {
            int32_t l = 0;
            for (int32_t p = ptr[i]; p < ptr[i + 1]; ++p) {
                int32_t d = lev[index[p]] + 1;
                if (d > l) l = d;
            }
            lev[i] = l;
            if (l > maxlev) maxlev = l;
        }
    }
    return maxlev + 1;
}

// ---------------------------------------------------------------------------
// Matrix Market coordinate parser (real/integer/pattern).
// Returns nnz read, or -1 on error.  Caller passes preallocated arrays of
// size nnz (from the header), 1-based indices are converted to 0-based.
// ---------------------------------------------------------------------------
int64_t mm_parse_coords(const char* path, int64_t skip_lines, int64_t nnz,
                        int32_t pattern, int32_t* rows, int32_t* cols,
                        double* vals) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    char buf[1024];
    for (int64_t i = 0; i < skip_lines; ++i) {
        if (!fgets(buf, sizeof buf, f)) { fclose(f); return -1; }
    }
    int64_t k = 0;
    while (k < nnz && fgets(buf, sizeof buf, f)) {
        if (buf[0] == '%' || buf[0] == '\n') continue;
        long r, c;
        double v = 1.0;
        if (pattern) {
            if (sscanf(buf, "%ld %ld", &r, &c) != 2) { fclose(f); return -1; }
        } else {
            if (sscanf(buf, "%ld %ld %lf", &r, &c, &v) != 3) {
                fclose(f);
                return -1;
            }
        }
        rows[k] = (int32_t)(r - 1);
        cols[k] = (int32_t)(c - 1);
        vals[k] = v;
        ++k;
    }
    fclose(f);
    return k;
}

void lis_native_free(void* p) { free(p); }

// ILU(0) directly on DIA storage: diags is nnd x n row-major
// (diags[k*n + i] = A[i, i+offsets[k]]), factored IN PLACE into combined
// LU (L factors at negative offsets, U incl. diagonal at >= 0).  The
// sparsity pattern is the set of structurally nonzero positions at entry;
// no fill outside it (classic ILU(0)).
int ilu0_dia(int64_t n, int32_t nnd, const int64_t* offsets, double* diags) {
    int32_t d0 = -1;
    for (int32_t k = 0; k < nnd; ++k)
        if (offsets[k] == 0) d0 = k;
    if (d0 < 0) return -1;

    // idx[a*nnd + b] = position of offset (off[a]+off[b]) or -1
    std::vector<int32_t> idx((size_t)nnd * nnd, -1);
    for (int32_t a = 0; a < nnd; ++a)
        for (int32_t b = 0; b < nnd; ++b) {
            int64_t t = offsets[a] + offsets[b];
            for (int32_t c = 0; c < nnd; ++c)
                if (offsets[c] == t) { idx[(size_t)a * nnd + b] = c; break; }
        }
    // structural pattern at entry
    std::vector<uint8_t> pat((size_t)nnd * n);
    for (size_t q = 0; q < (size_t)nnd * n; ++q) pat[q] = diags[q] != 0.0;

    for (int64_t i = 0; i < n; ++i) {
        for (int32_t a = 0; a < nnd; ++a) {
            if (offsets[a] >= 0) continue;
            if (!pat[(size_t)a * n + i]) continue;
            int64_t k = i + offsets[a];
            if (k < 0) continue;
            double ukk = diags[(size_t)d0 * n + k];
            if (ukk == 0.0) continue;
            double f = diags[(size_t)a * n + i] / ukk;
            diags[(size_t)a * n + i] = f;
            for (int32_t b = 0; b < nnd; ++b) {
                if (offsets[b] <= 0) continue;
                if (!pat[(size_t)b * n + k]) continue;
                int32_t c = idx[(size_t)a * nnd + b];
                if (c < 0 || !pat[(size_t)c * n + i]) continue;
                diags[(size_t)c * n + i] -= f * diags[(size_t)b * n + k];
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// greedy_color — sequential greedy proper edge coloring of a bipartite
// multigraph with d <= 128 colors (free-color bitmasks, first-free pick).
// Succeeds with high probability when the slot grid has slack (the Benes
// shuffle routing's common case, ops/shuffle.py); returns the number of
// edges left uncolored (color = -1), for which the caller falls back to
// the exact Euler decomposition.
// ---------------------------------------------------------------------------
int64_t greedy_color(int64_t m, const int64_t* left, const int64_t* right,
                     int64_t n_nodes, int32_t d, int32_t* color) {
    std::vector<uint64_t> fl(2 * n_nodes, ~0ULL), fr(2 * n_nodes, ~0ULL);
    if (d < 64) {
        uint64_t lo = (1ULL << d) - 1;
        for (int64_t i = 0; i < n_nodes; ++i) {
            fl[2 * i] = lo; fl[2 * i + 1] = 0;
            fr[2 * i] = lo; fr[2 * i + 1] = 0;
        }
    } else if (d < 128) {
        uint64_t hi = (d == 128) ? ~0ULL : ((1ULL << (d - 64)) - 1);
        for (int64_t i = 0; i < n_nodes; ++i) {
            fl[2 * i + 1] = hi;
            fr[2 * i + 1] = hi;
        }
    }
    int64_t fails = 0;
    uint64_t rnd = 0x9e3779b97f4a7c15ULL;   // xorshift state
    for (int64_t e = 0; e < m; ++e) {
        uint64_t* L = &fl[2 * left[e]];
        uint64_t* R = &fr[2 * right[e]];
        uint64_t w0 = L[0] & R[0];
        uint64_t w1 = L[1] & R[1];
        int pc0 = __builtin_popcountll(w0);
        int pc = pc0 + __builtin_popcountll(w1);
        if (pc == 0) { color[e] = -1; ++fails; continue; }
        // random free color: first-free drains low colors into disjoint
        // free sets and stalls; a uniform pick keeps them overlapping
        rnd ^= rnd << 13; rnd ^= rnd >> 7; rnd ^= rnd << 17;
        int k = (int)(rnd % (uint64_t)pc);
        int c;
        if (k < pc0) {
            uint64_t w = w0;
            for (int t = 0; t < k; ++t) w &= w - 1;
            c = __builtin_ctzll(w);
        } else {
            uint64_t w = w1;
            for (int t = pc0; t < k; ++t) w &= w - 1;
            c = 64 + __builtin_ctzll(w);
        }
        color[e] = c;
        if (c < 64) { L[0] &= ~(1ULL << c); R[0] &= ~(1ULL << c); }
        else { L[1] &= ~(1ULL << (c - 64)); R[1] &= ~(1ULL << (c - 64)); }
    }
    return fails;
}

// ---------------------------------------------------------------------------
// euler_split — one Euler-orientation split of an even-regular bipartite
// multigraph, the inner step of Benes-network routing (ops/shuffle.py).
//
// Input: m edges (u[i] in [0,nu), v[i] in [0,nv)); every node's degree is
// even.  Output bit[i] = direction of edge i in an Euler circuit
// (1 = traversed left->right).  Each node's incident edges then split
// exactly in half between bit 0 and bit 1, so splitting a 2h-regular
// graph log2(d) times colors its edges with d colors such that each
// color class is a perfect matching — the route computation for the
// mixed-radix Benes shuffle network (TPU-side: pallas lane shuffles).
// ---------------------------------------------------------------------------
int euler_split(int64_t m, const int64_t* u, const int64_t* v,
                int64_t nu, int64_t nv, uint8_t* bit) {
    const int64_t n = nu + nv;           // right nodes offset by nu
    // CSR adjacency over both sides; each entry packs
    // (far_node << 33) | (edge_id << 1) | is_left_endpoint so the walk
    // touches one sequential stream per node instead of random u/v reads
    std::vector<int64_t> deg(n + 1, 0);
    for (int64_t i = 0; i < m; ++i) { ++deg[u[i] + 1]; ++deg[nu + v[i] + 1]; }
    for (int64_t i = 0; i < n; ++i) deg[i + 1] += deg[i];
    std::vector<int64_t> adj(2 * m);
    {
        std::vector<int64_t> pos(deg.begin(), deg.end() - 1);
        for (int64_t i = 0; i < m; ++i) {
            adj[pos[u[i]]++] = ((nu + v[i]) << 33) | ((int64_t)i << 1) | 1;
            adj[pos[nu + v[i]]++] = (u[i] << 33) | ((int64_t)i << 1);
        }
    }
    std::vector<int64_t> cursor(deg.begin(), deg.end() - 1);
    std::vector<uint64_t> used((m + 63) / 64, 0);
    // Hierholzer: walk circuits, orienting each edge in traversal
    // direction.  Even degrees guarantee every walk returns to its start,
    // so each node's in- and out-degrees match.
    for (int64_t s = 0; s < n; ++s) {
        for (;;) {
            int64_t node = s;
            bool moved = false;
            for (;;) {
                int64_t c = cursor[node], end = deg[node + 1];
                int64_t e = -1, packed = 0;
                while (c < end) {
                    packed = adj[c];
                    e = (packed >> 1) & ((1LL << 32) - 1);
                    if (!((used[e >> 6] >> (e & 63)) & 1)) break;
                    ++c;
                }
                cursor[node] = c;
                if (c == end) break;     // circuit closed at this node
                used[e >> 6] |= 1ULL << (e & 63);
                bit[e] = packed & 1;     // 1 iff traversed left -> right
                node = packed >> 33;
                moved = true;
            }
            if (!moved) break;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// pass_idx — lane-shuffle gather table for one Benes pass
// (ops/shuffle.py:_pass_idx).  pos_before/pos_after hold each real
// element's slot before/after the pass; d, s are powers of two
// (d <= 128).  idx (size M, viewed as (M/128, 128) rows) receives the
// within-row gather: idx[row, lane_after] = lane_before.  With
// exact_holes, unread source lanes are paired with unwritten output
// lanes per row so every row stays a true permutation (hole slots then
// provably carry their zero payloads — no mask needed downstream).
// Replaces two global np.nonzero scans + fancy-index writes per pass.
// ---------------------------------------------------------------------------
int pass_idx(int64_t nnz, const int64_t* pb, const int64_t* pa,
             int64_t d, int64_t s, int64_t M, int exact_holes,
             int32_t* idx) {
    const int ls = __builtin_ctzll((unsigned long long)s);
    const int ld = __builtin_ctzll((unsigned long long)d);
    const int64_t gpr = 128 / d;
    const int lg = __builtin_ctzll((unsigned long long)gpr);
    const int64_t R = M / 128;
    if (!exact_holes) {
        for (int64_t r = 0; r < R; ++r)
            for (int l = 0; l < 128; ++l) idx[r * 128 + l] = l;
        for (int64_t i = 0; i < nnz; ++i) {
            int64_t g = ((pa[i] >> (ld + ls)) << ls) + (pa[i] & (s - 1));
            int32_t ab = (int32_t)((pb[i] >> ls) & (d - 1));
            int32_t aa = (int32_t)((pa[i] >> ls) & (d - 1));
            int32_t base = (int32_t)((g & (gpr - 1)) << ld);
            idx[(g >> lg) * 128 + base + aa] = base + ab;
        }
        return 0;
    }
    std::vector<uint8_t> read(M, 0);
    std::fill(idx, idx + M, -1);
    for (int64_t i = 0; i < nnz; ++i) {
        int64_t g = ((pa[i] >> (ld + ls)) << ls) + (pa[i] & (s - 1));
        int32_t ab = (int32_t)((pb[i] >> ls) & (d - 1));
        int32_t aa = (int32_t)((pa[i] >> ls) & (d - 1));
        int64_t row = g >> lg;
        int32_t base = (int32_t)((g & (gpr - 1)) << ld);
        idx[row * 128 + base + aa] = base + ab;
        read[row * 128 + base + ab] = 1;
    }
    for (int64_t r = 0; r < R; ++r) {
        const int64_t o = r * 128;
        int un = 0;
        for (int l = 0; l < 128; ++l) {
            if (idx[o + l] < 0) {
                while (read[o + un]) ++un;
                idx[o + l] = un++;
            }
        }
    }
    return 0;
}

}  // extern "C"
