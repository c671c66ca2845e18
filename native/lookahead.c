/* Fast APF lookahead scan: native host-side compute.
 *
 * Equivalent of the reference's Segment::set_lookahead
 * (src/segdata.cpp:225-410) and a line-for-line port of the Python oracle
 * in smcsmc_tpu/lookahead.py (compute_lookahead_py) — the Python scan is
 * quadratic in segments x lineages and costs ~3 ms/segment at n=8, which
 * dominates APF preprocessing on whole-chromosome inputs.
 *
 * Built on first use into build/ and loaded via ctypes
 * (smcsmc_tpu/lookahead.py, smcsmc_tpu/_native.py), falling back to the
 * Python oracle when no C compiler is available.  The oracle-vs-native equality is
 * gated by tests/test_apf.py::TestNativeLookahead.
 *
 * All output arrays are caller-allocated and pre-filled with the "empty"
 * values (fsd 0, rel_mu 1, dbl_s1/s2 -1, split_dist -1, split_alleles -1,
 * everything else 0); the scan only overwrites what it finds.
 */

#include <stdint.h>
#include <string.h>

#define MAX_MISSING_DATA 2000000.0
#define EPSILON 1e-6

typedef struct {
    int s1, s2;
    double first_ev, last_ev;
    uint8_t u1, u2, incompat;
} Doubleton;

void lookahead_scan(long S, int n, int D,
                    const double *pos, const double *len,
                    const int8_t *al, const uint8_t *is_mut_row,
                    float *fsd_out, float *rel_mu_out, uint8_t *unph_out,
                    int32_t *dbl_s1, int32_t *dbl_s2,
                    float *dbl_first, float *dbl_last,
                    uint8_t *dbl_u1, uint8_t *dbl_u2,
                    float *split_dist, int8_t *split_alleles,
                    int32_t *split_k)
{
    /* scratch (VLA-free: n <= 64 per the descendants contract) */
    double fsd[64], rel_mu[64];
    uint8_t unph[64], found_dbl[64], sing_unph[64];
    Doubleton dbl[256]; /* D is clamped by the caller to <= 256 */

    for (long i = 0; i < S; i++) {
        memset(unph, 0, n);
        memset(found_dbl, 0, n);
        for (int k = 0; k < n; k++) { fsd[k] = 0.0; rel_mu[k] = 0.0; }
        int n_dbl = 0;
        int num_singletons = 0, num_unph_singletons = 0, num_dbl_seq = 0;
        double tlb = 0.1, tlbm = 0.1;
        double cur_missing = 0.0, last_sing_dist = 0.0, distance = 0.0;
        const double base = pos[i];

        for (long j = i; j < S; j++) {
            const int8_t *a = al + (size_t)j * n;
            const int mut_row = is_mut_row[j];

            /* per-lineage variant/missing bookkeeping (segdata.cpp:263-306) */
            int num_var = 0, s1 = -1, s2 = -1;
            memset(sing_unph, 0, n);
            int num_missing = 0;
            for (int k = 0; k < n; k++) if (a[k] == -1) num_missing++;
            if (num_missing) cur_missing += len[j];
            for (int k = 0; k < n; k++) {
                if (mut_row && a[k] > 0) {
                    num_var++;
                    if (num_var == 1) s1 = k;
                    else if (num_var == 2) s2 = k;
                    if (a[k] == 2) {
                        sing_unph[k] = 1;
                        if (k + 1 < n) sing_unph[k + 1] = 1;
                        k++; /* skip the pair partner */
                    }
                }
            }
            if (cur_missing > MAX_MISSING_DATA) {
                for (int jj = 0; jj < n; jj++) {
                    if (a[jj] != -1) continue;
                    if (fsd[jj] == 0.0) {
                        /* long missing streak: give up on this lineage
                         * (segdata.cpp:288-300; effective value -epsilon) */
                        last_sing_dist = pos[j] - base;
                        fsd[jj] = -EPSILON;
                        rel_mu[jj] = tlbm / tlb;
                        num_singletons++;
                    }
                    if (!found_dbl[jj]) { found_dbl[jj] = 1; num_dbl_seq++; }
                }
            }
            if (num_missing == 0) cur_missing = 0.0;
            tlb += len[j] * n;
            tlbm += len[j] * (n - num_missing);
            if (cur_missing > MAX_MISSING_DATA) continue;

            int have_dbl = 0;
            distance = pos[j] + len[j] - base + 0.5;
            if (num_var == 1) { /* singleton (segdata.cpp:319-334) */
                if (fsd[s1] == 0.0) {
                    fsd[s1] = distance;
                    rel_mu[s1] = tlbm / tlb;
                    num_singletons++;
                    last_sing_dist = distance;
                    if (sing_unph[s1]) {
                        unph[s1] = 1;
                        if (s1 + 1 < n) {
                            fsd[s1 + 1] = distance;
                            rel_mu[s1 + 1] = rel_mu[s1];
                        }
                        num_singletons++;
                        num_unph_singletons++;
                    }
                }
            } else if (mut_row) { /* non-singleton (segdata.cpp:335-357) */
                for (int d = 0; d < n_dbl; d++) {
                    const int ds1 = dbl[d].s1, ds2 = dbl[d].s2;
                    if (((ds1 | 1) == ds2 && a[ds1] == 2) ||
                        (a[ds1] >= 0 && a[ds2] >= 0 &&
                         a[ds1] + a[ds2] == 1 && (a[ds1] | a[ds2]) == 1)) {
                        dbl[d].incompat = 1;
                    }
                    if (num_var == 2 && ds1 == s1 && ds2 == s2) {
                        have_dbl = 1;
                        if (!dbl[d].incompat) dbl[d].last_ev = distance;
                    }
                }
            }
            /* enter new doubleton (segdata.cpp:359-373) */
            if (num_var == 2 && !have_dbl && a[s1] > -1 && a[s2] > -1 &&
                n_dbl < D) {
                int entered = 0;
                for (int d1 = 0; d1 <= (a[s1] == 2) && !entered; d1++) {
                    for (int d2 = 0; d2 <= (a[s2] == 2) && !entered; d2++) {
                        const int i1 = s1 + d1, i2 = s2 + d2;
                        if (i1 < n && i2 < n && !found_dbl[i1] &&
                            !found_dbl[i2]) {
                            dbl[n_dbl].s1 = s1;
                            dbl[n_dbl].s2 = s2;
                            dbl[n_dbl].first_ev = distance;
                            dbl[n_dbl].last_ev = distance;
                            dbl[n_dbl].u1 = (a[s1] == 2);
                            dbl[n_dbl].u2 = (a[s2] == 2);
                            dbl[n_dbl].incompat = 0;
                            n_dbl++;
                            found_dbl[i1] = 1;
                            found_dbl[i2] = 1;
                            num_dbl_seq += 2;
                            entered = 1;
                        }
                    }
                }
            }
            /* first split (segdata.cpp:375-380) */
            if (split_dist[i] < 0.0f && mut_row && num_var > 2 &&
                n - num_var > 2) {
                split_dist[i] = (float)distance;
                memcpy(split_alleles + (size_t)i * n, a, n);
                split_k[i] = num_var < n - num_var ? num_var : n - num_var;
            }
            /* bail-outs (segdata.cpp:382-387) */
            if (num_singletons >= n && num_dbl_seq >= n - 1) break;
            if (num_singletons >= n &&
                distance > (2 + num_unph_singletons) * last_sing_dist)
                break;
        }

        /* fill in lineages with no singleton found (segdata.cpp:389-396) */
        for (int jj = 0; jj < n; jj++) {
            if (fsd[jj] == 0.0) {
                fsd[jj] = -distance;
                rel_mu[jj] = tlbm / tlb;
            }
        }
        for (int k = 0; k < n; k++) {
            fsd_out[(size_t)i * n + k] = (float)fsd[k];
            rel_mu_out[(size_t)i * n + k] = (float)rel_mu[k];
            unph_out[(size_t)i * n + k] = unph[k];
        }
        const int nd = n_dbl < D ? n_dbl : D;
        for (int d = 0; d < nd; d++) {
            dbl_s1[(size_t)i * D + d] = dbl[d].s1;
            dbl_s2[(size_t)i * D + d] = dbl[d].s2;
            dbl_first[(size_t)i * D + d] = (float)dbl[d].first_ev;
            dbl_last[(size_t)i * D + d] = (float)dbl[d].last_ev;
            dbl_u1[(size_t)i * D + d] = dbl[d].u1;
            dbl_u2[(size_t)i * D + d] = dbl[d].u2;
        }
    }
}
