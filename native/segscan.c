/* Fast .seg scanner: native host-side IO.
 *
 * Equivalent of the reference's buffered C++ reader (src/segdata.cpp:55-166):
 * parses tab-separated .seg rows (3- or 6-column) into preallocated arrays.
 * Built on first use into build/ and loaded via ctypes (smcsmc_tpu/segio.py,
 * smcsmc_tpu/_native.py), falling back to the pure-Python parser when no C
 * compiler is available.
 *
 * Allele codes (segdata.cpp:413-451): '0'->0 '1'->1 '.'->-1 '/'->2.
 *
 * Returns the number of rows parsed, or a negative error code:
 *   -1 allocation/format error, -2 non-consecutive segments,
 *   -3 inconsistent allele-column width, -4 bad allele code.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int code_of(char c) {
    switch (c) {
        case '0': return 0;
        case '1': return 1;
        case '.': return -1;
        case '/': return 2;
        default:  return -100;
    }
}

/* Scan the text buffer `buf` (NUL-terminated) of a .seg file.
 * Outputs (caller-allocated, capacity `cap` rows):
 *   pos[cap] (int64), len[cap] (int64), alleles[cap*nsam_max] (int8).
 * *nsam_out receives the column width.  check_consecutive != 0 enforces
 * segment adjacency. */
long segscan_parse(const char *buf, long cap, int nsam_max,
                   int64_t *pos, int64_t *len_out, int8_t *alleles,
                   int *nsam_out, int check_consecutive) {
    long rows = 0;
    int nsam = -1;
    int64_t next_start = -1;
    const char *p = buf;

    while (*p) {
        /* skip comment lines */
        if (*p == '#') {
            while (*p && *p != '\n') p++;
            if (*p) p++;
            continue;
        }
        if (*p == '\n') { p++; continue; }
        if (rows >= cap) return -1;

        char *end;
        int64_t start = strtoll(p, &end, 10);
        if (end == p || *end != '\t') return -1;
        p = end + 1;
        /* length column may carry a decimal point (segdata.cpp:86) */
        int64_t seglen = strtoll(p, &end, 10);
        if (end == p) return -1;
        while (*end && *end != '\t' && *end != '\n') end++;
        if (*end != '\t') return -1;
        p = end + 1;

        /* 6-column variant: T/F, T/F, chrom, alleles */
        if ((p[0] == 'T' || p[0] == 'F') && p[1] == '\t') {
            p += 2;
            if (!((p[0] == 'T' || p[0] == 'F') && p[1] == '\t')) return -1;
            p += 2;
            strtoll(p, &end, 10); /* chromosome, unused */
            if (*end != '\t') return -1;
            p = end + 1;
        }

        /* allele column */
        int col = 0;
        while (*p && *p != '\n' && *p != '\t' && *p != '\r') {
            int c = code_of(*p);
            if (c == -100) return -4;
            if (col >= nsam_max) return -3;
            alleles[rows * nsam_max + col] = (int8_t)c;
            col++;
            p++;
        }
        if (nsam < 0) nsam = col;
        else if (col != nsam) return -3;
        while (*p && *p != '\n') p++;
        if (*p) p++;

        if (check_consecutive && next_start >= 0 && next_start != start)
            return -2;
        next_start = start + seglen;

        pos[rows] = start;
        len_out[rows] = seglen;
        rows++;
    }
    *nsam_out = nsam < 0 ? 0 : nsam;
    return rows;
}

/* Count data rows (for caller preallocation). */
long segscan_count(const char *buf) {
    long rows = 0;
    const char *p = buf;
    while (*p) {
        if (*p != '#' && *p != '\n') rows++;
        while (*p && *p != '\n') p++;
        if (*p) p++;
    }
    return rows;
}
