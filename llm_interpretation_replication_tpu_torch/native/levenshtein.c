/* Levenshtein edit distance — native kernel.
 *
 * The reference's prompt-similarity validator depends on python-Levenshtein
 * (a C library; requirements.txt + calculate_prompt_similarity.py).  This is
 * the equivalent native component of the PyTorch port, built by the host's
 * `cc` on first use (native/__init__.py): two-row DP over UTF-32 code
 * points, O(min(m,n)) memory, called from Python via ctypes.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static size_t min3(size_t a, size_t b, size_t c) {
    size_t m = a < b ? a : b;
    return m < c ? m : c;
}

/* Distance over uint32 code-point arrays. Returns SIZE_MAX on alloc failure. */
size_t levenshtein_u32(const uint32_t *a, size_t la, const uint32_t *b, size_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    /* keep the shorter string in the inner dimension */
    if (lb > la) {
        const uint32_t *ts = a; a = b; b = ts;
        size_t tl = la; la = lb; lb = tl;
    }
    size_t *prev = (size_t *)malloc((lb + 1) * sizeof(size_t));
    size_t *curr = (size_t *)malloc((lb + 1) * sizeof(size_t));
    if (!prev || !curr) {
        free(prev); free(curr);
        return (size_t)-1;
    }
    for (size_t j = 0; j <= lb; j++) prev[j] = j;
    for (size_t i = 1; i <= la; i++) {
        curr[0] = i;
        uint32_t ca = a[i - 1];
        for (size_t j = 1; j <= lb; j++) {
            size_t cost = (ca == b[j - 1]) ? 0 : 1;
            curr[j] = min3(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + cost);
        }
        size_t *tmp = prev; prev = curr; curr = tmp;
    }
    size_t result = prev[lb];
    free(prev);
    free(curr);
    return result;
}

/* Batched pairwise distances: out[i] = d(a, bs_i); offsets delimit bs rows. */
void levenshtein_u32_batch(
    const uint32_t *a, size_t la,
    const uint32_t *bs, const size_t *offsets, size_t n,
    size_t *out) {
    for (size_t i = 0; i < n; i++) {
        size_t start = offsets[i];
        size_t end = offsets[i + 1];
        out[i] = levenshtein_u32(a, la, bs + start, end - start);
    }
}
