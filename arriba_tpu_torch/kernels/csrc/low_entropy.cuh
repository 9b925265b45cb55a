// Per-position math of the read-level low-entropy filter
// (filter_low_entropy.cpp:60-100, K = 3).
//
// Shared by the CUDA kernel (low_entropy.cu) and a CPU build of the same
// functions (tests/test_torch_kernel_math.py).
//
// A read is flagged when some 3-mer, counted over a greedy non-overlapping
// selection, reaches the threshold of the whole read or of either aligned
// segment. For K = 3 the greedy selection needs no prev_pos table: position
// p is selected iff it is eligible and the same 3-mer was selected neither
// at p-1 nor at p-2 (arriba_tpu/ops/readfilters.py:216-226). The counters
// only grow, so the reference's early exit at the first crossing equals the
// check on the final counters restricted to 3-mers counted at least once.
//
// Rows of at most LE_PACKED_MAX_CODES codes take le_scan_packed: the
// three counters of a 3-mer in 10-bit fields of one word, one add a
// position, the thresholds tested once per 3-mer at the end. Longer rows
// take le_row, the sequential reference of the same selection with three
// counters a 3-mer.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int LE_K = 3;
constexpr int LE_KMERS = 64;       // 4^K counters per segment

// 2-bit code of position p in a row packed 4 codes per byte, low bits first
__host__ __device__ inline int le_code(const uint8_t* packed_row, int p) {
    return (packed_row[p >> 2] >> ((p & 3) << 1)) & 3;
}

struct LowEntropyCarry {
    bool sel1;  // selected at p-1
    bool sel2;  // selected at p-2
    int kv1;    // 3-mer at p-1
    int kv2;    // 3-mer at p-2
};

__host__ __device__ inline void le_init(LowEntropyCarry* c) {
    c->sel1 = false;
    c->sel2 = false;
    c->kv1 = 0;
    c->kv2 = 0;
}

// Is the 3-mer kv at an eligible position p selected? Shifts the carry.
__host__ __device__ inline bool le_select(LowEntropyCarry* c, int kv) {
    const bool sel = !(c->sel1 && kv == c->kv1) && !(c->sel2 && kv == c->kv2);
    c->sel2 = c->sel1;
    c->kv2 = c->kv1;
    c->sel1 = sel;
    c->kv1 = kv;
    return sel;
}

// Does a 3-mer starting at p count for the segment [start, end)?
// (filter_low_entropy.cpp:90-95: pos + 1 >= start && pos < end)
__host__ __device__ inline bool le_in_segment(int p, int start, int end) {
    return p + 1 >= start && p < end;
}

// Count one selected 3-mer in the three counter planes (plane k of kmer v
// at counts[(k * 64 + v) * stride]) and report whether one of its counters
// reached its threshold.
template <typename Counter>
__host__ __device__ inline bool le_count(Counter* counts, int stride, int kv,
                                         bool in_a1, bool in_a2, int th_all,
                                         int th_a1, int th_a2) {
    Counter* c_all = counts + kv * stride;
    Counter* c_a1 = counts + (LE_KMERS + kv) * stride;
    Counter* c_a2 = counts + (2 * LE_KMERS + kv) * stride;
    *c_all += 1;
    if (in_a1) *c_a1 += 1;
    if (in_a2) *c_a2 += 1;
    return (long long)*c_all >= th_all || (long long)*c_a1 >= th_a1
           || (long long)*c_a2 >= th_a2;
}

// One read: length <= L codes packed in packed_row; thresholds computed on
// the host. counts holds 3 * 64 counters at the given stride.
template <typename Counter>
__host__ __device__ inline bool le_row(const uint8_t* packed_row, int length,
                                       int a1s, int a1e, int a2s, int a2e,
                                       int th_all, int th_a1, int th_a2,
                                       Counter* counts, int stride) {
    if (length < LE_K) return false;
    for (int k = 0; k < 3 * LE_KMERS; ++k) counts[k * stride] = 0;
    LowEntropyCarry c;
    le_init(&c);
    int kv = (le_code(packed_row, 0) << 2) | le_code(packed_row, 1);
    for (int p = 0; p < length - LE_K; ++p) {
        kv = ((kv << 2) | le_code(packed_row, p + 2)) & (LE_KMERS - 1);
        if (le_select(&c, kv)
            && le_count(counts, stride, kv, le_in_segment(p, a1s, a1e),
                        le_in_segment(p, a2s, a2e), th_all, th_a1, th_a2)) {
            return true;
        }
    }
    return false;
}

// ---- the packed kernel's procedure

constexpr int LE_PACKED_MAX_CODES = 3072;

// The 3-mer at p of a packed row of row_bytes bytes, as an index 0-63:
// code(p) | code(p+1) << 2 | code(p+2) << 4. The digits run backwards
// against le_row's, a bijection of the 64 3-mers, which changes neither
// equality nor which counter crosses.
__host__ __device__ inline int le_kmer(const uint8_t* row, int row_bytes,
                                       int p) {
    const int q = p >> 2;
    const uint32_t x = row[q] | (q + 1 < row_bytes ? row[q + 1] << 8 : 0u);
    return (int)((x >> ((p & 3) << 1)) & 63u);
}

// A segment [start, end) as the positions p it counts for (p + 1 >= start
// and p < end, le_in_segment), clipped to [0, n_pos) once: p counts iff
// (unsigned)(p - lo) < (unsigned)n.
struct LeSegment {
    int lo;
    int n;
};

__host__ __device__ inline LeSegment le_segment(int start, int end,
                                                int n_pos) {
    const long long lo = start - 1LL > 0 ? start - 1LL : 0;
    const long long hi = end < n_pos ? end : n_pos;
    LeSegment seg;
    seg.lo = (int)(lo < n_pos ? lo : n_pos);
    seg.n = hi > lo ? (int)(hi - lo) : 0;
    return seg;
}

__host__ __device__ inline bool le_counts(LeSegment seg, int p) {
    return (unsigned)(p - seg.lo) < (unsigned)seg.n;
}

// Packed counter word of a 3-mer (rows of at most LE_PACKED_MAX_CODES
// codes, so at most 1023 selections of one 3-mer): whole read in bits
// 0-9, segment 1 in bits 10-19, segment 2 in bits 20-29.
__host__ __device__ inline uint32_t le_weight(LeSegment a1, LeSegment a2,
                                              int p) {
    return 1u + ((uint32_t)le_counts(a1, p) << 10)
           + ((uint32_t)le_counts(a2, p) << 20);
}

// Did a 3-mer counted at least once cross a threshold? c: its packed word.
__host__ __device__ inline bool le_crossed_packed(uint32_t c, int th_all,
                                                  int th_a1, int th_a2) {
    const uint32_t c_all = c & 0x3ffu;
    return c_all >= 1 && ((long long)c_all >= th_all
                          || (long long)((c >> 10) & 0x3ffu) >= th_a1
                          || (long long)((c >> 20) & 0x3ffu) >= th_a2);
}

// One read of a packed row: walks its eligible positions p < n_pos in
// order, whole groups of four from one byte pair, then the rest one at a
// time, calling add(kmer, w) at each, w the position's counter weight
// (le_weight) where the greedy selection takes p and 0 where it does not,
// so that the caller adds without a branch. As in le_select, p is taken
// unless its 3-mer equals one taken at p-1 or p-2.
template <typename Add>
__host__ __device__ inline void le_scan_packed(const uint8_t* row,
                                               int row_bytes, int n_pos,
                                               LeSegment a1, LeSegment a2,
                                               Add add) {
    int prev1 = 0, prev2 = 0;
    bool sel1 = false, sel2 = false;
    const auto step = [&](int p, int v) {
        const bool sel = !(sel1 && v == prev1) && !(sel2 && v == prev2);
        add(v, sel ? le_weight(a1, a2, p) : 0u);
        prev2 = prev1;
        prev1 = v;
        sel2 = sel1;
        sel1 = sel;
    };
    int p = 0;
    for (; p + 4 <= n_pos; p += 4) {
        const int at = p >> 2;
        const uint32_t x = row[at]
            | (at + 1 < row_bytes ? row[at + 1] << 8 : 0u);
#pragma unroll
        for (int i = 0; i < 4; ++i) step(p + i, (int)((x >> (2 * i)) & 63u));
    }
    for (; p < n_pos; ++p) step(p, le_kmer(row, row_bytes, p));
}

}  // namespace arriba
