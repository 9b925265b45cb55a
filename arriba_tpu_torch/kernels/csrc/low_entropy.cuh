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
// take the long-row procedure at the end of this file: a group of lanes a
// read, each lane a chunk of positions, the selection carried across the
// chunks as the JAX op carries it, a 4-state transfer table (le_table,
// le_compose). le_row is the sequential reference of the same selection
// with three counters a 3-mer.
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

// ---- the long-row kernel's procedure (rows past LE_PACKED_MAX_CODES)
//
// The JAX op does not walk a read: it builds one 4-state transfer table a
// position and composes them with an associative scan
// (arriba_tpu/ops/readfilters.py _low_entropy_core). So a read can be cut
// into chunks, a table built for each apart from the others, and a scan
// over the chunks' tables hands each chunk its start state.
//
// A group of LE_LONG_LANES lanes takes a read. Its eligible positions are
// cut into tiles; in a tile, lane l owns the words [l * words, (l + 1) *
// words) of the tile, a word being 16 positions (one 32-bit word of the
// packed row). words = ceil(n_pos / (16 * lanes)), at most
// LE_LONG_WORDS: a read of at most 16 * LE_LONG_WORDS * lanes (4,096)
// positions is one tile, its chunks ceil(n_pos / lanes) positions rounded
// up to whole words. Each tile:
//   1. the group stages the tile's bytes and one word on each side;
//   2. each lane walks its chunk from the four start states at once
//      (le_chunk_pass1), which gives the chunk's table and, for each start
//      state, which of its positions are selected;
//   3. an exclusive scan of the tables over the lanes (le_compose, the
//      earlier chunk first) applied to the state the tile starts in gives
//      each lane its start state, and the whole tile's table the next
//      tile's;
//   4. each lane adds the selections of its start state into its 64
//      packed words (le_chunk_pass2, le_weight's 10-bit fields).
// A lane's field grows by at most ceil(16 * words / 3) a tile (a 3-mer
// selected at p is not selected again before p + 3), so before a tile that
// could carry a field past 1,023 the group flushes: it sums each 3-mer's
// words over the lanes into 32-bit totals (le_fold) and clears them. After
// the last tile it folds once more and tests the totals as
// le_crossed_packed tests a word.

constexpr int LE_LONG_LANES = 32;
constexpr int LE_LONG_WORDS = 256 / LE_LONG_LANES;
// a group's stage: a tile's words and the word on each side, shifted by up
// to 15 bytes to keep the row's 16-byte alignment, with a word to spare
constexpr int LE_LONG_STAGE_BYTES = 4 * LE_LONG_WORDS * LE_LONG_LANES + 48;
constexpr int LE_FIELD_MAX = 1023;
constexpr uint32_t LE_IDENTITY = 0xE4u;  // the table that maps s to s

struct LeLongPlan {
    int words;  // a lane's chunk, in words of 16 positions
    int tiles;  // tiles of 16 * words * lanes positions
};

__host__ __device__ inline LeLongPlan le_long_plan(int n_pos, int lanes,
                                                   int max_words) {
    const long long word_row = 16LL * lanes;
    long long words = (n_pos + word_row - 1) / word_row;
    words = words < 1 ? 1 : words > max_words ? max_words : words;
    LeLongPlan plan;
    plan.words = (int)words;
    plan.tiles = (int)((n_pos + word_row * words - 1) / (word_row * words));
    return plan;
}

// The JAX op's per-position table over the state s = (sel[p-2] << 1) |
// sel[p-1]: new bit nb(s) = eligible & !(sel[p-1] & same1) & !(sel[p-2] &
// same2), next state ((s & 1) << 1) | nb(s), entry s in bits 2s+1:2s.
__host__ __device__ inline uint32_t le_table(bool eligible, bool same1,
                                             bool same2) {
    const uint32_t nb0 = eligible;
    const uint32_t nb1 = eligible && !same1;
    const uint32_t nb2 = eligible && !same2;
    const uint32_t nb3 = nb1 & nb2;
    return nb0 | ((2u | nb1) << 2) | (nb2 << 4) | ((2u | nb3) << 6);
}

// The table of f, then g: entry s is g[f[s]].
__host__ __device__ inline uint32_t le_compose(uint32_t f, uint32_t g) {
    uint32_t out = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        out |= ((g >> (2 * ((f >> (2 * s)) & 3u))) & 3u) << (2 * s);
    }
    return out;
}

__host__ __device__ inline int le_apply(uint32_t table, int s) {
    return (int)((table >> (2 * s)) & 3u);
}

// same1 and same2 of the 16 positions of code word w of a packed row (code
// p_w + i in bits 2i+1:2i), from words w - 1, w and w + 1: bit 2i is set
// when the 3-mer at p_w + i equals the one at p_w + i - 1 (its four codes
// from p - 1 to p + 2 are equal), bit 2i + 1 when it equals the one at
// p_w + i - 2 (codes p - 2 and p, p - 1 and p + 1, p and p + 2 equal).
__host__ __device__ inline uint32_t le_same_word(uint32_t prev, uint32_t cur,
                                                 uint32_t next) {
    // codes p_w - 2 to p_w + 29, code p_w - 2 + j in bits 2j+1:2j
    const uint64_t u = ((uint64_t)next << 36) | ((uint64_t)cur << 4)
                       | (prev >> 28);
    const uint64_t lo = 0x5555555555555555ull;
    const uint64_t d1 = u ^ (u >> 2);  // field j: c(j) against c(j + 1)
    const uint64_t d2 = u ^ (u >> 4);  // field j: c(j) against c(j + 2)
    const uint64_t e1 = ~(d1 | (d1 >> 1)) & lo;
    const uint64_t e2 = ~(d2 | (d2 >> 1)) & lo;
    const uint32_t s1 = (uint32_t)((e1 & (e1 >> 2) & (e1 >> 4)) >> 2);
    const uint32_t s2 = (uint32_t)(e2 & (e2 >> 2) & (e2 >> 4));
    return s1 | (s2 << 1);
}

// The selection walked from the four start states at once: bit s of a and
// b is sel[p-1] and sel[p-2] when the chunk began in state s.
struct LeWalk4 {
    uint32_t a;
    uint32_t b;
};

__host__ __device__ inline LeWalk4 le_walk4_start() {
    LeWalk4 walk;
    walk.a = 0xAu;  // states 1 and 3
    walk.b = 0xCu;  // states 2 and 3
    return walk;
}

// Walks the 16 positions of a word (same: le_same_word), each eligible;
// returns their selections, bit 4i + s set when position i is selected
// from start state s.
__host__ __device__ inline uint64_t le_walk4_word(LeWalk4* walk,
                                                  uint32_t same) {
    uint32_t a = walk->a, b = walk->b;
    uint32_t rec[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const uint32_t x = ((same >> (2 * i)) & 1u) ? a : 0u;
        const uint32_t y = ((same >> (2 * i + 1)) & 1u) ? b : 0u;
        b = a;
        a = ~(x | y) & 0xFu;
        rec[i >> 3] += a << (4 * (i & 7));  // disjoint nibbles
    }
    walk->a = a;
    walk->b = b;
    return ((uint64_t)rec[1] << 32) | rec[0];
}

// The table a walk has composed: entry s is the state reached from s.
__host__ __device__ inline uint32_t le_walk4_table(LeWalk4 walk) {
    uint32_t table = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        table |= ((((walk.b >> s) & 1u) << 1) | ((walk.a >> s) & 1u))
                 << (2 * s);
    }
    return table;
}

// Bits shift to shift + 31 of the 64-bit hi:lo.
__host__ __device__ inline uint32_t le_funnel(uint32_t lo, uint32_t hi,
                                              int shift) {
    return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> shift);
}

// A lane's chunk as the passes read it: aligned(i) is the i-th 4-byte
// word of the stage from the one that holds the chunk's word -1 (the word
// before the chunk) on, and the chunk's word k is bytes shift / 8 on of
// aligned words k + 1 and k + 2 (le_funnel), from k = -1 to words (the
// word after the chunk). At the row's start the word before is 0.
template <typename Aligned>
struct LeChunk {
    Aligned aligned;
    int shift;
    bool row_start;
};

template <typename Aligned>
__host__ __device__ inline LeChunk<Aligned> le_chunk(Aligned aligned,
                                                     int shift,
                                                     bool row_start) {
    LeChunk<Aligned> chunk{aligned, shift, row_start};
    return chunk;
}

// Pass 1 of a lane: walks every position as eligible (the positions from
// n_pos on are not counted, and only a later chunk, which counts nothing,
// starts from their state); rec[w] gets word w's selections
// (le_walk4_word). Returns the chunk's table, le_table composed over its
// positions in order.
template <int MAX_WORDS, typename Aligned>
__host__ __device__ inline uint32_t le_chunk_pass1(LeChunk<Aligned> chunk,
                                                   int words,
                                                   uint64_t* rec) {
    LeWalk4 walk = le_walk4_start();
    uint32_t a1 = chunk.aligned(1), a2 = chunk.aligned(2);
    uint32_t prev = chunk.row_start ? 0u
                                    : le_funnel(chunk.aligned(0), a1,
                                                chunk.shift);
    uint32_t cur = le_funnel(a1, a2, chunk.shift);
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
        if (w < words) {
            const uint32_t a3 = chunk.aligned(w + 3);
            const uint32_t next = le_funnel(a2, a3, chunk.shift);
            rec[w] = le_walk4_word(&walk, le_same_word(prev, cur, next));
            prev = cur;
            cur = next;
            a2 = a3;
        }
    }
    return le_walk4_table(walk);
}

// The positions p_w to p_w + 15 that count for a segment, as bits 0-15.
__host__ __device__ inline uint32_t le_segment_bits(LeSegment seg, int p_w) {
    const int lo = seg.lo - p_w;
    const int hi = seg.lo + seg.n - p_w;  // seg.lo + seg.n <= n_pos
    const int l = lo < 0 ? 0 : lo > 16 ? 16 : lo;
    const int h = hi < 0 ? 0 : hi > 16 ? 16 : hi;
    return ((1u << h) - 1u) & ~((1u << l) - 1u);
}

// Bits 0, 4, ..., 28 of x as bits 0-7.
__host__ __device__ inline uint32_t le_gather8(uint32_t x) {
    x &= 0x11111111u;
    x = (x | (x >> 3)) & 0x03030303u;
    x = (x | (x >> 6)) & 0x000F000Fu;
    return (x | (x >> 12)) & 0xFFu;
}

// Eight positions' weights in one word: bit j where position j is
// selected, bit 10 + j where it is also in segment 1, bit 20 + j in
// segment 2, so that (bits >> j) & 0x100401 is its le_weight or 0.
__host__ __device__ inline uint32_t le_count_bits(uint32_t sel, uint32_t in1,
                                                  uint32_t in2) {
    return sel | ((sel & in1) << 10) | ((sel & in2) << 20);
}

// Counts a word: add(3-mer, weight) at each of its 16 positions, weight
// le_weight's fields (in1, in2: le_segment_bits) where bit 4i of sel is
// set, 0 where it is not, so that the caller adds without a branch.
template <typename Add>
__host__ __device__ inline void le_count_word(uint64_t sel, uint32_t cur,
                                              uint32_t next, uint32_t in1,
                                              uint32_t in2, Add add) {
    const uint64_t x = ((uint64_t)next << 32) | cur;
    const uint32_t bits[2] = {
        le_count_bits(le_gather8((uint32_t)sel), in1 & 0xFFu, in2 & 0xFFu),
        le_count_bits(le_gather8((uint32_t)(sel >> 32)), (in1 >> 8) & 0xFFu,
                      (in2 >> 8) & 0xFFu)};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        add((int)((x >> (2 * i)) & 63u),
            (bits[i >> 3] >> (i & 7)) & 0x100401u);
    }
}

// Pass 2 of a lane whose chunk starts at position p0 < n_pos in state
// start: counts the positions before n_pos that start's walk selects.
template <int MAX_WORDS, typename Aligned, typename Add>
__host__ __device__ inline void le_chunk_pass2(LeChunk<Aligned> chunk,
                                               int words,
                                               const uint64_t* rec,
                                               int start, int p0, int n_pos,
                                               LeSegment a1, LeSegment a2,
                                               Add add) {
    uint32_t lo = chunk.aligned(2);
    uint32_t cur = le_funnel(chunk.aligned(1), lo, chunk.shift);
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
        const int valid = n_pos - p0 - 16 * w;  // p0 + 16 w may pass int
        if (w < words && valid > 0) {
            const int p_w = p0 + 16 * w;
            const uint32_t hi = chunk.aligned(w + 3);
            const uint32_t next = le_funnel(lo, hi, chunk.shift);
            lo = hi;
            uint64_t sel = rec[w] >> start;
            if (valid < 16) sel &= (1ull << (4 * valid)) - 1ull;
            le_count_word(sel, cur, next, le_segment_bits(a1, p_w),
                          le_segment_bits(a2, p_w), add);
            cur = next;
        }
    }
}

// The bytes a group stages for tile t: its words and one word on each
// side, clipped to the row. Word j of the tile (j from -1 to words *
// lanes) is the row's bytes first + 4j to first + 4j + 3.
struct LeSpan {
    long long first;  // the tile's first byte
    long long lo;
    long long hi;
};

__host__ __device__ inline LeSpan le_tile_span(int t, LeLongPlan plan,
                                               int lanes, int row_bytes) {
    LeSpan span;
    span.first = 4LL * t * plan.words * lanes;
    span.lo = span.first >= 4 ? span.first - 4 : 0;
    const long long end = span.first + 4LL * plan.words * lanes + 4;
    span.hi = end < row_bytes ? end : row_bytes;
    return span;
}

// The most times `tiles` chunks of `words` words add to one field of a
// lane's word.
__host__ __device__ inline int le_field_most(int tiles, int words) {
    return tiles * ((16 * words + 2) / 3);
}

// Must the group flush before its next tile, tiles after its last flush?
__host__ __device__ inline bool le_flush_before(int tiles, int words) {
    return le_field_most(tiles + 1, words) > LE_FIELD_MAX;
}

// How many lanes' words the fold sums packed before it unpacks the sum,
// tiles after the last flush: no field of the sum can pass 1,023 (at
// least one word).
__host__ __device__ inline int le_fold_run(int tiles, int words) {
    const int most = le_field_most(tiles, words);
    return most > 0 && most <= LE_FIELD_MAX ? LE_FIELD_MAX / most
                                             : most > 0 ? 1 : LE_FIELD_MAX;
}

struct LeTotals {
    uint32_t all;
    uint32_t a1;
    uint32_t a2;
};

// Four lanes' packed words of one 3-mer.
struct LeQuad {
    uint32_t x, y, z, w;
};

__host__ __device__ inline void le_unpack(uint32_t sum, LeTotals* t) {
    t->all += sum & 0x3ffu;
    t->a1 += (sum >> 10) & 0x3ffu;
    t->a2 += (sum >> 20) & 0x3ffu;
}

// One 3-mer's fold: quad(m) holds lanes 4m to 4m + 3's words, taken from
// m = first on (mod quads, a power of two), added to t. Where the runs
// allow (le_fold_run), the words are summed packed 16 (four quads) or 4
// at a time before they are unpacked, else one at a time.
template <typename Quad>
__host__ __device__ inline void le_fold(Quad quad, int quads, int first,
                                        int run, LeTotals* t) {
    uint32_t sum = 0;
    for (int m = 0; m < quads; ++m) {
        const LeQuad q = quad((first + m) & (quads - 1));
        if (run >= 16) {
            sum += q.x + q.y + q.z + q.w;
            if ((m & 3) == 3 || m == quads - 1) {
                le_unpack(sum, t);
                sum = 0;
            }
        } else if (run >= 4) {
            le_unpack(q.x + q.y + q.z + q.w, t);
        } else {
            le_unpack(q.x, t);
            le_unpack(q.y, t);
            le_unpack(q.z, t);
            le_unpack(q.w, t);
        }
    }
}

// le_crossed_packed on a 3-mer's totals.
__host__ __device__ inline bool le_crossed_totals(LeTotals t, int th_all,
                                                  int th_a1, int th_a2) {
    return t.all >= 1 && ((long long)t.all >= th_all
                          || (long long)t.a1 >= th_a1
                          || (long long)t.a2 >= th_a2);
}

}  // namespace arriba
