// Per-cell math and per-row seed lookup of the exact single-seed ACCEPT of
// filter_mismappers.
//
// Shared by the CUDA kernel (accept_wavefront.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), so the code the kernel
// runs is checked against the plain PyTorch version without a GPU.
//
// Semantics: arriba_tpu/ops/realign.py _accept_wavefront_kernel. For a
// (read, window) row, cell (i, j) compares read byte i with window byte j.
// Every carry of a cell comes from its diagonal predecessor (i-1, j-1), so
// one diagonal delta = j - i is an independent automaton walked with i
// increasing. Only valid cells (i < read_len, 0 <= j < win_len) matter: an
// invalid cell resets every carry to the fill state below, which is also the
// state before the first cell of a diagonal.
//
// Counters stay unpacked in int32 (the Pallas kernel packs a and b into 9
// bits, which would wrap for reads longer than 511).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int AW_NEG = -(1 << 20);   // "no active walk" score
constexpr int AW_SEED = 8;           // seed k-mer length
constexpr int AW_MAX_CONS = 4;       // the walk dies on the 4th mismatch in a row

// kmer_to_int base code of a raw byte (filter_mismappers.cpp:33-45)
__host__ __device__ inline int aw_kmer_code(int byte) {
    return byte == 'T' ? 0 : byte == 'G' ? 1 : byte == 'C' ? 2 : 3;
}

struct AcceptCarry {
    int a;      // consecutive byte matches ending here
    int b;      // byte matches scanning left until the 2nd mismatch
    int q;      // consecutive k-mer code matches (seed streak)
    int bsave;  // b before the current streak began
    int cons;   // consecutive byte mismatches of the active walk
    int sc;     // best active right-extension score
    bool sok;   // streak-start eligibility, latched at streak start
};

__host__ __device__ inline void aw_init(AcceptCarry* c) {
    c->a = 0;
    c->b = 0;
    c->q = 0;
    c->bsave = 0;
    c->cons = 0;
    c->sc = AW_NEG;
    c->sok = false;
}

// May a seed starting at read position i and window position j fire?
// (the outer-loop seed bound, the k-mer index range [max(seed_lo, 0),
// min(seed_hi, win_len - 10)] and a window start that is not 'N')
__host__ __device__ inline bool aw_eligible(int i, int j, int window_byte,
                                            int read_len, int win_len,
                                            int min_score, int seed_lo,
                                            int seed_hi) {
    const int lo = seed_lo > 0 ? seed_lo : 0;
    return i + AW_SEED < read_len && 2 * i <= read_len + 16 - min_score
        && j >= lo && j <= seed_hi && j <= win_len - 10 && window_byte != 'N';
}

// One valid cell: update the carries in place from the predecessor's and
// return whether this cell reaches min_score.
__host__ __device__ inline bool aw_step(AcceptCarry* c, int read_byte,
                                        int window_byte, bool eligible,
                                        int min_score) {
    const bool m = read_byte == window_byte;
    const bool cm = aw_kmer_code(read_byte) == aw_kmer_code(window_byte);
    const int a_in = c->a;
    const int b_in = c->b;
    const int q_in = c->q;

    const bool starts = cm && q_in == 0;
    const bool sok = cm && (starts ? eligible : c->sok);
    const int bsave = cm ? (starts ? b_in : c->bsave) : 0;
    const int q = cm ? q_in + 1 : 0;
    const bool fired = q == AW_SEED && sok;
    const int candidate = AW_SEED + bsave;

    const int cons = m ? 0 : c->cons + 1;
    int sc_step = m ? c->sc + 1 : c->sc - 1;
    if (cons >= AW_MAX_CONS) sc_step = AW_NEG;
    const bool accept = (m && sc_step >= min_score)
        || (fired && candidate >= min_score);
    const int fired_score = fired ? candidate : AW_NEG;

    c->a = m ? a_in + 1 : 0;
    c->b = m ? b_in + 1 : a_in;
    c->q = q;
    c->bsave = bsave;
    c->cons = cons;
    c->sc = sc_step > fired_score ? sc_step : fired_score;
    c->sok = sok;
    return accept;
}

// Walk the valid cells of diagonal delta = j - i of one row, from its first
// valid cell (b and bsave need the left context); true as soon as a cell
// accepts.
__host__ __device__ inline bool aw_diagonal(const uint8_t* read,
                                            const uint8_t* window, int delta,
                                            int read_len, int win_len,
                                            int min_score, int seed_lo,
                                            int seed_hi) {
    const int i0 = delta < 0 ? -delta : 0;
    const int i1 = read_len < win_len - delta ? read_len : win_len - delta;
    AcceptCarry c;
    aw_init(&c);
    for (int i = i0; i < i1; ++i) {
        const int j = i + delta;
        const int w = window[j];
        const bool eligible = aw_eligible(i, j, w, read_len, win_len,
                                          min_score, seed_lo, seed_hi);
        if (aw_step(&c, read[i], w, eligible, min_score)) return true;
    }
    return false;
}

// ---------------------------------------------------------------------------
// Seed lookup: which diagonals can accept at all.
//
// A walk's score starts at AW_NEG, never falls below it, and jumps only
// through a fired seed; without one it gains at most 1 a cell, so it stays
// at most AW_NEG + read_len. So where min_score > read_len + AW_NEG (every
// min_score >= 0 included), a diagonal accepts only if a seed fires on it. A
// seed fires only on 8 code matches from an eligible start (i, j). So the
// diagonals worth walking are {j - s}: s an eligible read start, j an
// eligible window position (in [lo, hi], window[j] != 'N'), and the code
// 8-mers of the read at s and of the window at j equal. That set holds
// every firing diagonal (it ignores whether (s, j) starts a streak), and
// walking a diagonal in full gives aw_diagonal's exact answer.

constexpr int AW_CODE_N = 4;           // code byte flag: the raw byte is 'N'
constexpr int AW_BITMAP_WORDS = 2048;  // 65,536 one-bit 8-mer slots
constexpr int AW_STRIP = 2048;         // most diagonals one block owns

// code byte of a raw byte: kmer code in bits 0-1, AW_CODE_N for 'N'
__host__ __device__ inline int aw_code_byte(int byte) {
    return aw_kmer_code(byte) | (byte == 'N' ? AW_CODE_N : 0);
}

// 16-bit code 8-mer of the 8 raw bytes at p
__host__ __device__ inline int aw_kmer_raw(const uint8_t* p) {
    int kmer = 0;
    for (int k = 0; k < AW_SEED; ++k) kmer = (kmer << 2) | aw_kmer_code(p[k]);
    return kmer;
}

// 16-bit code 8-mer of the 8 code bytes at c (the same value as
// aw_kmer_raw of the raw bytes they came from)
__host__ __device__ inline int aw_kmer_coded(const uint8_t* c) {
    int kmer = 0;
    for (int k = 0; k < AW_SEED; ++k) kmer = (kmer << 2) | (c[k] & 3);
    return kmer;
}

// number of eligible read starts: s = 0 .. n-1 with s + 8 < read_len and
// 2 s <= read_len + 16 - min_score (aw_eligible's tests on i)
__host__ __device__ inline int aw_seed_starts(int read_len, int min_score) {
    const int x = read_len + 16 - min_score;
    if (x < 0) return 0;
    const int n = x / 2 + 1 < read_len - AW_SEED ? x / 2 + 1
                                                 : read_len - AW_SEED;
    return n > 0 ? n : 0;
}

// eligible window positions [*lo, *hi] of a row (aw_eligible's tests on j
// other than the 'N' test); empty when *lo > *hi
__host__ __device__ inline void aw_window_span(int win_len, int seed_lo,
                                               int seed_hi, int* lo,
                                               int* hi) {
    *lo = seed_lo > 0 ? seed_lo : 0;
    *hi = seed_hi < win_len - 10 ? seed_hi : win_len - 10;
}

// The diagonals delta in [-(L - 1), W - 1] cut into strips of *strip (a
// multiple of 32, at most AW_STRIP), *n_strips of them; strip k owns
// [-(L - 1) + k * strip, min(-(L - 1) + (k + 1) * strip, W) - 1].
__host__ __device__ inline void aw_strips(int L, int W, int* strip,
                                          int* n_strips) {
    const int d = L + W - 1;
    if (d <= 0) {
        *strip = 32;
        *n_strips = 0;
        return;
    }
    const int n = (d + AW_STRIP - 1) / AW_STRIP;
    *strip = ((d + n - 1) / n + 31) / 32 * 32;
    *n_strips = (d + *strip - 1) / *strip;
}

// Window positions [*jb, *je] whose seeds can name a diagonal of
// [d_lo, d_hi]: delta = j - s with 0 <= s < n_seeds, inside [lo, hi];
// empty (*jb > *je) when the row has no seeds
__host__ __device__ inline void aw_scan_span(int d_lo, int d_hi, int n_seeds,
                                             int lo, int hi, int* jb,
                                             int* je) {
    *jb = d_lo > lo ? d_lo : lo;
    const int top = d_hi + n_seeds - 1;
    *je = n_seeds <= 0 ? *jb - 1 : top < hi ? top : hi;
}

// The 8-mer at window position j (its code bytes at c) if j may seed and
// the read has that 8-mer among its eligible starts (bitmap), else -1
__host__ __device__ inline int aw_window_seed(const uint8_t* c,
                                              const uint32_t* bitmap) {
    if (c[0] & AW_CODE_N) return -1;
    const int kmer = aw_kmer_coded(c);
    return (bitmap[kmer >> 5] >> (kmer & 31)) & 1u ? kmer : -1;
}

// Read starts [*s_lo, *s_hi] that a hit at window position j may pair
// with: delta = j - s inside [d_lo, d_hi], 0 <= s < n_seeds
__host__ __device__ inline void aw_seed_span(int j, int d_lo, int d_hi,
                                             int n_seeds, int* s_lo,
                                             int* s_hi) {
    *s_lo = j - d_hi > 0 ? j - d_hi : 0;
    *s_hi = j - d_lo < n_seeds - 1 ? j - d_lo : n_seeds - 1;
}

// ---------------------------------------------------------------------------
// Rows whose min_score the seed lookup cannot serve.
//
// Where min_score <= read_len + AW_NEG an unseeded walk may accept (its
// score climbs from AW_NEG by 1 a matching cell), so a diagonal can accept
// that no seed names. Such a row walks every diagonal that holds a valid
// cell, each with aw_diagonal, which is then exactly the plain version's
// answer. The choice is per row, from its params alone.

__host__ __device__ inline bool aw_walks_all(int read_len, int min_score) {
    return (long long)min_score <= (long long)read_len + AW_NEG;
}

// The diagonals of [d_lo, d_hi] that hold a valid cell of a row: delta in
// [-(read_len - 1), win_len - 1]; empty (*first > *last) when none
__host__ __device__ inline void aw_all_span(int d_lo, int d_hi, int read_len,
                                            int win_len, int* first,
                                            int* last) {
    *first = d_lo > 1 - read_len ? d_lo : 1 - read_len;
    *last = d_hi < win_len - 1 ? d_hi : win_len - 1;
}

// ---------------------------------------------------------------------------
// Where a row's bytes are.
//
// Dense rows (offsets null) sit at row * L of the reads and row * W of the
// windows. Indexed rows (the mismapper screen's resident tables,
// ops/realign.resident_pairs) read their bytes by offset: int64 [rows, 2] =
// (read offset in the read table, window offset in the window table).
// Nothing past a row's win_len bytes decides its verdict: the walks stop
// before j = win_len (aw_diagonal) and a seed starts at j <= win_len - 10
// (aw_eligible), so its staged 8-mer ends at win_len - 3. A dense row
// pads its window with 1 past win_len; an indexed chunk of a longer window
// has the window's next bytes there, which no step reads.

constexpr int AW_TABLE_SLACK = 16;  // window table bytes past its last window

// A row's read and window: dense, or at the row's offsets into a read
// table of read_bytes and a window table of table_bytes, which must hold
// the read's read_len bytes and the window's win_len bytes and
// AW_TABLE_SLACK more (aw_stage_span's 16-byte loads); false for a row
// outside them (the caller builds none such).
__host__ __device__ inline bool aw_row_bytes(
        const uint8_t* reads, const uint8_t* windows, const int64_t* offsets,
        int row, int L, int W, int read_len, int win_len,
        long long read_bytes, long long table_bytes, const uint8_t** read,
        const uint8_t** window) {
    if (offsets == nullptr) {
        *read = reads + (long long)row * L;
        *window = windows + (long long)row * W;
        return true;
    }
    const long long ro = offsets[2 * (long long)row];
    const long long wo = offsets[2 * (long long)row + 1];
    const int wl = win_len > 0 ? win_len : 0;
    if (ro < 0 || ro + read_len > read_bytes || wo < 0
        || wo + wl + AW_TABLE_SLACK > table_bytes) {
        return false;
    }
    *read = reads + ro;
    *window = windows + wo;
    return true;
}

// The window stretch a strip stages: positions [jb, je + 7] as code bytes,
// *n_bytes of them from window + jb - *shift. With 16-byte loads
// (vector_loads; address is that of window + jb) the first load starts at
// the 16-byte boundary at or before it and *n_bytes is a multiple of 16:
// the last byte read is at most 15 past je + 7, inside a dense row of W %
// 16 == 0 bytes (je + 7 <= win_len - 3) or inside the table
// (AW_TABLE_SLACK). Otherwise the stretch itself.
__host__ __device__ inline void aw_stage_span(uint64_t address, int jb,
                                              int je, int vector_loads,
                                              int* shift, int* n_bytes) {
    *shift = vector_loads ? (int)(address & 15) : 0;
    const int n = je + AW_SEED - jb + *shift;
    *n_bytes = vector_loads ? (n + 15) & ~15 : n;
}

// Shared-memory layout of one block (byte offsets, 16-aligned pieces):
// the 8-mer bitmap, the claimed-diagonal bitset, the walk queue (diagonal
// offsets into the strip), the read's seed 8-mers, the read bytes and the
// window stretch as code bytes.
struct AwLayout {
    int bitmap, claimed, queue, seeds, read, codes, bytes;
};

__host__ __device__ inline int aw_align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline AwLayout aw_layout(int L, int strip) {
    AwLayout s;
    s.bitmap = 0;
    s.claimed = s.bitmap + 4 * AW_BITMAP_WORDS;
    s.queue = s.claimed + aw_align16(4 * ((strip + 31) / 32));
    s.seeds = s.queue + aw_align16(2 * strip);
    s.read = s.seeds + aw_align16(2 * L);
    s.codes = s.read + aw_align16(L);
    // the staged stretch starts up to 15 bytes before the first scanned
    // position and ends 8 bytes past the last, rounded up to 16
    s.bytes = s.codes + aw_align16(strip + L + 32);
    return s;
}

}  // namespace arriba
