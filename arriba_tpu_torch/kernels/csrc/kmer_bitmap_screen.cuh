// Per-slice and per-row steps of K5, the 8-mer bitmap screen of
// filter_mismappers.
//
// Shared by the CUDA kernels (kmer_bitmap_screen.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), so the code the kernels
// run is checked against the plain PyTorch version without a GPU.
//
// Semantics: ops/realign.screen_pairs of the port (and of the JAX package),
// the sound REJECT of a (read, gene window) pair: does any 8-mer of the
// read, in either orientation, occur in the window? Window bytes take the
// kmer_to_int code of aw_kmer_code (T 0, G 1, C 2, any other byte 3), which
// is the screen's code (realign._kmer_codes_bytes) and never PAD, so every
// window position j <= len - 8 holds an 8-mer. The read rows are K1's raw
// rows (forward, then reverse complement, byte 0 past the read: no
// sequence byte is 0) coded the same way; an 8-mer that covers byte 0 does
// not count. The old screen cut long windows into chunks overlapping by 7
// bytes, so every 8-mer of the window lay whole in one chunk: the chunked
// verdict is this one test against the whole window.
//
// Both passes read 16 raw bytes at a time (a group) and code them into one
// 32-bit word of 2-bit codes, the group's first byte in the top bits, as
// an 8-mer's first base is; the 8-mer at byte o of a group is then one
// shift of that word and the next group's (kb_kmer_at).
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "accept_wavefront.cuh"

namespace arriba {

constexpr int KB_K = AW_SEED;              // 8-mers
constexpr int KB_PAD = 0;                  // _PAD_READ of ops/realign.py
constexpr int KB_WORDS = AW_BITMAP_WORDS;  // 65,536 one-bit 8-mer slots
constexpr int KB_GROUP = 16;               // bytes a 16-byte load codes
// window positions a slice of the build pass sets, by default (a multiple
// of KB_GROUP; ops/realign.screen_schedule cuts the windows, and the
// launch names the slice length it used)
constexpr int KB_SLICE = 16384;
// groups of a slice a warp of the build pass owns at a time, a lane a
// group; its 32nd lane loads the next group, whose codes end the 31st
// lane's 8-mers
constexpr int KB_CHUNK_GROUPS = 31;
// read-row groups a warp of the test pass stages at a time, one a lane:
// a whole row of L <= 256 bytes a half
constexpr int KB_STAGE_GROUPS = 32;
// the groups of each of its rows a warp stages first, 32 / KB_FIRST_GROUPS
// rows at a time, a lane a group: those its first 32 tests read (bytes
// 0-38 of a row of L >= 39, groups 0-2)
constexpr int KB_FIRST_GROUPS = 4;

// the bit of an 8-mer's slot in its bitmap word (the word is kmer >> 5)
__host__ __device__ inline uint32_t kb_mask(int kmer) {
    return 1u << (kmer & 31);
}

__host__ __device__ inline bool kb_test(const uint32_t* bitmap, int kmer) {
    return kmer >= 0 && ((bitmap[kmer >> 5] & kb_mask(kmer)) != 0);
}

// the window span of a task: its bytes [*first, *first + *len) of the
// table, or none (*len = 0) where the window id or its span lies outside
// the table (the caller builds none such; this keeps every read inside)
__host__ __device__ inline void kb_window(const int64_t* offsets,
                                          const int32_t* lengths,
                                          int window, int n_windows,
                                          long long table_bytes,
                                          long long* first, int* len) {
    *first = 0;
    *len = 0;
    if (window < 0 || window >= n_windows) return;
    const long long off = offsets[window];
    const int n = lengths[window];
    if (off < 0 || n < 0 || off + n > table_bytes) return;
    *first = off;
    *len = n;
}

// window positions a window of len bytes holds an 8-mer at
__host__ __device__ inline int kb_window_positions(int len) {
    return len >= KB_K ? len - KB_K + 1 : 0;
}

// a row's tests: position q < L - 7 of the forward row, then q - (L - 7)
// of the reverse complement row right after it
__host__ __device__ inline int kb_row_tests(int L) {
    return L >= KB_K ? 2 * (L - KB_K + 1) : 0;
}

// the forward raw row of read id `read` (2 read of the table, its reverse
// complement 2 read + 1), or null where the id lies outside the table
__host__ __device__ inline const uint8_t* kb_read_row(const uint8_t* reads,
                                                      int read,
                                                      int n_read_rows,
                                                      int L) {
    if (read < 0 || 2 * (long long)read + 1 >= n_read_rows) return nullptr;
    return reads + (size_t)2 * read * L;
}

// ---------------------------------------------------------------------------
// 16-byte groups

// The 16 bytes of base[at, at + 16) as four little-endian words (byte j in
// bits 8 (j % 4) of w[j / 4]): one 16-byte load where the group lies
// inside the bytes [0, n_bytes) (at a multiple of 16 and base on a
// 16-byte boundary, which the callers keep), else the bytes inside one at
// a time and 0 for the rest.
__host__ __device__ inline void kb_load16(const uint8_t* base,
                                          long long n_bytes, long long at,
                                          uint32_t w[4]) {
    if (at >= 0 && at + KB_GROUP <= n_bytes) {
#ifdef __CUDA_ARCH__
        const uint4 v = *reinterpret_cast<const uint4*>(base + at);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
#else
        memcpy(w, base + at, KB_GROUP);
#endif
        return;
    }
    for (int k = 0; k < 4; ++k) w[k] = 0;
    for (int j = 0; j < KB_GROUP; ++j) {
        if (at + j >= 0 && at + j < n_bytes) {
            w[j >> 2] |= (uint32_t)base[at + j] << (8 * (j & 3));
        }
    }
}

// 0x80 in each byte of t that is 0, else 0 (no carry crosses a byte:
// (b & 0x7f) + 0x7f sets bit 7 of a byte b unless b & 0x7f is 0)
__host__ __device__ inline uint32_t kb_zero_bytes(uint32_t t) {
    return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}

// The codes of a group's 16 raw bytes: byte j's aw_kmer_code in bits
// 2 (15 - j) of *codes, and bit 15 - j of *pad set where byte j is KB_PAD
// (the read side's mark; a window ignores it). Four bytes a word at once:
// a code's bit 0 is "neither T nor C", its bit 1 "neither T nor G"; one
// multiply gathers a word's four 2-bit codes (or 1-bit marks) into its top
// byte (nibble), the word's first byte highest, with no carries between
// the fields it adds.
__host__ __device__ inline void kb_code16(const uint32_t w[4],
                                          uint32_t* codes, uint32_t* pad) {
    uint32_t c = 0, p = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t x = w[k];
        const uint32_t t = kb_zero_bytes(x ^ 0x54545454u);  // 'T'
        const uint32_t g = kb_zero_bytes(x ^ 0x47474747u);  // 'G'
        const uint32_t cc = kb_zero_bytes(x ^ 0x43434343u);  // 'C'
        const uint32_t v = ((~(t | cc) & 0x80808080u) >> 7)
            | ((~(t | g) & 0x80808080u) >> 6);
        c = (c << 8) | ((v * 0x40100401u) >> 24);
        const uint32_t z = kb_zero_bytes(x) >> 7;
        p = (p << 4) | ((z * 0x80402010u) >> 28);
    }
    *codes = c;
    *pad = p;
}

// the 8-mer at byte o (0-15) of a group whose codes are c0, the next
// group's c1 (read only where o > 8, where the 8-mer reaches into it)
__host__ __device__ inline int kb_kmer_at(uint32_t c0, uint32_t c1, int o) {
    const uint64_t both = ((uint64_t)c0 << 32) | c1;
    return (int)((both >> (2 * (24 - o))) & 0xffffu);
}

// whether the 8-mer at byte o of a group covers a PAD byte (pad marks of
// the group, p0, and of the next, p1)
__host__ __device__ inline bool kb_pad_at(uint32_t p0, uint32_t p1, int o) {
    return (((p0 << 16) | p1) >> (24 - o)) & 0xffu;
}

// ---------------------------------------------------------------------------
// The build pass: a slice is the positions [p0, p1) of one window, which
// read its bytes [p0, p1 + 7); each window's positions are cut into slices
// of `slice` positions from 0.

// the end p1 of the slice from p0 of a window of len bytes (p1 <= p0: the
// slice is empty, as for a window too short for an 8-mer, or a slice
// table made for longer windows)
__host__ __device__ inline int kb_slice_end(int p0, int len, int slice) {
    const int n = kb_window_positions(len);
    return slice < n - p0 ? p0 + slice : n;
}

// The first group of a slice, window-relative: the 16-byte boundary of
// the table at or before position p0 of a window at table offset first
// (a multiple of 16 from the table's start; at most 15 before p0).
__host__ __device__ inline int kb_slice_first_group(long long first,
                                                    int p0) {
    return p0 - (int)((first + p0) & 15);
}

// Whether the group at window offset s of a slice ending at p1 needs the
// next group: its last position p1 - 1 (or s + 15) has an 8-mer past byte
// s + 15. Then that group starts at or before p1 + 6 <= len - 1, so no
// load passes the 16-byte boundary after the window's last byte. A lane
// loads its group where it holds positions (s < p1) or the group before
// needs it, which kb_needs_next(s - 16, p1) alone says.
__host__ __device__ inline bool kb_needs_next(int s, int p1) {
    return s + KB_GROUP - KB_K + 1 < p1;
}

// the groups of a slice from its first group g0 that hold its positions
// [p0, p1)
__host__ __device__ inline int kb_slice_groups(int g0, int p1) {
    return (p1 - g0 + KB_GROUP - 1) / KB_GROUP;
}

// Whether the slice [p0, p1) holds every position of its window of len
// bytes: the window's only slice, whose block then owns its bitmap.
__host__ __device__ inline bool kb_whole_window(int p0, int p1, int len) {
    return p0 == 0 && p1 == kb_window_positions(len);
}

// Whether an 8-mer is one base 8 times (0, 0x5555, 0xaaaa, 0xffff): a run
// of T, G, C or of any other byte (N or A) sets one bit again and again.
__host__ __device__ inline bool kb_homopolymer(int kmer) {
    return kmer == (kmer & 3) * 0x5555;
}

// The 8-mers a group sets: those at window positions [max(s, p0),
// min(s + 16, p1)), as byte offsets [*lo, *hi) of the group.
__host__ __device__ inline void kb_group_span(int s, int p0, int p1,
                                              int* lo, int* hi) {
    *lo = s < p0 ? p0 - s : 0;
    *hi = p1 - s < KB_GROUP ? p1 - s : KB_GROUP;
}

// ---------------------------------------------------------------------------
// The test pass: a warp tests a row 32 tests at a time, from a stage of
// the row's groups (2 L raw bytes, the forward row then the reverse
// complement, L a multiple of 16, so 2 L / 16 groups): KB_FIRST_GROUPS
// from group 0 first, then KB_STAGE_GROUPS from group s0 where the tests
// need them, in KB_STAGE_GROUPS + 1 entries (an entry past a stage's
// last group is read, but never needed).

// the byte of a row's 2 L at which test q's 8-mer starts
__host__ __device__ inline int kb_test_byte(int q, int L) {
    const int n = L - KB_K + 1;
    return q < n ? q : L + q - n;
}

// the groups [*g0, *g1] that the tests [q0, q0 + 32) below n_tests read:
// at most 4, since they cover at most 46 consecutive bytes (the forward
// row's last 8-mers end at byte L - 1, the reverse complement's start at
// L)
__host__ __device__ inline void kb_test_groups(int q0, int n_tests, int L,
                                               int* g0, int* g1) {
    const int last = q0 + 31 < n_tests - 1 ? q0 + 31 : n_tests - 1;
    *g0 = kb_test_byte(q0, L) / KB_GROUP;
    *g1 = (kb_test_byte(last, L) + KB_K - 1) / KB_GROUP;
}

// whether the stage of n groups from group s0 lacks one of [g0, g1]; a
// new stage of KB_STAGE_GROUPS then starts at g0
__host__ __device__ inline bool kb_restage(int s0, int n, int g0, int g1) {
    return g0 < s0 || g1 >= s0 + n;
}

// the 8-mer at byte d (>= 0) of a stage (codes and pad marks of its
// groups), or -1 where it covers PAD
__host__ __device__ inline int kb_stage_kmer(const uint32_t* codes,
                                             const uint32_t* pad, int d) {
    const int g = d >> 4;
    const int o = d & (KB_GROUP - 1);
    if (kb_pad_at(pad[g], pad[g + 1], o)) return -1;
    return kb_kmer_at(codes[g], codes[g + 1], o);
}

// test q's 8-mer from the stage of the groups from s0, or -1 where it
// covers PAD
__host__ __device__ inline int kb_staged_kmer(const uint32_t* codes,
                                              const uint32_t* pad, int s0,
                                              int q, int L) {
    return kb_stage_kmer(codes, pad, kb_test_byte(q, L) - KB_GROUP * s0);
}

}  // namespace arriba
