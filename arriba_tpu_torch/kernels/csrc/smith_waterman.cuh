// Per-cell and per-lane math of the Smith-Waterman score wavefront (K3).
//
// Shared by the CUDA kernel (smith_waterman.cu) and a CPU build of the same
// functions (tests/test_torch_kernel_math.py), so the code the kernel runs
// is checked against the plain PyTorch version without a GPU. Each 16x2
// primitive below has a host emulation under #ifndef __CUDA_ARCH__.
//
// Semantics: arriba_tpu/ops/realign.py smith_waterman_scores. For a (read,
// window) row, cell (i, j) holds
//   h(i, j) = max(h(i-1, j-1) + s, h(i-1, j) + gap, h(i, j-1) + gap, 0)
// with s = match where read[i] == window[j] and mismatch elsewhere, and
// h = 0 wherever the read byte or the window byte is PAD (4); cells outside
// the matrix are 0. The row's score is the largest h. Bytes are codes 0-4.
//
// Work split: one warp per PAIR of batch rows (A and B). Every value is a
// 32-bit word with row A in its low and row B in its high signed halfword,
// so one 16x2 instruction updates a cell of both rows. Lane k owns the S
// consecutive read positions k*S .. k*S+S-1 of both rows (a stripe, kept
// in registers) and at step t works window column j = t - k. A lane needs,
// for column j, the row above its stripe at column j (from lane k-1's
// previous step) and at column j-1 (the one it received a step earlier):
// sw_pair_column takes the first and keeps the second.
//
// What a cell carries is g = h + gap, not h: g(i, j) serves as "up" for
// cell (i+1, j), as "left" for cell (i, j+1) and, with the score table
// holding s - gap, as "diag" for cell (i+1, j+1), since
// g(i-1, j-1) + (s - gap) = h(i-1, j-1) + s. A valid cell is then
//   s' = prmt(T0, T1, sel)                      the match test and select
//   h  = max(diag + s', max(up, left), 0)       max.s16x2, add+max.relu
//   h  = h & keep & ~pad                        PAD cells are 0
//   g  = h + gap                                add.s16x2
//   best = max(best, h)                         max.s16x2
//
// No 16-bit lane wraps (the wrapper refuses the parameters otherwise,
// kernels/__init__.py sw_guard). Let Hm bound every h. Along any path of a
// local alignment at most min(L, W) <= L steps are diagonal, so with
// top = max(match, mismatch, 0), Hm <= top * L + max(gap, 0) * (L + W),
// and the guard asks Hm < 2^13. It also asks
// -128 <= match - gap, mismatch - gap <= 127 (s' is a sign-extended byte)
// and |gap| <= 2^14. Then h in [0, 2^13), g in [gap, 2^13 + gap),
// diag + s' in [gap - 128, 2^13 + gap + 127] and every max of those stay
// inside [-2^15, 2^15), and h fits the 13 bits the shuffle gives it.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int SW_PAD = 4;  // PAD_CODE of ops/encode.py
constexpr uint32_t SW_H_BITS = 0x1fff1fffu;     // h of both rows, 13 bits
constexpr uint32_t SW_CODE_BITS = 0xe000e000u;  // window code of both rows

// ---- 16x2 primitives: per signed halfword, wrapping like the hardware

// halfword k of x, signed
__host__ __device__ inline int sw_half(uint32_t x, int k) {
    return (int16_t)(uint16_t)(x >> (16 * k));
}

// lo and hi (cut to 16 bits) in one word
__host__ __device__ inline uint32_t sw_pack(int lo, int hi) {
    return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// a + b (add.s16x2)
__host__ __device__ inline uint32_t sw_add2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    asm("add.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    return sw_pack(sw_half(a, 0) + sw_half(b, 0),
                   sw_half(a, 1) + sw_half(b, 1));
#endif
}

// max(a, b) (max.s16x2)
__host__ __device__ inline uint32_t sw_max2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    asm("max.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    const int lo = sw_half(a, 0) > sw_half(b, 0) ? sw_half(a, 0)
                                                 : sw_half(b, 0);
    const int hi = sw_half(a, 1) > sw_half(b, 1) ? sw_half(a, 1)
                                                 : sw_half(b, 1);
    return sw_pack(lo, hi);
#endif
}

// max(a + b, c, 0) (DPX __viaddmax_s16x2_relu)
__host__ __device__ inline uint32_t sw_addmax_relu2(uint32_t a, uint32_t b,
                                                    uint32_t c) {
#ifdef __CUDA_ARCH__
    return __viaddmax_s16x2_relu(a, b, c);
#else
    int out[2];
    for (int k = 0; k < 2; ++k) {
        const int sum = (int16_t)(uint16_t)(sw_half(a, k) + sw_half(b, k));
        const int m = sum > sw_half(c, k) ? sum : sw_half(c, k);
        out[k] = m > 0 ? m : 0;
    }
    return sw_pack(out[0], out[1]);
#endif
}

// Byte permute (prmt.b32, default mode): result byte i is byte (n & 7) of
// the eight bytes {lo, hi}, n the i-th nibble of sel; where n & 8 it is
// that byte's sign bit replicated.
__host__ __device__ inline uint32_t sw_perm(uint32_t lo, uint32_t hi,
                                            uint32_t sel) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(sel));
    return r;
#else
    const uint64_t bytes = (uint64_t)lo | ((uint64_t)hi << 32);
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i) {
        const uint32_t n = (sel >> (4 * i)) & 0xfu;
        uint32_t byte = (uint32_t)(bytes >> (8 * (n & 7))) & 0xffu;
        if (n & 8) byte = (byte & 0x80u) ? 0xffu : 0u;
        r |= byte << (8 * i);
    }
    return r;
#endif
}

// ---- the per-cell and per-lane procedure

// Score parameters of a pair: s - gap for a mismatch in every byte, the
// bits that turn it into s - gap for a match, gap in both halfwords.
struct SwScores {
    uint32_t mismatch4;
    uint32_t flip;
    uint32_t gap2;
};

__host__ __device__ inline SwScores sw_scores(int match, int mismatch,
                                              int gap) {
    const uint32_t mis = (uint32_t)(mismatch - gap) & 0xffu;
    SwScores sc;
    sc.mismatch4 = mis * 0x01010101u;
    sc.flip = ((uint32_t)(match - gap) & 0xffu) ^ mis;
    sc.gap2 = sw_pack(gap, gap);
    return sc;
}

// One lane's stripe of S read positions of both rows.
template <int S>
struct SwPair {
    uint32_t col[S];   // g(stripe row r, previous column), both rows
    uint32_t sel[S];   // prmt selector of the read codes at row r
    uint32_t keep[S];  // 0xffff in a half whose read code is not PAD
    uint32_t prev_in;  // g(row above the stripe, previous column)
    uint32_t best;     // largest h the lane has seen, both rows
};

// a and b: the rows' read codes (b null for the dummy row of an odd batch,
// all PAD)
template <int S>
__host__ __device__ inline void sw_pair_init(SwPair<S>* lane,
                                             const uint8_t* a,
                                             const uint8_t* b, int first,
                                             int L, uint32_t gap2) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
        const int i = first + r;
        const uint32_t ca = i < L ? a[i] : SW_PAD;
        const uint32_t cb = i < L && b != nullptr ? b[i] : SW_PAD;
        // T0 holds row A's score by window code in bytes 0-3, T1 row B's
        // in bytes 4-7 (a PAD code picks a byte that keep masks)
        lane->sel[r] = ca | ((ca | 8u) << 4) | ((cb | 4u) << 8)
                       | ((cb | 12u) << 12);
        lane->keep[r] = (ca == SW_PAD ? 0u : 0xffffu)
                        | (cb == SW_PAD ? 0u : 0xffff0000u);
        lane->col[r] = gap2;  // h = 0 before the first column
    }
    lane->prev_in = gap2;
    lane->best = 0;
}

// The word a lane passes down: h of both rows in bits 0-12 and 16-28, the
// window codes of the column in bits 13-15 (A) and 29-31 (B).
__host__ __device__ inline uint32_t sw_window_word(uint32_t code_a,
                                                   uint32_t code_b) {
    return (code_a << 13) | (code_b << 29);
}

// Window columns at .. at+3 of both rows, one byte each: row A's code in
// the low and row B's in the high nibble; PAD past the window's end, and
// row B all PAD where b is null.
__host__ __device__ inline uint32_t sw_window_pair(const uint8_t* a,
                                                   const uint8_t* b, int at,
                                                   int W) {
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
        const bool inside = at + k < W;
        const uint32_t ca = inside ? a[at + k] : SW_PAD;
        const uint32_t cb = inside && b != nullptr ? b[at + k] : SW_PAD;
        word |= (ca | (cb << 4)) << (8 * k);
    }
    return word;
}

// Lane 0's input at step t, from the sw_window_pair word holding column t:
// h = 0 above the first read position, and column t's codes.
__host__ __device__ inline uint32_t sw_lane0_word(uint32_t pair_word, int t) {
    const uint32_t byte = (pair_word >> (8 * (t & 3))) & 0xffu;
    return sw_window_word(byte & 0xfu, byte >> 4);
}

// Column j of the lane's stripe. in: lane k-1's word (h of the row above
// the stripe at column j, and the window codes of column j). Returns the
// word for lane k+1.
template <int S>
__host__ __device__ inline uint32_t sw_pair_column(SwPair<S>* lane,
                                                   uint32_t in,
                                                   const SwScores& sc) {
    uint32_t up = sw_add2(in & SW_H_BITS, sc.gap2);
    uint32_t diag = lane->prev_in;
    lane->prev_in = up;
    // s - gap by read code: T0 for row A, T1 for row B; byte 8 * (w & 3)
    // holds the match score (a PAD code is masked below)
    const uint32_t t0 = sc.mismatch4 ^ (sc.flip << ((in >> 10) & 0x18u));
    const uint32_t t1 = sc.mismatch4 ^ (sc.flip << ((in >> 26) & 0x18u));
    // 0xffff in a half whose window code is PAD (code bit 2)
    const uint32_t pad = ((in >> 15) & 0x00010001u) * 0xffffu;
    uint32_t h = 0;
#pragma unroll
    for (int r = 0; r < S; ++r) {
        const uint32_t left = lane->col[r];
        const uint32_t s = sw_perm(t0, t1, lane->sel[r]);
        h = sw_addmax_relu2(diag, s, sw_max2(up, left)) & lane->keep[r]
            & ~pad;
        diag = left;
        up = sw_add2(h, sc.gap2);
        lane->col[r] = up;
        lane->best = sw_max2(lane->best, h);
    }
    return h | (in & SW_CODE_BITS);
}

}  // namespace arriba
