// Per-cell, per-lane and tile-carry math of the tiled Smith-Waterman score
// wavefront (K3w), in 32-bit lanes and in K3's 16-bit pairs.
//
// Shared by the CUDA kernels (smith_waterman_wide.cu) and a CPU build of
// the same functions (tests/test_torch_kernel_math.py), so the code the
// kernels run is checked against the plain PyTorch version without a GPU.
//
// Semantics: arriba_tpu/ops/realign.py smith_waterman_scores, exactly. For
// a (read, window) row, cell (i, j) holds
//   h(i, j) = max(h(i-1, j-1) + s, h(i-1, j) + gap, h(i, j-1) + gap, 0)
// in int32, with s = match where the whole bytes read[i] and window[j] are
// equal and mismatch elsewhere, and h = 0 wherever either byte is PAD (4);
// cells outside the matrix are 0. The row's score is the largest h. Any
// byte 0-255 is taken by the 32-bit lanes; the 16-bit pairs take what K3
// (smith_waterman.cuh) takes, codes 0-4 and its score guard, at any L.
//
// Each row is trimmed to its own length. A warp first finds the extent of
// its read and of its window (1 + the last non-PAD byte, sw_wide_extent;
// the largest over its lanes) and sizes everything by those: the stripe,
// the tiles and the steps a tile. This is exact for any scores: every cell
// past the last non-PAD byte of either side is PAD, so its h is 0, and no
// such cell feeds a cell before it (h(i, j) reads only i-1 and j-1). A PAD
// inside a read or a window is not trimmed; it resets h as it always does.
//
// Work split: one warp per row (32-bit) or per pair of rows (16-bit, the
// pair's extents the larger of its two rows'). Lane k owns S consecutive
// read positions (a stripe, in registers) of a tile of 32 S positions and
// at step t works window column j = t - k, as K3 does for one tile. A read
// longer than a tile is cut into tiles of 32 S positions; the warp sweeps
// the window once a tile, and the h of a tile's last read position at
// every window column (its last row) is what the next tile's first
// position needs as "up" and "diag": lane 31 stores it in a carry row of W
// int32 in device memory (the pair's two 13-bit h in the 16-bit kernel),
// one column a step, and the next tile's lane 0 reads it back, chunk by
// chunk, as the h of the row above (sw_wide_up).
//
// Why one carry row is enough: the next tile reads column j in the chunk
// it loads at step 128 floor(j / 128) <= j, and this tile's lane 31 writes
// column j at step j + 31, so in one tile every column is read before it
// is written, and between two tiles the warp synchronises (__syncwarp
// orders the warp's memory accesses).
//
// No int32 wraps (the wrapper refuses the parameters otherwise,
// kernels/__init__.py sw_wide_guard; the argument of smith_waterman.cuh,
// carried to 31 bits). Along any path of a local alignment at most
// min(L, W) <= L steps are diagonal and at most L + W are gaps, so with
// top = max(match, mismatch, 0) every h <= Hm = top * L + max(gap, 0) *
// (L + W); diag + s <= Hm + top and max(up, left) + gap <= Hm + max(gap, 0),
// and both are >= min(match, mismatch, gap) >= -2^31. The guard asks
// Hm + max(top, gap, 0) < 2^31 with match, mismatch and gap in int32, which
// is also where the JAX op's own int32 sums stop being exact. The 16-bit
// pairs keep smith_waterman.cuh's proof: it bounds h by the row's width L,
// never by 512, and the carry holds the same 13-bit h a shuffle does.
#pragma once

#include <stdint.h>

#include "smith_waterman.cuh"

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int SWW_PAD = 4;         // PAD_CODE of ops/encode.py
constexpr int SWW_MAX_STRIPE = 16; // read positions a lane at most
constexpr int SWW_CHUNK = 128;     // window columns (and carry entries) a
                                   // warp loads at once, 4 a lane

// max(diag + s, max(up, left) + gap, 0): on sm_90 one DPX instruction
__host__ __device__ inline int sw_wide_cell(int diag, int up, int left,
                                            int s, int gap) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    return __viaddmax_s32_relu(diag, s, max(up, left) + gap);
#else
    const int a = diag + s;
    const int b = (up > left ? up : left) + gap;
    const int m = a > b ? a : b;
    return m > 0 ? m : 0;
#endif
}

// Lane `lane`'s part of a row's extent: the row's n bytes in runs of four
// a lane, 128 a warp, and 1 + the last non-PAD byte among the lane's, 0
// for none. The warp's extent is the largest of its lanes'.
__host__ __device__ inline int sw_wide_extent(const uint8_t* row, int n,
                                              int lane) {
    int extent = 0;
    for (int at = 4 * lane; at < n; at += 4 * 32) {
        for (int b = 0; b < 4 && at + b < n; ++b) {
            if (row[at + b] != SWW_PAD) extent = at + b + 1;
        }
    }
    return extent;
}

// The stripes a lane can hold, as a mask (bit S - 1 for S positions): 1,
// 2 and the even stripes 4-16. A launch instantiates each up to its cap,
// and warps whose rows take different stripes run different code side by
// side: with all sixteen, batches whose rows spread over many stripes ran
// up to 2x slower on an H100 than with these nine, which waste at most
// one position a lane (PERF.md, K3w's stripe sets timed side by side)
constexpr unsigned SWW_STRIPE_MASK = 0xaaabu;

__host__ __device__ constexpr bool sw_wide_allowed(int S) {
    return S >= 1 && S <= SWW_MAX_STRIPE
           && ((SWW_STRIPE_MASK >> (S - 1)) & 1u) != 0;
}

// The stripe a lane holds for a read of `len` positions (its extent): the
// fewest tiles of at most 512 positions, then the smallest stripe of the
// set that covers the read in that many tiles.
__host__ __device__ inline int sw_wide_stripe(int len) {
    const int tiles = len > 32 * SWW_MAX_STRIPE
                          ? (len + 32 * SWW_MAX_STRIPE - 1)
                                / (32 * SWW_MAX_STRIPE)
                          : 1;
    int stripe = ((len + tiles - 1) / tiles + 31) / 32;
    stripe = stripe > 1 ? stripe : 1;
    while (!sw_wide_allowed(stripe)) ++stripe;
    return stripe;
}

// The largest stripe a launch instantiates for reads of at most L
// positions, 4, 8 or 16 (each warp picks its own stripe up to it): it
// covers every extent up to L, and a narrow batch's kernel keeps the
// registers of its narrow stripes
__host__ __device__ inline int sw_wide_stripe_cap(int L) {
    return L <= 4 * 32 ? 4 : L <= 8 * 32 ? 8 : SWW_MAX_STRIPE;
}

__host__ __device__ inline int sw_wide_tiles(int len, int S) {
    return len > 0 ? (len + 32 * S - 1) / (32 * S) : 0;
}

// Steps of a tile whose stripes hold positions first .. len_r - 1 of a
// read against a window of len_w columns (the last lane holding one
// finishes column len_w - 1 at step len_w - 1 + its index); a tile with a
// successor is full, so it runs len_w + 31 steps
__host__ __device__ inline int sw_wide_steps(int first, int len_r, int len_w,
                                             int S) {
    const int held = len_r - first < 32 * S ? len_r - first : 32 * S;
    return held > 0 ? len_w + (held - 1) / S : 0;
}

// Lane 0's "up" at column t of tile `tile`: 0 above the read's first
// position, else the previous tile's carry at column t (0 past the
// window's extent, where every cell is PAD)
__host__ __device__ inline int sw_wide_up(const int32_t* carry, int tile,
                                          int t, int len_w) {
    return tile > 0 && t < len_w ? carry[t] : 0;
}

// The carry column lane 31 stores at step t of a tile that is not the last
// (h of the tile's last position at column t - 31), or -1 for none
__host__ __device__ inline int sw_wide_store_column(int t, int len_w) {
    const int j = t - 31;
    return j >= 0 && j < len_w ? j : -1;
}

// ---- 32-bit lanes

// One lane's stripe of S read positions.
template <int S>
struct SwWideLane {
    int col[S];     // h(stripe row r, previous column)
    int read[S];    // read bytes, PAD past the read
    int prev_in;    // h(row above the stripe, previous column)
    int best;       // largest h the lane has seen, over every tile
};

// Start a tile: the lane's stripe of positions first .. first + S - 1 of a
// read of len bytes; h = 0 before the first column. best is kept.
template <int S>
__host__ __device__ inline void sw_wide_tile_init(SwWideLane<S>* lane,
                                                  const uint8_t* read,
                                                  int first, int len) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
        lane->col[r] = 0;
        lane->read[r] = first + r < len ? read[first + r] : SWW_PAD;
    }
    lane->prev_in = 0;
}

// Column j of the lane's stripe: up_in = h(row above the stripe, j) and w =
// window[j] (PAD outside the window). Returns h(last stripe row, j), which
// the lane below needs next step (and lane 31 stores as the tile's carry).
template <int S>
__host__ __device__ inline int sw_wide_column(SwWideLane<S>* lane, int up_in,
                                              int w, int match, int mismatch,
                                              int gap) {
    int diag = lane->prev_in;
    int up = up_in;
    lane->prev_in = up_in;
    const bool w_pad = w == SWW_PAD;
#pragma unroll
    for (int r = 0; r < S; ++r) {
        const int left = lane->col[r];
        const int s = lane->read[r] == w ? match : mismatch;
        int h = sw_wide_cell(diag, up, left, s, gap);
        if (w_pad || lane->read[r] == SWW_PAD) h = 0;
        diag = left;
        lane->col[r] = h;
        up = h;
        lane->best = h > lane->best ? h : lane->best;
    }
    return up;
}

// ---- 16-bit pairs (K3's SwPair and sw_pair_column, tiled)

// Start a tile of a pair: sw_pair_init over the positions first .. first +
// S - 1 of reads a and b (b null for the dummy row of an odd batch) cut at
// the pair's extent len, keeping the running best of both rows.
template <int S>
__host__ __device__ inline void sw_pair_tile_init(SwPair<S>* lane,
                                                  const uint8_t* a,
                                                  const uint8_t* b, int first,
                                                  int len, uint32_t gap2) {
    const uint32_t best = lane->best;
    sw_pair_init<S>(lane, a, b, first, len, gap2);
    lane->best = best;
}

// Lane 0's word at step t of a tile: column t's codes of both rows (from
// the sw_window_pair word holding it) and the h of both rows above the
// tile there, the carry (0 in the first tile)
__host__ __device__ inline uint32_t sw_wide16_lane0(uint32_t pair_word, int t,
                                                    uint32_t up) {
    return sw_lane0_word(pair_word, t) | up;
}

// What lane 31 stores in the carry from the word it passes down: the h of
// both rows, without the window codes
__host__ __device__ inline int32_t sw_wide16_carry(uint32_t word) {
    return (int32_t)(word & SW_H_BITS);
}

}  // namespace arriba
