// Per-cell, per-lane and tile-carry math of the 32-bit Smith-Waterman
// score wavefront (K3w).
//
// Shared by the CUDA kernel (smith_waterman_wide.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), so the code the kernel
// runs is checked against the plain PyTorch version without a GPU.
//
// Semantics: arriba_tpu/ops/realign.py smith_waterman_scores, exactly. For
// a (read, window) row, cell (i, j) holds
//   h(i, j) = max(h(i-1, j-1) + s, h(i-1, j) + gap, h(i, j-1) + gap, 0)
// in int32, with s = match where the whole bytes read[i] and window[j] are
// equal and mismatch elsewhere, and h = 0 wherever either byte is PAD (4);
// cells outside the matrix are 0. The row's score is the largest h. Any
// byte 0-255 is taken: K3 (smith_waterman.cuh) ships codes in 3 bits and
// scores in 16, and the op routes here what it cannot carry.
//
// Work split: one warp per row. Lane k owns S consecutive read positions
// (a stripe, in registers) of a tile of 32 S positions and at step t works
// window column j = t - k, as K3's first design did for one tile. A read
// longer than a tile is cut into tiles of 32 S positions; the warp sweeps the
// window once a tile, and the h of a tile's last read position at every
// window column (its last row) is what the next tile's first position
// needs as "up" and "diag": lane 31 stores it in a carry row of W int32 in
// device memory, one column a step, and the next tile's lane 0 reads it
// back, chunk by chunk, as the h of the row above (sw_wide_up).
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
// is also where the JAX op's own int32 sums stop being exact.
#pragma once

#include <stdint.h>

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

// The stripe a lane holds: S, the read positions of a tile (32 S of them)
// and the tiles of a read of L positions. The stripes are 1, 2, 4, 8, 12 or
// 16 positions: the fewest tiles of at most 512 positions, then the
// smallest stripe that covers the read in that many tiles.
__host__ __device__ inline int sw_wide_stripe(int L) {
    const int tiles = L > 0 ? (L + 32 * SWW_MAX_STRIPE - 1)
                                  / (32 * SWW_MAX_STRIPE)
                            : 1;
    const int need = ((L + tiles - 1) / tiles + 31) / 32;
    return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8
         : need <= 12 ? 12 : 16;
}

__host__ __device__ inline int sw_wide_tiles(int L, int S) {
    return L > 0 ? (L + 32 * S - 1) / (32 * S) : 0;
}

// One lane's stripe of S read positions.
template <int S>
struct SwWideLane {
    int col[S];     // h(stripe row r, previous column)
    int read[S];    // read bytes, PAD past the read
    int prev_in;    // h(row above the stripe, previous column)
    int best;       // largest h the lane has seen, over every tile
};

// Start a tile: the lane's stripe of positions first .. first + S - 1 of a
// read of L bytes; h = 0 before the first column. best is kept.
template <int S>
__host__ __device__ inline void sw_wide_tile_init(SwWideLane<S>* lane,
                                                  const uint8_t* read,
                                                  int first, int L) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
        lane->col[r] = 0;
        lane->read[r] = first + r < L ? read[first + r] : SWW_PAD;
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

// Lane 0's "up" at column t of tile `tile`: 0 above the read's first
// position, else the previous tile's carry at column t (0 past the window,
// where every cell is PAD)
__host__ __device__ inline int sw_wide_up(const int32_t* carry, int tile,
                                          int t, int W) {
    return tile > 0 && t < W ? carry[t] : 0;
}

// The carry column lane 31 stores at step t of a tile that is not the last
// (h of the tile's last position at column t - 31), or -1 for none
__host__ __device__ inline int sw_wide_store_column(int t, int W) {
    const int j = t - 31;
    return j >= 0 && j < W ? j : -1;
}

// Steps of a tile whose stripes hold positions first .. L - 1 (the last
// lane holding one finishes column W - 1 at step W - 1 + its index); a tile
// with a successor is full, so it runs W + 31 steps
__host__ __device__ inline int sw_wide_steps(int first, int L, int W, int S) {
    const int held = L - first < 32 * S ? L - first : 32 * S;
    return held > 0 ? W + (held - 1) / S : 0;
}

}  // namespace arriba
