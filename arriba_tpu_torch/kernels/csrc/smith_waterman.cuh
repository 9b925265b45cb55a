// Per-cell and per-lane math of the Smith-Waterman score wavefront (K3).
//
// Shared by the CUDA kernel (smith_waterman.cu) and a CPU build of the same
// functions (tests/test_torch_kernel_math.py), so the code the kernel runs
// is checked against the plain PyTorch version without a GPU.
//
// Semantics: arriba_tpu/ops/realign.py smith_waterman_scores. For a (read,
// window) row, cell (i, j) holds
//   h(i, j) = max(h(i-1, j-1) + s, h(i-1, j) + gap, h(i, j-1) + gap, 0)
// with s = match where read[i] == window[j] and mismatch elsewhere, and
// h = 0 wherever the read byte or the window byte is PAD (4); cells outside
// the matrix are 0. The row's score is the largest h.
//
// Work split: one warp per row. Lane k owns the S consecutive read
// positions k*S .. k*S+S-1 (a stripe, kept in registers) and at step t
// works window column j = t - k, so the warp sweeps the window as a
// wavefront of 32 columns. A lane needs, for column j, the value of the
// row above its stripe at column j (from lane k-1's previous step) and at
// column j-1 (the one it received a step earlier): sw_lane_column takes
// the first and keeps the second.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int SW_PAD = 4;  // PAD_CODE of ops/encode.py

// max(diag + s, max(up, left) + gap, 0): on sm_90 one DPX instruction
__host__ __device__ inline int sw_cell(int diag, int up, int left, int s,
                                       int gap) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    return __viaddmax_s32_relu(diag, s, max(up, left) + gap);
#else
    const int a = diag + s;
    const int b = (up > left ? up : left) + gap;
    const int m = a > b ? a : b;
    return m > 0 ? m : 0;
#endif
}

// One lane's stripe of S read positions.
template <int S>
struct SwLane {
    int col[S];       // h(stripe row r, previous column)
    int read[S];      // read bytes, PAD beyond the row
    int prev_in;      // h(row above the stripe, previous column)
    int best;         // largest h the lane has seen
};

template <int S>
__host__ __device__ inline void sw_lane_init(SwLane<S>* lane,
                                             const uint8_t* read, int first,
                                             int L) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
        lane->col[r] = 0;
        lane->read[r] = first + r < L ? read[first + r] : SW_PAD;
    }
    lane->prev_in = 0;
    lane->best = 0;
}

// Column j of the lane's stripe: up_in = h(row above the stripe, j) and w =
// window[j] (PAD outside the window). Returns h(last stripe row, j), which
// the lane below needs next step.
template <int S>
__host__ __device__ inline int sw_lane_column(SwLane<S>* lane, int up_in,
                                              int w, int match, int mismatch,
                                              int gap) {
    int diag = lane->prev_in;
    int up = up_in;
    lane->prev_in = up_in;
    const bool w_pad = w == SW_PAD;
#pragma unroll
    for (int r = 0; r < S; ++r) {
        const int left = lane->col[r];
        const int s = lane->read[r] == w ? match : mismatch;
        int h = sw_cell(diag, up, left, s, gap);
        if (w_pad || lane->read[r] == SW_PAD) h = 0;
        diag = left;
        lane->col[r] = h;
        up = h;
        lane->best = h > lane->best ? h : lane->best;
    }
    return up;
}

}  // namespace arriba
