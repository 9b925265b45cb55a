// K3: best Smith-Waterman local alignment score per (read, window) row, for
// sm_90a.
//
// Replaces: arriba_tpu/ops/realign.py smith_waterman_scores_pallas (the
// Pallas TPU kernel at :162, pl.pallas_call at :235) and its jnp twin
// smith_waterman_scores (:124), the scoring half of realign_step, which the
// data-parallel path runs (parallel/dp.py sharded_realign_step).
//
// What bounds it: integer operations. No cell can be skipped. Every score
// fits 16 bits, so sm_90's 16x2 forms do a cell of two rows in one 32-bit
// instruction, and such a pair of valid cells needs five: one byte permute
// for the match test and its select, h + gap, the add, max and floor at 0
// (one DPX instruction), each at 64 a clock per SM, and the max of up and
// left and the running best, max.s16x2 at 128 a clock: 4 slots of the
// 32-bit integer rate a pair, 2 a cell (chip_smoke.py SW_OPS). The inputs
// are one byte per read position and window column: at 65,536 rows x 256
// x 256 that is ~4e9 cells against 34 MB, so operations and not memory set
// the bound.
//
// Design: the TPU kernel keeps [block, L] carry diagonals in VMEM and feeds
// window bytes through a 128-lane shift register. Gaps couple neighbouring
// cells of a diagonal, so this needs a real wavefront, and on the GPU it
// lives in one warp per two batch rows with every carry in registers, the
// two rows in the halves of each 32-bit word (smith_waterman.cuh): lane k
// holds a stripe of S = L/32 read positions of both rows and at step t
// computes column t - k. The two rows' h of the stripe's last position and
// their window codes of the column go to lane k+1 in one __shfl_up_sync,
// so a pair of rows takes W + 31 steps (fewer when the last lanes hold only
// padding), run in fours. Lane 0 takes the codes from a register chunk of
// 128 columns of both rows that the warp loads as whole 32-bit words, one
// per lane and row, every 128 steps; one more shuffle every four steps
// hands lane 0 its next four columns. A cell is one byte permute (the score by read code,
// from two words built per step from the window codes), max.s16x2, the
// DPX add+max.relu, a three-input AND for PAD, add.s16x2 and max.s16x2.
// The running best is a per-lane max, then __reduce_max_sync per row. A
// block holds 4 warps (8 rows; ~1 % faster than 8 warps, PERF.md); an odd
// batch's last warp pairs its row with an all-PAD dummy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smith_waterman.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// four window bytes from column at on, PAD past the row's end
__device__ inline uint32_t load_window_word(const uint8_t* win, int at, int W,
                                            bool aligned) {
    if (aligned && at + 3 < W) {
        return __ldg(reinterpret_cast<const uint32_t*>(win + at));
    }
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const uint32_t byte = at + b < W ? win[at + b] : arriba::SW_PAD;
        word |= byte << (8 * b);
    }
    return word;
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
smith_waterman_kernel(const uint8_t* __restrict__ reads,
                      const uint8_t* __restrict__ windows,
                      int32_t* __restrict__ out, int n, int L, int W,
                      int match, int mismatch, int gap) {
    const int lane = threadIdx.x & 31;
    const int row = 2 * (blockIdx.x * kWarps + (threadIdx.x >> 5));
    if (row >= n) return;  // the whole warp leaves together
    const bool has_b = row + 1 < n;

    const arriba::SwScores sc = arriba::sw_scores(match, mismatch, gap);
    arriba::SwPair<S> stripe;
    arriba::sw_pair_init<S>(&stripe, reads + (size_t)row * L,
                            has_b ? reads + (size_t)(row + 1) * L : nullptr,
                            lane * S, L, sc.gap2);
    const uint8_t* win_a = windows + (size_t)row * W;
    const uint8_t* win_b = win_a + W;
    const bool aligned = (reinterpret_cast<uintptr_t>(win_a) & 3) == 0
                         && (W & 3) == 0;
    // the last lane holding read positions finishes column W-1 at step
    // W - 1 + (L - 1) / S; the steps run in fours, and the up to three
    // past that see PAD columns only, which change no score
    const int n_steps = L > 0 ? W + (L - 1) / S : 0;
    // before the first column: h = 0 and PAD codes
    uint32_t word = arriba::sw_window_word(arriba::SW_PAD, arriba::SW_PAD);
    for (int base = 0; base < n_steps; base += 128) {
        const int at = base + 4 * lane;
        const uint32_t chunk =
            load_window_word(win_a, at, W, aligned)
            | ((has_b ? load_window_word(win_b, at, W, aligned)
                      : 0x04040404u) << 4);
        const int steps = min(128, n_steps - base);
        for (int i = 0; i < steps; i += 4) {
            const uint32_t pair = __shfl_sync(kFull, chunk, i >> 2);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const uint32_t incoming = __shfl_up_sync(kFull, word, 1);
                const uint32_t in = lane == 0 ? arriba::sw_lane0_word(pair, u)
                                              : incoming;
                word = arriba::sw_pair_column<S>(&stripe, in, sc);
            }
        }
    }
    const int best_a = (int)__reduce_max_sync(kFull, stripe.best & 0xffffu);
    const int best_b = (int)__reduce_max_sync(kFull, stripe.best >> 16);
    if (lane == 0) {
        out[row] = best_a;
        if (has_b) out[row + 1] = best_b;
    }
}

template <int S>
int launch(const void* reads, const void* windows, void* out, int n, int L,
           int W, int match, int mismatch, int gap, cudaStream_t stream) {
    const int pairs = (n + 1) / 2;
    const int blocks = (pairs + kWarps - 1) / kWarps;
    smith_waterman_kernel<S><<<blocks, kWarps * 32, 0, stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (int32_t*)out, n, L,
        W, match, mismatch, gap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// reads uint8 [n, L] (codes 0-4, PAD 4), windows uint8 [n, W] (the same),
// out int32 [n]; L <= 512 (a stripe of at most 16 positions a lane), and
// the scores inside the 16-bit guard of smith_waterman.cuh (checked by the
// caller).
int arriba_smith_waterman(const void* reads, const void* windows, void* out,
                          int n, int L, int W, int match, int mismatch,
                          int gap, void* stream) {
    if (n == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const int stripe = (L + 31) / 32;
    if (stripe <= 1) return launch<1>(reads, windows, out, n, L, W, match,
                                      mismatch, gap, s);
    if (stripe <= 2) return launch<2>(reads, windows, out, n, L, W, match,
                                      mismatch, gap, s);
    if (stripe <= 4) return launch<4>(reads, windows, out, n, L, W, match,
                                      mismatch, gap, s);
    if (stripe <= 8) return launch<8>(reads, windows, out, n, L, W, match,
                                      mismatch, gap, s);
    if (stripe <= 16) return launch<16>(reads, windows, out, n, L, W, match,
                                        mismatch, gap, s);
    return (int)cudaErrorInvalidValue;
}

const char* arriba_smith_waterman_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
