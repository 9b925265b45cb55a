// K3: best Smith-Waterman local alignment score per (read, window) row, for
// sm_90a.
//
// Replaces: arriba_tpu/ops/realign.py smith_waterman_scores_pallas (the
// Pallas TPU kernel at :162, pl.pallas_call at :235) and its jnp twin
// smith_waterman_scores (:124), the scoring half of realign_step, which the
// data-parallel path runs (parallel/dp.py sharded_realign_step).
//
// What bounds it: integer operations. A cell needs about 9 (the match test
// and select, three candidate adds, the max of four, the running best) and
// no cell can be skipped, while the inputs are one byte per read position
// and per window column: at 65,536 rows x 256 x 256 that is ~4e9 cells
// against 34 MB, so operations and not memory set the bound.
//
// Design: the TPU kernel keeps [block, L] carry diagonals in VMEM and feeds
// window bytes through a 128-lane shift register. Gaps couple neighbouring
// cells of a diagonal, so unlike K1 this needs a real wavefront, and on the
// GPU it lives in one warp per row with every carry in registers: lane k
// holds a stripe of S = L/32 read positions and at step t computes column
// t - k; the h of its stripe's last row and the window byte it used go to
// lane k+1 in one __shfl_up_sync (packed as h << 8 | byte), so a row takes
// W + 31 steps (fewer when the last lanes hold only padding) with two
// shuffles each. Lane 0 takes window bytes from a register chunk of 128
// columns that the warp loads as whole 32-bit words, one per lane, every
// 128 steps. The cell update is one DPX __viaddmax_s32_relu. The running
// best is a per-lane max, then __reduce_max_sync. A block holds 8 rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smith_waterman.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
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
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= n) return;  // the whole warp leaves together

    arriba::SwLane<S> stripe;
    arriba::sw_lane_init<S>(&stripe, reads + (size_t)row * L, lane * S, L);
    const uint8_t* win = windows + (size_t)row * W;
    const bool aligned = (reinterpret_cast<uintptr_t>(win) & 3) == 0;
    // the last lane holding read positions finishes column W-1 at step
    // W - 1 + (L - 1) / S
    const int n_steps = L > 0 ? W + (L - 1) / S : 0;
    uint32_t chunk = 0;
    int packed = arriba::SW_PAD;  // h of the stripe's last row << 8 | byte
    for (int t = 0; t < n_steps; ++t) {
        if ((t & 127) == 0) {
            chunk = load_window_word(win, t + 4 * lane, W, aligned);
        }
        const uint32_t word = __shfl_sync(kFull, chunk, (t >> 2) & 31);
        const int incoming = __shfl_up_sync(kFull, packed, 1);
        const int up = lane == 0 ? 0 : incoming >> 8;
        const int w = lane == 0 ? (int)((word >> (8 * (t & 3))) & 0xffu)
                                : incoming & 0xff;
        const int h = arriba::sw_lane_column<S>(&stripe, up, w, match,
                                                mismatch, gap);
        packed = (h << 8) | w;
    }
    const int best = __reduce_max_sync(kFull, stripe.best);
    if (lane == 0) out[row] = best;
}

template <int S>
int launch(const void* reads, const void* windows, void* out, int n, int L,
           int W, int match, int mismatch, int gap, cudaStream_t stream) {
    const int blocks = (n + kWarps - 1) / kWarps;
    smith_waterman_kernel<S><<<blocks, kWarps * 32, 0, stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (int32_t*)out, n, L,
        W, match, mismatch, gap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// reads uint8 [n, L] (PAD 4), windows uint8 [n, W] (PAD 4), out int32 [n];
// L <= 512 (a stripe of at most 16 positions a lane), and every h below
// 2^23 (checked by the caller).
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
