// K3w: best Smith-Waterman local alignment score per (read, window) row in
// 32-bit lanes, for sm_90a: what K3 (smith_waterman.cu) does not carry.
//
// Replaces: arriba_tpu/ops/realign.py smith_waterman_scores_pallas (the
// Pallas TPU kernel at :162, pl.pallas_call at :235) and its jnp twin
// smith_waterman_scores (:124) on the inputs K3 refuses: reads longer than
// 512 positions (a ReadBatch of 513 bp or longer reads is 640 wide, and the
// data-parallel realign step scores it), scores that could reach 2^13,
// match - gap or mismatch - gap outside a signed byte, and bytes above code
// 4. kernels.smith_waterman routes a batch here from its shapes, scores and
// largest byte, before launch.
//
// What bounds it: integer operations. No cell can be skipped, and a cell
// needs 7 in 32 bits (chip_smoke.py SWW_OPS): the byte compare and the
// select of match or mismatch, the max of up and left, + gap, the add, max
// and floor at 0 (one DPX instruction), the PAD select and the running
// best. The inputs are one byte a read position and a window column: at
// 65,536 rows x 640 x 256 that is ~1.1e10 cells against 59 MB (and the
// carry row, W int32 a row, written and read once a tile boundary), so
// operations and not memory set the bound.
//
// Design: K3's first design (a warp a row, a stripe of S read positions a
// lane in registers, the h of the stripe's last position and the window
// byte of the column passed to the next lane by __shfl_up_sync each step,
// the cell one __viaddmax_s32_relu), with the read cut into tiles of 32 S
// positions
// (smith_waterman_wide.cuh): the warp sweeps the window once a tile, lane
// 31 storing the tile's last row into a carry row in device memory, lane 0
// of the next tile reading it back 128 columns at a time (four int32 a
// lane, one shuffle a step). Lane 0 takes window bytes from a register
// chunk of 128 columns loaded as 32-bit words, as K3 does. The running
// best is a per-lane max over every tile, then __reduce_max_sync. A block
// holds 4 warps (4 rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include "smith_waterman_wide.cuh"

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
        const uint32_t byte = at + b < W ? win[at + b] : arriba::SWW_PAD;
        word |= byte << (8 * b);
    }
    return word;
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
smith_waterman_wide_kernel(const uint8_t* __restrict__ reads,
                           const uint8_t* __restrict__ windows,
                           int32_t* __restrict__ out, int32_t* carry, int n,
                           int L, int W, int match, int mismatch, int gap) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= n) return;  // the whole warp leaves together

    const uint8_t* read = reads + (size_t)row * L;
    const uint8_t* win = windows + (size_t)row * W;
    // plain loads and stores (not __ldg): the carry is written in this
    // launch
    int32_t* row_carry = carry + (size_t)row * W;
    const bool aligned = (reinterpret_cast<uintptr_t>(win) & 3) == 0;
    const int tiles = arriba::sw_wide_tiles(L, S);
    arriba::SwWideLane<S> stripe;
    stripe.best = 0;
    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * 32 * S;
        arriba::sw_wide_tile_init<S>(&stripe, read, first + lane * S, L);
        const int n_steps = arriba::sw_wide_steps(first, L, W, S);
        const bool stores = tile + 1 < tiles;
        int h = 0;
        int w = arriba::SWW_PAD;
        for (int base = 0; base < n_steps; base += arriba::SWW_CHUNK) {
            const uint32_t chunk = load_window_word(win, base + 4 * lane, W,
                                                    aligned);
            int up4[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                up4[c] = arriba::sw_wide_up(row_carry, tile,
                                            base + 4 * lane + c, W);
            }
            const int steps = min(arriba::SWW_CHUNK, n_steps - base);
            for (int i = 0; i < steps; ++i) {
                const int t = base + i;
                const uint32_t word = __shfl_sync(kFull, chunk, i >> 2);
                const int mine = (i & 3) == 0 ? up4[0] : (i & 3) == 1 ? up4[1]
                               : (i & 3) == 2 ? up4[2] : up4[3];
                const int up0 = __shfl_sync(kFull, mine, i >> 2);
                const int in_h = __shfl_up_sync(kFull, h, 1);
                const int in_w = __shfl_up_sync(kFull, w, 1);
                const int up = lane == 0 ? up0 : in_h;
                w = lane == 0 ? (int)((word >> (8 * (i & 3))) & 0xffu) : in_w;
                h = arriba::sw_wide_column<S>(&stripe, up, w, match,
                                              mismatch, gap);
                if (stores && lane == 31) {
                    const int j = arriba::sw_wide_store_column(t, W);
                    if (j >= 0) row_carry[j] = h;
                }
            }
        }
        __syncwarp();  // the carry row's stores before the next tile's loads
    }
    const int best = __reduce_max_sync(kFull, stripe.best);
    if (lane == 0) out[row] = best;
}

template <int S>
int launch(const void* reads, const void* windows, void* out, void* carry,
           int n, int L, int W, int match, int mismatch, int gap,
           cudaStream_t stream) {
    const int blocks = (n + kWarps - 1) / kWarps;
    smith_waterman_wide_kernel<S><<<blocks, kWarps * 32, 0, stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (int32_t*)out,
        (int32_t*)carry, n, L, W, match, mismatch, gap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// reads uint8 [n, L] and windows uint8 [n, W] (any bytes; PAD 4), out int32
// [n], carry int32 [n, W] scratch when L > 512 (more than one tile; unread
// otherwise, may be null); the scores inside the int32 guard of
// smith_waterman_wide.cuh (checked by the caller).
int arriba_smith_waterman_wide(const void* reads, const void* windows,
                               void* out, void* carry, int n, int L, int W,
                               int match, int mismatch, int gap,
                               void* stream) {
    if (n == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (arriba::sw_wide_stripe(L)) {
    case 1: return launch<1>(reads, windows, out, carry, n, L, W, match,
                             mismatch, gap, s);
    case 2: return launch<2>(reads, windows, out, carry, n, L, W, match,
                             mismatch, gap, s);
    case 4: return launch<4>(reads, windows, out, carry, n, L, W, match,
                             mismatch, gap, s);
    case 8: return launch<8>(reads, windows, out, carry, n, L, W, match,
                             mismatch, gap, s);
    case 12: return launch<12>(reads, windows, out, carry, n, L, W, match,
                               mismatch, gap, s);
    default: return launch<16>(reads, windows, out, carry, n, L, W, match,
                               mismatch, gap, s);
    }
}

const char* arriba_smith_waterman_wide_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
