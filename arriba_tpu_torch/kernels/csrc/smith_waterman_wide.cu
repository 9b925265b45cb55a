// K3w: best Smith-Waterman local alignment score per (read, window) row,
// tiled over the read and trimmed to each row's length, for sm_90a: what
// K3 (smith_waterman.cu) does not carry. Two kernels: K3's 16-bit pairs
// for reads past 512 positions whose scores and bytes K3's guards pass,
// and 32-bit lanes for the rest.
//
// Replaces: arriba_tpu/ops/realign.py smith_waterman_scores_pallas (the
// Pallas TPU kernel at :162, pl.pallas_call at :235) and its jnp twin
// smith_waterman_scores (:124) on the inputs K3 refuses: reads longer than
// 512 positions (a ReadBatch of 513 bp or longer reads is 640 wide, and the
// data-parallel realign step scores it), scores that could reach 2^13,
// match - gap or mismatch - gap outside a signed byte, and bytes above code
// 4. kernels.smith_waterman routes a batch from its shapes, scores and
// largest byte, before launch (kernels.sw_route): "smith_waterman_wide16"
// where only the read length stops K3, "smith_waterman_wide" otherwise.
//
// What bounds it: integer operations, on the cells whose read and window
// bytes are both not PAD. In 16-bit pairs a pair of such cells needs K3's
// 4 slots of the 32-bit integer rate (chip_smoke.py SW_OPS); in 32-bit
// lanes a cell needs 7 (SWW_OPS): the byte compare and the select of match
// or mismatch, the max of up and left, + gap, the add, max and floor at 0
// (one DPX instruction), the PAD select and the running best. The inputs
// are one byte a read position and a window column: at 65,536 rows x 640 x
// 256 that is ~1e10 cells against 59 MB (and the carry row, W int32 a row
// or a pair, written and read once a tile boundary), so operations and not
// memory set the bound.
//
// Design (smith_waterman_wide.cuh): a warp a row (32-bit) or a pair of
// rows (16-bit). It first finds its rows' extents (1 + the last non-PAD
// read byte and window byte, a __reduce_max_sync over the lanes' runs of
// the row) and picks its own stripe S from the read's: the launch
// instantiates every stripe a row of the batch width can take, and each
// warp branches to its own, so a warp never diverges. A lane holds S read
// positions in registers; the h of the stripe's last position and the
// column's window byte (codes, for pairs) go to the next lane by
// __shfl_up_sync each step. The read is cut into tiles of 32 S positions;
// the warp sweeps the window's extent once a tile, lane 31 storing the
// tile's last row into a carry row in device memory, lane 0 of the next
// tile reading it back 128 columns at a time (four entries a lane, one
// shuffle a step). Lane 0 takes window bytes from a register chunk of 128
// columns loaded as 32-bit words, as K3 does. 32-bit cells are one
// __viaddmax_s32_relu; 16-bit pairs run K3's sw_pair_column (both rows in
// the halves of each word, the steps in fours) unchanged. The running best
// is a per-lane max over every tile, then __reduce_max_sync. A block holds
// 4 warps.
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
struct Stripe {
    static constexpr int kS = S;
};

// f(Stripe<s>()) for a warp's stripe s (sw_wide_stripe), 1 <= s <= Cap,
// among the stripes of the set from S to Cap (sw_wide_stripe_cap of the
// batch width) that the launch instantiates
template <int Cap, int S = 1, typename F>
__device__ inline void with_stripe(int s, F&& f) {
    if constexpr (S < Cap && !arriba::sw_wide_allowed(S)) {
        with_stripe<Cap, S + 1>(s, f);
    } else {
        if constexpr (S < Cap) {
            if (s > S) {
                with_stripe<Cap, S + 1>(s, f);
                return;
            }
        }
        f(Stripe<S>());
    }
}

// ---- 32-bit lanes: a warp a row

// The lane's best h over the row's tiles: a read of len_r positions
// against a window of len_w columns (the extents; the window row is W
// bytes in memory)
template <int S>
__device__ int wide_row(const uint8_t* read, const uint8_t* win,
                        int32_t* row_carry, int len_r, int len_w, int W,
                        bool aligned, int match, int mismatch, int gap) {
    const int lane = threadIdx.x & 31;
    const int tiles = arriba::sw_wide_tiles(len_r, S);
    arriba::SwWideLane<S> stripe;
    stripe.best = 0;
    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * 32 * S;
        arriba::sw_wide_tile_init<S>(&stripe, read, first + lane * S, len_r);
        const int n_steps = arriba::sw_wide_steps(first, len_r, len_w, S);
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
                                            base + 4 * lane + c, len_w);
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
                    const int j = arriba::sw_wide_store_column(t, len_w);
                    if (j >= 0) row_carry[j] = h;
                }
            }
        }
        __syncwarp();  // the carry row's stores before the next tile's loads
    }
    return stripe.best;
}

template <int Cap>
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
    const int len_r = __reduce_max_sync(
        kFull, arriba::sw_wide_extent(read, L, lane));
    const int len_w = __reduce_max_sync(
        kFull, arriba::sw_wide_extent(win, W, lane));
    int best = 0;
    if (len_r > 0 && len_w > 0) {
        // plain loads and stores (not __ldg): the carry is written in this
        // launch
        int32_t* row_carry = carry + (size_t)row * W;
        const bool aligned = (reinterpret_cast<uintptr_t>(win) & 3) == 0;
        with_stripe<Cap>(arriba::sw_wide_stripe(len_r), [&](auto s) {
            best = wide_row<decltype(s)::kS>(read, win, row_carry, len_r,
                                             len_w, W, aligned, match,
                                             mismatch, gap);
        });
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) out[row] = best;
}

// ---- 16-bit pairs: a warp two rows, K3's cell

// The lane's best h of both rows over the pair's tiles: reads a and b (b
// null for the dummy row of an odd batch) cut at the pair's extent len_r,
// against windows win_a and win_b (W bytes in memory) up to its extent
// len_w
template <int S>
__device__ uint32_t wide16_pair(const uint8_t* a, const uint8_t* b,
                                const uint8_t* win_a, const uint8_t* win_b,
                                int32_t* pair_carry, int len_r, int len_w,
                                int W, bool aligned,
                                const arriba::SwScores& sc) {
    const int lane = threadIdx.x & 31;
    const int tiles = arriba::sw_wide_tiles(len_r, S);
    arriba::SwPair<S> stripe;
    stripe.best = 0;
    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * 32 * S;
        arriba::sw_pair_tile_init<S>(&stripe, a, b, first + lane * S, len_r,
                                     sc.gap2);
        // the steps run in fours; the up to three past n_steps see PAD
        // columns only (or store past the window's extent, which is
        // skipped)
        const int n_steps = arriba::sw_wide_steps(first, len_r, len_w, S);
        const bool stores = tile + 1 < tiles;
        // before the first column: h = 0 and PAD codes
        uint32_t word = arriba::sw_window_word(arriba::SW_PAD,
                                               arriba::SW_PAD);
        for (int base = 0; base < n_steps; base += arriba::SWW_CHUNK) {
            const int at = base + 4 * lane;
            const uint32_t chunk =
                load_window_word(win_a, at, W, aligned)
                | ((b != nullptr ? load_window_word(win_b, at, W, aligned)
                                 : 0x04040404u) << 4);
            int up4[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                up4[c] = arriba::sw_wide_up(pair_carry, tile, at + c, len_w);
            }
            const int steps = min(arriba::SWW_CHUNK, n_steps - base);
            for (int i = 0; i < steps; i += 4) {
                const uint32_t pair = __shfl_sync(kFull, chunk, i >> 2);
                uint32_t up[4] = {0u, 0u, 0u, 0u};
                if (tile > 0) {
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        up[u] = (uint32_t)__shfl_sync(kFull, up4[u], i >> 2);
                    }
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const uint32_t incoming = __shfl_up_sync(kFull, word, 1);
                    const uint32_t in =
                        lane == 0 ? arriba::sw_wide16_lane0(pair, u, up[u])
                                  : incoming;
                    word = arriba::sw_pair_column<S>(&stripe, in, sc);
                    if (stores && lane == 31) {
                        const int j = arriba::sw_wide_store_column(
                            base + i + u, len_w);
                        if (j >= 0) {
                            pair_carry[j] = arriba::sw_wide16_carry(word);
                        }
                    }
                }
            }
        }
        __syncwarp();  // the carry row's stores before the next tile's loads
    }
    return stripe.best;
}

template <int Cap>
__global__ void __launch_bounds__(kWarps * 32)
smith_waterman_wide16_kernel(const uint8_t* __restrict__ reads,
                             const uint8_t* __restrict__ windows,
                             int32_t* __restrict__ out, int32_t* carry, int n,
                             int L, int W, int match, int mismatch, int gap) {
    const int lane = threadIdx.x & 31;
    const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int row = 2 * pair;
    if (row >= n) return;  // the whole warp leaves together
    const bool has_b = row + 1 < n;

    const uint8_t* a = reads + (size_t)row * L;
    const uint8_t* b = has_b ? a + L : nullptr;
    const uint8_t* win_a = windows + (size_t)row * W;
    const uint8_t* win_b = has_b ? win_a + W : nullptr;
    const int len_r = __reduce_max_sync(
        kFull, max(arriba::sw_wide_extent(a, L, lane),
                   has_b ? arriba::sw_wide_extent(b, L, lane) : 0));
    const int len_w = __reduce_max_sync(
        kFull, max(arriba::sw_wide_extent(win_a, W, lane),
                   has_b ? arriba::sw_wide_extent(win_b, W, lane) : 0));
    uint32_t best = 0;
    if (len_r > 0 && len_w > 0) {
        const arriba::SwScores sc = arriba::sw_scores(match, mismatch, gap);
        int32_t* pair_carry = carry + (size_t)pair * W;
        const bool aligned = (reinterpret_cast<uintptr_t>(win_a) & 3) == 0
                             && (W & 3) == 0;
        with_stripe<Cap>(arriba::sw_wide_stripe(len_r), [&](auto s) {
            best = wide16_pair<decltype(s)::kS>(a, b, win_a, win_b,
                                                pair_carry, len_r, len_w, W,
                                                aligned, sc);
        });
    }
    const int best_a = (int)__reduce_max_sync(kFull, best & 0xffffu);
    const int best_b = (int)__reduce_max_sync(kFull, best >> 16);
    if (lane == 0) {
        out[row] = best_a;
        if (has_b) out[row + 1] = best_b;
    }
}

// One launch of the 16-bit (Pairs) or the 32-bit kernel, a warp a pair of
// rows or a row
template <int Cap, bool Pairs>
int launch(const void* reads, const void* windows, void* out, void* carry,
           int n, int L, int W, int match, int mismatch, int gap,
           cudaStream_t stream) {
    const int warps = Pairs ? (n + 1) / 2 : n;
    const int blocks = (warps + kWarps - 1) / kWarps;
    if constexpr (Pairs) {
        smith_waterman_wide16_kernel<Cap><<<blocks, kWarps * 32, 0, stream>>>(
            (const uint8_t*)reads, (const uint8_t*)windows, (int32_t*)out,
            (int32_t*)carry, n, L, W, match, mismatch, gap);
    } else {
        smith_waterman_wide_kernel<Cap><<<blocks, kWarps * 32, 0, stream>>>(
            (const uint8_t*)reads, (const uint8_t*)windows, (int32_t*)out,
            (int32_t*)carry, n, L, W, match, mismatch, gap);
    }
    return (int)cudaGetLastError();
}

// The launch whose stripes cover every row of a batch L wide
template <bool Pairs>
int launch_any(const void* reads, const void* windows, void* out,
               void* carry, int n, int L, int W, int match, int mismatch,
               int gap, void* stream) {
    if (n == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (arriba::sw_wide_stripe_cap(L)) {
    case 4: return launch<4, Pairs>(reads, windows, out, carry, n, L, W,
                                    match, mismatch, gap, s);
    case 8: return launch<8, Pairs>(reads, windows, out, carry, n, L, W,
                                    match, mismatch, gap, s);
    default: return launch<16, Pairs>(reads, windows, out, carry, n, L, W,
                                      match, mismatch, gap, s);
    }
}

}  // namespace

extern "C" {

// reads uint8 [n, L] and windows uint8 [n, W] (any bytes; PAD 4), out int32
// [n], carry int32 [n, W] scratch when L > 512 (a row can span more than
// one tile; unread otherwise, may be null); the scores inside the int32
// guard of smith_waterman_wide.cuh (checked by the caller).
int arriba_smith_waterman_wide(const void* reads, const void* windows,
                               void* out, void* carry, int n, int L, int W,
                               int match, int mismatch, int gap,
                               void* stream) {
    return launch_any<false>(reads, windows, out, carry, n, L, W, match,
                             mismatch, gap, stream);
}

const char* arriba_smith_waterman_wide_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The 16-bit pairs: reads and windows hold codes 0-4 (PAD 4), carry int32
// [ceil(n / 2), W] scratch when L > 512 (unread otherwise, may be null);
// the scores inside K3's 16-bit guard (smith_waterman.cuh; checked by the
// caller, as the codes are), at any L.
int arriba_smith_waterman_wide16(const void* reads, const void* windows,
                                 void* out, void* carry, int n, int L, int W,
                                 int match, int mismatch, int gap,
                                 void* stream) {
    return launch_any<true>(reads, windows, out, carry, n, L, W, match,
                            mismatch, gap, stream);
}

const char* arriba_smith_waterman_wide16_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
