"""The per-cell / per-position code the CUDA kernels run, on the CPU.

kernels/csrc/accept_wavefront.cuh, low_entropy.cuh and smith_waterman.cuh
hold the update functions K1, K2 and K3 call, as ``__host__ __device__``
code. Here g++ compiles them into a small harness that walks rows the way
the kernels do (K1: the seed lookup per strip of diagonals, the read's
8-mers in a bitmap, the window scan claiming each named diagonal once, then
a walk of each claimed diagonal, OR over them; and every diagonal walked,
for the per-diagonal soundness of the lookup;
K2: one sequential walk per read over its 2-bit-packed codes, and the
kernel's walk of a read from one byte pair per four positions into packed
counter words, tested once per 3-mer, or for wider rows the sequential
walk with three counters a 3-mer; K3: the 32 lanes of a warp over a pair of
rows in 16-bit halves, each lane a stripe of read positions, stepping over
the window columns with lane k taking lane k-1's previous word as the
shuffle does, with the host emulations of the 16x2 instructions; K3w:
the 32 lanes of a warp over one row in int32, the read in tiles whose last
row is carried to the next through a carry row; K4: its warpgroup's
products emulated from its layouts, at k = 8 and, for its any-k kernel,
at other k with biased digits, both through their copy rings stage by
stage; K1's rows that walk every diagonal; K1's rows read by offset from
a read table and a window table, and K5's blocks, a window's 8-mers in a
bitmap and its rows' read 8-mers tested a warp's 32 at a time), and
the results are held, exactly, against the port's plain PyTorch versions
and the JAX package's ops.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from arriba_tpu.ops import readfilters as jax_readfilters  # noqa: E402
from arriba_tpu.ops import realign as jax_realign  # noqa: E402
from arriba_tpu_torch.kernels.build import CSRC  # noqa: E402
from arriba_tpu_torch.ops import readfilters, realign  # noqa: E402
from chip_smoke import (ACCEPT_KINDS, accept_adversarial_inputs,  # noqa: E402
                        KB_EDGE_CASES, kb_edge_case, kb_slice_edge_cases,
                        mxu_inputs,
                        mxu_work, resident_chunk_edges,
                        resident_layouts, resident_main, resident_reads_n,
                        resident_shared, resident_short, resident_tail)

HARNESS = r"""
#include <stdint.h>
#include <algorithm>
#include <cstring>
#include <vector>
#include "accept_wavefront.cuh"
#include "kmer_bitmap_screen.cuh"
#include "low_entropy.cuh"
#include "mxu_kmer_screen.cuh"
#include "smith_waterman.cuh"
#include "smith_waterman_wide.cuh"

// K4's group of MK_GROUP wgmma.m64n160k32 s8 for one warpgroup, emulated
// from the layouts: tile j's 128 threads' A registers scattered into A_j
// (64 x 32) by mk_a_row / mk_a_col (warp w at rows 16 w ..), its B (32 x
// 160) read from image mk_tile_image(j) at the addresses the descriptor's
// fields name (mk_desc_address, the images at shared addresses base[i]),
// the products summed into one accumulator as the kernel chains them;
// returns the OR of all its entries (the verdict needs no D layout)
static uint32_t mk_group_fold(const uint32_t a[][128][4],
                              const uint8_t* const images[],
                              const uint32_t base[], const uint64_t desc[]) {
    static int8_t A[64][32], B[32][arriba::MK_N];
    static int32_t D[64][arriba::MK_N];
    for (int i = 0; i < 64; ++i) {
        for (int n = 0; n < arriba::MK_N; ++n) D[i][n] = 0;
    }
    for (int j = 0; j < arriba::MK_GROUP; ++j) {
        for (int thread = 0; thread < 128; ++thread) {
            const int lane = thread & 31;
            for (int r = 0; r < 4; ++r) {
                for (int byte = 0; byte < 4; ++byte) {
                    A[16 * (thread >> 5) + arriba::mk_a_row(lane, r)]
                     [arriba::mk_a_col(lane, r, byte)] =
                        (int8_t)(a[j][thread][r] >> (8 * byte));
                }
            }
        }
        const int img = arriba::mk_tile_image(j);
        for (int k = 0; k < 32; ++k) {
            for (int n = 0; n < arriba::MK_N; ++n) {
                B[k][n] = (int8_t)images[img][arriba::mk_desc_address(
                    desc[img], n, k) - base[img]];
            }
        }
        for (int i = 0; i < 64; ++i) {
            for (int n = 0; n < arriba::MK_N; ++n) {
                int32_t dot = 0;
                for (int k = 0; k < 32; ++k) dot += A[i][k] * B[k][n];
                D[i][n] += dot;
            }
        }
    }
    uint32_t acc = 0;
    for (int i = 0; i < 64; ++i) {
        acc = arriba::mk_fold<arriba::MK_N>(acc, D[i]);
    }
    return acc;
}

// K3's warp for a pair of rows (b, wb null: the dummy row of an odd
// batch): every 128 steps each lane loads four columns of both windows;
// lane 0 takes column t from lane (t / 4) % 32's chunk, and lane k reads
// lane k-1's word of the previous step (lanes run from 31 down to 0, so
// that word is not yet replaced)
template <int S>
static void sw_pair(const uint8_t* a, const uint8_t* b, const uint8_t* wa,
                    const uint8_t* wb, int L, int W, int match, int mismatch,
                    int gap, int32_t* best_a, int32_t* best_b) {
    const arriba::SwScores sc = arriba::sw_scores(match, mismatch, gap);
    arriba::SwPair<S> lanes[32];
    uint32_t words[32], chunk[32];
    for (int k = 0; k < 32; ++k) {
        arriba::sw_pair_init<S>(&lanes[k], a, b, k * S, L, sc.gap2);
        words[k] = arriba::sw_window_word(arriba::SW_PAD, arriba::SW_PAD);
    }
    // the kernel runs the steps in fours
    const int n_steps = L > 0 ? (W + (L - 1) / S + 3) & ~3 : 0;
    for (int t = 0; t < n_steps; ++t) {
        if ((t & 127) == 0) {
            for (int k = 0; k < 32; ++k) {
                chunk[k] = arriba::sw_window_pair(wa, wb, t + 4 * k, W);
            }
        }
        const uint32_t pair = chunk[(t >> 2) & 31];
        for (int k = 31; k >= 0; --k) {
            const uint32_t in = k == 0 ? arriba::sw_lane0_word(pair, t)
                                       : words[k - 1];
            words[k] = arriba::sw_pair_column<S>(&lanes[k], in, sc);
        }
    }
    *best_a = *best_b = 0;
    for (int k = 0; k < 32; ++k) {
        *best_a = std::max(*best_a, (int)(lanes[k].best & 0xffffu));
        *best_b = std::max(*best_b, (int)(lanes[k].best >> 16));
    }
}

// A warp's extent of a row of n bytes: the largest of its lanes'
// (sw_wide_extent), as __reduce_max_sync takes it
static int warp_extent(const uint8_t* row, int n) {
    int extent = 0;
    for (int k = 0; k < 32; ++k) {
        extent = std::max(extent, arriba::sw_wide_extent(row, n, k));
    }
    return extent;
}

// K3w's 32-bit warp over one row, trimmed to the read's extent len_r and
// the window's len_w (the window row W bytes in memory): the read in tiles
// of 32 S positions; per tile every 128 steps each lane loads four window
// bytes and four carry entries (sw_wide_up); lane 0 takes column t's byte
// and "up" from lane (t / 4) % 32's chunk, lane k lane k-1's h and byte of
// the previous step (lanes run from 31 down to 0), and lane 31 of a tile
// with a successor stores its h into the carry row
// (sw_wide_store_column). The carry starts as garbage, so a read before
// its write would show.
template <int S>
static int32_t sww_row(const uint8_t* read, const uint8_t* win, int len_r,
                       int len_w, int W, int match, int mismatch, int gap) {
    arriba::SwWideLane<S> lanes[32];
    int h[32], w[32], up4[32][4];
    uint32_t chunk[32];
    std::vector<int32_t> carry(W > 0 ? W : 1, 0x7eadbeef);
    for (int k = 0; k < 32; ++k) lanes[k].best = 0;
    const int tiles = arriba::sw_wide_tiles(len_r, S);
    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * 32 * S;
        for (int k = 0; k < 32; ++k) {
            arriba::sw_wide_tile_init<S>(&lanes[k], read, first + k * S,
                                         len_r);
            h[k] = 0;
            w[k] = arriba::SWW_PAD;
        }
        const int n_steps = arriba::sw_wide_steps(first, len_r, len_w, S);
        const bool stores = tile + 1 < tiles;
        for (int base = 0; base < n_steps; base += arriba::SWW_CHUNK) {
            for (int k = 0; k < 32; ++k) {
                chunk[k] = 0;
                for (int c = 0; c < 4; ++c) {
                    const int at = base + 4 * k + c;
                    const uint32_t byte = at < W ? win[at] : arriba::SWW_PAD;
                    chunk[k] |= byte << (8 * c);
                    up4[k][c] = arriba::sw_wide_up(carry.data(), tile, at,
                                                   len_w);
                }
            }
            const int steps = std::min(arriba::SWW_CHUNK, n_steps - base);
            for (int i = 0; i < steps; ++i) {
                const int t = base + i;
                const int up0 = up4[i >> 2][i & 3];
                const int w0 = (int)((chunk[i >> 2] >> (8 * (i & 3))) & 0xffu);
                for (int k = 31; k >= 0; --k) {
                    const int in_h = k == 0 ? up0 : h[k - 1];
                    w[k] = k == 0 ? w0 : w[k - 1];
                    h[k] = arriba::sw_wide_column<S>(&lanes[k], in_h, w[k],
                                                     match, mismatch, gap);
                    if (stores && k == 31) {
                        const int j = arriba::sw_wide_store_column(t, len_w);
                        if (j >= 0) carry[j] = h[31];
                    }
                }
            }
        }
    }
    int32_t best = 0;
    for (int k = 0; k < 32; ++k) best = std::max(best, lanes[k].best);
    return best;
}

// K3w's 16-bit warp over a pair of rows (b, wb null: the dummy row of an
// odd batch), trimmed to the pair's extents: K3's sw_pair warp, tiled as
// sww_row tiles, its steps in fours; lane 0 of a tile past the first takes
// both rows' h above it from the carry (sw_wide16_lane0), and lane 31 of
// a tile with a successor stores both rows' h (sw_wide16_carry). The
// carry starts as garbage.
template <int S>
static void sww16_pair(const uint8_t* a, const uint8_t* b, const uint8_t* wa,
                       const uint8_t* wb, int len_r, int len_w, int W,
                       int match, int mismatch, int gap, int32_t* best_a,
                       int32_t* best_b) {
    const arriba::SwScores sc = arriba::sw_scores(match, mismatch, gap);
    arriba::SwPair<S> lanes[32];
    uint32_t words[32], chunk[32];
    int up4[32][4];
    std::vector<int32_t> carry(W > 0 ? W : 1, 0x7eadbeef);
    for (int k = 0; k < 32; ++k) lanes[k].best = 0;
    const int tiles = arriba::sw_wide_tiles(len_r, S);
    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * 32 * S;
        for (int k = 0; k < 32; ++k) {
            arriba::sw_pair_tile_init<S>(&lanes[k], a, b, first + k * S,
                                         len_r, sc.gap2);
            words[k] = arriba::sw_window_word(arriba::SW_PAD, arriba::SW_PAD);
        }
        const int n_steps =
            (arriba::sw_wide_steps(first, len_r, len_w, S) + 3) & ~3;
        const bool stores = tile + 1 < tiles;
        for (int t = 0; t < n_steps; ++t) {
            if ((t & (arriba::SWW_CHUNK - 1)) == 0) {
                for (int k = 0; k < 32; ++k) {
                    chunk[k] = arriba::sw_window_pair(wa, wb, t + 4 * k, W);
                    for (int c = 0; c < 4; ++c) {
                        up4[k][c] = arriba::sw_wide_up(carry.data(), tile,
                                                       t + 4 * k + c, len_w);
                    }
                }
            }
            const int k0 = (t >> 2) & 31;
            const uint32_t up = tile > 0 ? (uint32_t)up4[k0][t & 3] : 0u;
            for (int k = 31; k >= 0; --k) {
                const uint32_t in =
                    k == 0 ? arriba::sw_wide16_lane0(chunk[k0], t, up)
                           : words[k - 1];
                words[k] = arriba::sw_pair_column<S>(&lanes[k], in, sc);
                if (stores && k == 31) {
                    const int j = arriba::sw_wide_store_column(t, len_w);
                    if (j >= 0) carry[j] = arriba::sw_wide16_carry(words[31]);
                }
            }
        }
    }
    *best_a = *best_b = 0;
    for (int k = 0; k < 32; ++k) {
        *best_a = std::max(*best_a, (int)(lanes[k].best & 0xffffu));
        *best_b = std::max(*best_b, (int)(lanes[k].best >> 16));
    }
}

// K4's any-k kernel's product of one tile of one k-step: the 128 threads'
// scaled A fragments scattered by the A layout, its B read back from the
// image through the descriptor's fields (the image at shared address
// base), added into the accumulator D as the wgmma adds it
static void mk_any_tile(const uint32_t a[128][4], const uint8_t* image,
                        uint32_t base, int32_t D[64][arriba::MK_N]) {
    static int8_t A[64][32], B[32][arriba::MK_N];
    for (int thread = 0; thread < 128; ++thread) {
        for (int r = 0; r < 4; ++r) {
            for (int byte = 0; byte < 4; ++byte) {
                A[16 * (thread >> 5) + arriba::mk_a_row(thread & 31, r)]
                 [arriba::mk_a_col(thread & 31, r, byte)] =
                    (int8_t)(a[thread][r] >> (8 * byte));
            }
        }
    }
    const uint64_t desc = arriba::mk_desc(base, arriba::MK_LBO,
                                          arriba::MK_SBO);
    for (int k = 0; k < 32; ++k) {
        for (int n = 0; n < arriba::MK_N; ++n) {
            B[k][n] = (int8_t)image[arriba::mk_desc_address(desc, n, k)
                                    - base];
        }
    }
    for (int i = 0; i < 64; ++i) {
        for (int n = 0; n < arriba::MK_N; ++n) {
            int32_t dot = 0;
            for (int k = 0; k < 32; ++k) dot += A[i][k] * B[k][n];
            D[i][n] += dot;
        }
    }
}

// K3w's work: each row (32-bit, wide16 = 0) or pair of rows (16-bit,
// wide16 = 1) trimmed to its extents, with the stripe its warp picks from
// the read's (sww_rows counts the rows whose stripe is past
// sw_wide_stripe_cap(L), which the launch does not instantiate); an empty
// read or window scores 0 without a tile
template <int S>
static void sww_warp(const uint8_t* reads, const uint8_t* windows,
                     int32_t* out, int row, int n, int L, int W, int len_r,
                     int len_w, int match, int mismatch, int gap,
                     int wide16) {
    const uint8_t* read = reads + (long)row * L;
    const uint8_t* win = windows + (long)row * W;
    if (!wide16) {
        out[row] = sww_row<S>(read, win, len_r, len_w, W, match, mismatch,
                              gap);
        return;
    }
    const bool has_b = row + 1 < n;
    int32_t dummy;
    sww16_pair<S>(read, has_b ? read + L : nullptr, win,
                  has_b ? win + W : nullptr, len_r, len_w, W, match,
                  mismatch, gap, &out[row], has_b ? &out[row + 1] : &dummy);
}

static void (*const SWW_WARPS[])(const uint8_t*, const uint8_t*, int32_t*,
                                 int, int, int, int, int, int, int, int, int,
                                 int) = {
    sww_warp<1>, sww_warp<2>, sww_warp<3>, sww_warp<4>, sww_warp<5>,
    sww_warp<6>, sww_warp<7>, sww_warp<8>, sww_warp<9>, sww_warp<10>,
    sww_warp<11>, sww_warp<12>, sww_warp<13>, sww_warp<14>, sww_warp<15>,
    sww_warp<16>};

extern "C" {

int sww_rows(const uint8_t* reads, const uint8_t* windows, int32_t* out,
             int n, int L, int W, int match, int mismatch, int gap,
             int wide16) {
    const int cap = arriba::sw_wide_stripe_cap(L);
    int past_cap = 0;
    for (int row = 0; row < n; row += wide16 ? 2 : 1) {
        const int rows = wide16 && row + 1 < n ? 2 : 1;
        int len_r = 0, len_w = 0;
        for (int r = row; r < row + rows; ++r) {
            len_r = std::max(len_r, warp_extent(reads + (long)r * L, L));
            len_w = std::max(len_w, warp_extent(windows + (long)r * W, W));
        }
        if (len_r == 0 || len_w == 0) {
            for (int r = row; r < row + rows; ++r) out[r] = 0;
            continue;
        }
        const int stripe = arriba::sw_wide_stripe(len_r);
        past_cap += stripe > cap;
        SWW_WARPS[stripe - 1](reads, windows, out, row, n, L, W, len_r,
                              len_w, match, mismatch, gap, wide16);
    }
    return past_cap;
}

// K3w's plan for a row (a read of L bytes, a window of W): the extents,
// the stripe, the tiles, each tile's steps (at most 64), and the stripe cap
// of the batch width
void sww_plan(const uint8_t* read, const uint8_t* win, int L, int W,
              int32_t* out) {
    out[0] = warp_extent(read, L);
    out[1] = warp_extent(win, W);
    out[2] = arriba::sw_wide_stripe(out[0]);
    out[3] = arriba::sw_wide_tiles(out[0], out[2]);
    out[4] = arriba::sw_wide_stripe_cap(L);
    for (int tile = 0; tile < out[3] && tile < 64; ++tile) {
        out[5 + tile] = arriba::sw_wide_steps(tile * 32 * out[2], out[0],
                                              out[1], out[2]);
    }
}

// mk_plan's fields: k, ksteps, digit, groups, images, kchunk, bias, mask,
// then each tile's A shift and image
void mk_plan_fields(int k, int64_t* out) {
    const arriba::MkPlan p = arriba::mk_plan(k);
    const int64_t fields[] = {p.k, p.ksteps, p.digit, p.groups, p.images,
                              p.kchunk, p.bias, (int64_t)p.mask};
    for (int i = 0; i < 8; ++i) out[i] = fields[i];
    for (int j = 0; j < arriba::MK_GROUP; ++j) {
        out[8 + 2 * j] = arriba::mk_any_a_shift(p, j);
        out[9 + 2 * j] = arriba::mk_any_image(p, j);
    }
}

// mk_any_layout's fields: chunk, groups, parts, bases, read_slot,
// window_slot, words, read_at, window_at, words_at, bytes
void mk_any_layout_fields(int k, int64_t* out) {
    const arriba::MkAnyLayout s = arriba::mk_any_layout(arriba::mk_plan(k));
    const int64_t fields[] = {s.chunk, s.groups, s.parts, s.bases,
                              s.read_slot, s.window_slot, s.words, s.read_at,
                              s.window_at, s.words_at, s.bytes};
    for (int i = 0; i < 11; ++i) out[i] = fields[i];
}

// mk_any_bytes at k for the k-mers first .. first + kmers - 1 of a row of
// n bytes, k-steps from c0: (start, count)
void mk_any_bytes_of(int k, int first, int kmers, int c0, int n,
                     int64_t* out) {
    const arriba::MkBytes b = arriba::mk_any_bytes(arriba::mk_plan(k), first,
                                                   kmers, c0, n);
    out[0] = b.start;
    out[1] = b.count;
}

// the stages block of grid copies, in order, for n rows of L and W bytes
// at k (MkCursor over slab x chunk x part), the rows in decided_at decided
// by a hit at their stage decided_at[row] (-1: never): (row, slab, chunk,
// part) each, up to max_stages; returns how many
int mk_any_schedule(int n, int grid, int block, int L, int W, int k,
                    const int32_t* decided_at, int32_t* out,
                    int max_stages) {
    const arriba::MkPlan p = arriba::mk_plan(k);
    const arriba::MkAnyLayout lay = arriba::mk_any_layout(p);
    const int slabs = (arriba::mk_any_kmers(L, k) + arriba::MK_N - 1)
                      / arriba::MK_N;
    const int chunks = (arriba::mk_any_kmers(W, k) + lay.chunk - 1)
                       / lay.chunk;
    if (slabs == 0 || chunks == 0) return 0;
    arriba::MkCursor cursor = {block, 0, 0};
    int decided = -1, count = 0, seen_of_row = 0, row = -1;
    while (count < max_stages) {
        const arriba::MkStage s = cursor.next(n, grid, slabs,
                                              chunks * lay.parts, decided);
        if (s.row < 0) break;
        if (s.row != row) {
            row = s.row;
            seen_of_row = 0;
        }
        out[4 * count] = s.row;
        out[4 * count + 1] = s.slab;
        out[4 * count + 2] = s.chunk / lay.parts;
        out[4 * count + 3] = s.chunk % lay.parts;
        ++count;
        if (seen_of_row++ == decided_at[s.row]) decided = s.row;
    }
    return count;
}

// the A matrix (16 x 32, int8) a warp's fragments of k-step s lay out for
// the 16 window k-mers of a stage from its k-mer t0, from the one-hot word
// table of the stage's n bytes (part from k-step c0), scaled by 2^shift
void mk_any_a_matrix(const uint8_t* bytes, int n, int k, int t0, int s,
                     int c0, int shift, int8_t* out) {
    const arriba::MkPlan p = arriba::mk_plan(k);
    std::vector<uint32_t> words(t0 + 16 + 8 * (s - c0) + 8);
    for (size_t i = 0; i < words.size(); ++i) {
        words[i] = arriba::mk_word(bytes, n, (int)i);
    }
    for (int lane = 0; lane < 32; ++lane) {
        uint32_t a[4];
        arriba::mk_any_a_words(p, words.data(), t0, s, c0, lane, a, shift);
        for (int r = 0; r < 4; ++r) {
            for (int byte = 0; byte < 4; ++byte) {
                out[arriba::mk_a_row(lane, r) * 32
                    + arriba::mk_a_col(lane, r, byte)] =
                    (int8_t)(a[r] >> (8 * byte));
            }
        }
    }
}

// K4's any-k kernel on its rows as its blocks schedule them
// (mxu_kmer_screen_any_kernel): block b of grid takes rows b, b + grid,
// ... in the order of its MkCursor over (slab, chunk x part), through a
// ring of MK_STAGES slots filled MK_STAGES - 1 stages ahead of the stage in
// use (a slot's fills counted as its mbarrier's phases), skipping what is
// left of a row once a vote decides it. Each stage's bytes are only those
// the kernel copies (mk_any_bytes; the slot's other bytes code 0, which a
// read outside the copied bytes would turn into false hits or lost ones).
// Where they change (a slab's first stage, or every stage when a row has
// more than one part) the scaled B images of the stage's k-steps from the
// staged read bytes (mk_any_b_word), kept across stages as the kernel
// keeps them in shared memory; at every stage the window's one-hot word
// table (mk_word); then each group of the stage: at a (slab, chunk)'s first
// part the accumulator from the plan's bias, every k-step of the part for
// every tile of the group into it (each tile's 128 threads' A from the
// table, mk_any_a_words, its B through the descriptor from image
// mk_any_image), and at the last part the test (mk_any_hit), OR-ed into
// the stage's seen, and the block's vote after every group. The row
// stops at the vote after its first hit: first_tile[row] is that hit's
// tile in the row's order (slab s, window tile t: s x the window's tiles +
// t; a group's digits name the tile), -1 for none. Returns the schedule's
// faults: a wait on a slot whose fill has not come or came twice, a slot
// refilled before its stage was taken, a copy in flight when the block
// ends, a stage multiplied against the images of another (row, slab,
// part), a part that takes up an accumulator another (row, slab, chunk)
// left, a verdict written other than once a row.
int mk_any_rows(const uint8_t* reads, const uint8_t* windows, uint8_t* out,
                int64_t* first_tile, int n, int L, int W, int k, int grid) {
    const arriba::MkPlan p = arriba::mk_plan(k);
    const arriba::MkAnyLayout lay = arriba::mk_any_layout(p);
    const int slabs = (arriba::mk_any_kmers(L, k) + arriba::MK_N - 1)
                      / arriba::MK_N;
    const int wk = arriba::mk_any_kmers(W, k);
    const int chunks = (wk + lay.chunk - 1) / lay.chunk;
    const int window_tiles = (wk + 63) / 64;
    const int span = p.groups * 64;
    const uint32_t base = 0x400;
    std::vector<uint8_t> images((size_t)p.images * p.kchunk
                                * arriba::MK_IMAGE);
    std::vector<uint8_t> staged_read(lay.read_slot);
    std::vector<uint8_t> staged_window(lay.window_slot);
    std::vector<uint32_t> words(lay.words);
    std::vector<int> written(n, 0);
    static int32_t D[64][arriba::MK_N];
    static uint32_t a[128][4];
    int faults = 0;
    for (int row = 0; row < n; ++row) first_tile[row] = -1;
    if (slabs == 0 || chunks == 0) {
        for (int row = 0; row < n; ++row) out[row] = 0;
        return 0;
    }
    for (int block = 0; block < grid; ++block) {
        arriba::MkCursor cursor = {block, 0, 0};
        arriba::MkStage ring[arriba::MK_STAGES];
        int fills[arriba::MK_STAGES] = {};     // the slot's phases completed
        bool in_flight[arriba::MK_STAGES] = {};
        int decided = -1;
        int image_of[3] = {-1, -1, -1};        // row, slab, part
        int acc_of[4] = {-1, -1, -1, -1};      // row, slab, chunk, next part
        auto issue = [&](int i) {
            const int slot = i % arriba::MK_STAGES;
            ring[slot] = cursor.next(n, grid, slabs, chunks * lay.parts,
                                     decided);
            if (ring[slot].row >= 0) {
                faults += in_flight[slot];
                in_flight[slot] = true;
                ++fills[slot];
            }
        };
        for (int i = 0; i < arriba::MK_STAGES - 1; ++i) issue(i);
        for (int i = 0;; ++i) {
            issue(i + arriba::MK_STAGES - 1);
            const int slot = i % arriba::MK_STAGES;
            const arriba::MkStage s = ring[slot];
            if (s.row < 0) break;
            // the kernel waits for phase i / MK_STAGES of the slot's
            // mbarrier by its parity: exactly that many fills before it
            faults += fills[slot] != i / arriba::MK_STAGES + 1;
            faults += !in_flight[slot];
            in_flight[slot] = false;
            if (s.row == decided) continue;
            const int chunk = s.chunk / lay.parts;
            const int part = s.chunk % lay.parts;
            const int c0 = part * p.kchunk;
            const int kc = std::min(p.kchunk, p.ksteps - c0);
            if (lay.parts > 1 || s.chunk == 0) {
                const arriba::MkBytes rb = arriba::mk_any_bytes(
                    p, s.slab * arriba::MK_N, arriba::MK_N, c0, L);
                std::fill(staged_read.begin(), staged_read.end(), 0);
                std::copy(reads + (long)s.row * L + rb.start,
                          reads + (long)s.row * L + rb.start + rb.count,
                          staged_read.begin());
                for (int step = 0; step < kc; ++step) {
                    for (int w = 0; w < arriba::MK_IMAGE / 4; ++w) {
                        const uint32_t word = arriba::mk_any_b_word(
                            p, staged_read.data(), rb.count, c0 + step, c0,
                            w);
                        for (int im = 0; im < p.images; ++im) {
                            const uint32_t scaled =
                                word << arriba::mk_any_b_shift(im);
                            uint8_t* at = &images[
                                (size_t)(im * p.kchunk + step)
                                * arriba::MK_IMAGE + 4 * w];
                            for (int b = 0; b < 4; ++b) {
                                at[b] = (uint8_t)(scaled >> (8 * b));
                            }
                        }
                    }
                }
                image_of[0] = s.row;
                image_of[1] = s.slab;
                image_of[2] = part;
            }
            faults += image_of[0] != s.row || image_of[1] != s.slab
                      || image_of[2] != part;
            const int q0 = chunk * lay.chunk;
            const arriba::MkBytes wb = arriba::mk_any_bytes(p, q0, lay.chunk,
                                                            c0, W);
            std::fill(staged_window.begin(), staged_window.end(), 0);
            std::copy(windows + (long)s.row * W + wb.start,
                      windows + (long)s.row * W + wb.start + wb.count,
                      staged_window.begin());
            for (int x = 0; x < lay.words; ++x) {
                words[x] = arriba::mk_word(staged_window.data(), wb.count, x);
            }
            const int groups = std::min(lay.groups,
                                        (wk - q0 + span - 1) / span);
            bool hit = false, seen = false;
            for (int g = 0; g < groups && !hit; ++g) {
                if (part == 0) {
                    for (int r = 0; r < 64; ++r) {
                        for (int c = 0; c < arriba::MK_N; ++c) {
                            D[r][c] = p.bias;
                        }
                    }
                    acc_of[0] = s.row;
                    acc_of[1] = s.slab;
                    acc_of[2] = chunk;
                } else {
                    faults += acc_of[0] != s.row || acc_of[1] != s.slab
                              || acc_of[2] != chunk || acc_of[3] != part;
                }
                acc_of[3] = part + 1;
                for (int step = c0; step < c0 + kc; ++step) {
                    for (int j = 0; j < p.groups; ++j) {
                        for (int thread = 0; thread < 128; ++thread) {
                            arriba::mk_any_a_words(
                                p, words.data(),
                                g * span + j * 64 + 16 * (thread >> 5), step,
                                c0, thread & 31, a[thread],
                                arriba::mk_any_a_shift(p, j));
                        }
                        const int im = arriba::mk_any_image(p, j);
                        mk_any_tile(a, &images[(size_t)(im * p.kchunk
                                                        + step - c0)
                                               * arriba::MK_IMAGE],
                                    base, D);
                    }
                }
                if (part != lay.parts - 1) continue;
                bool group_hit = false;
                uint32_t fold = 0;
                for (int r = 0; r < 64; ++r) {
                    group_hit |= arriba::mk_any_hit<arriba::MK_N>(p, D[r]);
                    fold = arriba::mk_fold<arriba::MK_N>(fold, D[r]);
                }
                if (group_hit && first_tile[s.row] < 0) {
                    for (int j = 0; j < p.groups; ++j) {
                        if (p.groups == 1
                            || fold >> (p.digit - 1 + p.digit * j) & 1u) {
                            first_tile[s.row] =
                                (int64_t)s.slab * window_tiles + q0 / 64
                                + g * p.groups + j;
                            break;
                        }
                    }
                }
                seen |= group_hit;
                hit = seen;
            }
            if (hit) decided = s.row;
            if (hit || (s.slab == slabs - 1
                        && s.chunk == chunks * lay.parts - 1)) {
                out[s.row] = hit;
                ++written[s.row];
            }
        }
        for (int slot = 0; slot < arriba::MK_STAGES; ++slot) {
            faults += in_flight[slot];
        }
    }
    for (int row = 0; row < n; ++row) faults += written[row] != 1;
    return faults;
}

// K1's work per row: every diagonal delta = j - i of the row, OR-reduced
void aw_rows(const uint8_t* reads, const uint8_t* windows,
             const int32_t* params, int32_t* out, int n, int L, int W) {
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        int accept = 0;
        for (int delta = -(L - 1); delta <= W - 1 && !accept; ++delta) {
            accept = arriba::aw_diagonal(reads + (long)row * L,
                                         windows + (long)row * W, delta,
                                         p[0], p[1], p[2], p[3], p[4]);
        }
        out[row] = accept;
    }
}

// K1's work on one row as the kernel does it: per strip of diagonals, the
// read's seeds in the bitmap, the window stretch coded once, the scan
// claiming each named diagonal once, then the walks of the claimed ones;
// a row whose min_score an unseeded walk can reach (aw_walks_all) walks,
// and claims, every diagonal of the strip that aw_all_span names instead.
// claims[delta + L - 1] counts the claims of each diagonal; every strip is
// scanned, also after an accept. The stretch is staged as aw_stage_span
// says: with table null a byte at a time, else in 16-byte loads aligned
// to table's start (where the kernel's table starts on a 16-byte
// boundary), each load checked to lie inside [table, table + table_bytes)
// (-1: one did not).
static int aw_row_seeded(const uint8_t* read, const uint8_t* window,
                         const int32_t* p, int read_len, int win_len, int L,
                         int W, const uint8_t* table, long long table_bytes,
                         int32_t* claims) {
    int strip, n_strips;
    arriba::aw_strips(L, W, &strip, &n_strips);
    std::vector<uint32_t> bitmap(arriba::AW_BITMAP_WORDS);
    std::vector<uint32_t> claimed((strip + 31) / 32);
    std::vector<uint16_t> seeds(L > 0 ? L : 1);
    std::vector<uint8_t> codes(arriba::aw_layout(L, strip).bytes
                               - arriba::aw_layout(L, strip).codes);
    std::vector<int> queue;
    const int n_seeds = arriba::aw_seed_starts(read_len, p[2]);
    int lo, hi;
    arriba::aw_window_span(win_len, p[3], p[4], &lo, &hi);
    int accept = 0;
    for (int k = 0; k < n_strips; ++k) {
        const int d_lo = -(L - 1) + k * strip;
        const int d_hi = std::min(d_lo + strip, W) - 1;
        if (arriba::aw_walks_all(read_len, p[2])) {
            int first, last;
            arriba::aw_all_span(d_lo, d_hi, read_len, win_len, &first,
                                &last);
            for (int delta = first; delta <= last; ++delta) {
                claims[delta + L - 1] += 1;
                if (!accept) {
                    accept = arriba::aw_diagonal(read, window, delta,
                                                 read_len, win_len, p[2],
                                                 p[3], p[4]);
                }
            }
            continue;
        }
        int jb, je;
        arriba::aw_scan_span(d_lo, d_hi, n_seeds, lo, hi, &jb, &je);
        if (jb > je) continue;
        std::fill(bitmap.begin(), bitmap.end(), 0u);
        std::fill(claimed.begin(), claimed.end(), 0u);
        int shift, n_bytes;
        arriba::aw_stage_span(table ? (uint64_t)(window + jb - table) : 0,
                              jb, je, table != nullptr, &shift, &n_bytes);
        const uint8_t* base = window + jb - shift;
        if (n_bytes > (int)codes.size()) return -1;
        if (table && (base < table || base + n_bytes > table + table_bytes
                      || (base - table) % 16 != 0)) {
            return -1;
        }
        for (int t = 0; t < n_bytes; ++t) {
            codes[t] = (uint8_t)arriba::aw_code_byte(base[t]);
        }
        for (int s = 0; s < n_seeds; ++s) {
            const int kmer = arriba::aw_kmer_raw(read + s);
            seeds[s] = (uint16_t)kmer;
            bitmap[kmer >> 5] |= 1u << (kmer & 31);
        }
        queue.clear();
        for (int j = jb; j <= je; ++j) {
            const int kmer = arriba::aw_window_seed(&codes[j - jb + shift],
                                                    bitmap.data());
            if (kmer < 0) continue;
            int s_lo, s_hi;
            arriba::aw_seed_span(j, d_lo, d_hi, n_seeds, &s_lo, &s_hi);
            for (int s = s_lo; s <= s_hi; ++s) {
                if (seeds[s] != kmer) continue;
                const int bit = j - s - d_lo;
                const uint32_t mask = 1u << (bit & 31);
                if (claimed[bit >> 5] & mask) continue;
                claimed[bit >> 5] |= mask;
                queue.push_back(bit);
                claims[d_lo + bit + L - 1] += 1;
            }
        }
        for (int bit : queue) {
            if (accept) break;
            accept = arriba::aw_diagonal(read, window, d_lo + bit, read_len,
                                         win_len, p[2], p[3], p[4]);
        }
    }
    return accept;
}

// K1's dense rows (claims[row, delta + L - 1], row stride L + W - 1)
void aw_rows_seeded(const uint8_t* reads, const uint8_t* windows,
                    const int32_t* params, int32_t* out, int32_t* claims,
                    int n, int L, int W) {
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        out[row] = aw_row_seeded(reads + (long)row * L,
                                 windows + (long)row * W, p,
                                 std::min(std::max(p[0], 0), L),
                                 std::min(p[1], W), L, W, nullptr, 0,
                                 claims + (long)row * (L + W - 1));
    }
}

// K1's indexed rows: each row's bytes by offset into a read table of
// read_bytes and a window table of table_bytes (aw_row_bytes; a row
// outside them accepts nothing), the stretch in 16-byte loads aligned to
// the table's start; out -1 for a row whose loads leave the table
void aw_rows_indexed(const uint8_t* reads, long long read_bytes,
                     const uint8_t* table, long long table_bytes,
                     const int64_t* offsets, const int32_t* params,
                     int32_t* out, int n, int L, int W) {
    std::vector<int32_t> claims(L + W - 1);
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        const int read_len = std::min(std::max(p[0], 0), L);
        const int win_len = std::min(p[1], W);
        const uint8_t* read;
        const uint8_t* window;
        out[row] = 0;
        if (!arriba::aw_row_bytes(reads, table, offsets, row, L, W, read_len,
                                  win_len, read_bytes, table_bytes, &read,
                                  &window)) {
            continue;
        }
        out[row] = aw_row_seeded(read, window, p, read_len, win_len, L, W,
                                 table, table_bytes, claims.data());
    }
}

// K5's two passes as the kernels run them, through the header's steps.
// The build pass a slice at a time (the slice table of
// realign.screen_schedule): its groups from kb_slice_first_group in a
// warp's chunks, each lane's group loaded where kb_needs_next says (as
// kb_load16 loads it; it must start on a 16-byte boundary of the table
// and at or before the window's last byte: -1 where one does not), coded,
// each 8-mer of the lane's span set from its codes and the next lane's
// into the bitmap of the slice's rank (an OR, as the blocks' atomicOr and
// whole-window stores are). The test pass a task at a time against its
// rank's bitmap, each row as a warp takes it: its first KB_FIRST_GROUPS
// groups staged (as its batch stages them) over what an earlier row left,
// then KB_STAGE_GROUPS where kb_restage says, a lane a group (each inside
// the read table and aligned: -1 where one is not), and 32 tests at a time,
// stopping after the first group with a set bit. tested[row] counts the
// tests made (each lane's test below the row's tests).
int kb_rows(const uint8_t* reads, const uint8_t* table,
            const int64_t* offsets, const int32_t* lengths,
            const int32_t* row_read, const int32_t* tasks,
            const int32_t* rank_window, const int32_t* task_rank,
            const int32_t* slices, uint8_t* out, int32_t* tested, int n_rows,
            int n_tasks, int n_used, int n_slices, int L, int n_read_rows,
            int n_windows, long long table_bytes, int slice_len) {
    std::vector<uint32_t> bitmaps((size_t)std::max(n_used, 1) *
                                  arriba::KB_WORDS);
    for (int b = 0; b < n_slices; ++b) {
        const int rank = slices[2 * b];
        const int p0 = slices[2 * b + 1];
        if (rank < 0 || rank >= n_used || p0 < 0) continue;
        long long first;
        int len;
        arriba::kb_window(offsets, lengths, rank_window[rank], n_windows,
                          table_bytes, &first, &len);
        const int p1 = arriba::kb_slice_end(p0, len, slice_len);
        if (p1 <= p0) continue;
        uint32_t* bitmap = &bitmaps[(size_t)rank * arriba::KB_WORDS];
        const int g0 = arriba::kb_slice_first_group(first, p0);
        const int n_groups = arriba::kb_slice_groups(g0, p1);
        for (int chunk = 0; arriba::KB_CHUNK_GROUPS * chunk < n_groups;
             ++chunk) {
            uint32_t c0[32];
            for (int lane = 0; lane < 32; ++lane) {
                const int s = g0 + arriba::KB_GROUP
                    * (arriba::KB_CHUNK_GROUPS * chunk + lane);
                uint32_t w[4] = {0, 0, 0, 0}, pad;
                if (arriba::kb_needs_next(s - arriba::KB_GROUP, p1)) {
                    const long long at = first + s;
                    if (at < 0 || at % 16 != 0 || at > first + len - 1) {
                        return -1;
                    }
                    arriba::kb_load16(table, table_bytes, at, w);
                }
                arriba::kb_code16(w, &c0[lane], &pad);
            }
            for (int lane = 0; lane < arriba::KB_CHUNK_GROUPS; ++lane) {
                const int s = g0 + arriba::KB_GROUP
                    * (arriba::KB_CHUNK_GROUPS * chunk + lane);
                if (s >= p1) break;
                int lo, hi;
                arriba::kb_group_span(s, p0, p1, &lo, &hi);
                for (int o = lo; o < hi; ++o) {
                    const int kmer =
                        arriba::kb_kmer_at(c0[lane], c0[lane + 1], o);
                    bitmap[kmer >> 5] |= arriba::kb_mask(kmer);
                }
            }
        }
    }
    std::vector<uint32_t> empty(arriba::KB_WORDS, 0u);
    const int n_tests = arriba::kb_row_tests(L);
    const int row_groups = 2 * L / arriba::KB_GROUP;
    const long long read_bytes = (long long)n_read_rows * L;
    uint32_t codes[arriba::KB_STAGE_GROUPS + 1];
    uint32_t pads[arriba::KB_STAGE_GROUPS + 1];
    for (int b = 0; b < n_tasks; ++b) {
        const int32_t* task = tasks + 3 * (long)b;
        const int rank = task_rank[b];
        const uint32_t* bitmap = rank >= 0 && rank < n_used
            ? &bitmaps[(size_t)rank * arriba::KB_WORDS] : empty.data();
        const int end = std::min(task[2], n_rows);
        for (int r = std::max(task[1], 0); r < end; ++r) {
            const int read = row_read[r];
            const bool valid =
                arriba::kb_read_row(reads, read, n_read_rows, L) != nullptr;
            const long long row = 2LL * read * L;
            // n groups of the stage from group s0, a lane a group (-1: a
            // load left the read table or was not aligned); the entries
            // past them keep what they held
            auto stage = [&](int s0, int n) {
                for (int lane = 0; lane < n; ++lane) {
                    uint32_t c = 0, pad = 0xffffu;
                    if (s0 + lane < row_groups) {
                        const long long at =
                            row + (long long)arriba::KB_GROUP * (s0 + lane);
                        if (at % 16 != 0 || at + 16 > read_bytes) return -1;
                        uint32_t w[4];
                        arriba::kb_load16(reads, read_bytes, at, w);
                        arriba::kb_code16(w, &c, &pad);
                    }
                    codes[lane] = c;
                    pads[lane] = pad;
                }
                return 0;
            };
            // what an earlier row left in the stage: garbage here
            for (int k = 0; k <= arriba::KB_STAGE_GROUPS; ++k) {
                codes[k] = 0x9e3779b9u * (r + k + 1);
                pads[k] = 0x7f4a7c15u * (r + k + 1);
            }
            bool hit = false;
            int s0 = 0;  // the row's batch stages its first groups
            int staged = arriba::KB_FIRST_GROUPS;
            if (valid && stage(s0, staged) != 0) return -1;
            for (int base = 0; valid && base < n_tests && !hit; base += 32) {
                int g0, g1;
                arriba::kb_test_groups(base, n_tests, L, &g0, &g1);
                if (arriba::kb_restage(s0, staged, g0, g1)) {
                    s0 = g0;
                    staged = arriba::KB_STAGE_GROUPS;
                    if (stage(s0, staged) != 0) return -1;
                }
                for (int lane = 0; lane < 32; ++lane) {
                    const int q = base + lane;
                    if (q >= n_tests) break;
                    tested[r] += 1;
                    hit |= arriba::kb_test(bitmap, arriba::kb_staged_kmer(
                                                       codes, pads, s0, q, L));
                }
            }
            out[r] = hit ? 1 : 0;
        }
    }
    return 0;
}

// every diagonal of every row walked: accepts[row, delta + L - 1]
void aw_rows_diagonals(const uint8_t* reads, const uint8_t* windows,
                       const int32_t* params, uint8_t* accepts, int n, int L,
                       int W) {
    for (int row = 0; row < n; ++row) {
        const int32_t* p = params + (long)row * 5;
        for (int delta = -(L - 1); delta <= W - 1; ++delta) {
            accepts[(long)row * (L + W - 1) + delta + L - 1] =
                arriba::aw_diagonal(reads + (long)row * L,
                                    windows + (long)row * W, delta,
                                    std::min(std::max(p[0], 0), L),
                                    std::min(p[1], W), p[2], p[3], p[4]);
        }
    }
}

// K2's work per row, counters at stride 1
void le_rows(const uint8_t* packed, const int32_t* meta, uint8_t* out,
             int n, int row_bytes) {
    uint32_t counts[3 * arriba::LE_KMERS];
    for (int row = 0; row < n; ++row) {
        const int32_t* m = meta + (long)row * 8;
        out[row] = arriba::le_row(packed + (long)row * row_bytes, m[0], m[1],
                                  m[2], m[3], m[4], m[5], m[6], m[7], counts,
                                  1);
    }
}

// the widest rows, in codes, K2's packed entry point takes
int le_packed_max_codes() { return arriba::LE_PACKED_MAX_CODES; }

// K2's long-row kernel on one read, its group of LE_LONG_LANES lanes as a
// loop: each tile staged as the kernel stages it (the row's bytes of the
// tile's span at the row's own 16-byte alignment, the rest of the stage
// garbage), each lane's words read from the stage, pass 1, the shuffle
// scan as the same log2(lanes) steps over the lanes' tables (lane l takes
// lane l - d's table before its own), pass 2 into each lane's 64 packed
// words, the flushes and the fold, each lane summing its 3-mers' words in
// the kernel's order, and the test of the totals.
bool le_long_row(const uint8_t* r, const int32_t* m, int row_bytes) {
    constexpr int L = arriba::LE_LONG_LANES, W = arriba::LE_LONG_WORDS;
    const int n_pos = std::max(std::min(m[0], 4 * row_bytes) - arriba::LE_K,
                               0);
    const arriba::LeSegment a1 = arriba::le_segment(m[1], m[2], n_pos);
    const arriba::LeSegment a2 = arriba::le_segment(m[3], m[4], n_pos);
    const arriba::LeLongPlan plan = arriba::le_long_plan(n_pos, L, W);
    std::vector<uint32_t> words(L * 64, 0u);  // lane l's 3-mer v at l * 64 + v
    std::vector<arriba::LeTotals> totals(64, arriba::LeTotals{0u, 0u, 0u});
    uint32_t stage[arriba::LE_LONG_STAGE_BYTES / 4];
    uint32_t table[L], incl[L], before[L];
    uint64_t rec[L][W];
    const auto fold = [&](int tiles) {
        const int run = arriba::le_fold_run(tiles, plan.words);
        for (int lane = 0; lane < L; ++lane) {
            for (int k = 0; k < 64 / L; ++k) {
                const int v = lane + k * L;
                arriba::le_fold(
                    [&](int m) {
                        const uint32_t* w = &words[4 * m * 64 + v];
                        return arriba::LeQuad{w[0], w[64], w[128], w[192]};
                    },
                    L / 4, lane, run, &totals[v]);
            }
        }
        std::fill(words.begin(), words.end(), 0u);
    };
    int state = 0, since = 0;
    for (int t = 0; t < plan.tiles; ++t) {
        if (arriba::le_flush_before(since, plan.words)) {
            fold(since);
            since = 0;
        }
        const arriba::LeSpan span = arriba::le_tile_span(t, plan, L,
                                                         row_bytes);
        const uint8_t* lo = r + span.lo;
        const int head = (int)(reinterpret_cast<uintptr_t>(lo) & 15);
        std::memset(stage, 0xa5, sizeof stage);
        std::memcpy(reinterpret_cast<uint8_t*>(stage) + head, lo,
                    span.hi - span.lo);
        const int word0 = head + (int)(span.first - span.lo);
        const auto words_of = [&](int lane) {
            const int q0 = word0 + 4 * (lane * plan.words - 1);
            return arriba::le_chunk(
                [&, q0](int i) -> uint32_t {
                    return stage[std::max((q0 >> 2) + i, 0)];
                },
                (word0 & 3) * 8, t == 0 && lane == 0);
        };
        for (int lane = 0; lane < L; ++lane) {
            table[lane] = arriba::le_chunk_pass1<W>(words_of(lane),
                                                    plan.words, rec[lane]);
            incl[lane] = table[lane];
        }
        for (int d = 1; d < L; d <<= 1) {
            std::copy(incl, incl + L, before);
            for (int lane = d; lane < L; ++lane) {
                incl[lane] = arriba::le_compose(before[lane - d], incl[lane]);
            }
        }
        for (int lane = 0; lane < L; ++lane) {
            const uint32_t excl = lane ? incl[lane - 1] : arriba::LE_IDENTITY;
            const int start = arriba::le_apply(excl, state);
            const long long p0 = 16LL * plan.words * ((long long)t * L + lane);
            if (p0 < n_pos) {
                arriba::le_chunk_pass2<W>(
                    words_of(lane), plan.words, rec[lane], start, (int)p0,
                    n_pos, a1, a2, [&](int v, uint32_t weight) {
                        words[lane * 64 + v] += weight;
                    });
            }
        }
        state = arriba::le_apply(incl[L - 1], state);
        ++since;
    }
    fold(since);
    bool flagged = false;
    for (int v = 0; v < 64; ++v) {
        flagged |= arriba::le_crossed_totals(totals[v], m[5], m[6], m[7]);
    }
    return flagged;
}

// K2's work per row as the kernel does it, the route following the row
// width as the kernel's dispatch does: rows of at most 3,072 codes through
// le_scan_packed into 64 packed words and the test of each word, wider
// ones through the long-row kernel's procedure (le_long_row)
void le_rows_kernel(const uint8_t* packed, const int32_t* meta,
                    uint8_t* out, int n, int row_bytes) {
    const bool packed_route =
        4LL * row_bytes <= arriba::LE_PACKED_MAX_CODES;
    uint32_t words[64];
    for (int row = 0; row < n; ++row) {
        const int32_t* m = meta + (long)row * 8;
        const uint8_t* r = packed + (long)row * row_bytes;
        if (!packed_route) {
            out[row] = le_long_row(r, m, row_bytes);
            continue;
        }
        const int length = std::min(m[0], 4 * row_bytes);
        const int n_pos = std::max(length - arriba::LE_K, 0);
        std::fill(words, words + 64, 0u);
        arriba::le_scan_packed(r, row_bytes, n_pos,
                               arriba::le_segment(m[1], m[2], n_pos),
                               arriba::le_segment(m[3], m[4], n_pos),
                               [&](int v, uint32_t w) { words[v] += w; });
        bool flagged = false;
        for (int v = 0; v < 64; ++v) {
            flagged |= arriba::le_crossed_packed(words[v], m[5], m[6], m[7]);
        }
        out[row] = flagged;
    }
}

// kb_code16 of n groups of 16 bytes: out[2 g] the codes, out[2 g + 1]
// the PAD marks of group g
void kb_code_groups(const uint8_t* bytes, uint32_t* out, int n) {
    for (int g = 0; g < n; ++g) {
        uint32_t w[4];
        std::memcpy(w, bytes + 16 * g, 16);
        arriba::kb_code16(w, &out[2 * g], &out[2 * g + 1]);
    }
}

int kb_homopolymer_of(int kmer) { return arriba::kb_homopolymer(kmer); }

// K5's constants: the default slice, the bitmap words, a group's bytes,
// the groups a warp stages
void kb_constants(int32_t* out) {
    out[0] = arriba::KB_SLICE;
    out[1] = arriba::KB_WORDS;
    out[2] = arriba::KB_GROUP;
    out[3] = arriba::KB_STAGE_GROUPS;
}

// the long-row procedure's constants and plan: lanes, words, the field's
// most selections; plan of n_pos (words, tiles)
void le_long_constants(int32_t* out) {
    out[0] = arriba::LE_LONG_LANES;
    out[1] = arriba::LE_LONG_WORDS;
    out[2] = arriba::LE_FIELD_MAX;
}

void le_long_plan_of(int n_pos, int32_t* out) {
    const arriba::LeLongPlan plan = arriba::le_long_plan(
        n_pos, arriba::LE_LONG_LANES, arriba::LE_LONG_WORDS);
    out[0] = plan.words;
    out[1] = plan.tiles;
}

uint32_t le_table_of(int eligible, int same1, int same2) {
    return arriba::le_table(eligible, same1, same2);
}

uint32_t le_compose_of(uint32_t f, uint32_t g) {
    return arriba::le_compose(f, g);
}

// tables of 8 bits (every map of the four states) for which (f g) h and
// f (g h) differ, and those for which the identity is not neutral
int le_compose_errors() {
    int errors = 0;
    for (uint32_t f = 0; f < 256; ++f) {
        errors += arriba::le_compose(f, arriba::LE_IDENTITY) != f;
        errors += arriba::le_compose(arriba::LE_IDENTITY, f) != f;
        for (uint32_t g = 0; g < 256; ++g) {
            const uint32_t fg = arriba::le_compose(f, g);
            for (uint32_t h = 0; h < 256; ++h) {
                errors += arriba::le_compose(fg, h)
                          != arriba::le_compose(f, arriba::le_compose(g, h));
            }
        }
    }
    return errors;
}

// The selection of a packed row's first n_pos positions three ways, from
// the state before position first (its sel[p-1] and sel[p-2]): le_select
// walked in order (sel_walk; the carry's 3-mers are those at first - 1 and
// first - 2); le_table composed over the positions, applied to that state,
// low bit (sel_table); and the long-row kernel's pass 1 over the words
// from first (a multiple of 16), its record read at that state (sel_pass1).
// tables[k]: pass 1's table of words first / 16 to first / 16 + k against
// le_table's composition over the same positions.
void le_selection_ways(const uint8_t* row, int row_bytes, int first,
                       int n_pos, int start, uint8_t* sel_walk,
                       uint8_t* sel_table, uint8_t* sel_pass1,
                       uint32_t* tables) {
    const auto kmer = [&](int p) {
        return arriba::le_kmer(row, row_bytes, p);
    };
    arriba::LowEntropyCarry c;
    c.sel1 = start & 1;
    c.sel2 = start >> 1;
    c.kv1 = first >= 1 ? kmer(first - 1) : -1;
    c.kv2 = first >= 2 ? kmer(first - 2) : -1;
    uint32_t table = arriba::LE_IDENTITY;
    for (int p = first; p < n_pos; ++p) {
        const int v = kmer(p);
        sel_walk[p - first] = arriba::le_select(&c, v);
        const bool same1 = p >= 1 && v == kmer(p - 1);
        const bool same2 = p >= 2 && v == kmer(p - 2);
        table = arriba::le_compose(table, arriba::le_table(true, same1,
                                                           same2));
        sel_table[p - first] = arriba::le_apply(table, start) & 1;
        if ((p - first) % 16 == 15) tables[(p - first) / 16 * 2] = table;
    }
    const auto word = [&](int j) {
        uint32_t x = 0;
        for (int b = 0; b < 4; ++b) {
            const int at = 4 * j + b;
            if (at >= 0 && at < row_bytes) x |= (uint32_t)row[at] << (8 * b);
        }
        return x;
    };
    arriba::LeWalk4 walk = arriba::le_walk4_start();
    for (int w = 0; 16 * w < n_pos - first; ++w) {
        const int j = first / 16 + w;
        const uint32_t prev = j >= 1 ? word(j - 1) : 0u;
        const uint64_t rec = arriba::le_walk4_word(
            &walk, arriba::le_same_word(prev, word(j), word(j + 1)));
        for (int i = 0; i < 16 && 16 * w + i < n_pos - first; ++i) {
            sel_pass1[16 * w + i] = (rec >> (4 * i + start)) & 1u;
        }
        tables[2 * w + 1] = arriba::le_walk4_table(walk);
    }
}

// K3's work per pair of rows, with the stripe the kernel's dispatch picks;
// an odd n pairs the last row with the all-PAD dummy
void sw_rows(const uint8_t* reads, const uint8_t* windows, int32_t* out,
             int n, int L, int W, int match, int mismatch, int gap) {
    const int stripe = (L + 31) / 32;
    for (int row = 0; row < n; row += 2) {
        const bool has_b = row + 1 < n;
        const uint8_t* a = reads + (long)row * L;
        const uint8_t* b = has_b ? a + L : nullptr;
        const uint8_t* wa = windows + (long)row * W;
        const uint8_t* wb = has_b ? wa + W : nullptr;
        int32_t dummy;
        int32_t* out_b = has_b ? &out[row + 1] : &dummy;
        auto pair = stripe <= 1 ? sw_pair<1> : stripe <= 2 ? sw_pair<2>
                  : stripe <= 4 ? sw_pair<4> : stripe <= 8 ? sw_pair<8>
                  : sw_pair<16>;
        pair(a, b, wa, wb, L, W, match, mismatch, gap, &out[row], out_b);
    }
}

// K4's layouts. A: the (thread, register, byte) slots of the warpgroup's
// 64 x 32 A, every element held exactly once; the B image's words: word w
// holds base mk_b_word_base(w) of k-mer mk_b_word_kmer(w), at byte 4 w
int mk_layout_errors() {
    int a[64][32] = {};
    for (int thread = 0; thread < 128; ++thread) {
        for (int r = 0; r < 4; ++r) {
            for (int byte = 0; byte < 4; ++byte) {
                a[16 * (thread >> 5) + arriba::mk_a_row(thread & 31, r)]
                 [arriba::mk_a_col(thread & 31, r, byte)]++;
            }
        }
    }
    int errors = 0;
    for (int i = 0; i < 64; ++i) {
        for (int k = 0; k < 32; ++k) errors += a[i][k] != 1;
    }
    for (int w = 0; w < arriba::MK_IMAGE / 4; ++w) {
        errors += arriba::mk_b_offset(arriba::mk_b_word_kmer(w),
                                      4 * arriba::mk_b_word_base(w)) != 4 * w;
    }
    return errors;
}

// the B image: every (k-mer n, lane k) of the 160 x 32 at one distinct byte
// of the MK_IMAGE, and a descriptor of the image at shared address base
// (multiples of 16 below 2^18) names that byte from its fields alone
int mk_image_errors(uint32_t base) {
    std::vector<int> seen(arriba::MK_IMAGE, 0);
    const uint64_t desc = arriba::mk_desc(base, arriba::MK_LBO,
                                          arriba::MK_SBO);
    int errors = 0;
    for (int n = 0; n < arriba::MK_N; ++n) {
        for (int k = 0; k < 32; ++k) {
            const int at = arriba::mk_b_offset(n, k);
            if (at < 0 || at >= arriba::MK_IMAGE) {
                ++errors;
                continue;
            }
            errors += seen[at]++ != 0;
            errors += arriba::mk_desc_address(desc, n, k) != base + at;
        }
    }
    return errors;
}

// the A matrix (16 x 32 int8) of the 16 k-mers at p0 as one warp's
// fragments (mk_a_fragment over the bytes' one-hot words, mk_word) lay it
// out
void mk_a_matrix(const uint8_t* bytes, int n, int p0, int8_t* out) {
    std::vector<uint32_t> words(p0 + 32);
    for (int p = 0; p < p0 + 32; ++p) words[p] = arriba::mk_word(bytes, n, p);
    for (int lane = 0; lane < 32; ++lane) {
        uint32_t a[4];
        arriba::mk_a_fragment(words.data(), p0, lane, a);
        for (int r = 0; r < 4; ++r) {
            for (int byte = 0; byte < 4; ++byte) {
                out[arriba::mk_a_row(lane, r) * 32
                    + arriba::mk_a_col(lane, r, byte)] =
                    (int8_t)(a[r] >> (8 * byte));
            }
        }
    }
}

// K4's blocks on their rows as the kernel schedules them: block b of grid
// takes rows b, b + grid, ... in the order of its MkCursor, through a ring
// of MK_STAGES slots filled MK_STAGES - 1 stages ahead of the stage in use
// (a slot's fills counted as its mbarrier's phases), skipping what is left
// of a row once a hit decides it. A stage is a slab of MK_N read k-mers
// against chunk window k-mers (MK_CHUNK in the kernel; smaller multiples of
// 64 to cross stage edges in small windows), its bytes as the kernel
// stages them (the slab's MK_N + 7 read bytes and the chunk's chunk + 7
// window bytes at most, code 0 past them, which a read outside the staged
// bytes would turn into false hits). At a slab's first stage the block
// writes the three scaled B images from mk_b_word, kept across stages as
// the kernel keeps them in shared memory; at every stage the window bases
// as one-hot words (mk_word); then each group of MK_GROUP tiles of 64
// window k-mers: the 128 threads' scaled A from mk_a_fragment over those
// words, the emulated products into one accumulator, the fold and the
// block's vote. A tile past the stage's k-mers gets a zero A: the kernel's
// stage of MK_CHUNK = 16 tiles never cuts a group, and past the window's
// end its tiles hold only k-mers that run off it, which cannot reach k
// either. The row stops at its first hit: first_tile[row] is that tile's
// index in this order (slab s, window tile t: s x the window's tiles + t;
// the group's digits name the tile), -1 for none. Returns the schedule's
// faults: a wait on a slot whose fill has not come or came twice, a slot
// refilled before its stage was taken, a copy still in flight when the
// block ends, a stage multiplied against another slab's images, a verdict
// written other than once a row.
int mk_rows(const uint8_t* reads, const uint8_t* windows, uint8_t* out,
            int64_t* first_tile, int n, int L, int W, int chunk, int grid) {
    const uint32_t base[arriba::MK_IMAGES] = {0x400, 0x1800, 0x2c00};
    uint64_t desc[arriba::MK_IMAGES];
    std::vector<uint8_t> image[arriba::MK_IMAGES];
    const uint8_t* images[arriba::MK_IMAGES];
    for (int i = 0; i < arriba::MK_IMAGES; ++i) {
        desc[i] = arriba::mk_desc(base[i], arriba::MK_LBO, arriba::MK_SBO);
        image[i].resize(arriba::MK_IMAGE);
        images[i] = image[i].data();
    }
    const int slabs = arriba::mk_slabs(L);
    const int n_kmers = W - arriba::MK_K + 1;
    const int chunks = n_kmers > 0 ? (n_kmers + chunk - 1) / chunk : 0;
    const int window_tiles = n_kmers > 0 ? (n_kmers + 63) / 64 : 0;
    const int span = arriba::MK_GROUP * 64;
    const int read_span = arriba::MK_N + arriba::MK_K - 1;
    const int window_span = chunk + arriba::MK_K - 1;
    std::vector<uint8_t> staged_read(read_span + 64);
    std::vector<uint8_t> staged_window(window_span + 64);
    std::vector<uint32_t> words(window_span);
    std::vector<int> written(n, 0);
    static uint32_t a[arriba::MK_GROUP][128][4];
    int faults = 0;
    for (int row = 0; row < n; ++row) first_tile[row] = -1;
    if (slabs == 0 || chunks == 0) {
        for (int row = 0; row < n; ++row) out[row] = 0;
        return 0;
    }
    // the stage's products on the images, from its window bytes: the first
    // hit's tile in the row's order, -1 for none
    auto multiply = [&](const arriba::MkStage& s) -> int64_t {
        const uint8_t* window = windows + (long)s.row * W;
        const int q0 = s.chunk * chunk;
        const int w_bytes = W - q0;
        std::fill(staged_window.begin(), staged_window.end(), 0);
        std::copy(window + q0, window + q0 + std::min(window_span, w_bytes),
                  staged_window.begin());
        for (int p = 0; p < window_span; ++p) {
            words[p] = arriba::mk_word(staged_window.data(), w_bytes, p);
        }
        const int tiles = (std::min(chunk, n_kmers - q0) + 63) / 64;
        const int groups = (tiles + arriba::MK_GROUP - 1) / arriba::MK_GROUP;
        for (int g = 0; g < groups; ++g) {
            for (int j = 0; j < arriba::MK_GROUP; ++j) {
                for (int thread = 0; thread < 128; ++thread) {
                    if (g * arriba::MK_GROUP + j >= tiles) {
                        std::fill(a[j][thread], a[j][thread] + 4, 0u);
                        continue;
                    }
                    arriba::mk_a_fragment(
                        words.data(), g * span + j * 64 + 16 * (thread >> 5),
                        thread & 31, a[j][thread], arriba::mk_a_shift(j));
                }
            }
            const uint32_t acc = mk_group_fold(a, images, base, desc);
            if (arriba::mk_hit(acc)) {
                return (int64_t)s.slab * window_tiles + q0 / 64 + g * 4
                       + arriba::mk_hit_tile(acc);
            }
        }
        return -1;
    };
    for (int block = 0; block < grid; ++block) {
        arriba::MkCursor cursor = {block, 0, 0};
        arriba::MkStage ring[arriba::MK_STAGES];
        int fills[arriba::MK_STAGES] = {};     // the slot's phases completed
        bool in_flight[arriba::MK_STAGES] = {};
        int decided = -1, image_row = -1, image_slab = -1;
        auto issue = [&](int k) {
            const int slot = k % arriba::MK_STAGES;
            ring[slot] = cursor.next(n, grid, slabs, chunks, decided);
            if (ring[slot].row >= 0) {
                faults += in_flight[slot];
                in_flight[slot] = true;
                ++fills[slot];
            }
        };
        for (int k = 0; k < arriba::MK_STAGES - 1; ++k) issue(k);
        for (int k = 0;; ++k) {
            issue(k + arriba::MK_STAGES - 1);
            const int slot = k % arriba::MK_STAGES;
            const arriba::MkStage s = ring[slot];
            if (s.row < 0) break;
            // the kernel waits for phase k / MK_STAGES of the slot's
            // mbarrier by its parity: exactly that many fills before it
            faults += fills[slot] != k / arriba::MK_STAGES + 1;
            faults += !in_flight[slot];
            in_flight[slot] = false;
            if (s.row == decided) continue;
            if (s.chunk == 0) {
                const uint8_t* read = reads + (long)s.row * L;
                const int r_bytes = L - s.slab * arriba::MK_N;
                std::fill(staged_read.begin(), staged_read.end(), 0);
                std::copy(read + s.slab * arriba::MK_N,
                          read + s.slab * arriba::MK_N
                              + std::min(read_span, r_bytes),
                          staged_read.begin());
                for (int w = 0; w < arriba::MK_IMAGE / 4; ++w) {
                    const uint32_t word = arriba::mk_b_word(
                        staged_read.data(), r_bytes, w);
                    for (int i = 0; i < arriba::MK_IMAGES; ++i) {
                        const uint32_t scaled = word << arriba::mk_b_shift(i);
                        for (int byte = 0; byte < 4; ++byte) {
                            image[i][4 * w + byte] =
                                (uint8_t)(scaled >> (8 * byte));
                        }
                    }
                }
                image_row = s.row;
                image_slab = s.slab;
            }
            faults += image_row != s.row || image_slab != s.slab;
            const int64_t first = multiply(s);
            if (first >= 0) {
                decided = s.row;
                first_tile[s.row] = first;
            }
            if (first >= 0
                || (s.slab == slabs - 1 && s.chunk == chunks - 1)) {
                out[s.row] = first >= 0;
                ++written[s.row];
            }
        }
        for (int slot = 0; slot < arriba::MK_STAGES; ++slot) {
            faults += in_flight[slot];
        }
    }
    for (int row = 0; row < n; ++row) faults += written[row] != 1;
    return faults;
}

// K3's 16x2 primitives as the host emulation computes them: 0 add.s16x2,
// 1 max.s16x2, 2 the DPX add+max.relu, 3 prmt
uint32_t sw_primitive(int which, uint32_t a, uint32_t b, uint32_t c) {
    switch (which) {
    case 0: return arriba::sw_add2(a, b);
    case 1: return arriba::sw_max2(a, b);
    case 2: return arriba::sw_addmax_relu2(a, b, c);
    default: return arriba::sw_perm(a, b, c);
    }
}

}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("g++ is not installed: the kernels' update functions "
                    "cannot be compiled for the CPU")
    work = tmp_path_factory.mktemp("kernel_math")
    source = work / "harness.cpp"
    source.write_text(HARNESS)
    library = work / "libharness.so"
    subprocess.run([compiler, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", str(source), "-o", str(library)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(library))
    lib.aw_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.aw_rows_seeded.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    lib.aw_rows_diagonals.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.aw_rows_indexed.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.kb_rows.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong, ctypes.c_int]
    lib.kb_constants.argtypes = [ctypes.c_void_p]
    lib.kb_code_groups.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.kb_homopolymer_of.argtypes = [ctypes.c_int]
    lib.le_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.le_rows_kernel.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.le_long_constants.argtypes = [ctypes.c_void_p]
    lib.le_long_plan_of.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.le_table_of.argtypes = [ctypes.c_int] * 3
    lib.le_table_of.restype = ctypes.c_uint32
    lib.le_compose_of.argtypes = [ctypes.c_uint32] * 2
    lib.le_compose_of.restype = ctypes.c_uint32
    lib.le_selection_ways.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 4
    lib.le_packed_max_codes.restype = ctypes.c_int
    lib.sw_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    lib.sw_primitive.argtypes = [ctypes.c_int] + [ctypes.c_uint32] * 3
    lib.sw_primitive.restype = ctypes.c_uint32
    lib.mk_a_matrix.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.mk_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    lib.mk_image_errors.argtypes = [ctypes.c_uint32]
    lib.sww_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.sww_plan.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.mk_plan_fields.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mk_any_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    lib.mk_any_layout_fields.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mk_any_bytes_of.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.mk_any_schedule.argtypes = [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.mk_any_a_matrix.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return lib


def _ptr(array):
    return array.ctypes.data_as(ctypes.c_void_p)


def _accept_rows(seed, N, L, W):
    """(reads, windows, params): embedded read copies with a few mutations,
    random rejects, 'N' bytes, short win_len and per-row seed ranges."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    reads = np.zeros((N, L), np.uint8)
    windows = np.ones((N, W), np.uint8)
    params = np.zeros((N, 5), np.int32)
    for row in range(N):
        read_len = int(rng.integers(20, L + 1))
        win_len = int(rng.integers(read_len, W + 1))
        window = alphabet[rng.choice(5, win_len, p=[.24, .24, .24, .24, .04])]
        read = alphabet[rng.integers(0, 4, read_len)]
        if row % 3 != 2:  # embedded copy, mutated a little
            start = int(rng.integers(0, win_len - read_len + 1))
            read = window[start:start + read_len].copy()
            flips = rng.integers(0, read_len, int(rng.integers(0, 6)))
            read[flips] = alphabet[rng.integers(0, 4, len(flips))]
            if row % 3 == 1:  # a run of 3-5 mismatches: the walk's break
                run = int(rng.integers(3, 6))
                at = int(rng.integers(read_len // 4, read_len // 2))
                read[at:at + run] = np.where(read[at:at + run] == ord("A"),
                                             ord("C"), ord("A"))
        reads[row, :read_len] = read
        windows[row, :win_len] = window
        ms = int(0.8 * read_len + 0.5) - int(rng.integers(0, 3)) * (row % 2)
        lo = int(rng.integers(-5, 40)) if row % 4 == 1 else 0
        hi = int(rng.integers(lo, win_len + 20)) if row % 4 == 1 else win_len
        params[row] = (read_len, win_len, ms, lo, hi)
    return reads, windows, params


# the second shape has reads longer than 511 bytes: the counters stay
# unpacked, so nothing wraps
@pytest.mark.parametrize("seed,N,L,W", [(17, 24, 128, 512), (5, 4, 576, 640)])
def test_accept_cell_update_matches_plain_and_jax(harness, seed, N, L, W):
    reads, windows, params = _accept_rows(seed, N, L, W)
    native = np.zeros(N, np.int32)
    harness.aw_rows(_ptr(reads), _ptr(windows), _ptr(params), _ptr(native),
                    N, L, W)
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    np.testing.assert_array_equal(native != 0, plain)
    np.testing.assert_array_equal(plain, xla)
    assert 0 < plain.sum() < N


def _strip_edge_rows(seed, L, W):
    """Rows whose only seed names a diagonal at an edge of a block's strip
    (the first and last diagonal of each strip, the lowest diagonal that
    reaches window byte 0): the read suffix from its first or its last
    eligible start s, copied onto that diagonal after a code mismatch; from
    s = 0, code mismatches every 8 bytes break every later eligible seed.
    Every row accepts."""
    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"ACGT", np.uint8)
    d = L + W - 1
    n = -(-d // 2048)
    strip = -(-(-(-d // n)) // 32) * 32
    read_len = L - 28
    ms = int(0.8 * read_len + 0.5)
    s_max = min((read_len + 16 - ms) // 2 + 1, read_len - 8) - 1
    edges = [-s_max] + [-(L - 1) + k * strip + e for k in range(1, n)
                        for e in (-1, 0)]
    rows = [(s, delta) for delta in edges for s in (0, s_max)
            if delta + s >= 0]
    reads = np.zeros((len(rows), L), np.uint8)
    windows = np.ones((len(rows), W), np.uint8)
    params = np.zeros((len(rows), 5), np.int32)
    for row, (s, delta) in enumerate(rows):
        read = base[rng.integers(0, 4, read_len)]
        window = base[rng.integers(0, 4, W)]
        window[delta + s:delta + read_len] = read[s:]
        other = np.where(read == ord("T"), ord("G"), ord("T"))
        if s > 0:
            window[delta + s - 1] = other[s - 1]
        else:
            cuts = np.arange(8, s_max + 9, 8)
            window[delta + cuts] = other[cuts]
        reads[row, :read_len] = read
        windows[row] = window
        params[row] = (read_len, W, ms, 0, W)
    return reads, windows, params


# the shapes above, the adversarial rows (two of each kind) at a small
# shape, and seeds at the edges of the strips of a window of two strips
_AW_CASES = {
    "embedded": lambda: _accept_rows(17, 24, 128, 512),
    "long_reads": lambda: _accept_rows(5, 4, 576, 640),
    "adversarial": lambda: accept_adversarial_inputs(
        N=2 * len(ACCEPT_KINDS), L=128, W=512),
    "strip_edges": lambda: _strip_edge_rows(7, 128, 2600),
}


def _seed_lookup(harness, reads, windows, params):
    """K1's per-row procedure under g++: (verdicts, claims [N, L + W - 1])."""
    (N, L), W = reads.shape, windows.shape[1]
    verdicts = np.zeros(N, np.int32)
    claims = np.zeros((N, L + W - 1), np.int32)
    harness.aw_rows_seeded(_ptr(reads), _ptr(windows), _ptr(params),
                           _ptr(verdicts), _ptr(claims), N, L, W)
    return verdicts != 0, claims


@pytest.mark.parametrize("case", list(_AW_CASES))
def test_accept_seed_lookup_matches_plain_and_jax(harness, case):
    reads, windows, params = _AW_CASES[case]()
    seeded, claims = _seed_lookup(harness, reads, windows, params)
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    np.testing.assert_array_equal(seeded, plain)
    np.testing.assert_array_equal(plain, xla)
    assert claims.max() <= 1        # each diagonal is walked at most once
    if case == "adversarial":
        want = [ACCEPT_KINDS[row % len(ACCEPT_KINDS)][1]
                for row in range(len(reads))]
        np.testing.assert_array_equal(plain, want)
    elif case == "strip_edges":
        assert plain.all()
    else:
        assert 0 < plain.sum() < len(reads)


@pytest.mark.parametrize("case", list(_AW_CASES))
def test_every_accepting_diagonal_is_a_seed_candidate(harness, case):
    """Soundness of the lookup, diagonal by diagonal: aw_diagonal accepts
    no diagonal that the seed lookup leaves unwalked."""
    reads, windows, params = _AW_CASES[case]()
    (N, L), W = reads.shape, windows.shape[1]
    accepts = np.zeros((N, L + W - 1), np.uint8)
    harness.aw_rows_diagonals(_ptr(reads), _ptr(windows), _ptr(params),
                              _ptr(accepts), N, L, W)
    _, claims = _seed_lookup(harness, reads, windows, params)
    accepts = accepts != 0
    assert accepts.any()
    assert not (accepts & (claims == 0)).any()
    # the walks of every diagonal OR to the plain version's verdict
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    np.testing.assert_array_equal(accepts.any(axis=1), plain)


# the resident cases (chip_smoke.resident_case) at sizes the CPU takes
_RESIDENT_CASES = {
    "main": lambda: resident_main(contig_len=200_000, n_windows=6,
                                  win_lo=1_000, win_hi=9_000, n_pairs=200),
    "tail": lambda: resident_tail(lengths=(0, 7, 20, 100, 600, 1023, 1024,
                                           1025, 2100)),
    "short": resident_short,
    "reads_n": resident_reads_n,
    "chunk_edges": lambda: resident_chunk_edges(window_chunk=1024),
    "shared": lambda: resident_shared(n_pairs=300),
}


def _kb_emulate(harness, args, schedule):
    """K5's two passes under g++ (kb_rows) on screen_inputs' tensors:
    (verdicts, tests made a row)."""
    reads, table, offsets, lengths, row_read, tasks = (x.numpy()
                                                       for x in args)
    rank_window, task_rank, slices = (x.numpy() for x in (
        schedule.rank_window, schedule.task_rank, schedule.slices))
    n = len(row_read)
    out = np.zeros(n, np.uint8)
    tested = np.zeros(n, np.int32)
    assert harness.kb_rows(
        _ptr(reads), _ptr(table), _ptr(offsets), _ptr(lengths),
        _ptr(row_read), _ptr(tasks), _ptr(rank_window), _ptr(task_rank),
        _ptr(slices), _ptr(out), _ptr(tested), n, len(tasks),
        len(rank_window), len(slices), reads.shape[1], reads.shape[0],
        len(offsets), table.size, schedule.slice_len) == 0
    return out != 0, tested


# a slice length that cuts the CPU cases' windows at many edges
_SMALL_SLICE = 48


@pytest.mark.parametrize("layout", ["packed", "contig"])
@pytest.mark.parametrize("case", list(_RESIDENT_CASES))
def test_kmer_bitmap_screen_emulation_matches_plain_and_jax(harness, case,
                                                            layout):
    """K5's two passes under g++ (kb_rows: the tasks and slices of
    screen_inputs, a window of the shared case split over several tasks)
    against its plain version and the JAX package's screen_pairs, on the
    tables resident_pairs packs and on the contig as the window table
    (unaligned windows, the bytes past each the contig's); a row without a
    hit makes every test, one with a hit stops at the end of its group of
    32."""
    _kb_emulation_case(harness, case, layout, realign.KB_SLICE)


@pytest.mark.parametrize("layout", ["packed", "contig"])
@pytest.mark.parametrize("case", list(_RESIDENT_CASES))
def test_kmer_bitmap_screen_emulation_small_slices(harness, case, layout):
    """The same at slices of 48 positions, which cut every window of these
    cases at many edges."""
    _kb_emulation_case(harness, case, layout, _SMALL_SLICE)


def _kb_emulation_case(harness, case, layout, slice_len):
    made = _RESIDENT_CASES[case]()
    resident = resident_layouts(made, torch.device("cpu"))[layout]
    n = len(resident.pair_read)
    order, args, schedule = realign.screen_inputs(resident, np.arange(n),
                                                  slice_len=slice_len)
    got, tested = _kb_emulate(harness, args, schedule)
    plain = realign.kmer_bitmap_screen_plain(*args).numpy()
    np.testing.assert_array_equal(got, plain)
    verdict = np.zeros(n, bool)
    verdict[order] = plain
    contig, spans, seqs, _ = made
    np.testing.assert_array_equal(verdict, jax_realign.screen_pairs(
        seqs, [contig[a:a + m] for a, m in spans]))
    n_tests = 2 * (args[0].shape[1] - 7)
    assert (tested[~plain] == n_tests).all()
    assert ((tested[plain] % 32 == 0) | (tested[plain] == n_tests)).all()
    if case == "shared":
        assert len(args[5]) > 1 and 0 < plain.sum() < n
    if slice_len == _SMALL_SLICE and case in ("main", "reads_n"):
        assert len(schedule.slices) > 10 * len(schedule.rank_window)


_SLICE_EDGE_CASES = kb_slice_edge_cases()


def _kb_edge_inputs(case, layout):
    """(made, resident, pairs, rows_per_task) of an edge case of K5
    (chip_smoke.kb_edge_case) on the CPU, in a layout of
    resident_layouts."""
    made, left_out, rows_per_task = kb_edge_case(case)
    resident = resident_layouts(made, torch.device("cpu"))[layout]
    pairs = np.flatnonzero(resident.pair_window != (
        -1 if left_out is None else left_out))
    return made, resident, pairs, rows_per_task


@pytest.mark.parametrize("layout", ["packed", "contig"])
@pytest.mark.parametrize("case", KB_EDGE_CASES)
def test_kmer_bitmap_screen_emulation_edges(harness, case, layout):
    """K5's two passes under g++ at the edges of its schedule, against its
    plain version and the JAX package's screen_pairs, on the packed tables
    and on the contig as the window table (there the slices' last groups
    sit 10 bytes past a 16-byte boundary): windows of KB_SLICE
    + 7, + 8 and 2 KB_SLICE + 6 bytes, each read sharing with its window
    only an 8-mer planted across a slice's edge or at the window's first
    or last position (and a read planted nowhere sharing none); a window
    no task names (no rank, no slice); tasks of one row; reads of 0-7
    bytes, which hold no 8-mer; reads past 256 bytes, whose rows the test
    pass stages in pieces, sharing an 8-mer only near the end of either
    orientation, or none."""
    made, resident, pairs, rows_per_task = _kb_edge_inputs(case, layout)
    order, args, schedule = realign.screen_inputs(
        resident, pairs, rows_per_task=rows_per_task)
    got, _ = _kb_emulate(harness, args, schedule)
    plain = realign.kmer_bitmap_screen_plain(*args).numpy()
    np.testing.assert_array_equal(got, plain)
    verdict = np.zeros(len(pairs), bool)
    verdict[order] = plain
    contig, spans, seqs, _ = made
    np.testing.assert_array_equal(verdict, jax_realign.screen_pairs(
        [seqs[i] for i in pairs],
        [contig[spans[i][0]:spans[i][0] + spans[i][1]] for i in pairs]))
    if case in _SLICE_EDGE_CASES:
        assert verdict[:-1].all() and not verdict[-1]
        assert len(schedule.slices) == -(-(made[1][0][1] - 7)
                                         // realign.KB_SLICE)
    elif case == "unnamed_window":
        assert len(schedule.rank_window) == len(resident.win_len) - 1
        assert 1 not in schedule.rank_window.tolist()
        assert verdict.any() and not verdict.all()
    elif case == "long_reads":
        assert args[0].shape[1] > 32 * 16 // 2
        np.testing.assert_array_equal(verdict, np.arange(len(pairs)) % 4 != 0)
    elif case == "one_row_tasks":
        assert len(args[5]) == len(pairs)
        assert verdict.any() and not verdict.all()
    else:
        lengths = np.array([len(seqs[i]) for i in pairs])
        assert not verdict[lengths < 8].any()
        assert verdict[(lengths == 8) & (np.arange(len(pairs)) % 2 == 0)].all()


def test_kb_code16_codes_every_byte(harness):
    """kb_code16 (four bytes a word at once) gives each of the 256 byte
    values, at each of a group's 16 places, aw_kmer_code's code (T 0, G 1,
    C 2, any other byte 3) in bits 2 (15 - j) and, for byte 0 alone, the
    PAD mark in bit 15 - j."""
    rng = np.random.default_rng(101)
    groups = np.concatenate([
        np.arange(256, dtype=np.uint8).reshape(16, 16),
        np.arange(256, dtype=np.uint8).reshape(16, 16).T,
        rng.choice(np.frombuffer(b"ACGTN\x00acgt", np.uint8), (64, 16)),
        rng.integers(0, 256, (64, 16)).astype(np.uint8)])
    out = np.zeros((len(groups), 2), np.uint32)
    harness.kb_code_groups(_ptr(np.ascontiguousarray(groups)), _ptr(out),
                           len(groups))
    code = np.full(256, 3, np.uint64)
    code[[ord("T"), ord("G"), ord("C")]] = [0, 1, 2]
    shifts = np.arange(15, -1, -1, dtype=np.uint64)
    want_codes = (code[groups] << (2 * shifts)).sum(axis=1)
    want_pads = ((groups == 0).astype(np.uint64) << shifts).sum(axis=1)
    np.testing.assert_array_equal(out[:, 0], want_codes)
    np.testing.assert_array_equal(out[:, 1], want_pads)


def test_kb_homopolymer_names_the_four_runs(harness):
    """kb_homopolymer holds for the 8-mers of one base 8 times (TTTTTTTT,
    GGGGGGGG, CCCCCCCC and the "other" code's, which N and A runs set) and
    for no other of the 65,536."""
    hits = [kmer for kmer in range(1 << 16) if harness.kb_homopolymer_of(kmer)]
    assert hits == [0, 0x5555, 0xAAAA, 0xFFFF]


def test_kb_constants_match_the_header(harness):
    """kernels.KB_SLICE and KB_WORDS, and realign's default slice, are the
    header's; a slice and a stage are whole 16-byte groups."""
    from arriba_tpu_torch import kernels

    got = np.zeros(4, np.int32)
    harness.kb_constants(_ptr(got))
    slice_len, words, group, stage = got.tolist()
    assert (kernels.KB_SLICE, kernels.KB_WORDS) == (slice_len, words)
    assert realign.KB_SLICE == slice_len and slice_len % group == 0
    assert words * 32 == 4 ** 8 and group == 16 and stage == 32


@pytest.mark.parametrize("layout", ["packed", "contig"])
@pytest.mark.parametrize("case", ["tail", "short", "reads_n", "chunk_edges"])
def test_accept_indexed_emulation_matches_plain_and_jax(harness, case,
                                                        layout):
    """K1's indexed rows under g++ (aw_rows_indexed: each row's bytes by
    offset, the staged stretch in 16-byte loads aligned to the table's
    start, each checked to stay inside the table) against the indexed
    plain version and the JAX package's XLA wavefront on the same rows made
    dense (windows padded with 1 past win_len), at 1,024-byte chunks: on
    the contig layout the bytes past a chunk's end are the window's or the
    contig's next ones, and no "tail" row accepts."""
    made = _RESIDENT_CASES[case]()
    resident = resident_layouts(made, torch.device("cpu"))[layout]
    n = min(len(resident.pair_read), 24)
    W = 1024
    row_pair, offsets, params = realign.resident_accept_rows(
        resident, np.arange(n), np.asarray(made[3][:n]), W)
    reads, table = resident.accept_reads.numpy(), resident.table.numpy()
    out = np.zeros(len(row_pair), np.int32)
    L = reads.shape[1]
    harness.aw_rows_indexed(_ptr(reads), reads.size, _ptr(table), table.size,
                            _ptr(offsets), _ptr(params), _ptr(out),
                            len(row_pair), L, W)
    assert (out >= 0).all()      # every load stayed inside the table
    plain = realign.accept_wavefront_indexed_plain(
        resident.accept_reads, resident.table, torch.from_numpy(offsets),
        torch.from_numpy(params), W).numpy()
    np.testing.assert_array_equal(out != 0, plain)
    flat = reads.reshape(-1)
    dense_reads = flat[offsets[:, :1] + np.arange(L)]
    lanes = np.arange(W)
    dense_windows = np.where(lanes < params[:, 1:2], table[np.minimum(
        offsets[:, 1:2] + lanes, len(table) - 1)], 1).astype(np.uint8)
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(dense_reads), jnp.asarray(dense_windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    np.testing.assert_array_equal(plain, xla)
    if case == "tail":
        assert not plain.any()
    elif case != "short":
        assert plain.any()


def _low_entropy_rows(seed, n, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (n, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    a1s = rng.integers(-3, L, n).astype(np.int32)
    a1e = (a1s + rng.integers(-10, L, n)).astype(np.int32)  # some inverted
    a2s = rng.integers(0, L, n).astype(np.int32)
    a2e = (a2s + rng.integers(0, L, n)).astype(np.int32)
    for row in range(0, n, 4):  # repeat a short motif: low entropy
        motif = rng.integers(0, 4, int(rng.integers(1, 4)))
        codes[row] = np.tile(motif, L)[:L]
        lengths[row] = int(rng.integers(L // 2, L + 1))
    for row in range(1, n, 4):  # a low-entropy stretch around segment 1
        lengths[row] = L
        a1s[row] = int(rng.integers(2, L // 2))
        a1e[row] = a1s[row] + int(rng.integers(12, L // 2))
        lo = a1s[row] - int(rng.integers(0, 3))
        hi = a1e[row] + int(rng.integers(0, 3))
        codes[row, lo:hi] = np.tile(rng.integers(0, 4, 1), hi - lo)
    return codes, lengths, a1s, a1e, a2s, a2e


@pytest.mark.parametrize("kmer_content", [0.6, 0.3])
def test_low_entropy_position_update_matches_plain_and_jax(harness,
                                                           kmer_content):
    codes, lengths, a1s, a1e, a2s, a2e = _low_entropy_rows(3, 256, 150)
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, kmer_content)
    meta = np.ascontiguousarray(np.stack(
        [lengths, a1s, a1e, a2s, a2e, *th], axis=1).astype(np.int32))
    packed = np.ascontiguousarray(readfilters.pack_codes(codes))
    native = np.zeros(len(codes), np.uint8)
    harness.le_rows(_ptr(packed), _ptr(meta), _ptr(native), len(codes),
                    packed.shape[1])
    plain = readfilters.low_entropy_batch(
        *(torch.from_numpy(x) for x in (codes, lengths, a1s, a1e, a2s, a2e)),
        kmer_content).numpy()
    xla = np.asarray(jax_readfilters.low_entropy_batch(
        *(jnp.asarray(x) for x in (codes, lengths, a1s, a1e, a2s, a2e)),
        kmer_content))
    np.testing.assert_array_equal(native != 0, plain)
    np.testing.assert_array_equal(plain, xla)
    assert 0 < plain.sum() < len(codes)


def _low_entropy_edge_rows(seed, n, L):
    """_low_entropy_rows plus rows at the edges: lengths 0-4 and L,
    segments starting before the read or past its end, ending past it, and
    inverted, and homopolymer rows of the full width."""
    codes, lengths, a1s, a1e, a2s, a2e = (
        np.concatenate([x, np.resize(x, (24,) + x.shape[1:])])
        for x in _low_entropy_rows(seed, n, L))
    edge = np.arange(n, n + 24)
    lengths[edge[:6]] = [0, 1, 2, 3, 4, L]
    codes[edge[6:12]] = int(seed) % 4                   # homopolymers
    lengths[edge[6:12]] = L
    a1s[edge[6:]] = np.resize([-7, 0, L - 2, L + 5, 3, 1], 18)
    a1e[edge[6:]] = np.resize([L + 9, L, L + 1, L + 9, 2, L // 2], 18)
    a2s[edge[12:]] = np.resize([L // 3, -1, L], 12)
    a2e[edge[12:]] = np.resize([L // 3, L // 2, L + 3], 12)
    return codes, lengths, a1s, a1e, a2s, a2e


def _le_rows_kernel(harness, rows, th):
    """le_rows_kernel's flags on rows with thresholds th."""
    codes, lengths, a1s, a1e, a2s, a2e = rows
    meta = np.ascontiguousarray(np.stack(
        [lengths, a1s, a1e, a2s, a2e, *th], axis=1).astype(np.int32))
    packed = np.ascontiguousarray(readfilters.pack_codes(codes))
    native = np.zeros(len(codes), np.uint8)
    harness.le_rows_kernel(_ptr(packed), _ptr(meta), _ptr(native),
                           len(codes), packed.shape[1])
    return native != 0


def _low_entropy_through(harness, rows, kmer_content):
    """K2's per-row procedure (le_rows_kernel), the plain version and the
    JAX package on the same rows; all must agree. Returns the flags."""
    codes, lengths, a1s, a1e, a2s, a2e = rows
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, kmer_content)
    plain = readfilters.low_entropy_batch(
        *(torch.from_numpy(x) for x in rows), kmer_content).numpy()
    xla = np.asarray(jax_readfilters.low_entropy_batch(
        *(jnp.asarray(x) for x in rows), kmer_content))
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(_le_rows_kernel(harness, rows, th), plain)
    return plain


# widths on and off a multiple of four codes (whole byte pairs, then the
# rest one at a time), from a few byte pairs to a few hundred
@pytest.mark.parametrize("L", [150, 37, 149, 64, 511, 1021])
@pytest.mark.parametrize("kmer_content", [0.6, 0.3])
def test_low_entropy_packed_kernel_matches_plain_and_jax(harness, L,
                                                         kmer_content):
    plain = _low_entropy_through(harness, _low_entropy_edge_rows(3, 256, L),
                                 kmer_content)
    assert 0 < plain.sum() < len(plain)
    assert not plain[256:259].any()      # lengths 0-2 never flag


# 3,072 codes: the packed counters' widest rows (a homopolymer selects its
# 3-mer 1,023 times); 3,100 and 4,000: the long-row kernel's procedure
# (le_long_row), one tile of chunks of 112 and 128 positions
@pytest.mark.parametrize("L", [3072, 3100, 4000])
def test_low_entropy_long_rows_match_plain_and_jax(harness, L):
    plain = _low_entropy_through(harness, _low_entropy_edge_rows(5, 8, L),
                                 0.6)
    assert 0 < plain.sum() < len(plain)


def test_le_long_work_counts_the_walk():
    """chip_smoke.le_long_work, the counts behind K2's long-row bound,
    against a walk of each read position by position as le_row does it:
    the positions walked up to the first selected 3-mer whose counter
    reaches its threshold, the selected ones among them, their segment
    counts, the same over every eligible position, and the verdict; and
    le_long_ops from those counts."""
    from chip_smoke import (LE_LONG_CLEAR_OPS, LE_LONG_END_OPS,
                            LE_LONG_TEST_OPS, LE_OPS_PER_POSITION,
                            le_long_ops, le_long_work, low_entropy_inputs)

    n, L = 48, 260
    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs(seed=9, n=n, L=L)
    for row in range(0, n, 5):
        codes[row] = np.tile(codes[row, :1 + row % 3], L)[:L]
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1).astype(np.int32)
    packed = torch.from_numpy(readfilters.pack_codes(codes))
    seen = readfilters._unpack_codes(packed, L).numpy().astype(int)
    want = dict.fromkeys(("positions", "selected", "segment_counts",
                          "eligible", "all_segment_counts"), 0)
    verdict = []
    for row in range(n):
        length, s1, e1, s2, e2, t_all, t1, t2 = (int(x) for x in meta[row])
        counts = np.zeros((3, 64), int)
        prev = [(False, 0), (False, 0)]
        stopped = False
        for p in range(max(0, length - 3)):
            kv = seen[row, p] << 4 | seen[row, p + 1] << 2 | seen[row, p + 2]
            sel = all(not (was and kv == v) for was, v in prev)
            prev = [(sel, kv), prev[0]]
            segments = (p + 1 >= s1 and p < e1, p + 1 >= s2 and p < e2)
            want["eligible"] += 1
            want["all_segment_counts"] += sel * sum(segments)
            if stopped:
                continue
            want["positions"] += 1
            if not sel:
                continue
            want["selected"] += 1
            want["segment_counts"] += sum(segments)
            counts[0, kv] += 1
            counts[1, kv] += segments[0]
            counts[2, kv] += segments[1]
            stopped = (counts[0, kv] >= t_all or counts[1, kv] >= t1
                       or counts[2, kv] >= t2)
        verdict.append(stopped)
    work = le_long_work(packed, *torch.from_numpy(meta).unbind(dim=1))
    assert {key: work[key] for key in want} == want
    assert work["verdict"].tolist() == verdict
    assert 0 < sum(verdict) < n
    ops = le_long_ops(work, n)
    assert ops["stop"] == (
        want["positions"] * LE_OPS_PER_POSITION + want["segment_counts"]
        + (want["selected"] + want["segment_counts"]) * LE_LONG_TEST_OPS
        + n * LE_LONG_CLEAR_OPS)
    assert ops["end"] == (want["eligible"] * LE_OPS_PER_POSITION
                          + want["all_segment_counts"]
                          + n * (LE_LONG_CLEAR_OPS + LE_LONG_END_OPS))


# the host picks K2's entry point from the row width with its own copy of
# the header's limit: the two must agree, or a count names a kernel that
# did not launch (the packed entry point refuses wider rows)
def test_low_entropy_route_follows_header(harness):
    from arriba_tpu_torch import kernels

    assert kernels.LE_PACKED_MAX_CODES == harness.le_packed_max_codes()
    assert kernels.LE_LONG_LANES == _le_long_constants(harness)[0]
    widest = harness.le_packed_max_codes() // 4
    assert kernels.le_route(widest) == "low_entropy"
    assert kernels.le_route(widest + 1) == "low_entropy_long"


def _le_long_constants(harness):
    """(lanes, words, field max) of the header's long-row procedure."""
    out = np.zeros(3, np.int32)
    harness.le_long_constants(_ptr(out))
    return tuple(int(x) for x in out)


def _le_long_plan(harness, n_pos):
    out = np.zeros(2, np.int32)
    harness.le_long_plan_of(n_pos, _ptr(out))
    return int(out[0]), int(out[1])


def _le_selected(codes, lengths):
    """bool [n, P]: the greedy selection of each row's eligible positions,
    walked position by position (numpy over the rows), and the 3-mers
    [n, P]."""
    c = np.minimum(codes, 3).astype(np.int64)
    kv = c[:, :-2] << 4 | c[:, 1:-1] << 2 | c[:, 2:]
    n = len(codes)
    P = max(0, int(lengths.max()) - 3)
    sel = np.zeros((n, P), bool)
    sel1 = np.zeros(n, bool)
    sel2 = np.zeros(n, bool)
    for p in range(P):
        now = p < lengths - 3
        if p >= 1:
            now &= ~(sel1 & (kv[:, p] == kv[:, p - 1]))
        if p >= 2:
            now &= ~(sel2 & (kv[:, p] == kv[:, p - 2]))
        sel[:, p] = now
        sel2, sel1 = sel1, now
    return sel, kv[:, :P]


def _le_tight_thresholds(rows):
    """(thresholds, verdicts) at the edge of each row's verdict: its most
    counted 3-mer in plane row % 3 (the whole read, segment 1, segment 2)
    reaches the threshold on even rows and falls one short on odd ones; the
    other planes never cross. So a count one off flips a verdict."""
    codes, lengths, a1s, a1e, a2s, a2e = rows
    sel, kv = _le_selected(codes, lengths)
    p = np.arange(sel.shape[1])[None, :]
    planes = (sel, sel & (p + 1 >= a1s[:, None]) & (p < a1e[:, None]),
              sel & (p + 1 >= a2s[:, None]) & (p < a2e[:, None]))
    n = len(codes)
    th = np.full((3, n), 1 << 30, np.int64)
    verdicts = np.zeros(n, bool)
    for row in range(n):
        plane = planes[row % 3][row]
        most = np.bincount(kv[row][plane], minlength=64).max()
        th[row % 3, row] = max(1, most + row % 2)
        verdicts[row] = most >= 1 and row % 2 == 0
    return tuple(x.astype(np.int32) for x in th), verdicts


def _low_entropy_through_thresholds(harness, rows, th):
    """_low_entropy_through with the thresholds given: le_rows_kernel, the
    plain version and the JAX op; all must agree. Returns the flags."""
    plain = readfilters._low_entropy_core_plain(
        *(torch.from_numpy(x) for x in (*rows, *th))).numpy()
    xla = np.asarray(jax_readfilters._low_entropy_core(
        *(jnp.asarray(x) for x in (*rows, *th))))
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(_le_rows_kernel(harness, rows, th), plain)
    return plain


def _le_long_rows(seed, n, L, boundaries=()):
    """Rows for the long-row procedure: random codes with a few N, and
    homopolymer and dinucleotide rows (whose start states never merge) of
    the full width, with segments that begin or end at the positions in
    boundaries (a chunk's first position)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.002] = 4
    lengths = np.full(n, L, np.int32)
    lengths[n // 2:] -= rng.integers(0, 40, n - n // 2).astype(np.int32)
    for row in range(0, n, 3):          # homopolymers
        codes[row] = row % 4
    for row in range(1, n, 3):          # dinucleotides
        codes[row] = np.tile([row % 4, (row + 1 + row // 3) % 4], L)[:L]
    a1s = rng.integers(0, L // 2, n).astype(np.int32)
    a1e = (a1s + rng.integers(1, L // 2, n)).astype(np.int32)
    a2s = rng.integers(0, L, n).astype(np.int32)
    a2e = (a2s + rng.integers(0, L, n)).astype(np.int32)
    # a segment counts p iff start - 1 <= p < end: from a chunk's first
    # position, or up to the one before it
    for k, b in enumerate(boundaries):
        row = k % n
        if k % 2:
            a2e[row] = b
        else:
            a1s[row] = b + 1
            a1e[row] = max(a1e[row], b + 200)
    return codes, lengths, a1s, a1e, a2s, a2e


# rows a lane's chunk is 112 (3,100) and 128 (4,000) positions of, whose
# segments begin and end at chunk boundaries, with thresholds at the edge
# of each verdict
@pytest.mark.parametrize("L", [3100, 4000])
def test_low_entropy_long_rows_tight_thresholds(harness, L):
    words, tiles = _le_long_plan(harness, L - 3)
    assert tiles == 1
    chunk = 16 * words
    rows = _le_long_rows(7, 24, L, [chunk * k for k in range(1, 12)])
    th, verdicts = _le_tight_thresholds(rows)
    plain = _low_entropy_through_thresholds(harness, rows, th)
    np.testing.assert_array_equal(plain, verdicts)
    assert verdicts.sum() >= 10


# a lane's chunk past 3,069 positions in the issue's terms: rows of lanes x
# 3,069 + 100 codes take more tiles than a lane's 10-bit fields hold, so the
# group flushes its words into the 32-bit totals at least once
def test_low_entropy_long_rows_flush(harness):
    lanes, words_max, field_max = _le_long_constants(harness)
    L = lanes * 3069 + 100
    words, tiles = _le_long_plan(harness, L - 3)
    assert words == words_max
    per_tile = (16 * words + 2) // 3
    assert tiles * per_tile > field_max        # a flush is needed
    rows = _le_long_rows(11, 9, L)
    th, verdicts = _le_tight_thresholds(rows)
    # the same rows again at kmer_content 0.6, in the same batch
    th = tuple(np.concatenate([x, y]) for x, y in zip(
        th, readfilters._thresholds(*rows[1:], 0.6)))
    plain = _low_entropy_through_thresholds(
        harness, tuple(np.concatenate([x, x]) for x in rows), th)
    np.testing.assert_array_equal(plain[:9], verdicts)
    assert verdicts.sum() >= 4
    assert plain[9::3].all()                    # the homopolymers


# rows whose n_pos leaves lanes without a position (n_pos below 16 x the
# lanes), lengths 0-3, and n_pos at and around a word and a chunk
def test_low_entropy_long_rows_short_reads(harness):
    lanes, _, _ = _le_long_constants(harness)
    L = 3100
    lengths = np.array([0, 1, 2, 3, 4, 5, 19, 20, 35, 16 * lanes + 2,
                        16 * lanes + 3, 16 * lanes + 4, 2 * 16 * lanes + 3,
                        1000, L - 1, L] * 2, np.int32)
    n = len(lengths)
    codes, _, a1s, a1e, a2s, a2e = _le_long_rows(13, n, L)
    rows = (codes, lengths, a1s, a1e, a2s, a2e)
    th, verdicts = _le_tight_thresholds(rows)
    plain = _low_entropy_through_thresholds(harness, rows, th)
    np.testing.assert_array_equal(plain, verdicts)
    assert not plain[[0, 1, 2, 3, 16, 17, 18, 19]].any()  # lengths 0-3
    assert verdicts.sum() >= 4
    _low_entropy_through(harness, rows, 0.3)


# the per-position table is the JAX op's formula (arriba_tpu/ops/
# readfilters.py _low_entropy_core: nb0 ... nb3 and tables)
def test_le_table_is_the_jax_formula(harness):
    e, s1, s2 = (jnp.array(x, bool) for x in zip(
        *[(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]))
    e_ = e.astype(jnp.int32)
    ns1 = (~s1).astype(jnp.int32)
    ns2 = (~s2).astype(jnp.int32)
    tables = (e_ | ((2 | (e_ & ns1)) << 2) | ((e_ & ns2) << 4)
              | ((2 | (e_ & ns1 & ns2)) << 6))
    got = [harness.le_table_of(int(a), int(b), int(c))
           for a, b, c in zip(e, s1, s2)]
    assert got == np.asarray(tables).tolist()


# le_compose is associative over every map of the four states, with the
# identity table neutral on both sides, and composes f before g
def test_le_compose_is_associative(harness):
    assert harness.le_compose_errors() == 0
    shift = 0x39  # s -> s + 1 (mod 4): 1, 2, 3, 0
    to_zero = 0x00
    assert harness.le_compose_of(shift, to_zero) == to_zero
    assert harness.le_compose_of(to_zero, shift) == 0x55  # every s -> 1


# over random rows, homopolymers, dinucleotides and short repeats, from
# each start state at chunk starts on and off position 0: le_table composed
# over the positions, and pass 1's walk from the four start states at once,
# give le_select's selections walked in order, and pass 1's table of each
# word prefix equals the composition
_LE_KINDS = ("random", "homopolymer", "dinucleotide", "repeat3", "mixed")


@pytest.mark.parametrize("kind", _LE_KINDS)
def test_le_selection_ways_agree(harness, kind):
    rng = np.random.default_rng(_LE_KINDS.index(kind))
    L = 400
    if kind == "random":
        codes = rng.integers(0, 4, L)
    elif kind == "homopolymer":
        codes = np.full(L, 2)
    elif kind == "dinucleotide":
        codes = np.tile([1, 3], L)[:L]
    elif kind == "repeat3":
        codes = np.tile([0, 0, 1], L)[:L]
    else:
        codes = np.concatenate([np.full(50, 1), np.tile([0, 2], 40),
                                rng.integers(0, 4, L - 130)])
    packed = np.ascontiguousarray(
        readfilters.pack_codes(codes[None, :].astype(np.uint8))[0])
    n_pos = L - 3
    for first in (0, 16, 48, 160):
        for start in ((0,) if first == 0 else range(4)):
            m = n_pos - first
            ways = [np.zeros(m, np.uint8) for _ in range(3)]
            tables = np.zeros(2 * ((m + 15) // 16), np.uint32)
            harness.le_selection_ways(_ptr(packed), len(packed), first,
                                      n_pos, start, *(_ptr(w) for w in ways),
                                      _ptr(tables))
            np.testing.assert_array_equal(ways[1], ways[0])
            np.testing.assert_array_equal(ways[2], ways[0])
            full = m // 16
            np.testing.assert_array_equal(tables[0:2 * full:2],
                                          tables[1:2 * full:2])
            if kind in ("homopolymer", "dinucleotide"):
                assert 0 < ways[0].sum() < m


# stripes of 1, 2, 4, 8 and 16 read positions a lane; L not a multiple of 32
# and W < L among them
@pytest.mark.parametrize("seed,n,L,W", [(1, 12, 20, 50), (2, 12, 37, 300),
                                        (3, 10, 100, 64), (4, 8, 256, 256),
                                        (5, 4, 300, 180)])
def test_smith_waterman_cell_update_matches_plain_and_jax(harness, seed, n,
                                                          L, W):
    from .test_torch_realign import _sw_rows

    reads, windows = _sw_rows(seed, n, L, W)
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2)):
        native = np.zeros(n, np.int32)
        harness.sw_rows(_ptr(reads), _ptr(windows), _ptr(native), n, L, W,
                        match, mismatch, gap)
        plain = realign.smith_waterman_scores(
            torch.from_numpy(reads), torch.from_numpy(windows), match,
            mismatch, gap).numpy()
        np.testing.assert_array_equal(native, plain)
    xla = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows), match, mismatch, gap))
    np.testing.assert_array_equal(plain, xla)
    assert plain.min() == 0 and plain.max() > 8


# odd batches (the last row beside the all-PAD dummy), a one-row batch, PAD
# inside reads and windows, both score sets, and each row in either half:
# the batch reversed pairs every row with another partner
@pytest.mark.parametrize("seed,n,L,W", [(6, 13, 37, 300), (7, 1, 256, 256),
                                        (8, 7, 100, 64)])
def test_smith_waterman_pair_warp_odd_batches(harness, seed, n, L, W):
    from arriba_tpu_torch.ops.encode import PAD_CODE

    from .test_torch_realign import _sw_rows

    reads, windows = _sw_rows(seed, n + 2, L, W)
    reads, windows = reads[:n].copy(), windows[:n].copy()
    rng = np.random.default_rng(seed)
    reads[rng.random(reads.shape) < 0.02] = PAD_CODE
    windows[rng.random(windows.shape) < 0.02] = PAD_CODE
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2)):
        plain = realign.smith_waterman_scores(
            torch.from_numpy(reads), torch.from_numpy(windows), match,
            mismatch, gap).numpy()
        for order in (slice(None), slice(None, None, -1)):
            r = np.ascontiguousarray(reads[order])
            w = np.ascontiguousarray(windows[order])
            native = np.zeros(n, np.int32)
            harness.sw_rows(_ptr(r), _ptr(w), _ptr(native), n, L, W, match,
                            mismatch, gap)
            np.testing.assert_array_equal(native, plain[order])
    xla = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows), match, mismatch, gap))
    np.testing.assert_array_equal(plain, xla)
    assert plain.max() > 8


def _halves(x):
    return [int(np.int16(np.uint16((x >> (16 * k)) & 0xFFFF)))
            for k in (0, 1)]


def _word(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _wrap16(x):
    return int(np.int16(np.uint16(x & 0xFFFF)))


# per-halfword scalar math of each 16x2 primitive
_SW_PRIMITIVES = {
    "add.s16x2": (0, lambda a, b, c: _wrap16(a + b)),
    "max.s16x2": (1, lambda a, b, c: max(a, b)),
    "viaddmax_s16x2_relu": (2, lambda a, b, c: max(_wrap16(a + b), c, 0)),
}
_EDGE_HALVES = [0, 1, -1, 2, -2, 127, -128, 8191, -8192, 16383, -16384,
                32767, -32768]


@pytest.mark.parametrize("name", list(_SW_PRIMITIVES) + ["prmt"])
def test_smith_waterman_primitive_emulation(harness, name):
    """Each 16x2 primitive's host emulation against per-halfword scalar
    math on random and edge halves; prmt against its byte selection with
    sign replication, and on the selectors and score tables K3 builds."""
    rng = np.random.default_rng(11)
    halves = _EDGE_HALVES + rng.integers(-32768, 32768, 40).tolist()
    words = [_word(lo, hi) for lo in _EDGE_HALVES for hi in halves[::3]]
    words += [int(x) for x in rng.integers(0, 1 << 32, 200, np.uint64)]
    if name != "prmt":
        which, scalar = _SW_PRIMITIVES[name]
        for k in range(300):
            a, b, c = (words[(k * m + j) % len(words)]
                       for m, j in ((7, 0), (11, 3), (13, 5)))
            got = harness.sw_primitive(which, a, b, c)
            want = [scalar(x, y, z) for x, y, z in zip(
                _halves(a), _halves(b), _halves(c))]
            assert _halves(got) == want, (name, hex(a), hex(b), hex(c))
        return
    selectors = [int(x) for x in rng.integers(0, 1 << 16, 200)]
    # K3's selectors: read codes 0-4 of both rows
    selectors += [ca | ((ca | 8) << 4) | ((cb | 4) << 8) | ((cb | 12) << 12)
                  for ca in range(5) for cb in range(5)]
    for k, sel in enumerate(selectors):
        lo, hi = words[k % len(words)], words[(3 * k + 1) % len(words)]
        data = lo | (hi << 32)
        want = 0
        for i in range(4):
            n = (sel >> (4 * i)) & 0xF
            byte = (data >> (8 * (n & 7))) & 0xFF
            if n & 8:
                byte = 0xFF if byte & 0x80 else 0
            want |= byte << (8 * i)
        assert harness.sw_primitive(3, lo, hi, sel) == want
    # the score table picks s - gap, sign-extended, for each code pair
    for match, mismatch, gap in ((1, -1, -1), (2, -3, -2), (5, -100, 20)):
        mis = (mismatch - gap) & 0xFF
        flip = ((match - gap) & 0xFF) ^ mis
        for wa in range(4):
            for wb in range(4):
                t0 = (mis * 0x01010101) ^ (flip << (8 * wa))
                t1 = (mis * 0x01010101) ^ (flip << (8 * wb))
                for ca in range(4):
                    for cb in range(4):
                        sel = (ca | ((ca | 8) << 4) | ((cb | 4) << 8)
                               | ((cb | 12) << 12))
                        got = _halves(harness.sw_primitive(3, t0, t1, sel))
                        assert got == [
                            (match if ca == wa else mismatch) - gap,
                            (match if cb == wb else mismatch) - gap]


@pytest.mark.parametrize("L,W,params,ok", [
    (256, 256, (1, -1, -1), True),
    (512, 8192, (15, -1, -1), True),     # 15 * 512 = 7680 < 2^13
    (512, 256, (16, -1, -1), False),     # 16 * 512 = 8192
    (513, 256, (1, -1, -1), False),      # past 16 positions a lane
    (256, 256, (1, -129, -1), True),     # mismatch - gap = -128
    (256, 256, (1, -130, -1), False),    # -129
    (256, 256, (1, -1, 1), True),        # 256 + 512 < 2^13
    (512, 8192, (1, -1, 1), False),      # +1 a gap over L + W
    (100, 20, (1, -200, -200), False),   # match - gap = 201
    (10, 10, (-20000, -20000, -20000), False),  # |gap| > 2^14
])
def test_smith_waterman_guard(L, W, params, ok):
    """K3's 16-bit guard, decided from shapes and scores alone: a refused
    call raises ValueError before anything reaches the card."""
    from arriba_tpu_torch import kernels

    if ok:
        kernels.sw_guard(L, W, *params)
    else:
        with pytest.raises(ValueError):
            kernels.sw_guard(L, W, *params)


def test_mxu_fragment_layout_covers_each_element_once(harness):
    """K4's layout helpers put every element of the warpgroup's 64 x 32 A
    in exactly one (thread, register, byte) and each word of the B image at
    its own offset, and a warp's fragments lay out its 16 window k-mers
    one-hot: A[i, 4j + c] = 1 iff bytes[p0 + i + j] == c <= 3 (0 past the
    bytes)."""
    assert harness.mk_layout_errors() == 0
    rng = np.random.default_rng(12)
    L = 40
    read = rng.integers(0, 6, L).astype(np.uint8)
    for p0 in (0, 16, 32):
        got = np.zeros((16, 32), np.int8)
        harness.mk_a_matrix(_ptr(read), L, p0, _ptr(got))
        want = np.zeros((16, 32), np.int8)
        for i in range(16):
            for j in range(8):
                p = p0 + i + j
                if p < L and read[p] <= 3:
                    want[i, 4 * j + read[p]] = 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("base", [0, 0x400, 0x3ec00])
def test_mxu_b_image_bytes_are_distinct_and_descriptor_addressed(harness,
                                                                 base):
    """Every element (read k-mer n, lane k) of K4's 160 x 32 B image lies
    at one distinct byte of its 5,120, and the wgmma descriptor of the
    image, decoded from its start, leading and stride fields, addresses
    that byte, wherever the image sits in shared memory."""
    assert harness.mk_image_errors(base) == 0


def _mxu_rows_device_ops(above_4):
    """tests/test_device_ops.py:262-286 (planted seeds, one past the first
    w_chunk, one at the tail, PAD tails, a fully padded read), with bytes
    5-255 scattered through reads and windows and over planted seeds when
    above_4 is set."""
    from .test_torch_realign import _screen_rows_padded

    reads, windows = _screen_rows_padded()
    if above_4:
        rng = np.random.default_rng(21)
        for x in (reads, windows):
            spots = rng.random(x.shape) < 0.03
            x[spots] = rng.integers(5, 256, int(spots.sum()))
        reads[0, 14] = windows[0, 43] = 9       # inside the row-0 seed
        reads[6, 20:28] = windows[6, 300:308] = [0, 1, 2, 3, 3, 2, 1, 0]
    return reads, windows


def _mxu_rows_long(seed, n=8, L=300, W=600):
    """Reads of 293 k-mers (two slabs of 160), seeds planted from read
    position 280 (the second slab) in half the rows; a window of several
    stages at a 64-k-mer stage."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 2, (n, L)).astype(np.uint8)
    windows = rng.integers(2, 4, (n, W)).astype(np.uint8)
    for row in range(0, n, 2):
        at = int(rng.integers(0, W - 8))
        windows[row, at:at + 8] = reads[row, 280 + row:288 + row]
    return reads, windows


def _mxu_rows_narrow(L, W):
    """Rows narrower than one tile: an 8-mer of the read planted in every
    other window when both are wide enough."""
    rng = np.random.default_rng(L * 1000 + W)
    reads = rng.integers(0, 4, (10, L)).astype(np.uint8)
    windows = rng.integers(0, 4, (10, W)).astype(np.uint8)
    if L >= 8 and W >= 8:
        windows[::2, W - 8:] = reads[::2, L - 8:]
    return reads, windows


# (rows, window k-mers staged at a time): the kernel's stage (MK_CHUNK,
# 2,048) and smaller ones, multiples of its 64-k-mer tile, that cross stage
# edges inside these windows; the mixed rows (early, late and no hits, at
# one and two slabs) give the blocks that take rows in turn rows decided
# early next to rows that run to the window's end
_MK_CASES = {
    "device_ops": (lambda: _mxu_rows_device_ops(False), 2048),
    "device_ops_chunk_64": (lambda: _mxu_rows_device_ops(False), 64),
    "above_4": (lambda: _mxu_rows_device_ops(True), 2048),
    "odd": (lambda: tuple(x[:48] for x in mxu_inputs("odd")), 2048),
    "pad": (lambda: mxu_inputs("pad", N=16, W=1024), 256),
    "long_reads": (lambda: _mxu_rows_long(3), 64),
    "narrow": (lambda: _mxu_rows_narrow(20, 12), 2048),
    "narrow_read_7": (lambda: _mxu_rows_narrow(7, 40), 2048),
    "narrow_window_7": (lambda: _mxu_rows_narrow(40, 7), 2048),
    "mixed": (lambda: mxu_inputs("mixed", N=24, W=700), 128),
    "mixed_long": (lambda: mxu_inputs("mixed", N=24, L=300, W=700), 128),
}


def _mk_emulate(harness, reads, windows, chunk, grid):
    """K4's emulation (mk_rows) over the rows with grid blocks: verdicts
    (bool [n]) and each row's first tile with a hit; no schedule fault."""
    (n, L), W = reads.shape, windows.shape[1]
    verdict = np.zeros(n, np.uint8)
    first = np.zeros(n, np.int64)
    faults = harness.mk_rows(_ptr(reads), _ptr(windows), _ptr(verdict),
                             _ptr(first), n, L, W, chunk, grid)
    assert faults == 0
    return verdict != 0, first


@pytest.mark.parametrize("case", list(_MK_CASES))
def test_mxu_kmer_screen_emulation_matches_plain_and_jax(harness, case):
    """K4's blocks with the warpgroup product emulated from its A layout
    and its B image read back through the descriptor, against the port's
    plain version and the JAX package's mxu_shared_kmer_mask (and, where
    every byte is a code 0-4, both sorted screens); each row's first
    (slab, window tile) with a hit against mxu_work, which chip_smoke.py's
    bound counts from. Once with a block a row, and once with 3 blocks,
    each taking its rows in turn through the copy ring; neither with a
    fault of the ring's schedule (mk_rows)."""
    make_rows, chunk = _MK_CASES[case]
    reads, windows = (np.ascontiguousarray(x) for x in make_rows())
    (n, L), W = reads.shape, windows.shape[1]
    verdict, first = _mk_emulate(harness, reads, windows, chunk, n)
    r, w = torch.from_numpy(reads), torch.from_numpy(windows)
    plain = realign.mxu_shared_kmer_mask_plain(r, w).numpy()
    np.testing.assert_array_equal(verdict, plain)
    work = mxu_work(r, w)
    np.testing.assert_array_equal(first, work["first_tile"].numpy())
    np.testing.assert_array_equal(plain, work["verdict"].numpy())
    in_turn = _mk_emulate(harness, reads, windows, chunk, 3)
    np.testing.assert_array_equal(in_turn[0], plain)
    np.testing.assert_array_equal(in_turn[1], first)
    if min(L, W) >= 8:                  # the JAX op needs one k-mer each
        xla = np.asarray(jax_realign.mxu_shared_kmer_mask(
            jnp.asarray(reads), jnp.asarray(windows)))
        np.testing.assert_array_equal(plain, xla)
    if max(reads.max(), windows.max()) <= 4:
        np.testing.assert_array_equal(
            plain, realign.shared_kmer_mask(r, w).numpy())
    if case.startswith("narrow_"):
        assert not plain.any()
    else:
        assert 0 < plain.sum() < n


def _sww_rows(seed, n, L, W, above_4):
    """_sw_rows (copies, mutated copies, gapped copies, PAD tails, all-PAD
    rows), and where above_4 is set, bytes 5-255 scattered through reads
    and windows and carried into half the copies, so that whole-byte
    matches above code 4 score. Past 512 positions, every other row but
    the last two also gets a copy of a window stretch (with one
    substitution) across the edge of K3w's first tile, so that its best
    alignment runs through the tile carry."""
    from .test_torch_realign import _sw_rows

    reads, windows = _sw_rows(seed, n, L, W)
    if L > 512:
        rng = np.random.default_rng(seed + 1)
        edge = 32 * _stripe(L)      # a full read's first tile ends here
        for row in range(0, n - 2, 2):
            length = int(rng.integers(W // 2, W + 1))
            at = int(rng.integers(0, W - length + 1))
            start = edge - int(rng.integers(length // 4, 3 * length // 4))
            reads[row, start:start + length] = windows[row, at:at + length]
            reads[row, start + length // 3] ^= 1
    if above_4:
        rng = np.random.default_rng(seed)
        for x in (reads, windows):
            spots = (rng.random(x.shape) < 0.1) & (x != PAD)
            x[spots] = rng.integers(5, 256, int(spots.sum()))
        for row in range(0, n - 2, 2):
            length = int(rng.integers(8, min(L, W) // 2))
            at = int(rng.integers(0, W - length))
            reads[row, :length] = windows[row, at:at + length]
    return reads, windows


PAD = 4
WIDE16, WIDE = "smith_waterman_wide16", "smith_waterman_wide"
# K3w's stripes (smith_waterman_wide.cuh SWW_STRIPE_MASK)
STRIPES = (1, 2, 4, 6, 8, 10, 12, 14, 16)


def _sww_check(harness, reads, windows, params, route):
    """kernels.sw_route's choice, then K3w's emulation (sww_rows) in the
    32-bit lanes and, where the route is the 16-bit pairs, in those too,
    each against the port's plain version, and the plain version against
    the JAX package's jnp wavefront, exactly. Returns the plain scores."""
    from arriba_tpu_torch import kernels

    n, L = reads.shape
    W = windows.shape[1]
    r, w = torch.from_numpy(reads), torch.from_numpy(windows)
    assert kernels.sw_route(r, w, *params) == route
    plain = realign.smith_waterman_scores(r, w, *params).numpy()
    for wide16 in (0, 1) if route == WIDE16 else (0,):
        native = np.full(n, -1, np.int32)
        past_cap = harness.sww_rows(_ptr(reads), _ptr(windows), _ptr(native),
                                    n, L, W, *params, wide16)
        assert past_cap == 0
        np.testing.assert_array_equal(native, plain)
    xla = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows), *params))
    np.testing.assert_array_equal(plain, xla)
    return plain


# (seed, rows, L, W, (match, mismatch, gap), bytes above 4, route), each a
# batch K3 does not carry: reads past 512 positions (two tiles of 384 and
# of 512), bytes above code 4, h past 2^13, match - gap outside a signed
# byte, a positive gap; where only the length stops K3, K3w's 16-bit pairs
_SWW_CASES = {
    "L640": (11, 6, 640, 96, (1, -1, -1), False, WIDE16),
    "L1024": (12, 4, 1024, 64, (1, -1, -1), False, WIDE16),
    "L1100_above_4": (13, 4, 1100, 40, (1, -1, -1), True, WIDE),
    "bytes_above_4": (14, 8, 100, 120, (1, -1, -1), True, WIDE),
    "past_2_13": (15, 3, 640, 512, (20, -3, -5), False, WIDE),
    "gap_past_a_byte": (16, 6, 200, 150, (2, -3, -200), False, WIDE),
    "positive_gap": (17, 4, 600, 90, (3, -2, 2), False, WIDE16),
}


@pytest.mark.parametrize("case", list(_SWW_CASES))
def test_smith_waterman_wide_matches_plain_and_jax(harness, case):
    """K3w's cells and tile carry (sww_rows: the warp's lanes, the carry
    row written by lane 31 and read back chunk by chunk by the next tile's
    lane 0) in the width kernels.sw_route picks (and in 32-bit lanes too
    where it picks the 16-bit pairs) against the port's plain version and
    the JAX package's jnp wavefront, exactly; the Pallas kernel
    (interpret mode) too on the first two."""
    seed, n, L, W, params, above_4, route = _SWW_CASES[case]
    reads, windows = _sww_rows(seed, n, L, W, above_4)
    plain = _sww_check(harness, reads, windows, params, route)
    if case in ("L640", "L1024"):
        pallas = np.asarray(jax_realign.smith_waterman_scores_pallas(
            jnp.asarray(reads), jnp.asarray(windows), *params, block_n=n,
            interpret=True))
        np.testing.assert_array_equal(plain, pallas)
    assert plain.min() == 0 and plain.max() > 8
    if case == "past_2_13":
        assert plain.max() >= 1 << 13


def _sww_trim_rows(seed, L, W, read_lengths, above_4=False):
    """A row a read extent of read_lengths (PAD past it, a non-PAD byte at
    it), against windows of extents that cycle through W, 0, 1, 31, 32,
    33, W - 5 and W // 2 + 1 (capped at W); each read holds a copy of a
    stretch of its window with one substitution, so that it scores; every
    third row a PAD inside the read and one inside the window, which
    trimming must keep; consecutive rows differ in length, so each 16-bit
    pair does. With above_4, a tenth of the bytes are 5-255."""
    rng = np.random.default_rng(seed)
    n = len(read_lengths)
    reads = rng.integers(0, 4, (n, L)).astype(np.uint8)
    windows = rng.integers(0, 4, (n, W)).astype(np.uint8)
    if above_4:
        for x in (reads, windows):
            spots = rng.random(x.shape) < 0.1
            x[spots] = rng.integers(5, 256, int(spots.sum()))
    cycle = [W, 0, 1, 31, 32, 33, W - 5, W // 2 + 1]
    for row, lr in enumerate(read_lengths):
        lw = min(W, cycle[row % len(cycle)])
        if min(lr, lw) > 8:
            length = int(rng.integers(min(lr, lw) // 2, min(lr, lw) + 1))
            at = int(rng.integers(0, lw - length + 1))
            start = int(rng.integers(0, lr - length + 1))
            reads[row, start:start + length] = windows[row, at:at + length]
            reads[row, start + length // 2] = (
                reads[row, start + length // 2] + 1) % 4
        if row % 3 == 1:
            if lr > 2:
                reads[row, int(rng.integers(0, lr - 1))] = PAD
            if lw > 2:
                windows[row, int(rng.integers(0, lw - 1))] = PAD
        reads[row, lr:] = PAD
        windows[row, lw:] = PAD
        if lr:
            reads[row, lr - 1] = rng.integers(0, 4)
        if lw:
            windows[row, lw - 1] = rng.integers(0, 4)
    return reads, windows


# (seed, L, W, read extents, scores, bytes above 4, route): every stripe
# the per-row choice can take (all in one tile; 10-16 in two and three),
# empty reads and windows, an odd count; L = 513 around the tile edge; a
# positive gap; bytes above 4 (32-bit lanes only)
_SWW_TRIM_LENGTHS = [0, 1, 32, 33, 512, 513, 600, 768, 769, 1024, 1025,
                     1100] + [32 * s - 10 for s in STRIPES]
_SWW_TRIM_CASES = {
    "every_stripe": (21, 1100, 160, _SWW_TRIM_LENGTHS, (1, -1, -1), False,
                     WIDE16),
    "L513": (22, 513, 100, [513, 512, 511, 480, 385, 384, 1, 0, 513, 257,
                            256, 513], (1, -1, -1), False, WIDE16),
    "positive_gap": (23, 600, 90, [600, 37, 599, 300, 0, 513, 64, 590],
                     (3, -2, 2), False, WIDE16),
    "above_4": (24, 700, 120, [700, 5, 650, 0, 400, 129, 699, 33, 512],
                (1, -1, -1), True, WIDE),
    "gap_past_a_byte": (25, 1100, 70, _SWW_TRIM_LENGTHS[::-2],
                        (2, -3, -200), False, WIDE),
}


@pytest.mark.parametrize("case", list(_SWW_TRIM_CASES))
def test_smith_waterman_wide_trims_each_row(harness, case):
    """K3w trims each row to its own extents (sww_plan: the warp's
    reduction over its lanes' runs finds 1 + the last non-PAD byte of the
    read and of the window; a PAD inside either is kept) and runs only the
    tiles and steps those need, with the stripe each row or pair picks;
    exact against the plain version and the JAX wavefront in both widths
    where the 16-bit pairs take the batch, with every stripe the batch
    width allows taken once its rows' extents call for it."""
    seed, L, W, lengths, params, above_4, route = _SWW_TRIM_CASES[case]
    reads, windows = _sww_trim_rows(seed, L, W, lengths, above_4)
    plan = np.zeros(5 + 64, np.int32)
    stripes = set()
    for row in range(len(lengths)):
        harness.sww_plan(_ptr(reads[row]), _ptr(windows[row]), L, W,
                         _ptr(plan))
        assert int(plan[0]) == lengths[row]
        assert windows[row, int(plan[1]):].tolist() == [PAD] * (W - plan[1])
        if lengths[row]:
            stripes.add(int(plan[2]))
    plain = _sww_check(harness, reads, windows, params, route)
    assert plain.max() > 8 and (plain[np.array(lengths) == 0] == 0).all()
    if case == "every_stripe":
        assert stripes == set(STRIPES)


def _stripe(length):
    """K3w's stripe for a read extent: the fewest tiles of at most 512
    positions, then the smallest stripe of STRIPES that covers the read
    in them."""
    tiles = max(1, -(-length // 512))
    return min(s for s in STRIPES if tiles * 32 * s >= length)


def _stripe_cap(L):
    """The largest stripe K3w's launch instantiates for a batch L wide: 4,
    8 or 16, at least every extent's up to L."""
    return 4 if L <= 128 else 8 if L <= 256 else 16


@pytest.mark.parametrize("L", [1, 31, 33, 128, 129, 256, 257, 512, 513,
                               640, 1024, 1025, 1100, 5000])
def test_smith_waterman_wide_plan(harness, L):
    """K3w's per-row plan (sww_plan) for reads of several extents in a
    batch L wide: the extent is 1 + the last non-PAD byte (a PAD inside
    kept); the stripe the fewest tiles of at most 512 positions, then the
    smallest stripe of STRIPES that covers the read in them, every tile but
    the last full; a full tile's steps the window's extent + 31, the last
    tile's the window's extent + (held - 1) / stripe; and no stripe past
    the cap the launch instantiates for width L (4, 8 or 16), which covers
    every extent up to L."""
    W = 300
    cap = _stripe_cap(L)
    assert max(_stripe(e) for e in range(1, L + 1)) <= cap
    plan = np.zeros(5 + 64, np.int32)
    rng = np.random.default_rng(L)
    for extent, win_extent in ((L, W), (max(1, L // 3), 1), (1, W - 7),
                               (max(1, L - 1), 150), (0, W), (L, 0)):
        read = np.full(L, PAD, np.uint8)
        read[:extent] = rng.integers(0, 4, extent)
        if extent > 2:
            read[extent // 2] = PAD
        window = np.full(W, PAD, np.uint8)
        window[:win_extent] = rng.integers(0, 4, win_extent)
        harness.sww_plan(_ptr(read), _ptr(window), L, W, _ptr(plan))
        got_r, got_w, stripe, tiles, got_cap = (int(x) for x in plan[:5])
        assert (got_r, got_w, got_cap) == (extent, win_extent, cap)
        if extent == 0:
            assert tiles == 0
            continue
        assert stripe == _stripe(extent) <= cap
        assert tiles == -(-extent // 512)
        assert (tiles - 1) * 32 * stripe < extent <= tiles * 32 * stripe
        held = extent - (tiles - 1) * 32 * stripe
        assert plan[5:5 + tiles].tolist() == [win_extent + 31] * (tiles - 1) \
            + [win_extent + (held - 1) // stripe]


@pytest.mark.parametrize("L,W,params,byte,route", [
    (513, 256, (1, -1, -1), 3, WIDE16),
    (640, 256, (1, -1, -1), 4, WIDE16),
    (5000, 3000, (1, -1, -1), 0, WIDE16),      # 5,000 < 2^13
    (640, 256, (1, -1, -1), 5, WIDE),          # a byte above code 4
    (640, 256, (1, -1, -1), 255, WIDE),
    (8192, 256, (1, -1, -1), 0, WIDE),         # h could reach 2^13
    (640, 256, (13, -1, -1), 0, WIDE),         # 13 * 640 = 8,320
    (640, 256, (1, -1, 9), 0, WIDE),           # 640 + 9 * 896 > 2^13
    (640, 256, (1, -200, -1), 0, WIDE),        # mismatch - gap = -199
    (512, 256, (1, -1, -1), 0, "smith_waterman"),
])
def test_smith_waterman_route(L, W, params, byte, route):
    """sw_route, before any launch: past 512 positions, a batch of codes
    0-4 whose scores fit 16 bits goes to K3w's 16-bit pairs; a byte of 5
    or more, or scores that could reach 2^13 or leave a signed byte, to
    its 32-bit lanes; up to 512 positions K3 keeps its route."""
    from arriba_tpu_torch import kernels

    reads = torch.zeros(3, L, dtype=torch.uint8)
    windows = torch.ones(3, W, dtype=torch.uint8)
    reads[1, L - 1] = byte
    before = dict(kernels.launch_counts)
    assert kernels.sw_route(reads, windows, *params) == route
    assert kernels.launch_counts == before


@pytest.mark.parametrize("L,W,params,ok", [
    (640, 256, (1, -1, -1), True),
    (100000, 100000, (10000, -1, -1), True),     # 10^9 + 10^4 < 2^31
    (100000, 100000, (30000, -1, -1), False),    # 3 * 10^9
    (1000, 1000, (1, -1, 1 << 20), True),        # ~2.1e9 - 2.1e9 ... fits
    (1000, 1000, (1, -1, 1 << 21), False),       # 2^21 * 2000 > 2^31
    (10, 10, (1, -(1 << 31), -1), True),
    (10, 10, (1, -(1 << 31) - 1, -1), False),    # not an int32
    (10, 10, (1 << 31, -1, -1), False),
])
def test_smith_waterman_wide_guard(L, W, params, ok):
    """K3w's int32 guard, from shapes and scores alone: every h and sum
    inside int32, where the JAX op's own sums are exact."""
    from arriba_tpu_torch import kernels

    if ok:
        kernels.sw_wide_guard(L, W, *params)
    else:
        with pytest.raises(ValueError):
            kernels.sw_wide_guard(L, W, *params)


# each regime of mk_plan: digits of 4 bits (k <= 8, four tiles a group), of
# 5 and 6 bits (three tiles), of 7-12 bits (two tiles), one tile a group
_MK_PLAN_REGIMES = {
    "digit4": range(1, 9),
    "digit5": range(9, 17),
    "digit6": range(17, 33),
    "digit7_12": list(range(33, 130)) + [255, 256, 257, 1024, 2047, 2048],
    "one_tile": [2049, 4096, 1 << 20, 1 << 30, (1 << 31) - 1],
}


@pytest.mark.parametrize("regime", list(_MK_PLAN_REGIMES))
def test_mxu_any_k_plan(harness, regime):
    """mk_plan's digits, for every k of a regime: 2^(D - 1) >= k, the bias
    b = 2^(D-1) - k in every digit, the mask on bit D - 1 of every digit,
    tile j weighted 2^(D j) through an A shift and a B image scale (1 or
    64) of at most 2^6 each, the sum below 2^31, and the images' k-steps
    within the budget; one tile a group (k > 2,048) has no bias and no
    mask (the test is the largest dot against k); k = 8 gives K4's own
    test (no bias, mask 0x8888)."""
    for k in _MK_PLAN_REGIMES[regime]:
        fields = np.zeros(16, np.int64)
        harness.mk_plan_fields(k, _ptr(fields))
        kk, ksteps, digit, groups, images, kchunk, bias, mask = (
            int(x) for x in fields[:8])
        m = digit - 1
        assert kk == k and ksteps == -(-k // 8), k
        assert 2 ** m >= k and (m == 3 or 2 ** (m - 1) < k), k
        assert digit * (groups - 1) <= 12 and 1 <= groups <= 4, k
        assert groups == 1 or digit * groups > 12 or groups == 4, k
        assert images == (2 if groups > 1 else 1), k
        assert 1 <= kchunk <= ksteps and images * kchunk * 5120 <= 98304, k
        if groups == 1:
            assert k > 2048 and bias == mask == 0, k
            continue
        assert bias == sum((2 ** m - k) << (digit * j)
                           for j in range(groups)), k
        assert mask == sum(1 << (m + digit * j) for j in range(groups)), k
        assert (2 ** m) << (digit * (groups - 1)) < 2 ** 31, k
        for j in range(groups):
            a_shift, image = int(fields[8 + 2 * j]), int(fields[9 + 2 * j])
            assert 0 <= a_shift <= 6, k
            assert a_shift + 6 * image == digit * j, k
        if k == 8:
            assert (bias, mask, groups) == (0, 0x8888, 4)


def _mk_any_rows(k, seed, n=10, L=60, W=400):
    """Rows for the any-k screen: reads over codes {0, 1}, windows over
    {2, 3} (no k-mer shared by chance), a read k-mer planted in the window
    of rows 0, 2, 4 (at the window's last k-mer in row 4), one holding PAD
    in row 6 and one holding a byte above 4 in row 8 (neither shared), PAD
    tails in the odd rows."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 2, (n, L)).astype(np.uint8)
    windows = rng.integers(2, 4, (n, W)).astype(np.uint8)
    for row in range(0, n, 2):
        kmer = rng.integers(0, 4, k).astype(np.uint8)
        if row == 6:
            kmer[k // 2] = PAD
        elif row == 8:
            kmer[(k - 1) // 3] = int(rng.integers(5, 256))
        start = int(rng.integers(0, L - k + 1))
        at = W - k if row == 4 else int(rng.integers(0, W - k + 1))
        reads[row, start:start + k] = kmer
        windows[row, at:at + k] = kmer
    for row in range(1, n, 2):
        reads[row, int(rng.integers(k, L + 1)):] = PAD
        windows[row, int(rng.integers(k, W + 1)):] = PAD
    return reads, windows


def _mk_any_emulate(harness, reads, windows, k, grid):
    """The any-k kernel's emulation (mk_any_rows) over the rows with grid
    blocks: verdicts (bool [n]) and each row's first tile with a hit; no
    fault of the ring's schedule or of the accumulator's parts."""
    (n, L), W = reads.shape, windows.shape[1]
    verdict = np.zeros(n, np.uint8)
    first = np.zeros(n, np.int64)
    faults = harness.mk_any_rows(_ptr(reads), _ptr(windows), _ptr(verdict),
                                 _ptr(first), n, L, W, k, grid)
    assert faults == 0, k
    return verdict != 0, first


def _mk_any_check(harness, reads, windows, k, want=None):
    """The emulation with a block a row and with 3 blocks taking rows in
    turn, against the port's plain version and the JAX op at k (past k =
    80 against the k-mer sets instead: XLA would compile one slice a
    position), exactly; each row's first tile against mxu_work (k <= 31).
    Returns the plain verdicts."""
    reads, windows = np.ascontiguousarray(reads), np.ascontiguousarray(
        windows)
    n = len(reads)
    verdict, first = _mk_any_emulate(harness, reads, windows, k, n)
    r, w = torch.from_numpy(reads), torch.from_numpy(windows)
    plain = realign.mxu_shared_kmer_mask_plain(r, w, k).numpy()
    np.testing.assert_array_equal(verdict, plain)
    in_turn = _mk_any_emulate(harness, reads, windows, k, 3)
    np.testing.assert_array_equal(in_turn[0], plain)
    np.testing.assert_array_equal(in_turn[1], first)
    if k <= 80:
        xla = np.asarray(jax_realign.mxu_shared_kmer_mask(
            jnp.asarray(reads), jnp.asarray(windows), k=k))
        np.testing.assert_array_equal(plain, xla)
    else:
        def kmers(x):
            return {x[p:p + k].tobytes() for p in range(len(x) - k + 1)
                    if x[p:p + k].max() <= 3}
        shared = [bool(kmers(r_) & kmers(w_))
                  for r_, w_ in zip(reads, windows)]
        np.testing.assert_array_equal(plain, shared)
    if k <= 31:
        work = mxu_work(r, w, k)
        np.testing.assert_array_equal(first, work["first_tile"].numpy())
        np.testing.assert_array_equal(plain, work["verdict"].numpy())
    if want is not None:
        assert plain.tolist() == want, k
    return plain


def _mk_any_layout(harness, k):
    fields = np.zeros(11, np.int64)
    harness.mk_any_layout_fields(k, _ptr(fields))
    return dict(zip(("chunk", "groups", "parts", "bases", "read_slot",
                     "window_slot", "words", "read_at", "window_at",
                     "words_at", "bytes"), (int(x) for x in fields)))


# k = 1 to 31 (one to four k-steps, digits of 4 to 6 bits, 3 or 4 tiles a
# group), k = 8 (the plan at K4's own k), k = 40 (two tiles a group), k =
# 80 (more k-steps than the images hold: two parts a stage) and k = 2,049
# (one tile a group, the largest dot tested against k, 14 parts)
@pytest.mark.parametrize("k,L,W", [(1, 60, 400), (4, 60, 400),
                                   (12, 60, 400), (16, 60, 400),
                                   (31, 60, 400), (8, 200, 300),
                                   (40, 90, 300), (80, 120, 200),
                                   (2049, 2100, 2120)])
def test_mxu_any_k_emulation_matches_plain_and_jax(harness, k, L, W):
    """K4's any-k kernel (mk_any_rows: each stage from the bytes the
    kernel copies, the window's one-hot word table, every k-step of a
    group's tiles into one accumulator started at the plan's bias, the
    scaled B images per k-step read back through the descriptor, the fold
    and the mask, the block's vote after every group),
    with a block a row and with 3 blocks taking rows in turn through the
    copy ring, against the port's plain version and the JAX package's
    mxu_shared_kmer_mask at that k, exactly; each row's first tile with a
    hit against mxu_work (k <= 31). Row 4's k-mer is the window's last."""
    reads, windows = _mk_any_rows(k, k * 101 + L, L=L, W=W)
    _mk_any_check(harness, reads, windows, k,
                  [row in (0, 2, 4) for row in range(len(reads))])


@pytest.mark.parametrize("k,L", [(12, 60), (31, 60), (80, 120)])
def test_mxu_any_k_emulation_straddles_chunks(harness, k, L):
    """A k-mer that straddles a stage's chunk boundary (1,920 window
    k-mers a stage at k = 12, 1,728 at k = 31; 128 at k = 80, two parts a
    stage), one at the 2,048th k-mer and one at the window's
    last (chip_smoke's 'straddle' rows, 8 of L x 2,300): the stage's
    copied bytes (chunk + k - 1, mk_any_bytes) hold every base of them, as
    the emulation finds against the plain version and the JAX op. The
    rows' chunk is the layout's."""
    reads, windows = mxu_inputs("straddle", N=8, L=L, W=2300, k=k,
                                chunk=_mk_any_layout(harness, k)["chunk"])
    _mk_any_check(harness, reads, windows, k,
                  [row % 2 == 0 for row in range(len(reads))])


@pytest.mark.parametrize("k", [12, 31])
def test_mxu_any_k_emulation_rows_in_turn(harness, k):
    """chip_smoke's mixed rows at k (no hit, or a read k-mer planted in the
    window's first 16th, anywhere, or at its last k-mer), 16 rows of 152 x
    4,000, three stages a row: with 3 blocks a row decided in its first
    stage leaves its next stages, and the next row's first, in the ring,
    which the block waits for and skips (mk_any_rows counts a fault of
    that schedule), and every verdict equals the plain version's."""
    reads, windows = mxu_inputs("mixed", N=16, W=4000, k=k)
    plain = _mk_any_check(harness, reads, windows, k)
    assert 0 < plain.sum() < len(plain)


# the k where mk_any_layout changes: one k-step, the images' last k-step
# with two tiles a group (72) and past it (73: two parts), two tiles a
# group up to 2,048, one tile from 2,049, and k far past any stage
_MK_LAYOUT_K = [1, 7, 9, 12, 16, 17, 31, 32, 33, 40, 72, 73, 80, 151, 152,
                153, 2048, 2049, 4096, 100000, 1 << 30]


# the chunk at chip_smoke's k and where the layout changes
_MK_CHUNK_K = (1, 12, 16, 31, 40, 72, 80)
_MK_CHUNKS = [2048, 1920, 1920, 1728, 512, 2048, 128]


def test_mxu_any_k_layout(harness):
    """mk_any_layout at each k: a row has one part while the images hold
    every k-step (k <= 72), and then a chunk is at most the groups in
    2,048 k-mers; past k = 72 a part of plan.kchunk k-steps is a stage and
    a chunk one group (128 k-mers, 64 past 2,048). Of those, the chunk
    holds the most groups that let the most blocks (4 down to 2) share an
    SM's shared memory: 1,728 k-mers at k = 31 (four blocks an SM), 512 at k = 40. The slots hold
    the largest span mk_span can give (up to 15 bytes each side, a
    multiple of 16), the word table chunk - 1 + the bases a stage covers,
    the regions follow each other at 16-byte boundaries, and a block's
    shared memory stays within the H100's 227 KB at every k."""
    plan = np.zeros(16, np.int64)
    for k in _MK_LAYOUT_K:
        lay = _mk_any_layout(harness, k)
        harness.mk_plan_fields(k, _ptr(plan))
        ksteps, groups, images, kchunk = (int(plan[1]), int(plan[3]),
                                          int(plan[4]), int(plan[5]))
        span = 64 * groups
        assert lay["parts"] == -(-ksteps // kchunk), k
        assert (lay["parts"] == 1) == (k <= 72), k
        if lay["parts"] == 1:
            assert 1 <= lay["groups"] <= 2048 // span, k
        else:
            assert lay["groups"] == 1, k
        assert lay["chunk"] == lay["groups"] * span, k
        assert any(lay["bytes"] <= 233472 // blocks - 1152
                   for blocks in (4, 3, 2)), k
        bases = min(k, 8 * kchunk)
        assert lay["bases"] == bases, k
        for slot, kmers in (("read_slot", 160), ("window_slot",
                                                lay["chunk"])):
            assert lay[slot] % 16 == 0, k
            assert lay[slot] >= -(-(15 + kmers - 1 + bases) // 16) * 16, k
        assert lay["words"] == lay["chunk"] - 1 + bases, k
        assert lay["read_at"] == images * kchunk * 5120, k
        assert lay["window_at"] == lay["read_at"] + 4 * lay["read_slot"], k
        assert lay["words_at"] == lay["window_at"] + 4 * lay["window_slot"]
        assert lay["bytes"] == lay["words_at"] + 4 * lay["words"], k
        assert lay["bytes"] <= 232448 - 128, k
    assert [_mk_any_layout(harness, k)["chunk"]
            for k in _MK_CHUNK_K] == _MK_CHUNKS


@pytest.mark.parametrize("k", [1, 12, 31, 72, 80, 2049, 5000])
def test_mxu_any_k_stage_bytes(harness, k):
    """mk_any_bytes for every (slab or chunk, part) of a row: a stage's
    bytes start at base 8 c0 of its first k-mer and run to the last base
    of its part of its last k-mer (its k-mers - 1 + the part's bases),
    clipped to the row and never empty; the parts' bases tile the k-mer's
    k bases; mk_span's copy of them fits the slot."""
    lay = _mk_any_layout(harness, k)
    plan = np.zeros(16, np.int64)
    harness.mk_plan_fields(k, _ptr(plan))
    kchunk = int(plan[5])
    out = np.zeros(2, np.int64)
    for n, kmers, slot in ((k + 300, 160, "read_slot"),
                           (k + 5000, lay["chunk"], "window_slot")):
        for first in range(0, n - k + 1, kmers):
            covered = []
            for part in range(lay["parts"]):
                c0 = part * kchunk
                harness.mk_any_bytes_of(k, first, kmers, c0, n, _ptr(out))
                start, count = int(out[0]), int(out[1])
                bases = min(8 * kchunk, k - 8 * c0)
                assert start == first + 8 * c0, (k, first, part)
                assert count == min(kmers - 1 + bases, n - start) >= 1
                for shift in range(16):
                    assert -(-(shift + count) // 16) * 16 <= lay[slot], k
                covered += range(8 * c0, 8 * c0 + bases)
            assert covered == list(range(k)), k


@pytest.mark.parametrize("k,grid,block", [(12, 1, 0), (80, 3, 1),
                                          (2049, 2, 0)])
def test_mxu_any_k_cursor(harness, k, grid, block):
    """MkCursor over slab x chunk x part at any k: block b of grid copies
    its rows b, b + grid, ... in turn, each as its slabs, each slab's
    chunks, each chunk's parts, and copies nothing of a row past the stage
    a hit decides it at (rows 1 and 4 here, at their second stage)."""
    n, L, W = 7, k + 170, k + 300
    lay = _mk_any_layout(harness, k)
    slabs = -(-(L - k + 1) // 160)
    chunks = -(-(W - k + 1) // lay["chunk"])
    decided_at = np.full(n, -1, np.int32)
    decided_at[[1, 4]] = 1
    out = np.zeros((4096, 4), np.int32)
    count = harness.mk_any_schedule(n, grid, block, L, W, k,
                                    _ptr(decided_at), _ptr(out), 4096)
    want = []
    for row in range(block, n, grid):
        stages = [(row, slab, chunk, part) for slab in range(slabs)
                  for chunk in range(chunks) for part in range(lay["parts"])]
        if decided_at[row] >= 0:
            stages = stages[:decided_at[row] + 1]
        want += stages
    assert [tuple(x) for x in out[:count].tolist()] == want


@pytest.mark.parametrize("k,s,c0,shift", [(12, 0, 0, 0), (12, 1, 0, 5),
                                          (31, 3, 0, 6), (80, 9, 9, 4),
                                          (2049, 256, 247, 0)])
def test_mxu_any_k_word_table_fragments(harness, k, s, c0, shift):
    """A warp's A fragments of k-step s from a stage's one-hot word table
    (mk_any_a_words, words indexed by mk_any_word_index): A[i, 4j + c] =
    2^shift where base 8 s + j < k and the stage's byte t0 + i + 8 (s -
    c0) + j holds code c <= 3, else 0 (a byte past the stage's n bytes
    too)."""
    rng = np.random.default_rng(k + s)
    n = 100
    stage = rng.integers(0, 6, n).astype(np.uint8)
    for t0 in (0, 16, 48):
        got = np.zeros((16, 32), np.int8)
        harness.mk_any_a_matrix(_ptr(stage), n, k, t0, s, c0, shift,
                                _ptr(got))
        want = np.zeros((16, 32), np.int8)
        for i in range(16):
            for j in range(8):
                at = t0 + i + 8 * (s - c0) + j
                if 8 * s + j < k and at < n and stage[at] <= 3:
                    want[i, 4 * j + stage[at]] = np.int8(1 << shift)
        np.testing.assert_array_equal(got, want)


def _accept_low_min_score_rows(seed, N=16, L=128, W=512):
    """_accept_rows with min_score -2^20 + 1 in every other row, and by
    row % 8 at 1 and 3 read_len - 2^20 (an unseeded walk's reach: every
    diagonal walked) and read_len - 2^20 + 1 (the seed lookup); rows 14 and
    15 with disjoint read and window alphabets, so no cell matches and
    even the lowest min_score rejects."""
    reads, windows, params = _accept_rows(seed, N, L, W)
    neg = -(1 << 20)
    params[::2, 2] = neg + 1
    params[1::8, 2] = params[1::8, 0] + neg
    params[3::8, 2] = params[3::8, 0] + neg + 1
    for row in (14, 15):
        read_len, win_len = int(params[row, 0]), int(params[row, 1])
        reads[row, :read_len] = ord("A")
        windows[row, :win_len] = np.where(np.arange(win_len) % 2, ord("C"),
                                          ord("G"))
    return reads, windows, params


def test_accept_every_diagonal_mode_matches_plain_and_jax(harness):
    """K1's rows whose min_score an unseeded walk can reach (down to
    -2^20 + 1): the kernel's per-row procedure (aw_rows_seeded, which walks
    every diagonal of such a row) against the port's plain version, the
    JAX package's XLA twin and its Pallas kernel (interpret mode),
    exactly; each diagonal walked at most once."""
    reads, windows, params = _accept_low_min_score_rows(23)
    seeded, claims = _seed_lookup(harness, reads, windows, params)
    plain = realign.accept_wavefront(torch.from_numpy(reads),
                                     torch.from_numpy(windows),
                                     torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(windows),
        *(jnp.asarray(params[:, c]) for c in range(5))))
    pallas_params = np.zeros((len(reads), 128), np.int32)
    pallas_params[:, :5] = params
    pallas = np.asarray(jax_realign._accept_wavefront_pallas(
        jnp.asarray(reads), jnp.asarray(windows), jnp.asarray(pallas_params),
        block_n=len(reads), interpret=True))
    np.testing.assert_array_equal(seeded, plain)
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(plain, pallas)
    assert claims.max() <= 1
    # the rows the host helper names walk (claim) every diagonal that holds
    # a valid cell, the others only seeded ones
    from arriba_tpu_torch import kernels

    walks_all = kernels.accept_walks_all(torch.from_numpy(params),
                                         reads.shape[1]).numpy()
    assert walks_all.tolist() == [row % 2 == 0 or row % 8 == 1
                                  for row in range(len(reads))]
    L = reads.shape[1]
    for row, (read_len, win_len) in enumerate(params[:, :2]):
        walked = claims[row, L - read_len:L - 1 + win_len]
        assert walked.all() == walks_all[row], row
    assert not plain[14] and not plain[15]
    assert plain[:14:2].all()
