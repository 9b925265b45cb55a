// K5: the 8-mer bitmap screen of filter_mismappers (the sound REJECT), for
// sm_90a, in two passes.
//
// Replaces: arriba_tpu/ops/realign.py:61 shared_kmer_mask (a jax.jit op,
// reached from _screen_kernel at :290 and screen_pairs at :686), which
// sorts every row's window 8-mers and binary-searches the read's in them,
// one dense [rows, 8,192] window copy a (read, window chunk, orientation)
// row.
//
// What bounds it: integer operations. The inputs are the gene windows,
// each on the card once in a byte table (ops/realign.resident_pairs), and
// a few integers a (read, window) pair; the work is each distinct window's
// 8-mers set in a bitmap once, and each pair's read 8-mers tested against
// it up to the first that is set. chip_smoke.py counts both from its
// inputs (kb_work).
//
// Design: two kernels on the caller's stream, the second launched after
// the first (the stream orders them; no block waits for another).
//  1. Build: a block a slice, (window rank, first position) of the slice
//     table (ops/realign.screen_schedule: each window the tasks name cut
//     into slices of `slice` positions). It clears an 8 KB bitmap in
//     shared memory; its warps take the slice's 16-byte groups 31 at a
//     time from the table's 16-byte boundary at or before the slice
//     (kb_slice_first_group), a lane a group: one 16-byte load, coded four
//     bytes a word at once (kb_code16), the next lane's codes (a shuffle)
//     ending its 8-mers, so a group is loaded and coded once (a chunk's
//     32nd again as the next chunk's first). Each position's 8-mer sets
//     its bit with a shared atomicOr, except that a homopolymer's bit is
//     read first (an N or A run is one 8-mer, 65,535, one hot word). The
//     window's only slice stores the bitmap whole; the slices of a longer
//     window OR their non-zero words into its zeros. The bitmaps, uint32
//     [windows used, 2,048], are indexed by the window's rank among the
//     windows the tasks name.
//  2. Test: a block a task, (window, first row, end row) of rows sorted by
//     window. It copies its window's finished bitmap into shared memory
//     (16-byte loads into registers, stored once the first batch of rows'
//     loads is issued), then tests its rows, a warp a row: each warp
//     stages 8 rows at a time, their first 4 groups (the first 32 tests'
//     bytes) a lane a group, coded once into the rows' stages in shared
//     memory; a row's later tests stage 32 groups at a time where they
//     need them (kb_restage).
//     The lanes take 32 tests at a time, the forward 8-mers, then the
//     reverse complement's, each 8-mer one shift of two staged words, up
//     to the first group of 32 with a set bit.
// What this does about the one-pass kernel's costs: no task scans a
// window (a window shared by many tasks is set once, over as many blocks
// as it has slices, so the longest window no longer sets one block's
// time); the task size only trades the bitmap copy against the rows a
// block takes; a test reads two staged words, not 8 global bytes, and a
// row that hits in its first 32 tests has 4 of its groups coded, not 2 L
// bytes. What is left: the shared atomics of the build pass (their bank
// conflicts) and the coding, both counted in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_bitmap_screen.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// rows a warp of the test pass stages at a time: their first groups, a
// lane a group
constexpr int kBatch = 32 / arriba::KB_FIRST_GROUPS;

__global__ void __launch_bounds__(kBlock)
kmer_bitmap_build_kernel(const uint8_t* __restrict__ table,
                         const int64_t* __restrict__ offsets,
                         const int32_t* __restrict__ lengths,
                         const int32_t* __restrict__ rank_window,
                         const int32_t* __restrict__ slices,
                         uint32_t* __restrict__ bitmaps, int n_used,
                         int n_windows, long long table_bytes, int slice) {
    __shared__ __align__(16) uint32_t bitmap[arriba::KB_WORDS];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid / 32;
    const int rank = slices[2 * (size_t)blockIdx.x];
    const int p0 = slices[2 * (size_t)blockIdx.x + 1];
    if (rank < 0 || rank >= n_used || p0 < 0) return;
    long long first;
    int len;
    arriba::kb_window(offsets, lengths, rank_window[rank], n_windows,
                      table_bytes, &first, &len);
    const int p1 = arriba::kb_slice_end(p0, len, slice);
    if (p1 <= p0) return;  // the whole block: the slice is empty

    for (int w = tid; w < arriba::KB_WORDS / 4; w += kBlock) {
        reinterpret_cast<uint4*>(bitmap)[w] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    // a warp's chunks of KB_CHUNK_GROUPS groups, a lane a group (lane 31's
    // codes end lane 30's 8-mers), the next chunk's loads issued before
    // this one's codes are used
    const int g0 = arriba::kb_slice_first_group(first, p0);
    const int n_groups = arriba::kb_slice_groups(g0, p1);
    auto load = [&](int chunk, uint32_t raw[4]) {
        const int s = g0 + arriba::KB_GROUP
            * (arriba::KB_CHUNK_GROUPS * chunk + lane);
        if (arriba::kb_needs_next(s - arriba::KB_GROUP, p1)) {
            arriba::kb_load16(table, table_bytes, first + s, raw);
        } else {
            raw[0] = raw[1] = raw[2] = raw[3] = 0;
        }
    };
    uint32_t raw[4], next[4];
    int chunk = warp;
    if (arriba::KB_CHUNK_GROUPS * chunk < n_groups) load(chunk, raw);
    for (; arriba::KB_CHUNK_GROUPS * chunk < n_groups; chunk += kWarps) {
        if (arriba::KB_CHUNK_GROUPS * (chunk + kWarps) < n_groups) {
            load(chunk + kWarps, next);
        }
        uint32_t c0, c1, pad;
        arriba::kb_code16(raw, &c0, &pad);
        c1 = __shfl_down_sync(0xffffffffu, c0, 1);
        const int s = g0 + arriba::KB_GROUP
            * (arriba::KB_CHUNK_GROUPS * chunk + lane);
        if (lane < arriba::KB_CHUNK_GROUPS && s < p1) {
            int lo, hi;
            arriba::kb_group_span(s, p0, p1, &lo, &hi);
#pragma unroll
            for (int o = 0; o < arriba::KB_GROUP; ++o) {
                if (o < lo || o >= hi) continue;
                // a homopolymer's bit is read first, so that a run of one
                // base does not queue atomics on one word
                const int kmer = arriba::kb_kmer_at(c0, c1, o);
                const uint32_t mask = arriba::kb_mask(kmer);
                if (!arriba::kb_homopolymer(kmer)
                    || (bitmap[kmer >> 5] & mask) == 0) {
                    atomicOr(bitmap + (kmer >> 5), mask);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) raw[k] = next[k];
    }
    __syncthreads();

    // the window's only slice stores its bitmap whole; slices of a longer
    // window OR their words into the zeros
    uint32_t* out = bitmaps + (size_t)rank * arriba::KB_WORDS;
    if (arriba::kb_whole_window(p0, p1, len)) {
        for (int w = tid; w < arriba::KB_WORDS / 4; w += kBlock) {
            reinterpret_cast<uint4*>(out)[w] =
                reinterpret_cast<const uint4*>(bitmap)[w];
        }
        return;
    }
    for (int w = tid; w < arriba::KB_WORDS; w += kBlock) {
        const uint32_t v = bitmap[w];
        if (v != 0) atomicOr(out + w, v);
    }
}

// A warp's rows, kBatch at a time: the read ids 32 rows at a time, a lane
// a row; the first KB_FIRST_GROUPS groups of each of kBatch rows loaded
// and coded together, a lane a group, into the rows' stages.
struct TestRows {
    int r0;     // the warp's first row; its rows are r0 + kWarps k
    int count;  // its rows
    int ids;    // this lane's read id among the warp's next 32 rows
    uint32_t valid;  // which of those 32 rows name a read of the table
};

using Stage = uint32_t[arriba::KB_STAGE_GROUPS + 1];

__device__ inline void stage_batch(const uint8_t* __restrict__ reads,
                                   const int32_t* __restrict__ row_read,
                                   TestRows* rows, int k0, int lane, int L,
                                   int n_read_rows, Stage* codes,
                                   Stage* pads) {
    if (k0 % 32 == 0) {
        rows->ids = k0 + lane < rows->count
            ? row_read[rows->r0 + kWarps * (k0 + lane)] : -1;
        rows->valid = __ballot_sync(
            0xffffffffu, arriba::kb_read_row(reads, rows->ids, n_read_rows,
                                             L) != nullptr);
    }
    const int b = lane / arriba::KB_FIRST_GROUPS;
    const int g = lane % arriba::KB_FIRST_GROUPS;
    const int read = __shfl_sync(0xffffffffu, rows->ids, (k0 + b) & 31);
    uint32_t c = 0, pad = 0xffffu;
    if (k0 + b < rows->count && g < 2 * L / arriba::KB_GROUP
        && (rows->valid >> ((k0 + b) & 31) & 1)) {
        uint32_t w[4];
        arriba::kb_load16(reads, (long long)n_read_rows * L,
                          2LL * read * L + arriba::KB_GROUP * g, w);
        arriba::kb_code16(w, &c, &pad);
    }
    __syncwarp();  // every lane is done with the last batch's stages
    codes[b][g] = c;
    pads[b][g] = pad;
    __syncwarp();
}

// A row's tests from base on, 32 at a time, from its stage (n groups from
// group s0), staged again where the tests need other groups; true at the
// first group of 32 with a set bit.
__device__ inline bool test_rest(const uint8_t* __restrict__ reads,
                                 const uint32_t* bitmap, uint32_t* codes,
                                 uint32_t* pads, int read, int base, int s0,
                                 int n, int lane, int L, int n_read_rows) {
    const int n_tests = arriba::kb_row_tests(L);
    const int row_groups = 2 * L / arriba::KB_GROUP;
    bool hit = false;
    for (; base < n_tests && !hit; base += 32) {
        int g0, g1;
        arriba::kb_test_groups(base, n_tests, L, &g0, &g1);
        if (arriba::kb_restage(s0, n, g0, g1)) {
            s0 = g0;
            n = arriba::KB_STAGE_GROUPS;
            __syncwarp();  // every lane is done with the stage
            uint32_t c = 0, pad = 0xffffu;
            if (s0 + lane < row_groups) {
                uint32_t w[4];
                arriba::kb_load16(reads, (long long)n_read_rows * L,
                                  2LL * read * L
                                      + (long long)arriba::KB_GROUP
                                            * (s0 + lane),
                                  w);
                arriba::kb_code16(w, &c, &pad);
            }
            codes[lane] = c;
            pads[lane] = pad;
            __syncwarp();
        }
        const int q = base + lane;
        const bool set = q < n_tests
            && arriba::kb_test(bitmap, arriba::kb_staged_kmer(codes, pads,
                                                              s0, q, L));
        hit = __any_sync(0xffffffffu, set);
    }
    return hit;
}

// The bitmap by 16-byte loads into registers, stored once the first
// batch is staged, so that the copy overlaps the first batch's loads.
__global__ void __launch_bounds__(kBlock)
kmer_bitmap_test_kernel(const uint8_t* __restrict__ reads,
                        const int32_t* __restrict__ row_read,
                        const int32_t* __restrict__ tasks,
                        const int32_t* __restrict__ task_rank,
                        const uint32_t* __restrict__ bitmaps,
                        uint8_t* __restrict__ out, int n_rows, int L,
                        int n_read_rows, int n_used) {
    __shared__ __align__(128) uint32_t bitmap[arriba::KB_WORDS];
    __shared__ Stage codes[kWarps][kBatch];
    __shared__ Stage pads[kWarps][kBatch];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid / 32;
    const int rank = task_rank[blockIdx.x];
    const bool has_bitmap = rank >= 0 && rank < n_used;
    const uint4* src = reinterpret_cast<const uint4*>(
        bitmaps + (size_t)(has_bitmap ? rank : 0) * arriba::KB_WORDS);
    constexpr int kWords = arriba::KB_WORDS / 4 / kBlock;  // uint4 a thread
    uint4 words[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
        words[k] = has_bitmap ? src[tid + kBlock * k]
                              : make_uint4(0, 0, 0, 0);
    }

    const int32_t* task = tasks + 3 * (size_t)blockIdx.x;
    const int end = min(task[2], n_rows);
    TestRows rows;
    rows.r0 = max(task[1], 0) + warp;
    rows.count = end > rows.r0 ? (end - rows.r0 + kWarps - 1) / kWarps : 0;
    if (rows.count > 0) {
        stage_batch(reads, row_read, &rows, 0, lane, L, n_read_rows,
                    codes[warp], pads[warp]);
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
        reinterpret_cast<uint4*>(bitmap)[tid + kBlock * k] = words[k];
    }
    __syncthreads();  // the bitmap

    // every row's first 32 tests read the same places of its first groups:
    // this lane's test, its byte, and whether the first stage holds them
    const int n_tests = arriba::kb_row_tests(L);
    const bool ok_first = lane < n_tests;
    const int at_first = arriba::kb_test_byte(lane, L);
    int g0_first, g1_first;
    arriba::kb_test_groups(0, n_tests, L, &g0_first, &g1_first);
    const bool first_staged = n_tests > 0
        && !arriba::kb_restage(0, arriba::KB_FIRST_GROUPS, g0_first,
                               g1_first);
    for (int k0 = 0; k0 < rows.count; k0 += kBatch) {
        if (k0 > 0) {
            stage_batch(reads, row_read, &rows, k0, lane, L, n_read_rows,
                        codes[warp], pads[warp]);
        }
        const int nb = min(kBatch, rows.count - k0);
        uint32_t hits = 0;  // bit b: row k0 + b shares an 8-mer
        for (int b = 0; b < nb; ++b) {
            if (!(rows.valid >> ((k0 + b) & 31) & 1)) continue;
            uint32_t* stage_codes = codes[warp][b];
            uint32_t* stage_pads = pads[warp][b];
            bool hit = false;
            int base = 0;
            if (first_staged) {
                hit = __any_sync(0xffffffffu,
                                 ok_first && arriba::kb_test(
                                     bitmap, arriba::kb_stage_kmer(
                                                 stage_codes, stage_pads,
                                                 at_first)));
                base = 32;
            }
            if (!hit && base < n_tests) {
                const int read =
                    __shfl_sync(0xffffffffu, rows.ids, (k0 + b) & 31);
                hit = test_rest(reads, bitmap, stage_codes, stage_pads, read,
                                base, 0, arriba::KB_FIRST_GROUPS, lane, L,
                                n_read_rows);
            }
            hits |= (hit ? 1u : 0u) << b;
        }
        if (lane < nb) out[rows.r0 + kWarps * (k0 + lane)] = hits >> lane & 1;
    }
}

}  // namespace

extern "C" {

// The build pass: table uint8 [table_bytes] (raw window bytes, from a
// 16-byte boundary), offsets int64 [n_windows] and lengths int32
// [n_windows] (each window's span of the table), rank_window int32
// [n_used] (the window of each rank), slices int32 [n_slices, 2] (window
// rank, first position; `slice` positions each, a multiple of 16);
// bitmaps uint32 [n_used, 2,048], zeros, gets each used window's 8-mers.
int arriba_kmer_bitmap_build(const void* table, const void* offsets,
                             const void* lengths, const void* rank_window,
                             const void* slices, void* bitmaps, int n_slices,
                             int n_used, int n_windows,
                             long long table_bytes, int slice,
                             void* stream) {
    if (n_slices == 0) return 0;
    kmer_bitmap_build_kernel<<<n_slices, kBlock, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)table, (const int64_t*)offsets,
        (const int32_t*)lengths, (const int32_t*)rank_window,
        (const int32_t*)slices, (uint32_t*)bitmaps, n_used, n_windows,
        table_bytes, slice);
    return (int)cudaGetLastError();
}

// The test pass: reads uint8 [n_read_rows, L] (K1's raw rows: 2 r
// forward, 2 r + 1 reverse complement, 0 past the read; L a multiple of
// 16, the table on a 16-byte boundary), row_read int32 [n_rows] (each
// row's read id, rows sorted by window), tasks int32 [n_tasks, 3]
// (window, first row, end row), task_rank int32 [n_tasks] (the rank of
// each task's window, -1 for none), bitmaps the build pass's; out uint8
// [n_rows] gets each task's rows' verdicts.
int arriba_kmer_bitmap_test(const void* reads, const void* row_read,
                            const void* tasks, const void* task_rank,
                            const void* bitmaps, void* out, int n_rows,
                            int n_tasks, int L, int n_read_rows, int n_used,
                            void* stream) {
    if (n_rows == 0 || n_tasks == 0) return 0;
    kmer_bitmap_test_kernel<<<n_tasks, kBlock, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const int32_t*)row_read,
        (const int32_t*)tasks, (const int32_t*)task_rank,
        (const uint32_t*)bitmaps, (uint8_t*)out, n_rows, L, n_read_rows,
        n_used);
    return (int)cudaGetLastError();
}

const char* arriba_kmer_bitmap_build_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

const char* arriba_kmer_bitmap_test_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
