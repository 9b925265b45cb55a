// K5: the 8-mer bitmap screen of filter_mismappers (the sound REJECT), for
// sm_90a.
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
// 8-mers set in a bitmap once a block that tests its pairs, and each
// pair's read 8-mers tested against it up to the first that is set.
// chip_smoke.py counts both from its inputs.
//
// Design: a block owns one task, (window, first row, end row), of rows
// sorted by window (ops/realign.screen_tasks cuts a window's rows into
// tasks of at most KB_TASK_ROWS, so a window shared by many rows spreads
// over many blocks, each setting the window's bitmap again). It
//  1. clears a 65,536-bit bitmap in shared memory;
//  2. stages the window KB_TILE positions at a time as code bytes (one
//     load and one code a byte) and sets the bit of every position's
//     8-mer, with an atomicOr only where the bit is not yet set;
//  3. tests its rows, a warp a row: the lanes take 32 of the row's tests
//     (the forward read row's 8-mers, then the reverse complement's, both
//     coded as the window is) at a time and stop at the first group with a
//     set bit.
// The verdict is written a row, in the tasks' row order, into a uint8
// output (1 = the pair shares an 8-mer).
#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_bitmap_screen.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
kmer_bitmap_screen_kernel(const uint8_t* __restrict__ reads,
                          const uint8_t* __restrict__ table,
                          const int64_t* __restrict__ offsets,
                          const int32_t* __restrict__ lengths,
                          const int32_t* __restrict__ row_read,
                          const int32_t* __restrict__ tasks,
                          uint8_t* __restrict__ out, int n_rows, int L,
                          int n_read_rows, int n_windows,
                          long long table_bytes) {
    __shared__ uint32_t bitmap[arriba::KB_WORDS];
    __shared__ uint8_t codes[arriba::KB_TILE + arriba::KB_K - 1];
    const int tid = threadIdx.x;
    const int32_t* task = tasks + 3 * (size_t)blockIdx.x;
    long long first;
    int len;
    arriba::kb_window(offsets, lengths, task[0], n_windows, table_bytes,
                      &first, &len);
    const uint8_t* window = table + first;

    // 1. clear
    for (int w = tid; w < arriba::KB_WORDS; w += kBlock) bitmap[w] = 0;

    // 2. the window's 8-mers, a tile of positions at a time
    const int n_pos = arriba::kb_window_positions(len);
    for (int t0 = 0; t0 < n_pos; t0 += arriba::KB_TILE) {
        const int n = min(arriba::KB_TILE, n_pos - t0);
        __syncthreads();  // the clear, or the last tile's reads, are done
        for (int t = tid; t < n + arriba::KB_K - 1; t += kBlock) {
            codes[t] = (uint8_t)arriba::aw_kmer_code(window[t0 + t]);
        }
        __syncthreads();
        for (int t = tid; t < n; t += kBlock) {
            const int kmer = arriba::aw_kmer_coded(codes + t);
            const uint32_t mask = arriba::kb_mask(kmer);
            if ((bitmap[kmer >> 5] & mask) == 0) {
                atomicOr(bitmap + (kmer >> 5), mask);
            }
        }
    }
    __syncthreads();

    // 3. the rows, a warp a row
    const int lane = tid & 31;
    const int n_tests = arriba::kb_row_tests(L);
    const int end = min(task[2], n_rows);
    for (int r = max(task[1], 0) + tid / 32; r < end; r += kBlock / 32) {
        const uint8_t* fwd =
            arriba::kb_read_row(reads, row_read[r], n_read_rows, L);
        bool hit = false;
        for (int base = 0; fwd != nullptr && base < n_tests && !hit;
             base += 32) {
            const int q = base + lane;
            const bool set = q < n_tests
                && arriba::kb_test(bitmap, arriba::kb_row_kmer(fwd, q, L));
            hit = __any_sync(0xffffffffu, set);
        }
        if (lane == 0) out[r] = hit ? 1 : 0;
    }
}

}  // namespace

extern "C" {

// reads uint8 [n_read_rows, L] (K1's raw rows: 2 r forward, 2 r + 1
// reverse complement, 0 past the read), table uint8 [table_bytes] (raw window
// bytes), offsets int64 [n_windows] and lengths int32 [n_windows] (each
// window's span of the table), row_read int32 [n_rows] (each row's read
// id, rows sorted by window), tasks int32 [n_tasks, 3] (window, first row,
// end row); out uint8 [n_rows] gets each task's rows' verdicts.
int arriba_kmer_bitmap_screen(const void* reads, const void* table,
                              const void* offsets, const void* lengths,
                              const void* row_read, const void* tasks,
                              void* out, int n_rows, int n_tasks, int L,
                              int n_read_rows, int n_windows,
                              long long table_bytes, void* stream) {
    if (n_rows == 0 || n_tasks == 0) return 0;
    kmer_bitmap_screen_kernel<<<n_tasks, kBlock, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)table,
        (const int64_t*)offsets, (const int32_t*)lengths,
        (const int32_t*)row_read, (const int32_t*)tasks, (uint8_t*)out,
        n_rows, L, n_read_rows, n_windows, table_bytes);
    return (int)cudaGetLastError();
}

const char* arriba_kmer_bitmap_screen_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
