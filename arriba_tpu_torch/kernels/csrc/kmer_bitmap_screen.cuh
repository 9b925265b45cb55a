// Per-window and per-row steps of K5, the 8-mer bitmap screen of
// filter_mismappers.
//
// Shared by the CUDA kernel (kmer_bitmap_screen.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), so the code the kernel
// runs is checked against the plain PyTorch version without a GPU.
//
// Semantics: ops/realign.screen_pairs of the port (and of the JAX package),
// the sound REJECT of a (read, gene window) pair: does any 8-mer of the
// read, in either orientation, occur in the window? Window bytes take the
// kmer_to_int code of aw_kmer_code (T 0, G 1, C 2, any other byte 3), which
// is the screen's code (realign._kmer_codes_bytes) and never PAD, so every
// window position j <= len - 8 holds an 8-mer. The read rows are K1's raw
// rows (forward, then reverse complement, byte 0 past the read: no
// sequence byte is 0) coded the same way; an 8-mer that covers byte 0 does
// not count. The old screen cut long windows into chunks overlapping by 7
// bytes, so every 8-mer of the window lay whole in one chunk: the chunked
// verdict is this one test against the whole window.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "accept_wavefront.cuh"

namespace arriba {

constexpr int KB_K = AW_SEED;              // 8-mers
constexpr int KB_PAD = 0;                  // _PAD_READ of ops/realign.py
constexpr int KB_WORDS = AW_BITMAP_WORDS;  // 65,536 one-bit 8-mer slots
constexpr int KB_TILE = 4096;              // window positions staged a step

// the bit of an 8-mer's slot in its bitmap word (the word is kmer >> 5)
__host__ __device__ inline uint32_t kb_mask(int kmer) {
    return 1u << (kmer & 31);
}

__host__ __device__ inline bool kb_test(const uint32_t* bitmap, int kmer) {
    return kmer >= 0 && ((bitmap[kmer >> 5] & kb_mask(kmer)) != 0);
}

// the window span of a task: its bytes [*first, *first + *len) of the
// table, or none (*len = 0) where the window id or its span lies outside
// the table (the caller builds none such; this keeps every read inside)
__host__ __device__ inline void kb_window(const int64_t* offsets,
                                          const int32_t* lengths,
                                          int window, int n_windows,
                                          long long table_bytes,
                                          long long* first, int* len) {
    *first = 0;
    *len = 0;
    if (window < 0 || window >= n_windows) return;
    const long long off = offsets[window];
    const int n = lengths[window];
    if (off < 0 || n < 0 || off + n > table_bytes) return;
    *first = off;
    *len = n;
}

// window positions a window of len bytes holds an 8-mer at
__host__ __device__ inline int kb_window_positions(int len) {
    return len >= KB_K ? len - KB_K + 1 : 0;
}

// the code 8-mer of a read's raw row at position i (row L bytes wide), or
// -1 where it runs past the row or covers PAD
__host__ __device__ inline int kb_read_kmer(const uint8_t* row, int i,
                                            int L) {
    if (i < 0 || i + KB_K > L) return -1;
    int kmer = 0;
    for (int t = 0; t < KB_K; ++t) {
        const int c = row[i + t];
        if (c == KB_PAD) return -1;
        kmer = (kmer << 2) | aw_kmer_code(c);
    }
    return kmer;
}

// a row's tests: position q < L - 7 of the forward row, then q - (L - 7)
// of the reverse complement row right after it
__host__ __device__ inline int kb_row_tests(int L) {
    return L >= KB_K ? 2 * (L - KB_K + 1) : 0;
}

__host__ __device__ inline int kb_row_kmer(const uint8_t* fwd, int q,
                                           int L) {
    const int n = L - KB_K + 1;
    return q < n ? kb_read_kmer(fwd, q, L) : kb_read_kmer(fwd + L, q - n, L);
}

// the forward raw row of read id `read` (2 read of the table, its reverse
// complement 2 read + 1), or null where the id lies outside the table
__host__ __device__ inline const uint8_t* kb_read_row(const uint8_t* reads,
                                                      int read,
                                                      int n_read_rows,
                                                      int L) {
    if (read < 0 || 2 * (long long)read + 1 >= n_read_rows) return nullptr;
    return reads + (size_t)2 * read * L;
}

}  // namespace arriba
