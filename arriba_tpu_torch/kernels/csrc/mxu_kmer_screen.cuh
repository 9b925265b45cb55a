// Fragment layout and per-tile math of the one-hot 8-mer screen (K4).
//
// Shared by the CUDA kernel (mxu_kmer_screen.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), which emulates the
// tensor-core product from the layout below.
//
// A k-mer is encoded as 4k = 32 int8 lanes, one-hot per base: lane 4j + c
// is 1 when position j holds code c (0-3). A byte above 3 (PAD 4, or any
// larger byte) one-hots to four zero lanes, so a k-mer that covers one can
// never reach a dot of k. The dot product of two encodings counts the
// positions where both hold the same code 0-3: it lies in [0, k] and is k
// exactly when the k-mers are equal. With k = 8 that is bit 3, so an OR of
// dots tests "some dot is 8" with one AND at the end (mk_hit).
//
// One mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 multiplies 16 read
// k-mers (A, 16 x 32, row-major) by 8 window k-mers (B, 32 x 8,
// column-major) into 16 x 8 int32 dots: the whole reduction depth is one
// instruction. Lane l of the warp, with g = l / 4 and t = l % 4, holds
// (PTX ISA, "Matrix fragments for mma.m16n8k32" with .s8):
//   A: 4 registers of 4 bytes; register r, byte b is row g + 8 (r & 1),
//      column 4 t + b + 16 (r >> 1)
//   B: 2 registers of 4 bytes; register r, byte b is row 4 t + b + 16 r,
//      column g
//   C/D: 4 int32; register r is row g + 8 (r >> 1), column 2 t + (r & 1)
// So each A or B register covers the four lanes of one base of one k-mer:
// it is the one-hot word of that base (mk_onehot).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int MK_K = 8;           // k-mer length: 4k = 32, one MMA's depth
constexpr int MK_TILE_M = 16;     // read k-mers a tile
constexpr int MK_TILE_N = 8;      // window k-mers a tile
constexpr int MK_WARPS = 8;       // warps a block (a row)
constexpr int MK_CHUNK = 2048;    // window k-mers staged at a time

// the layout of the m16n8k32 s8 fragments (see the head of this file)
__host__ __device__ inline int mk_a_row(int lane, int r) {
    return (lane >> 2) + 8 * (r & 1);
}
__host__ __device__ inline int mk_a_col(int lane, int r, int b) {
    return 4 * (lane & 3) + b + 16 * (r >> 1);
}
__host__ __device__ inline int mk_b_row(int lane, int r, int b) {
    return 4 * (lane & 3) + b + 16 * r;
}
__host__ __device__ inline int mk_b_col(int lane) { return lane >> 2; }
__host__ __device__ inline int mk_c_row(int lane, int r) {
    return (lane >> 2) + 8 * (r >> 1);
}
__host__ __device__ inline int mk_c_col(int lane, int r) {
    return 2 * (lane & 3) + (r & 1);
}

// the four one-hot lanes of a base, byte c set for code c; 0 above code 3
__host__ __device__ inline uint32_t mk_onehot(uint32_t code) {
    return code <= 3 ? 1u << (8 * code) : 0u;
}

// lane's A fragment of the read tile whose first k-mer starts at read
// position p0: register r holds the base at position j = column / 4 of the
// k-mer at row p0 + row, 0 past the read's L bytes (so a k-mer running off
// the read has a zero lane and cannot reach k)
__host__ __device__ inline void mk_a_fragment(const uint8_t* read, int L,
                                              int p0, int lane,
                                              uint32_t a[4]) {
    for (int r = 0; r < 4; ++r) {
        const int p = p0 + mk_a_row(lane, r) + mk_a_col(lane, r, 0) / 4;
        a[r] = p < L ? mk_onehot(read[p]) : 0u;
    }
}

// lane's B fragment of the window tile whose first k-mer starts at
// position q0 of onehot, the one-hot words of a stretch of the window (0
// past its end)
__host__ __device__ inline void mk_b_fragment(const uint32_t* onehot, int q0,
                                              int lane, uint32_t b[2]) {
    for (int r = 0; r < 2; ++r) {
        b[r] = onehot[q0 + mk_b_col(lane) + mk_b_row(lane, r, 0) / 4];
    }
}

// fold a tile's four dots into the running OR; mk_hit tests it for a dot
// of k (dots lie in [0, k] and k = 8 is the only one with bit 3 set)
__host__ __device__ inline uint32_t mk_fold(uint32_t acc, const int32_t d[4]) {
    return acc | (uint32_t)d[0] | (uint32_t)d[1] | (uint32_t)d[2]
           | (uint32_t)d[3];
}
__host__ __device__ inline bool mk_hit(uint32_t acc) {
    return (acc & MK_K) != 0;
}

// read tiles of a row of L bytes: ceil((L - k + 1) / 16), 0 when L < k
__host__ __device__ inline int mk_read_tiles(int L) {
    return L >= MK_K ? (L - MK_K + MK_TILE_M) / MK_TILE_M : 0;
}

// the read tiles a warp holds in registers at once: 10 cover a read of up
// to 167 bytes (the bench's 152, a 150 bp read); longer reads take their
// tiles 10 at a time, each group against the whole window. A group always
// runs all 10: a tile past the read's last k-mer holds only k-mers that
// run off the read, each with a zero base, so none reaches a dot of k
// (a per-tile guard made the full product 17 % slower on an H100)
constexpr int MK_GROUP = 10;

}  // namespace arriba
