// Operand layouts and per-tile math of the one-hot 8-mer screen (K4).
//
// Shared by the CUDA kernel (mxu_kmer_screen.cu) and a CPU build of the
// same functions (tests/test_torch_kernel_math.py), which emulates the
// warpgroup product from the layouts below.
//
// A k-mer is encoded as 4k = 32 int8 lanes, one-hot per base: lane 4j + c
// is 1 when position j holds code c (0-3). A byte above 3 (PAD 4, or any
// larger byte) one-hots to four zero lanes, so a k-mer that covers one can
// never reach a dot of k. The dot product of two encodings counts the
// positions where both hold the same code 0-3: it lies in [0, k] and is k
// exactly when the k-mers are equal. With k = 8 that is bit 3, so an OR of
// dots tests "some dot is 8" with one AND at the end (mk_hit).
//
// One wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 multiplies 64
// window k-mers (A, 64 x 32, in registers) by 160 read k-mers (B, 32 x
// 160, in shared memory) into 64 x 160 int32 dots: the whole reduction
// depth is one instruction.
//
// Four tiles in one accumulator. A dot lies in [0, 8], one base-16 digit,
// so the products of MK_GROUP = 4 window tiles can share the accumulators
// if tile j's product is weighted 16^j: each dot of the sum holds tile j's
// dot exactly as its digit j, and bit 4 j + 3 is set only by a dot of 8 in
// tile j (MK_HIT_MASK tests all four). The weight is the product of an A
// scale and a B scale, both bytes below 128 (s8): 1 x 1, 1 x 16, 16 x 16,
// 64 x 64, so the block keeps three B images, scaled 1, 16 and 64
// (mk_a_shift, mk_tile_image, mk_b_shift). Four wgmmas then leave one
// accumulator set to fold and vote on, where one tile a wgmma left four.
//
// A: warp w of the warpgroup holds rows 16 w .. 16 w + 15 in the layout of
// mma.m16n8k32's A (PTX ISA, "Register fragments and shared memory matrix
// layouts" for wgmma with .s8 A in registers): lane l, with g = l / 4 and
// t = l % 4, register r, byte b is row 16 w + g + 8 (r & 1), column
// 4 t + b + 16 (r >> 1). Each register covers the four lanes of one base of
// one k-mer: it is the one-hot word of that base (mk_onehot).
//
// B: K-major (each read k-mer's 32 lanes together), no swizzle. The image
// is made of core matrices of 8 k-mers x 16 bytes, 128 contiguous bytes
// each (a k-mer's 16 bytes, then the next k-mer's). The two 16-byte halves
// of the 32 lanes lie MK_LBO apart (the descriptor's leading byte offset,
// the K direction) and consecutive groups of 8 k-mers MK_SBO apart (its
// stride byte offset), so (k-mer n, lane k) lies at mk_b_offset(n, k).
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

constexpr int MK_K = 8;            // k-mer length: 4k = 32, one wgmma's depth
constexpr int MK_TILE_M = 64;      // window k-mers a wgmma (the A rows)
constexpr int MK_N = 160;          // read k-mers a slab (the B columns)
constexpr int MK_CHUNK = 2048;     // window k-mers a stage copies
constexpr int MK_GROUP = 4;        // window tiles an accumulation
constexpr int MK_IMAGES = 3;       // B images, scaled 1, 16 and 64
constexpr int MK_STAGES = 4;       // slots of a block's copy ring
constexpr uint32_t MK_HIT_MASK = 0x8888;    // bit 3 of each tile's digit
constexpr int MK_LBO = 128;        // bytes between the two K halves
constexpr int MK_SBO = 256;        // bytes between groups of 8 k-mers
constexpr int MK_IMAGE = MK_N * 4 * MK_K;   // bytes a B image: 5,120
// bytes a stage copies at most: the slab's read bytes (MK_N + 7) and the
// chunk's window bytes (MK_CHUNK + 7), each from the 16-byte boundary at
// or below its first byte up to a 16-byte multiple (cp.async.bulk)
constexpr int MK_READ_SPAN = (15 + MK_N + MK_K - 1 + 15) / 16 * 16;
constexpr int MK_WINDOW_SPAN = (15 + MK_CHUNK + MK_K - 1 + 15) / 16 * 16;

// the layout of the A fragments (see the head of this file); warp w adds
// 16 w to the row
__host__ __device__ inline int mk_a_row(int lane, int r) {
    return (lane >> 2) + 8 * (r & 1);
}
__host__ __device__ inline int mk_a_col(int lane, int r, int b) {
    return 4 * (lane & 3) + b + 16 * (r >> 1);
}

// the four one-hot lanes of a base, byte c set for code c; 0 above code 3
__host__ __device__ inline uint32_t mk_onehot(uint32_t code) {
    return code <= 3 ? 1u << (8 * code) : 0u;
}

// tile j (0-3) of a group weighs 16^j = 2^mk_a_shift(j) x 2^mk_b_shift of
// B image mk_tile_image(j)
__host__ __device__ inline int mk_a_shift(int j) {
    return j == 2 ? 4 : j == 3 ? 6 : 0;
}
__host__ __device__ inline int mk_tile_image(int j) {
    return j == 0 ? 0 : j == 3 ? 2 : 1;
}
__host__ __device__ inline int mk_b_shift(int image) {
    return image == 0 ? 0 : image == 1 ? 4 : 6;
}

// the one-hot word of byte p of bytes, n of them readable; 0 past them
__host__ __device__ inline uint32_t mk_word(const uint8_t* bytes, int n,
                                            int p) {
    return p < n ? mk_onehot(bytes[p]) : 0u;
}

// lane's A fragment of the 16 k-mers whose first starts at p0, from the
// one-hot words of their bases (mk_word), each lane scaled by 2^shift:
// register r holds the base at position j = column / 4 of the k-mer at row
// p0 + row (a k-mer running off the bytes has a zero word and cannot reach
// k)
__host__ __device__ inline void mk_a_fragment(const uint32_t* words, int p0,
                                              int lane, uint32_t a[4],
                                              int shift = 0) {
    for (int r = 0; r < 4; ++r) {
        a[r] = words[p0 + mk_a_row(lane, r) + mk_a_col(lane, r, 0) / 4]
               << shift;
    }
}

// byte offset of lane k (0-31) of read k-mer n (0-159) in the B image
__host__ __device__ inline int mk_b_offset(int n, int k) {
    return (n >> 3) * MK_SBO + (k >> 4) * MK_LBO + (n & 7) * 16 + (k & 15);
}

// the (k-mer, base) whose one-hot word is 32-bit word w of the B image,
// the inverse of mk_b_offset(n, 4 j) / 4: consecutive threads write
// consecutive words
__host__ __device__ inline int mk_b_word_kmer(int w) {
    return (w >> 6) * 8 + ((w >> 2) & 7);
}
__host__ __device__ inline int mk_b_word_base(int w) {
    return ((w >> 5) & 1) * 4 + (w & 3);
}

// word w of the B image of the read k-mers from slab position 0 of bytes,
// n of them readable: the one-hot word of base j of k-mer n, 0 past them
__host__ __device__ inline uint32_t mk_b_word(const uint8_t* bytes, int n,
                                              int w) {
    return mk_word(bytes, n, mk_b_word_kmer(w) + mk_b_word_base(w));
}

// the wgmma shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): bits 0-13 the start address / 16, 16-29 the leading byte offset
// / 16, 32-45 the stride byte offset / 16, 49-51 the base offset (0), 62-63
// the swizzle mode (0: none)
__host__ __device__ inline uint64_t mk_desc(uint32_t address, int lbo,
                                            int sbo) {
    return (uint64_t)((address & 0x3ffff) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3fff) << 16
           | (uint64_t)((sbo >> 4) & 0x3fff) << 32;
}

// the shared address a descriptor of a K-major, unswizzled operand names
// for (column n, lane k), from its fields alone: the core matrix (n / 8,
// k / 16) at n / 8 strides and k / 16 leading offsets from the start, then
// row n % 8 of 16 bytes and byte k % 16 inside it
__host__ __device__ inline uint32_t mk_desc_address(uint64_t desc, int n,
                                                    int k) {
    const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
    const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3fff) << 4;
    const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3fff) << 4;
    return start + (n >> 3) * sbo + (k >> 4) * lbo + (n & 7) * 16 + (k & 15);
}

// fold a group's dots into the running OR; mk_hit tests it for a dot of k
// in any tile (a tile's dots lie in [0, k], its digit, and k = 8 is the
// only one with bit 3 set); mk_hit_tile names the first such tile
// (eight independent ORs, so the fold is no chain of N dependent steps)
template <int N>
__host__ __device__ inline uint32_t mk_fold(uint32_t acc, const int32_t* d) {
    uint32_t part[8] = {};
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int i = 0; i < N; ++i) part[i & 7] |= (uint32_t)d[i];
    return acc | ((part[0] | part[1]) | (part[2] | part[3]))
           | ((part[4] | part[5]) | (part[6] | part[7]));
}
__host__ __device__ inline bool mk_hit(uint32_t acc) {
    return (acc & MK_HIT_MASK) != 0;
}
__host__ __device__ inline int mk_hit_tile(uint32_t acc) {
    for (int j = 0; j < MK_GROUP; ++j) {
        if (acc & (uint32_t)MK_K << (4 * j)) return j;
    }
    return -1;
}

// slabs of MK_N read k-mers in a read of L bytes, 0 when L < k
__host__ __device__ inline int mk_slabs(int L) {
    return L >= MK_K ? (L - MK_K + MK_N) / MK_N : 0;
}

// stages of MK_CHUNK window k-mers in a window of W bytes, 0 when W < k
__host__ __device__ inline int mk_chunks(int W) {
    return W >= MK_K ? (W - MK_K + MK_CHUNK) / MK_CHUNK : 0;
}

// a stage of a block's schedule: slab slab of row row's read against chunk
// chunk of its window; row -1 when the block's rows are done
struct MkStage {
    int row, slab, chunk;
};

// a block's copy cursor: its rows block, block + grid, ... below n, each as
// slabs x chunks stages, slab by slab; the copies run MK_STAGES - 1 stages
// ahead of the stage in use, so the next row's first stages are copied
// while the block still works on a row. next() gives the stage to copy and
// moves on; what is left of the row decided (by a hit) is not copied, its
// stages already copied are waited for and skipped by the block
struct MkCursor {
    int row, slab, chunk;

    __host__ __device__ MkStage next(int n, int grid, int slabs, int chunks,
                                     int decided) {
        if (row == decided) {
            row += grid;
            slab = chunk = 0;
        }
        if (row >= n) return {-1, 0, 0};
        const MkStage s = {row, slab, chunk};
        if (++chunk == chunks) {
            chunk = 0;
            if (++slab == slabs) {
                slab = 0;
                row += grid;
            }
        }
        return s;
    }
};

// the 16-byte aligned span a stage copies for n bytes from address a: it
// starts at a rounded down to 16 (the bytes sit *shift past it) and holds a
// multiple of 16 bytes
__host__ __device__ inline uint32_t mk_span(uint64_t a, int n, int* shift) {
    *shift = (int)(a & 15);
    return (uint32_t)((*shift + n + 15) & ~15);
}

// ---------------------------------------------------------------------------
// K4 at any k (mxu_kmer_screen.cu's second kernel; k = 8 keeps the kernel
// above).
//
// A k-mer is 4k one-hot lanes, padded with zero lanes to MK_KSTEPS = 32
// lanes a k-step: k-step s holds bases 8 s .. 8 s + 7 (a base past k is a
// zero lane, so the padding adds nothing to a dot). One wgmma m64n160k32 a
// k-step, chained into one accumulator, gives the full dot, in [0, k], k
// exactly when the k-mers are equal over codes 0-3.
//
// The hit test stays one OR fold and one AND, for any k. Let m be the
// least integer >= 3 with 2^m >= k, D = m + 1 digit bits, and b = 2^m - k.
// The accumulator starts at sum_j b 2^(D j) (wgmma then adds to it), and
// tile j of a group of G tiles is weighted 2^(D j), so digit j of a sum is
// dot_j + b, which lies in [b, 2^m] and below 2^D (no carry into the next
// digit): bit m of digit j is set exactly when dot_j + b = 2^m, that is
// dot_j = k. An OR of sums keeps each such bit, so (OR & mask), mask =
// sum_j 2^(m + D j), is non-zero iff some dot of some tile is k. With k = 8
// this is K4's own test (b = 0, D = 4, mask 0x8888).
// The weights are products of an A scale 2^a(j) and a B scale 2^b(j), both
// <= 64 so that a scaled one-hot byte stays an s8: b(j) = 6 where D j > 6,
// else 0, and a(j) = D j - b(j), so G tiles need D (G - 1) <= 12: G = 4 for
// k <= 8 (D = 4), 3 for k <= 32 (D = 5, 6), 2 for k <= 2,048 (D <= 12). A
// sum is then at most 2^(D G) <= 2^24, a positive int32. Beyond k = 2,048 a
// group is one tile and needs no digits: the accumulator starts at 0, each
// sum is a dot, at most k < 2^31, and the test is the largest sum against
// k (mk_any_hit). Two B images (scaled 1 and 64) serve every group, one
// where G = 1.

constexpr int MK_KSTEP_BASES = 8;       // bases a k-step (32 lanes)
constexpr int MK_ANY_IMAGE_BUDGET = 98304;  // bytes of B images a block

struct MkPlan {
    int k;          // k-mer length
    int ksteps;     // 32-lane k-steps a k-mer: ceil(k / 8)
    int digit;      // D, bits a tile's digit
    int groups;     // G, tiles an accumulation
    int images;     // B images (scaled 1 and 64; one when G = 1)
    int kchunk;     // k-steps the block's images hold at once
    int32_t bias;   // the accumulator's start: b in every digit (G > 1)
    uint32_t mask;  // bit m of every digit (G > 1)
};

__host__ __device__ inline MkPlan mk_plan(int k) {
    MkPlan p;
    p.k = k;
    p.ksteps = k / MK_KSTEP_BASES + (k % MK_KSTEP_BASES != 0);
    int m = 3;
    while ((1LL << m) < k) ++m;
    p.digit = m + 1;
    p.groups = p.digit > 12 ? 1 : 12 / p.digit + 1 < MK_GROUP
                                  ? 12 / p.digit + 1 : MK_GROUP;
    p.images = p.groups > 1 ? 2 : 1;
    const int fit = MK_ANY_IMAGE_BUDGET / (p.images * MK_IMAGE);
    p.kchunk = p.ksteps < fit ? p.ksteps : fit;
    p.bias = 0;
    p.mask = 0;
    for (int j = 0; p.groups > 1 && j < p.groups; ++j) {
        p.bias += (int32_t)(((1LL << m) - k) << (p.digit * j));
        p.mask |= 1u << (m + p.digit * j);
    }
    return p;
}

// Does one of a thread's n sums d show a dot of k? With G > 1 tiles a
// group, the OR of the sums against plan.mask; with one, the largest sum
// against k
template <int N>
__host__ __device__ inline bool mk_any_hit(const MkPlan& p,
                                           const int32_t* d) {
    if (p.groups > 1) return (mk_fold<N>(0u, d) & p.mask) != 0;
    int32_t top = d[0];
    for (int i = 1; i < N; ++i) top = d[i] > top ? d[i] : top;
    return top >= p.k;
}

// tile j's A shift and B image (0: scale 1, 1: scale 64)
__host__ __device__ inline int mk_any_image(const MkPlan& p, int j) {
    return p.digit * j > 6 ? 1 : 0;
}
__host__ __device__ inline int mk_any_a_shift(const MkPlan& p, int j) {
    return p.digit * j - 6 * mk_any_image(p, j);
}
__host__ __device__ inline int mk_any_b_shift(int image) {
    return image == 0 ? 0 : 6;
}

// read k-mers (R = L - k + 1) and window k-mers, 0 when a side has none
__host__ __device__ inline int mk_any_kmers(int L, int k) {
    return L >= k ? L - k + 1 : 0;
}

// ---------------------------------------------------------------------------
// The any-k kernel's stages, its copy ring and its one-hot word tables.
//
// A stage is a slab of MK_N read k-mers against a chunk of window k-mers
// over a part of the k-mers' k-steps, and it is what one slot of the
// block's copy ring (MK_STAGES slots, MkCursor, as K4) holds. Where the B
// images hold every k-step (plan.kchunk == plan.ksteps: k <= 72) a row has
// one part, and a chunk is at most the groups of plan.groups tiles that
// fit in MK_CHUNK k-mers (2,048 at four and two tiles a group, 1,920 at
// three). A stage's bytes are then the slab's MK_N + k - 1 read bytes and
// the chunk's chunk + k - 1 window bytes, so a k-mer that straddles a
// chunk's end has all its bases in one stage. Past k = 72 those spans
// would grow with k beyond shared memory (four slots of 2,048 + k - 1
// window bytes and a table of as many words), so the chunk shrinks to one
// group (128 k-mers, 64 past k = 2,048) and each part of plan.kchunk
// k-steps is a stage of its own, holding only its part's bases: the
// slab's MK_N - 1 + 8 plan.kchunk read bytes at most and the chunk's
// chunk - 1 + 8 plan.kchunk window bytes; the group's accumulator runs on
// across the parts of its (slab, chunk). Every stage is then bounded
// whatever k is (at most ~110 KB of shared memory a block), and a chunk
// shrinks further where that lets more blocks share an SM
// (mk_any_layout).
//
// Byte i of a stage, on either side, is base 8 c0 + i of the stage's first
// k-mer (c0 the part's first k-step), so base 8 s + j of the stage's k-mer
// t lies at mk_any_word_index(t, s - c0, j). The window's bytes become a
// table of one-hot words once a stage (mk_word), from which each A
// fragment is a shared load with its tile's shift (mk_any_a_words); the
// read's become the B images at the stage that starts a slab, or at every
// stage when a row has more than one part (mk_any_b_word).

struct MkAnyLayout {
    int chunk;        // window k-mers a stage (a multiple of the group)
    int groups;       // groups of a full stage
    int parts;        // stages a (slab, chunk): ceil(ksteps / kchunk)
    int bases;        // bases a stage covers at most: min(k, 8 kchunk)
    int read_slot;    // bytes a ring slot's read span (a multiple of 16)
    int window_slot;  // bytes a ring slot's window span (a multiple of 16)
    int words;        // one-hot words a stage's window table
    int read_at;      // dynamic shared memory: the B images from 0, then
    int window_at;    // the read slots, the window slots and the word table
    int words_at;
    int bytes;        // dynamic shared memory a block
};

// the layout of a stage of `groups` groups
__host__ __device__ inline MkAnyLayout mk_any_stage_layout(const MkPlan& p,
                                                           int parts,
                                                           int groups) {
    MkAnyLayout s;
    s.parts = parts;
    s.groups = groups;
    s.chunk = groups * p.groups * MK_TILE_M;
    s.bases = p.k < MK_KSTEP_BASES * p.kchunk ? p.k
                                               : MK_KSTEP_BASES * p.kchunk;
    // up to 15 bytes before the span (its 16-byte boundary) and up to 15
    // after it (cp.async.bulk copies multiples of 16)
    s.read_slot = (15 + MK_N - 1 + s.bases + 15) / 16 * 16;
    s.window_slot = (15 + s.chunk - 1 + s.bases + 15) / 16 * 16;
    s.words = s.chunk - 1 + s.bases;
    s.read_at = p.images * p.kchunk * MK_IMAGE;
    s.window_at = s.read_at + MK_STAGES * s.read_slot;
    s.words_at = s.window_at + MK_STAGES * s.window_slot;
    s.bytes = s.words_at + 4 * s.words;
    return s;
}

// A stage holds the most groups (up to MK_CHUNK k-mers while a row has
// one part, else one) that keep the block's shared memory within an SM's
// share for the most blocks an SM (MK_ANY_SM_BLOCKS down to 1) that any
// stage allows: 1,728 k-mers at k = 31, where 1,920 would let three blocks
// share an SM, not four
constexpr int MK_ANY_SM_BLOCKS = 4;
constexpr int MK_ANY_SM_SHARED = 233472;    // an H100 SM's 228 KB
constexpr int MK_ANY_BLOCK_EXTRA = 1024 + 128;  // reserved a block, static

__host__ __device__ inline MkAnyLayout mk_any_layout(const MkPlan& p) {
    const int parts = (p.ksteps + p.kchunk - 1) / p.kchunk;
    const int most = parts == 1 ? MK_CHUNK / (p.groups * MK_TILE_M) : 1;
    for (int blocks = MK_ANY_SM_BLOCKS; blocks > 1; --blocks) {
        const int budget = MK_ANY_SM_SHARED / blocks - MK_ANY_BLOCK_EXTRA;
        for (int groups = most; groups >= 1; --groups) {
            const MkAnyLayout s = mk_any_stage_layout(p, parts, groups);
            if (s.bytes <= budget) return s;
        }
    }
    return mk_any_stage_layout(p, parts, most);
}

// where a stage's bytes start in a row of n bytes and how many of them it
// copies: the bases of k-steps c0 .. c0 + plan.kchunk - 1 (up to base k -
// 1) of the k-mers first .. first + kmers - 1, so from byte first + 8 c0,
// kmers - 1 + (the part's bases) bytes, clipped to the row (count >= 1
// for a k-mer first of the row)
struct MkBytes {
    int start, count;
};

__host__ __device__ inline MkBytes mk_any_bytes(const MkPlan& p, int first,
                                                int kmers, int c0, int n) {
    const int start = first + MK_KSTEP_BASES * c0;
    const int left = p.k - MK_KSTEP_BASES * c0;
    const int bases = left < MK_KSTEP_BASES * p.kchunk
                          ? left : MK_KSTEP_BASES * p.kchunk;
    const int want = kmers - 1 + bases;
    return {start, want < n - start ? want : n - start};
}

// the stage offset of base 8 (c0 + step) + j of the stage's k-mer t
__host__ __device__ inline int mk_any_word_index(int t, int step, int j) {
    return t + MK_KSTEP_BASES * step + j;
}

// word w (MK_IMAGE / 4 a k-step) of the B image of k-step s for a stage's
// read k-mers, from its count staged read bytes (part from k-step c0): the
// one-hot word of base 8 s + mk_b_word_base(w) of k-mer mk_b_word_kmer(w);
// 0 for a base past k or a byte past count
__host__ __device__ inline uint32_t mk_any_b_word(const MkPlan& p,
                                                  const uint8_t* bytes,
                                                  int count, int s, int c0,
                                                  int w) {
    const int j = mk_b_word_base(w);
    return MK_KSTEP_BASES * s + j < p.k
               ? mk_word(bytes, count,
                         mk_any_word_index(mk_b_word_kmer(w), s - c0, j))
               : 0u;
}

// lane's A fragment of k-step s for the 16 window k-mers of a stage from
// its k-mer t0 (the warp's first row), from the stage's one-hot words:
// register r holds base 8 s + column / 4 of k-mer t0 + mk_a_row(lane, r),
// scaled by 2^shift, 0 for a base past k
__host__ __device__ inline void mk_any_a_words(const MkPlan& p,
                                               const uint32_t* words, int t0,
                                               int s, int c0, int lane,
                                               uint32_t a[4], int shift) {
    for (int r = 0; r < 4; ++r) {
        const int j = mk_a_col(lane, r, 0) / 4;
        a[r] = MK_KSTEP_BASES * s + j < p.k
                   ? words[mk_any_word_index(t0 + mk_a_row(lane, r), s - c0,
                                             j)] << shift
                   : 0u;
    }
}

}  // namespace arriba
