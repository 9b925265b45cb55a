// K4: the one-hot 8-mer screen on the int8 tensor cores, for sm_90a.
//
// Replaces: arriba_tpu/ops/realign.py:79 mxu_shared_kmer_mask, a jax.jit
// op (no Pallas kernel): does any 8-mer of read n occur in window n, as a
// batched int8 product of one-hot k-mer encodings with a fused
// any(dot == 8). Bench-only in the JAX package, as in this one.
//
// What bounds it: int8 tensor-core operations. The whole product is
// rows x (L - 7) x (W - 7) x 32 multiply-adds (512 x 145 x 8,001 x 32 at
// the bench's shape: 38.0 G operations, 19.2 us at the H100 SXM's 1,979
// dense int8 TOPS), which only wgmma reaches; a row with a shared 8-mer
// can stop at its first hit. The inputs are 4 MB at that shape (~1.3 us
// of memory time).
//
// Design (the simple first version; wgmma, TMA and a persistent schedule
// are later work): a block of 8 warps owns a row. Each warp builds the A
// fragments of its read tiles (16 k-mers each), MK_GROUP = 10 at a time,
// in registers, straight from the uint8 codes. The block stages the window
// in chunks of 2,048 k-mers as one-hot words in shared memory; warp w
// takes the chunk's window tiles (8 k-mers each) w, w + 8, ...: one B
// fragment, then one mma.sync.m16n8k32 s8 per read tile (the reduction
// depth 4k = 32 is one instruction), the four dots of each ORed into a
// running word whose bit 3 is set only by a dot of 8 (mk_fold, mk_hit). A
// warp that sees a hit sets a shared flag, and every warp leaves at the
// next tile once the flag is set, so a row stops at its first hit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_kmer_screen.cuh"

namespace {

constexpr int kWarps = arriba::MK_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = arriba::MK_CHUNK;
constexpr int kGroup = arriba::MK_GROUP;
constexpr unsigned kFull = 0xffffffffu;

__device__ inline void mk_mma(const uint32_t a[4], const uint32_t b[2],
                              int32_t d[4]) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0));
}

// MK_GROUP read tiles in registers at a time (see its note)
__global__ void __launch_bounds__(kThreads)
mxu_kmer_screen_kernel(const uint8_t* __restrict__ reads,
                       const uint8_t* __restrict__ windows,
                       uint8_t* __restrict__ out, int L, int W) {
    // one-hot words of the chunk's k-mers and the 7 bytes past its last,
    // rounded up: the chunk's last tile reads up to word kChunk + 6
    __shared__ uint32_t onehot[kChunk + 16];
    __shared__ int hit;
    volatile int* flag = &hit;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const uint8_t* read = reads + (size_t)blockIdx.x * L;
    const uint8_t* window = windows + (size_t)blockIdx.x * W;
    const int n_tiles = arriba::mk_read_tiles(L);
    const int n_kmers = W - arriba::MK_K + 1;
    if (threadIdx.x == 0) hit = 0;

    for (int t0 = 0; t0 < n_tiles; t0 += kGroup) {
        uint32_t a[kGroup][4];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
            arriba::mk_a_fragment(read, L, (t0 + i) * arriba::MK_TILE_M,
                                  lane, a[i]);
        }
        for (int c0 = 0; c0 < n_kmers; c0 += kChunk) {
            // every warp is done with the last chunk and wrote its flag
            // before this barrier; none writes it again until the next
            __syncthreads();
            if (*flag) break;
            for (int i = threadIdx.x; i < kChunk + 16; i += kThreads) {
                const int pos = c0 + i;
                onehot[i] = pos < W ? arriba::mk_onehot(__ldg(window + pos))
                                    : 0u;
            }
            __syncthreads();
            const int tiles = (min(kChunk, n_kmers - c0)
                               + arriba::MK_TILE_N - 1) / arriba::MK_TILE_N;
            uint32_t acc = 0;
            for (int w = warp; w < tiles; w += kWarps) {
                uint32_t b[2];
                arriba::mk_b_fragment(onehot, w * arriba::MK_TILE_N, lane, b);
#pragma unroll
                for (int i = 0; i < kGroup; ++i) {
                    int32_t d[4];
                    mk_mma(a[i], b, d);
                    acc = arriba::mk_fold(acc, d);
                }
                const bool found = __any_sync(kFull, arriba::mk_hit(acc));
                if (found && lane == 0) *flag = 1;
                // the flag may change between lanes' reads: one vote
                if (found || __any_sync(kFull, *flag != 0)) break;
            }
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) out[blockIdx.x] = hit ? 1 : 0;
}

}  // namespace

extern "C" {

// reads uint8 [n, L], windows uint8 [n, W] (codes 0-3; any larger byte one-
// hots to zero), out uint8 [n]: 1 where read and window share an 8-mer
int arriba_mxu_kmer_screen(const void* reads, const void* windows, void* out,
                           int n, int L, int W, void* stream) {
    if (n == 0) return 0;
    mxu_kmer_screen_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (uint8_t*)out, L, W);
    return (int)cudaGetLastError();
}

const char* arriba_mxu_kmer_screen_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
