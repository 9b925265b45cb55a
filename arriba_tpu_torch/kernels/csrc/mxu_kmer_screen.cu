// K4: the one-hot 8-mer screen on the int8 tensor cores (wgmma), for
// sm_90a. A second kernel below, mxu_kmer_screen_any_kernel, takes every
// other k the JAX op takes (arriba_mxu_kmer_screen_any_k); what follows up
// to it is about k = 8.
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
// of memory time), so a row that stops early is bound by latency: of its
// copy, of the build of its operands, of its first products.
//
// Design: a block is one warpgroup (128 threads) and walks rows by a
// fixed stride (the grid is what fits on the card at once, at most one
// block a row). A row is a sequence of stages, (slab of MK_N = 160 read
// k-mers) x (chunk of MK_CHUNK = 2,048 window k-mers), in the order of the
// block's MkCursor; each stage's read and window bytes reach shared memory
// by cp.async.bulk (one thread issues two 1-D bulk copies, no tensor map,
// from the 16-byte boundary at or below the bytes, so any row width works;
// they complete on the stage's mbarrier) into a ring of MK_STAGES slots,
// MK_STAGES - 1 stages ahead of the one in use: the next chunks and the
// next row's first ones arrive while the block multiplies. At a slab's first stage the block writes the read
// k-mers' one-hot words once into three B images (scaled 1, 16, 64; 5,120
// bytes each, K-major, no swizzle, mk_b_offset) and fences them for the
// async proxy; at every stage it turns the window bytes into one-hot words
// (mk_word) once; one barrier. Then, for each group of MK_GROUP = 4 tiles of
// 64 window k-mers: wgmma.fence and four
// wgmma.mma_async.m64n160k32.s32.s8.s8 chained into one accumulator, tile
// j weighted 16^j (the header's "four tiles in one accumulator"), each
// with the tile's scaled one-hot words in registers as A (each warp 16
// k-mers in the m16n8k32 A layout, 16 word loads a group, mk_a_fragment)
// against its B image; commit, wait; the next group's A; every thread ORs
// its 80 sums in eight independent chains (no D layout is needed: only
// whether a digit is 8), and after every kVote = 2 groups and a stage's
// last the block votes (__syncthreads_or: the same answer in every
// thread, so every barrier stays uniform). A hit ends the row: its stages
// already in flight are waited for and skipped, and the ring moves on to
// the next row.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py
// --against and --k4-occupancy): a block's chain of dependent steps,
// not the tensor cores, holds K4. One row alone on an SM takes ~0.66 us a
// group, ~4x its four products' own time; at 4 rows an SM the no-hit
// product runs at ~54 % of the dense int8 rate. Two warpgroups a row,
// double-buffered A registers and 1,024-k-mer stages each measured slower,
// two accumulator chains a warpgroup no faster.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_kmer_screen.cuh"

namespace {

constexpr int kThreads = 128;                 // one warpgroup
constexpr int kVote = 2;                      // groups between two votes
constexpr int kStages = arriba::MK_STAGES;    // slots of the copy ring
constexpr int kAcc = arriba::MK_N / 2;        // int32 dots a thread: 80
// one-hot words a stage's window table holds: its k-mers' bases
constexpr int kWords = arriba::MK_CHUNK + arriba::MK_K - 1;

struct Stage {
    arriba::MkStage at;             // at.row -1: the block's rows are done
    int read_shift, window_shift;   // where the bytes start in their slots
};

__device__ inline uint32_t smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 ::"r"(smem(bar)), "r"(1)
                 : "memory");
}

// wait for the phase of bar with this parity to complete; a copy that has
// not landed after 2^26 polls is a fault, raised as one (a trap ends the
// launch with an error) and not left to hang the card
__device__ inline void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    for (uint32_t polls = 0;; ++polls) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (polls == (1u << 26)) __trap();
    }
}

// one thread: expect bytes on bar, then the two bulk copies that bring them
__device__ inline void stage_copy(uint64_t* bar, void* read_dst,
                                  const void* read_src, uint32_t read_bytes,
                                  void* window_dst, const void* window_src,
                                  uint32_t window_bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem(bar)), "r"(read_bytes + window_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem(read_dst)), "l"(read_src), "r"(read_bytes),
          "r"(smem(bar))
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem(window_dst)), "l"(window_src), "r"(window_bytes),
          "r"(smem(bar))
        : "memory");
}

// this thread's generic shared accesses before the async proxy's next ones
__device__ inline void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// keep the compiler from moving reads or writes of the dots across the
// wgmma synchronisation around them
__device__ inline void pin(int32_t (&d)[kAcc]) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = A x B (+ d when add): A a tile's one-hot words (registers), B an
// image (desc)
__device__ inline void wgmma_tile(int32_t (&d)[80], const uint32_t a[4],
                                  uint64_t desc, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add)
        : "memory");
}

// the A fragments of a group's four tiles from the stage's one-hot words,
// the first tile at window k-mer p0 of the warp, each scaled for its weight
__device__ inline void group_a(uint32_t (&a)[arriba::MK_GROUP][4],
                               const uint32_t* words, int p0, int lane) {
#pragma unroll
    for (int j = 0; j < arriba::MK_GROUP; ++j) {
        arriba::mk_a_fragment(words, p0 + j * arriba::MK_TILE_M, lane, a[j],
                              arriba::mk_a_shift(j));
    }
}

// one group: the four weighted products into d, the next group's A into a
// once they are done (when there is one; the products read a until then),
// the dots folded into seen, and, when vote is set, the block's vote on a
// dot of 8 in seen. Every thread of the block calls it with the same
// arguments but its own registers, so the barrier is uniform.
__device__ inline bool group(int32_t (&d)[kAcc],
                             uint32_t (&a)[arriba::MK_GROUP][4],
                             const uint64_t (&desc)[arriba::MK_IMAGES],
                             bool more, bool vote, const uint32_t* words,
                             int next_p0, int lane, uint32_t& seen) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    pin(d);
#pragma unroll
    for (int j = 0; j < arriba::MK_GROUP; ++j) {
        wgmma_tile(d, a[j], desc[arriba::mk_tile_image(j)], j);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    pin(d);
    if (more) group_a(a, words, next_p0, lane);
    seen = arriba::mk_fold<kAcc>(seen, d);
    return vote && __syncthreads_or(arriba::mk_hit(seen));
}

__global__ void __launch_bounds__(kThreads, 4)
mxu_kmer_screen_kernel(const uint8_t* __restrict__ reads,
                       const uint8_t* __restrict__ windows,
                       uint8_t* __restrict__ out, int n, int L, int W) {
    __shared__ __align__(1024)
        uint8_t image[arriba::MK_IMAGES][arriba::MK_IMAGE];
    __shared__ __align__(128) uint8_t read_s[kStages][arriba::MK_READ_SPAN];
    __shared__ __align__(128)
        uint8_t window_s[kStages][arriba::MK_WINDOW_SPAN];
    __shared__ uint32_t words[kWords];      // the stage's one-hot bases
    __shared__ __align__(8) uint64_t bars[kStages];
    __shared__ Stage stages[kStages];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp_row = 16 * (tid >> 5);   // the warp's first A row
    const int slabs = arriba::mk_slabs(L);
    const int chunks = arriba::mk_chunks(W);
    if (slabs == 0 || chunks == 0) {        // no k-mer on one side
        for (int row = blockIdx.x * kThreads + tid; row < n;
             row += gridDim.x * kThreads) {
            out[row] = 0;
        }
        return;
    }
    if (tid == 0) {
        for (int k = 0; k < kStages; ++k) bar_init(&bars[k]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the copy cursor (every thread moves it, thread 0 issues) and the last
    // row decided by a hit, whose remaining stages are not copied
    arriba::MkCursor cursor = {(int)blockIdx.x, 0, 0};
    int decided = -1;
    auto issue = [&](int k) {
        const arriba::MkStage at = cursor.next(n, gridDim.x, slabs, chunks,
                                               decided);
        const int slot = k % kStages;
        if (tid == 0) {
            Stage s = {at, 0, 0};
            if (at.row >= 0) {
                const uint8_t* r = reads + (size_t)at.row * L
                                   + at.slab * arriba::MK_N;
                const uint8_t* w = windows + (size_t)at.row * W
                                   + (size_t)at.chunk * arriba::MK_CHUNK;
                const uint32_t r_bytes = arriba::mk_span(
                    (uintptr_t)r, min(arriba::MK_N + arriba::MK_K - 1,
                                      L - at.slab * arriba::MK_N),
                    &s.read_shift);
                const uint32_t w_bytes = arriba::mk_span(
                    (uintptr_t)w, min(arriba::MK_CHUNK + arriba::MK_K - 1,
                                      W - at.chunk * arriba::MK_CHUNK),
                    &s.window_shift);
                stage_copy(&bars[slot], read_s[slot], r - s.read_shift,
                           r_bytes, window_s[slot], w - s.window_shift,
                           w_bytes);
            }
            stages[slot] = s;
        }
    };
    for (int k = 0; k < kStages - 1; ++k) issue(k);

    uint64_t desc[arriba::MK_IMAGES];
#pragma unroll
    for (int i = 0; i < arriba::MK_IMAGES; ++i) {
        desc[i] = arriba::mk_desc(smem(image[i]), arriba::MK_LBO,
                                  arriba::MK_SBO);
    }
    int32_t d[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0;

    for (int k = 0;; ++k) {
        // every thread is done with slot (k - 1) % kStages, whose refill by
        // the async proxy follows (the fence orders this thread's generic
        // reads of it before that), with the images' last product and with
        // the window words; the stage descriptors written so far are visible
        fence_proxy_async();
        __syncthreads();
        issue(k + kStages - 1);
        const int slot = k % kStages;
        const Stage stage = stages[slot];
        const arriba::MkStage s = stage.at;
        if (s.row < 0) break;
        bar_wait(&bars[slot], (uint32_t)(k / kStages) & 1u);
        if (s.row == decided) continue;
        // the slab's B images at its first stage, and every stage's window
        // bases as one-hot words (0 past the window); one barrier for both
        if (s.chunk == 0) {
            const uint8_t* r = read_s[slot] + stage.read_shift;
            const int r_bytes = L - s.slab * arriba::MK_N;
            for (int w = tid; w < arriba::MK_IMAGE / 4; w += kThreads) {
                const uint32_t word = arriba::mk_b_word(r, r_bytes, w);
#pragma unroll
                for (int i = 0; i < arriba::MK_IMAGES; ++i) {
                    reinterpret_cast<uint32_t*>(image[i])[w] =
                        word << arriba::mk_b_shift(i);
                }
            }
            fence_proxy_async();
        }
        const int q0 = s.chunk * arriba::MK_CHUNK;
        const uint8_t* window = window_s[slot] + stage.window_shift;
        for (int i = tid; i < kWords; i += kThreads) {
            words[i] = arriba::mk_word(window, W - q0, i);
        }
        __syncthreads();
        // groups of four tiles of 64 k-mers; a group past the window's last
        // k-mer holds only k-mers that run off it (zero lanes, no hit)
        const int span = arriba::MK_GROUP * arriba::MK_TILE_M;
        const int groups = (min(arriba::MK_CHUNK, W - arriba::MK_K + 1 - q0)
                            + span - 1) / span;
        // a vote after every kVote groups and after the stage's last
        uint32_t a[arriba::MK_GROUP][4];
        group_a(a, words, warp_row, lane);
        bool hit = false;
        uint32_t seen = 0;
        for (int g = 0; g < groups && !hit; ++g) {
            hit = group(d, a, desc, g + 1 < groups,
                        (g + 1) % kVote == 0 || g + 1 == groups, words,
                        (g + 1) * span + warp_row, lane, seen);
        }
        if (hit) decided = s.row;
        if ((hit || (s.slab == slabs - 1 && s.chunk == chunks - 1))
            && tid == 0) {
            out[s.row] = hit ? 1 : 0;
        }
    }
}

// K4 at any k other than 8 (mxu_kmer_screen.cuh, "K4 at any k"): a block is
// one warpgroup and walks rows by a fixed stride; a row is its slabs of
// MK_N read k-mers, each against the window's groups of plan.groups tiles
// of 64 window k-mers. At a slab's first group the block writes the
// slab's B images (scaled 1 and 64) for the k-steps they hold
// (plan.kchunk; when a k-mer has more k-steps than that, every group
// writes them again, chunk by chunk), straight from the read's bytes in
// device memory. A group starts its accumulator at plan.bias and, for each
// k-step, builds its tiles' scaled A from the window's bytes and chains
// their wgmmas into it; then every thread tests its 80 sums (mk_any_hit:
// their OR against plan.mask, or with one tile a group their largest
// against k) and the block votes. A hit ends the row. No copy ring: the
// bytes come through the caches, which is enough for the rows this kernel
// serves.
__global__ void __launch_bounds__(kThreads)
mxu_kmer_screen_any_kernel(const uint8_t* __restrict__ reads,
                           const uint8_t* __restrict__ windows,
                           uint8_t* __restrict__ out, int n, int L, int W,
                           arriba::MkPlan plan) {
    extern __shared__ __align__(16) uint8_t images[];  // 16: no swizzle
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp_row = 16 * (tid >> 5);
    const int k = plan.k;
    const int slabs = (arriba::mk_any_kmers(L, k) + arriba::MK_N - 1)
                      / arriba::MK_N;
    const int tiles = (arriba::mk_any_kmers(W, k) + arriba::MK_TILE_M - 1)
                      / arriba::MK_TILE_M;
    const int groups = (tiles + plan.groups - 1) / plan.groups;
    const int span = plan.groups * arriba::MK_TILE_M;

    for (int row = blockIdx.x; row < n; row += gridDim.x) {
        const uint8_t* read = reads + (size_t)row * L;
        const uint8_t* window = windows + (size_t)row * W;
        bool hit = false;
        for (int slab = 0; slab < slabs && !hit; ++slab) {
            const int n0 = slab * arriba::MK_N;
            for (int g = 0; g < groups && !hit; ++g) {
                int32_t d[kAcc];
#pragma unroll
                for (int i = 0; i < kAcc; ++i) d[i] = plan.bias;
                for (int c0 = 0; c0 < plan.ksteps; c0 += plan.kchunk) {
                    const int c_n = min(plan.kchunk, plan.ksteps - c0);
                    if (g == 0 || plan.kchunk < plan.ksteps) {
                        // every thread's products on the images are done
                        __syncthreads();
                        for (int s = 0; s < c_n; ++s) {
                            for (int w = tid; w < arriba::MK_IMAGE / 4;
                                 w += kThreads) {
                                const uint32_t word = arriba::mk_any_b_word(
                                    read, L, n0, k, c0 + s, w);
                                for (int i = 0; i < plan.images; ++i) {
                                    reinterpret_cast<uint32_t*>(
                                        images + (size_t)(i * plan.kchunk + s)
                                                     * arriba::MK_IMAGE)[w] =
                                        word << arriba::mk_any_b_shift(i);
                                }
                            }
                        }
                        fence_proxy_async();
                        __syncthreads();
                    }
                    for (int s = 0; s < c_n; ++s) {
                        uint32_t a[arriba::MK_GROUP][4];
#pragma unroll
                        for (int j = 0; j < arriba::MK_GROUP; ++j) {
                            if (j < plan.groups) {
                                arriba::mk_any_a_fragment(
                                    window, W, g * span + j * arriba::MK_TILE_M
                                                   + warp_row,
                                    k, c0 + s, lane, a[j],
                                    arriba::mk_any_a_shift(plan, j));
                            }
                        }
                        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
                        pin(d);
#pragma unroll
                        for (int j = 0; j < arriba::MK_GROUP; ++j) {
                            if (j < plan.groups) {
                                const int image =
                                    arriba::mk_any_image(plan, j);
                                wgmma_tile(d, a[j], arriba::mk_desc(
                                    smem(images + (size_t)(image * plan.kchunk
                                                           + s)
                                                      * arriba::MK_IMAGE),
                                    arriba::MK_LBO, arriba::MK_SBO), 1);
                            }
                        }
                        asm volatile("wgmma.commit_group.sync.aligned;"
                                     ::: "memory");
                        asm volatile("wgmma.wait_group.sync.aligned 0;"
                                     ::: "memory");
                        pin(d);
                    }
                }
                hit = __syncthreads_or(arriba::mk_any_hit<kAcc>(plan, d));
            }
        }
        if (tid == 0) out[row] = hit ? 1 : 0;
    }
}

// blocks that fit on the card at once, for the device in use (asked once a
// device)
int grid_limit(int* blocks) {
    static int known[64];
    int device, sms, per_sm;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device < 64 && known[device] > 0) {
        *blocks = known[device];
        return 0;
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mxu_kmer_screen_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (device < 64) known[device] = *blocks;
    return 0;
}

}  // namespace

extern "C" {

// reads uint8 [n, L], windows uint8 [n, W] (codes 0-3; any larger byte one-
// hots to zero), out uint8 [n]: 1 where read and window share an 8-mer
int arriba_mxu_kmer_screen(const void* reads, const void* windows, void* out,
                           int n, int L, int W, void* stream) {
    if (n == 0) return 0;
    int blocks;
    const int err = grid_limit(&blocks);
    if (err != 0) return err;
    mxu_kmer_screen_kernel<<<n < blocks ? n : blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (uint8_t*)out, n, L,
        W);
    return (int)cudaGetLastError();
}

const char* arriba_mxu_kmer_screen_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// the same at any k >= 1 (mxu_kmer_screen_any_kernel; the caller sends
// k = 8 to arriba_mxu_kmer_screen): out uint8 [n], 1 where read and window
// share a k-mer over codes 0-3
int arriba_mxu_kmer_screen_any_k(const void* reads, const void* windows,
                                 void* out, int n, int L, int W, int k,
                                 void* stream) {
    if (n == 0) return 0;
    if (k < 1) return (int)cudaErrorInvalidValue;
    const arriba::MkPlan plan = arriba::mk_plan(k);
    const int smem_bytes = plan.images * plan.kchunk * arriba::MK_IMAGE;
    cudaError_t err = cudaFuncSetAttribute(
        mxu_kmer_screen_any_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    int device, sms, per_sm;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mxu_kmer_screen_any_kernel, kThreads, smem_bytes);
    }
    if (err != cudaSuccess) return (int)err;
    const int blocks = sms * (per_sm > 0 ? per_sm : 1);
    mxu_kmer_screen_any_kernel<<<n < blocks ? n : blocks, kThreads,
                                 smem_bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (uint8_t*)out, n, L,
        W, plan);
    return (int)cudaGetLastError();
}

const char* arriba_mxu_kmer_screen_any_k_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
