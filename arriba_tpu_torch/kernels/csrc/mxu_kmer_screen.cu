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

// K4 at any k other than 8 (mxu_kmer_screen.cuh, "K4 at any k" and "The
// any-k kernel's stages"): K4's design at any k. A block is one warpgroup
// and walks its rows by a fixed stride through K4's copy ring: each stage
// (a slab of MK_N read k-mers against a chunk of window k-mers, over a part
// of the k-steps; mk_any_layout) reaches shared memory by cp.async.bulk on
// its slot's mbarrier, MK_STAGES - 1 stages ahead of the stage in use, in
// the order of the block's MkCursor, so the next row's first stages arrive
// while a row that a hit decides is skipped. At a stage the block writes
// the window's bytes once into a table of one-hot words (mk_word) and, at a
// slab's first stage (at every stage when a row has more than one part),
// the slab's B images of the stage's k-steps, scaled 1 and 64, from the
// staged read bytes (mk_any_b_word); one barrier. Then for each group of
// plan.groups tiles of 64 window k-mers: the accumulator starts at
// plan.bias (b in every digit, 0 with one tile a group), and every k-step of the stage goes to the
// tensor cores back to back: for each k-step the tiles' A fragments from
// the word table with their shifts (mk_any_a_words; built while the
// k-step before runs), wgmma.fence, the tiles' wgmma.mma_async.m64n160k32
// s8 into the one accumulator; then one commit and one wait for the
// group; the next group's first A while every thread tests its 80 sums
// (mk_any_hit: their OR against plan.mask, or with one tile a group their
// largest against k); and after every group the block votes
// (__syncthreads_or, uniform; K4's vote every two groups measured slower
// here, PERF.md, the any-k redesign). Where a row has more than
// one part (k > 72), the group's accumulator runs on across its stages
// and is tested at the last. A hit ends the row: its stages in flight are
// waited for and skipped. G (= plan.groups) and KB (the k-steps a stage
// issues: a k-mer's up to k = 32, else the images' nine or nineteen) are
// template arguments (any_kernel). Every instantiation fits four blocks an
// SM in its registers (at most 128: 120-125 by ptxas), and the stage's
// chunk is sized so that their shared memory does too where it can
// (mk_any_layout).
template <int KB, int G>
__global__ void __launch_bounds__(kThreads, arriba::MK_ANY_SM_BLOCKS)
mxu_kmer_screen_any_kernel(const uint8_t* __restrict__ reads,
                           const uint8_t* __restrict__ windows,
                           uint8_t* __restrict__ out, int n, int L, int W,
                           arriba::MkPlan plan, arriba::MkAnyLayout lay) {
    extern __shared__ __align__(128) uint8_t shared[];  // mk_any_layout
    __shared__ __align__(8) uint64_t bars[kStages];
    __shared__ Stage stages[kStages];
    uint8_t* const images = shared;
    uint8_t* const read_s = shared + lay.read_at;
    uint8_t* const window_s = shared + lay.window_at;
    uint32_t* const words = reinterpret_cast<uint32_t*>(shared + lay.words_at);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp_row = 16 * (tid >> 5);
    const int slabs = (arriba::mk_any_kmers(L, plan.k) + arriba::MK_N - 1)
                      / arriba::MK_N;
    const int wk = arriba::mk_any_kmers(W, plan.k);
    const int chunks = (wk + lay.chunk - 1) / lay.chunk;
    if (slabs == 0 || chunks == 0) {        // no k-mer on one side
        for (int row = blockIdx.x * kThreads + tid; row < n;
             row += gridDim.x * kThreads) {
            out[row] = 0;
        }
        return;
    }
    if (tid == 0) {
        for (int i = 0; i < kStages; ++i) bar_init(&bars[i]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the copy cursor over (row, slab, chunk x part) (every thread moves
    // it, thread 0 issues) and the last row decided by a hit
    const int stage_chunks = chunks * lay.parts;
    arriba::MkCursor cursor = {(int)blockIdx.x, 0, 0};
    int decided = -1;
    auto issue = [&](int i) {
        const arriba::MkStage at = cursor.next(n, gridDim.x, slabs,
                                               stage_chunks, decided);
        const int slot = i % kStages;
        if (tid == 0) {
            Stage s = {at, 0, 0};
            if (at.row >= 0) {
                const int c0 = at.chunk % lay.parts * plan.kchunk;
                const arriba::MkBytes rb = arriba::mk_any_bytes(
                    plan, at.slab * arriba::MK_N, arriba::MK_N, c0, L);
                const arriba::MkBytes wb = arriba::mk_any_bytes(
                    plan, at.chunk / lay.parts * lay.chunk, lay.chunk, c0, W);
                const uint8_t* r = reads + (size_t)at.row * L + rb.start;
                const uint8_t* w = windows + (size_t)at.row * W + wb.start;
                const uint32_t r_bytes = arriba::mk_span(
                    (uintptr_t)r, rb.count, &s.read_shift);
                const uint32_t w_bytes = arriba::mk_span(
                    (uintptr_t)w, wb.count, &s.window_shift);
                stage_copy(&bars[slot], read_s + slot * lay.read_slot,
                           r - s.read_shift, r_bytes,
                           window_s + slot * lay.window_slot,
                           w - s.window_shift, w_bytes);
            }
            stages[slot] = s;
        }
    };
    for (int i = 0; i < kStages - 1; ++i) issue(i);

    const uint64_t desc0 = arriba::mk_desc(smem(images), arriba::MK_LBO,
                                           arriba::MK_SBO);
    const int span = G * arriba::MK_TILE_M;
    const int32_t start = plan.bias;
    int32_t d[kAcc];
    uint32_t a[KB][G][4];
    // the A fragments of k-step s for group g's tiles (zero past k)
    auto build_a = [&](uint32_t (&as)[G][4], int g, int s, int c0) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
            arriba::mk_any_a_words(plan, words,
                                   g * span + j * arriba::MK_TILE_M
                                       + warp_row,
                                   s, c0, lane, as[j],
                                   arriba::mk_any_a_shift(plan, j));
        }
    };

    for (int i = 0;; ++i) {
        // every thread is done with slot (i - 1) % kStages, whose refill by
        // the async proxy follows, with the images' last products and with
        // the word table; the stage descriptors written so far are visible
        fence_proxy_async();
        __syncthreads();
        issue(i + kStages - 1);
        const int slot = i % kStages;
        const Stage stage = stages[slot];
        const arriba::MkStage s = stage.at;
        if (s.row < 0) break;
        bar_wait(&bars[slot], (uint32_t)(i / kStages) & 1u);
        if (s.row == decided) continue;
        const int chunk = s.chunk / lay.parts;
        const int part = s.chunk % lay.parts;
        const int c0 = part * plan.kchunk;
        const int kc = min(plan.kchunk, plan.ksteps - c0);
        // the B images of the stage's k-steps where they change, and the
        // window's bases as one-hot words; one barrier for both
        if (lay.parts > 1 || s.chunk == 0) {
            const uint8_t* r = read_s + slot * lay.read_slot
                               + stage.read_shift;
            const int count = arriba::mk_any_bytes(
                plan, s.slab * arriba::MK_N, arriba::MK_N, c0, L).count;
            constexpr int kImageWords = arriba::MK_IMAGE / 4;
            for (int w = tid; w < kc * kImageWords; w += kThreads) {
                const int step = w / kImageWords;
                const int at = w - step * kImageWords;
                const uint32_t word = arriba::mk_any_b_word(
                    plan, r, count, c0 + step, c0, at);
                for (int im = 0; im < plan.images; ++im) {
                    reinterpret_cast<uint32_t*>(images)[
                        (im * plan.kchunk + step) * kImageWords + at] =
                        word << arriba::mk_any_b_shift(im);
                }
            }
            fence_proxy_async();
        }
        const int q0 = chunk * lay.chunk;
        {
            const uint8_t* w = window_s + slot * lay.window_slot
                               + stage.window_shift;
            const int count = arriba::mk_any_bytes(plan, q0, lay.chunk, c0,
                                                   W).count;
            for (int at = tid; at < lay.words; at += kThreads) {
                words[at] = arriba::mk_word(w, count, at);
            }
        }
        __syncthreads();
        // the stage's groups; a group past the window's last k-mer holds
        // only k-mers that run off it (zero words, no hit). Every path up
        // to the wait is the same for every thread and every group (no
        // branch, which would make ptxas serialise the wgmmas): a part
        // past the first carries the accumulator on, a k-step past the
        // part's (at most KB - 1 of them, at the last part or where KB
        // rounds the k-steps up) has a zero A and multiplies an image the
        // part holds
        const int groups = min(lay.groups, (wk - q0 + span - 1) / span);
        const bool last_part = part == lay.parts - 1;
        build_a(a[0], 0, c0, c0);
        bool hit = false, seen = false;
        for (int g = 0; g < groups && !hit; ++g) {
#pragma unroll
            for (int x = 0; x < kAcc; ++x) d[x] = part == 0 ? start : d[x];
            // k-step x's A is built while k-step x - 1's products run (a[0]
            // ahead of the group). ptxas then reports the wgmmas
            // serialised (an A register written inside the commit group),
            // but every A built first measured no faster at k = 12 and 16
            // and slower at k = 31, where its 157 registers let three
            // blocks share an SM, not four (PERF.md, the any-k redesign)
#pragma unroll
            for (int x = 0; x < KB; ++x) {
                if (x > 0) build_a(a[x], g, c0 + x, c0);
                const int step = x < kc ? x : 0;
                asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
                pin(d);
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    const int im = arriba::mk_any_image(plan, j);
                    wgmma_tile(d, a[x][j],
                               desc0 + (uint64_t)(((im * plan.kchunk + step)
                                                   * arriba::MK_IMAGE) >> 4),
                               1);
                }
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            pin(d);
            // the next group's first A (this group's again at the last)
            build_a(a[0], g + 1 < groups ? g + 1 : g, c0, c0);
            if (last_part) {
                seen |= arriba::mk_any_hit<kAcc>(plan, d);
                hit = __syncthreads_or(seen);
            }
        }
        if (hit) decided = s.row;
        if ((hit || (s.slab == slabs - 1 && s.chunk == stage_chunks - 1))
            && tid == 0) {
            out[s.row] = hit ? 1 : 0;
        }
    }
}

using AnyKernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int,
                           int, int, arriba::MkPlan, arriba::MkAnyLayout);

// the instantiation for a plan: G = plan.groups tiles a group, KB k-steps a
// wait: a k-mer's k-steps at k <= 32 (k 17-24 with one zero k-step), nine
// (the images' k-steps with two tiles a group, k 33-2,048) or nineteen (one
// tile a group, past k = 2,048); which numbers it for the host's caches
AnyKernel any_kernel(const arriba::MkPlan& plan, int* which) {
    static const AnyKernel kernels[] = {
        mxu_kmer_screen_any_kernel<1, 4>, mxu_kmer_screen_any_kernel<2, 3>,
        mxu_kmer_screen_any_kernel<4, 3>, mxu_kmer_screen_any_kernel<9, 2>,
        mxu_kmer_screen_any_kernel<19, 1>};
    *which = plan.groups == 4 ? 0 : plan.groups == 3 ? (plan.ksteps == 2
                                                         ? 1 : 2)
             : plan.groups == 2 ? 3 : 4;
    return kernels[*which];
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
// share a k-mer over codes 0-3. The grid (what fits on the card at once, at
// most a block a row) is asked once a device and k, and each
// instantiation's dynamic shared-memory limit is only ever raised.
int arriba_mxu_kmer_screen_any_k(const void* reads, const void* windows,
                                 void* out, int n, int L, int W, int k,
                                 void* stream) {
    static uint64_t known[64][64];  // (k << 32) | blocks, at [device][k % 64]
    static int limit[64][5];        // each instantiation's smem attribute
    if (n == 0) return 0;
    if (k < 1) return (int)cudaErrorInvalidValue;
    const arriba::MkPlan plan = arriba::mk_plan(k);
    const arriba::MkAnyLayout lay = arriba::mk_any_layout(plan);
    int which, device, blocks = 0;
    const AnyKernel kernel = any_kernel(plan, &which);
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const bool cached = device < 64;
    const uint64_t entry = cached ? known[device][k & 63] : 0;
    if (entry >> 32 == (uint64_t)k) blocks = (int)(uint32_t)entry;
    if (blocks == 0) {
        if (!cached || lay.bytes > limit[device][which]) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                lay.bytes);
            if (err != cudaSuccess) return (int)err;
            if (cached) limit[device][which] = lay.bytes;
        }
        int sms, per_sm;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, lay.bytes);
        }
        if (err != cudaSuccess) return (int)err;
        blocks = sms * (per_sm > 0 ? per_sm : 1);
        if (cached) known[device][k & 63] = (uint64_t)k << 32 | blocks;
    }
    kernel<<<n < blocks ? n : blocks, kThreads, lay.bytes,
             (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows, (uint8_t*)out, n, L,
        W, plan, lay);
    return (int)cudaGetLastError();
}

const char* arriba_mxu_kmer_screen_any_k_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// the window k-mers a stage of the any-k kernel holds at k (mk_any_layout;
// a host function, no launch): where a k-mer straddles a stage's chunk
int arriba_mxu_kmer_screen_any_k_chunk(int k) {
    return k < 1 ? 0 : arriba::mk_any_layout(arriba::mk_plan(k)).chunk;
}

}  // extern "C"
