// K2: the read-level low-entropy scan, for sm_90a.
//
// Replaces: the device op of arriba_tpu/ops/readfilters.py
// _low_entropy_core / _low_entropy_core_packed (a jax.jit associative scan
// over packed 4-state tables with one-hot counters in 10-bit lanes).
//
// What bounds it: integer operations. A 131,072-row chunk of 150 bp reads
// is ~5 MB of 2-bit codes plus 32 B of metadata a row (~2.8 us of memory
// time), and each eligible position needs ~9 integer operations (3-mer
// from the byte pair, selection, its weight, one counter add; the
// aligned-segment tests are position ranges fixed per read), each read
// ~640 more to clear and test its 64 counter words (chip_smoke.py LE_OPS).
// Rows past 3,072 codes do the same ~9 a position (chip_smoke.py
// le_long_ops): 8,192 reads of 4,000 codes are 31 M positions, 32 MB.
//
// Design: a thread a read for rows of at most 3,072 codes (measured
// against a group of 2-32 lanes a read, which each pay a scan and the
// summing of their counters: PERF.md). A block of 128 threads holds 128
// reads, whose packed rows lie contiguous in memory: the block stages them
// into shared memory with 16-byte loads. Such rows keep one 32-bit word
// per 3-mer with the three counters in 10-bit fields: le_scan_packed walks
// the read from one byte pair per four positions and adds at every
// position (0 where it is not selected: no branch), in 64 words private to
// the thread and laid out so that all of them sit in the thread's own
// bank; the thresholds are tested once per 3-mer at the end.
//
// Longer rows take low_entropy_long_kernel: a thread a read would walk
// 4,000 dependent steps with a few warps an SM. Instead a group of
// LE_LONG_LANES lanes takes a read, as the JAX op's associative scan
// allows (the long-row procedure in low_entropy.cuh): the group stages a
// tile of up to 4,096 positions with 16-byte loads, neighbouring lanes on
// neighbouring addresses; each lane walks its chunk of whole words from
// the four
// start states at once (pass 1, which records each start state's
// selections), a shuffle scan of the chunks' transfer tables gives every
// lane its true start state, and each lane adds that state's selections
// into 64 packed words of its own, as the packed kernel does (pass 2).
// Each tile's table carries the state to the next; the group flushes the
// 10-bit fields into 32-bit totals before one could pass 1,023, and once
// at the end, each lane summing the words of 64 / LE_LONG_LANES 3-mers
// over the group four lanes at a time, and the group tests them with one
// vote. The read is walked whole, as in the packed kernel. 128 threads a
// block, 37 KB of shared memory: 6 blocks, 24 warps an SM. What bounds it
// is its own integer instructions, ~20 a position over the two passes
// against the function's ~9 (PERF.md): not the shared-memory pipe (a
// stage padded against the lanes' bank conflicts gained nothing), the
// instruction cache or the atomics.
//
// Each kernel has its own entry point; the host picks one from the row
// width before launch (kernels.le_route), and the packed entry refuses
// wider rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "low_entropy.cuh"

namespace {

constexpr int kBlock = 128;  // the packed kernel
constexpr int kMeta = 8;  // length, a1s, a1e, a2s, a2e, th_all, th_a1, th_a2

// Rows of at most 3,072 codes: staged rows, packed counters private to a
// thread
__global__ void __launch_bounds__(kBlock)
low_entropy_kernel(const uint8_t* __restrict__ packed,
                   const int32_t* __restrict__ meta,
                   uint8_t* __restrict__ out, int n, int row_bytes) {
    extern __shared__ uint4 shared[];
    // [warp][3-mer][lane]: lane l's counter of 3-mer v at v * 32 + l of its
    // warp's 8 KB, so all of a thread's words sit in bank l
    uint32_t* counts = reinterpret_cast<uint32_t*>(shared);
    uint8_t* stage = reinterpret_cast<uint8_t*>(counts + kBlock * 64);

    // stage the block's rows: whole 16-byte words where they lie inside,
    // bytes at the ragged ends; stage mirrors the rows' 16-byte alignment
    const int first_row = blockIdx.x * kBlock;
    const int rows = min(kBlock, n - first_row);
    const uint8_t* begin = packed + (size_t)first_row * row_bytes;
    const int offset = (int)(reinterpret_cast<uintptr_t>(begin) & 15);
    const uint8_t* base = begin - offset;
    const int end = offset + rows * row_bytes;
    for (int w = threadIdx.x; w < (end + 15) / 16; w += kBlock) {
        if (w * 16 >= offset && w * 16 + 16 <= end) {
            reinterpret_cast<uint4*>(stage)[w] =
                __ldg(reinterpret_cast<const uint4*>(base) + w);
        } else {
            for (int b = max(w * 16, offset); b < min(w * 16 + 16, end); ++b) {
                stage[b] = base[b];
            }
        }
    }
    uint32_t* mine = counts + (threadIdx.x >> 5) * 64 * 32
                     + (threadIdx.x & 31);
#pragma unroll
    for (int v = 0; v < 64; ++v) mine[v * 32] = 0;
    const int row = first_row + threadIdx.x;
    int n_pos = 0;
    arriba::LeSegment a1{0, 0}, a2{0, 0};
    int th_all = 0, th_a1 = 0, th_a2 = 0;
    if (row < n) {
        const int32_t* m = meta + (size_t)row * kMeta;
        // the caller checks length <= 4 * row_bytes on the host; the clamp
        // keeps the scan inside the row whatever meta holds
        n_pos = max(min(__ldg(m), 4 * row_bytes) - arriba::LE_K, 0);
        a1 = arriba::le_segment(__ldg(m + 1), __ldg(m + 2), n_pos);
        a2 = arriba::le_segment(__ldg(m + 3), __ldg(m + 4), n_pos);
        th_all = __ldg(m + 5);
        th_a1 = __ldg(m + 6);
        th_a2 = __ldg(m + 7);
    }
    __syncthreads();

    arriba::le_scan_packed(
        stage + offset + threadIdx.x * row_bytes, row_bytes, n_pos, a1, a2,
        [&](int v, uint32_t weight) { atomicAdd(&mine[v * 32], weight); });
    bool flagged = false;
    for (int v = 0; v < 64; ++v) {
        flagged |= arriba::le_crossed_packed(mine[v * 32], th_all, th_a1,
                                             th_a2);
    }
    if (row < n) out[row] = flagged;
}

// Longer rows: a group of kLongLanes lanes a read (the long-row procedure
// of low_entropy.cuh)
constexpr int kLongBlock = 128;
constexpr int kLongLanes = arriba::LE_LONG_LANES;
constexpr int kLongWords = arriba::LE_LONG_WORDS;
constexpr int kLongGroups = kLongBlock / kLongLanes;
constexpr int kLongKmers = arriba::LE_KMERS / kLongLanes;  // folded a lane
// counters [warp][3-mer][lane], 8 KB a warp; a stage a group
constexpr int kLongSmem = kLongBlock * arriba::LE_KMERS * 4
                          + kLongGroups * arriba::LE_LONG_STAGE_BYTES;
// blocks an SM by shared memory: 227 KB, less 1 KB the card keeps a block
constexpr int kLongMinBlocks = 232448 / (kLongSmem + 1024);

static_assert(kLongLanes >= 4 && 32 % kLongLanes == 0,
              "a read's lanes lie in one warp, four lanes' words a quad");

// The exclusive scan of the group's tables (mask: its lanes of the warp):
// excl composes the tables of the lanes before this one, earlier lanes
// first; total all of the group's
__device__ inline void le_group_scan(unsigned mask, uint32_t table, int lane,
                                     uint32_t* excl, uint32_t* total) {
    uint32_t incl = table;
#pragma unroll
    for (int d = 1; d < kLongLanes; d <<= 1) {
        const uint32_t before = __shfl_up_sync(mask, incl, d, kLongLanes);
        if (lane >= d) incl = arriba::le_compose(before, incl);
    }
    const uint32_t prev = __shfl_up_sync(mask, incl, 1, kLongLanes);
    *excl = lane == 0 ? arriba::LE_IDENTITY : prev;
    *total = __shfl_sync(mask, incl, kLongLanes - 1, kLongLanes);
}

__global__ void __launch_bounds__(kLongBlock, kLongMinBlocks)
low_entropy_long_kernel(const uint8_t* __restrict__ packed,
                        const int32_t* __restrict__ meta,
                        uint8_t* __restrict__ out, int n, int row_bytes) {
    extern __shared__ uint4 shared[];
    uint32_t* counts = reinterpret_cast<uint32_t*>(shared);
    uint8_t* groups = reinterpret_cast<uint8_t*>(counts + kLongBlock * 64);
    const int group = threadIdx.x / kLongLanes;
    const int lane = threadIdx.x % kLongLanes;
    const int first = group * kLongLanes;  // the group's first thread
    const long long row = (long long)blockIdx.x * kLongGroups + group;
    if (row >= n) return;  // the whole group
    uint8_t* stage = groups + group * arriba::LE_LONG_STAGE_BYTES;
    const uint32_t* stage_words = reinterpret_cast<const uint32_t*>(stage);
    const unsigned mask = kLongLanes == 32
        ? 0xffffffffu
        : ((1u << (kLongLanes & 31)) - 1u)
              << ((threadIdx.x & 31) / kLongLanes * kLongLanes);

    const int32_t* m = meta + row * kMeta;
    // the caller checks length <= 4 * row_bytes on the host; the clamp
    // keeps the scan inside the row whatever meta holds
    const int n_pos = max(min(__ldg(m), 4 * row_bytes) - arriba::LE_K, 0);
    const arriba::LeSegment a1 =
        arriba::le_segment(__ldg(m + 1), __ldg(m + 2), n_pos);
    const arriba::LeSegment a2 =
        arriba::le_segment(__ldg(m + 3), __ldg(m + 4), n_pos);
    const arriba::LeLongPlan plan =
        arriba::le_long_plan(n_pos, kLongLanes, kLongWords);
    const uint8_t* row_bytes_at = packed + row * row_bytes;

    // all of a thread's counter words sit in its bank: 3-mer v's at byte
    // mine_off | v << 7, whose bits do not overlap
    const uint32_t mine_off =
        ((threadIdx.x >> 5) * 64 * 32 + (threadIdx.x & 31)) * 4;
    // group lanes 4m to 4m + 3's words of 3-mer v, 16 bytes
    constexpr int kQuads = kLongLanes / 4;
    const auto quad = [&](int v, int m) {
        const int t = first + 4 * m;
        return reinterpret_cast<uint4*>(counts + (t >> 5) * 64 * 32 + v * 32
                                        + (t & 31));
    };
    // clear the group's words, 16 quads a lane
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int at = lane + k * kLongLanes;
        *quad(at / kQuads, at % kQuads) = make_uint4(0u, 0u, 0u, 0u);
    }
    arriba::LeTotals totals[kLongKmers];
#pragma unroll
    for (int k = 0; k < kLongKmers; ++k) totals[k] = {0u, 0u, 0u};
    // sums every lane's words of this lane's 3-mers into totals, the
    // quads taken from the lane's own index on so that a quarter of the
    // warp reads eight bank groups; a flush clears them after
    const auto fold = [&](int tiles, bool clear) {
        const int run = arriba::le_fold_run(tiles, plan.words);
        __syncwarp(mask);
#pragma unroll
        for (int k = 0; k < kLongKmers; ++k) {
            const int v = lane + k * kLongLanes;
            arriba::le_fold(
                [&](int m) {
                    const uint4 q = *quad(v, m);
                    return arriba::LeQuad{q.x, q.y, q.z, q.w};
                },
                kQuads, lane, run, &totals[k]);
            if (clear) {
                for (int m = 0; m < kQuads; ++m) {
                    *quad(v, m) = make_uint4(0u, 0u, 0u, 0u);
                }
            }
        }
        __syncwarp(mask);
    };

    int state = 0;  // the state the tile starts in
    int since = 0;  // tiles counted since the last flush
    for (int t = 0; t < plan.tiles; ++t) {
        if (arriba::le_flush_before(since, plan.words)) {
            fold(since, true);
            since = 0;
        }
        // stage the tile: whole 16-byte words where they lie inside the
        // span, bytes at its ragged ends; the stage mirrors the row's
        // 16-byte alignment
        const arriba::LeSpan span =
            arriba::le_tile_span(t, plan, kLongLanes, row_bytes);
        const uint8_t* lo = row_bytes_at + span.lo;
        const int head = (int)(reinterpret_cast<uintptr_t>(lo) & 15);
        const uint8_t* base = lo - head;
        const int end = head + (int)(span.hi - span.lo);
        __syncwarp(mask);  // the last tile's words are read
        for (int w = lane; w < (end + 15) / 16; w += kLongLanes) {
            if (w * 16 >= head && w * 16 + 16 <= end) {
                reinterpret_cast<uint4*>(stage)[w] =
                    __ldg(reinterpret_cast<const uint4*>(base) + w);
            } else {
                for (int b = max(w * 16, head); b < min(w * 16 + 16, end);
                     ++b) {
                    stage[b] = base[b];
                }
            }
        }
        __syncwarp(mask);
        // the lane's chunk: its word -1 is the stage's bytes q0 on
        const int word0 = head + (int)(span.first - span.lo);
        const int q0 = word0 + 4 * (lane * plan.words - 1);
        const auto chunk = arriba::le_chunk(
            [&](int i) -> uint32_t {
                return stage_words[max((q0 >> 2) + i, 0)];
            },
            (word0 & 3) * 8, t == 0 && lane == 0);
        uint64_t rec[kLongWords];
        const uint32_t table =
            arriba::le_chunk_pass1<kLongWords>(chunk, plan.words, rec);
        uint32_t excl, total;
        le_group_scan(mask, table, lane, &excl, &total);
        const int start = arriba::le_apply(excl, state);
        state = arriba::le_apply(total, state);
        const long long p0 =
            16LL * plan.words * ((long long)t * kLongLanes + lane);
        if (p0 < n_pos) {
            arriba::le_chunk_pass2<kLongWords>(
                chunk, plan.words, rec, start, (int)p0, n_pos, a1, a2,
                [&](int v, uint32_t weight) {
                    atomicAdd(reinterpret_cast<uint32_t*>(
                                  reinterpret_cast<char*>(counts)
                                  + (mine_off | ((uint32_t)v << 7))),
                              weight);
                });
        }
        ++since;
    }
    fold(since, false);
    bool flagged = false;
#pragma unroll
    for (int k = 0; k < kLongKmers; ++k) {
        flagged |= arriba::le_crossed_totals(totals[k], __ldg(m + 5),
                                             __ldg(m + 6), __ldg(m + 7));
    }
    flagged = __any_sync(mask, flagged);
    if (lane == 0) out[row] = flagged;
}

}  // namespace

extern "C" {

// packed uint8 [n, row_bytes] (4 codes per byte), meta int32 [n, 8],
// out uint8 [n]; length <= 4 * row_bytes per row. The packed counters:
// rows of at most LE_PACKED_MAX_CODES codes (wider ones are refused and
// take arriba_low_entropy_long).
int arriba_low_entropy(const void* packed, const void* meta, void* out,
                       int n, int row_bytes, void* stream) {
    if (4LL * row_bytes > arriba::LE_PACKED_MAX_CODES) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return 0;
    // counters, then the rows, shifted by up to 15 bytes to keep their
    // 16-byte alignment, in whole 16-byte words
    const size_t smem = kBlock * 64 * sizeof(uint32_t)
                        + ((size_t)kBlock * row_bytes + 30) / 16 * 16;
    if (smem > 48 * 1024) {  // rows wider than 512 codes
        const cudaError_t e = cudaFuncSetAttribute(
            low_entropy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    low_entropy_kernel<<<(n + kBlock - 1) / kBlock, kBlock, smem,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)meta, (uint8_t*)out, n,
        row_bytes);
    return (int)cudaGetLastError();
}

const char* arriba_low_entropy_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// the same for rows past LE_PACKED_MAX_CODES codes, at any width
// (low_entropy_long_kernel, a group of lanes a read)
int arriba_low_entropy_long(const void* packed, const void* meta, void* out,
                            int n, int row_bytes, void* stream) {
    if (n == 0) return 0;
    // the kernel's shared memory and the largest carveout, set once a
    // device
    static int configured[64];
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    if (device >= 64 || !configured[device]) {
        e = cudaFuncSetAttribute(low_entropy_long_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLongSmem);
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(
                low_entropy_long_kernel,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        }
        if (e != cudaSuccess) return (int)e;
        if (device < 64) configured[device] = 1;
    }
    low_entropy_long_kernel<<<(n + kLongGroups - 1) / kLongGroups, kLongBlock,
                              kLongSmem, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)meta, (uint8_t*)out, n,
        row_bytes);
    return (int)cudaGetLastError();
}

const char* arriba_low_entropy_long_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
