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
//
// Design: a thread a read (measured against a group of 2-32 lanes a read,
// which each pay a scan and the summing of their counters: PERF.md). A
// block of 128 threads holds 128 reads, whose packed rows lie contiguous
// in memory: the block stages them into shared memory with 16-byte loads.
// Rows of at most 3,072 codes keep one 32-bit word per 3-mer with the
// three counters in 10-bit fields: le_scan_packed walks the read from one
// byte pair per four positions and adds at every position (0 where it is
// not selected: no branch), in 64 words private to the thread and laid out
// so that all of them sit in the thread's own bank; the thresholds are
// tested once per 3-mer at the end. Longer rows take a second kernel, le_row
// with three 32-bit counters a 3-mer, reading the codes from device memory.
// Each kernel has its own entry point; the host picks one from the row
// width before launch (kernels.le_route), and the packed entry refuses
// wider rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "low_entropy.cuh"

namespace {

constexpr int kBlock = 128;      // the packed kernel
constexpr int kLongBlock = 64;   // the long-row kernel: 48 KB of counters
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

// Longer rows: le_row, three 32-bit counters per 3-mer, the thread's
// column of the block's counters
__global__ void __launch_bounds__(kLongBlock)
low_entropy_long_kernel(const uint8_t* __restrict__ packed,
                        const int32_t* __restrict__ meta,
                        uint8_t* __restrict__ out, int n, int row_bytes) {
    __shared__ uint32_t counts[3 * arriba::LE_KMERS * kLongBlock];
    const int row = blockIdx.x * kLongBlock + threadIdx.x;
    if (row >= n) return;
    const int32_t* m = meta + (size_t)row * kMeta;
    const int length = min(m[0], 4 * row_bytes);
    out[row] = arriba::le_row(packed + (size_t)row * row_bytes, length, m[1],
                              m[2], m[3], m[4], m[5], m[6], m[7],
                              counts + threadIdx.x, kLongBlock) ? 1 : 0;
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

// the same at any row width: three 32-bit counters a 3-mer
// (low_entropy_long_kernel), for rows past LE_PACKED_MAX_CODES codes
int arriba_low_entropy_long(const void* packed, const void* meta, void* out,
                            int n, int row_bytes, void* stream) {
    if (n == 0) return 0;
    low_entropy_long_kernel<<<(n + kLongBlock - 1) / kLongBlock, kLongBlock,
                              0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int32_t*)meta, (uint8_t*)out, n,
        row_bytes);
    return (int)cudaGetLastError();
}

const char* arriba_low_entropy_long_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
