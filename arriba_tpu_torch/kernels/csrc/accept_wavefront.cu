// K1: exact single-seed ACCEPT of filter_mismappers, for sm_90a.
//
// Replaces: arriba_tpu/ops/realign.py:444 _accept_wavefront_pallas (the
// Pallas TPU kernel, pl.pallas_call at :564) and its XLA twin
// _accept_wavefront_kernel (:339).
//
// What bounds it: integer operations, at the card's 32-bit integer rate
// (64 a clock per SM on compute capability 9.0). A row is a read of up to
// L = 192 bytes against a window of up to 8,192. Walking every diagonal
// would be ~1.2 M cells a row at 36 operations each. But a diagonal
// accepts only through a seed that fired
// (accept_wavefront.cuh, "Seed lookup"), and a 150 bp read at min_score
// 120 has only 24 read starts that may seed. So the work the data needs is
// a scan of the row's eligible window positions (an 8-mer and a bitmap
// test each, ~14 operations) plus full walks of the few diagonals the scan
// names: on random windows about one in 2,700 positions names one.
// chip_smoke.py counts both from its inputs. The bytes (~4 MB a launch)
// stay far below the operations.
//
// Design: a block owns one row and one strip of up to 2,048 diagonals, so
// a launch of 512 rows x 8,192 window bytes is 2,560 blocks. It
//  1. clears a 65,536-bit bitmap in shared memory, stages the read, and
//     stages the window stretch its strip's seeds can reach, as code bytes
//     (16-byte loads from the 16-byte boundary before it where the rows or
//     the table are 16-byte aligned, each byte coded once);
//  2. sets the bit of the code 8-mer of every eligible read start and keeps
//     the 8-mers in a list indexed by start;
//  3. steps over the stretch's window positions, one thread a position:
//     where the position may seed and its 8-mer's bit is set, each read
//     start with that 8-mer names the diagonal j - s. A diagonal of the
//     strip is claimed with atomicOr in a shared bitset, so each one is
//     queued once, whatever number of seeds name it (a poly-A row names
//     every diagonal and costs one walk each, no more than walking all);
//  4. drains the queue, one walk a thread, with the unchanged aw_diagonal,
//     and stops taking walks once a walk of the block has accepted.
// The row verdict is an OR: a warp ballot, then one atomicOr per warp into
// an int32 [N] output that the caller zeroes; a block whose row another
// block has already accepted skips its work. The result is exact whatever
// order the blocks run in.
// A row whose min_score is within an unseeded walk's reach (min_score <=
// read_len - 2^20; accept_wavefront.cuh, aw_walks_all) skips steps 1-3 and
// walks every diagonal of its strip that holds a valid cell (walk_all),
// with the plain version's arithmetic; the choice is per row, from params.
// Rows sit on gridDim.y and gridDim.z (65,535 each), so any row count
// launches. The dense entry (arriba_accept_wavefront) takes each row's
// read and window bytes as rows of [N, L] and [N, W]; the indexed one
// (arriba_accept_wavefront_indexed, the mismapper screen's path) reads
// them by offset from a read table and a window table that sit on the
// card once (accept_wavefront.cuh, aw_row_bytes), with the same steps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "accept_wavefront.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kParams = 5;  // read_len, win_len, min_score, seed_lo, seed_hi

// A row whose min_score an unseeded walk can reach (aw_walks_all): every
// diagonal of the strip with a valid cell is walked, one a thread, the
// read staged in shared memory; the block stops taking walks once one of
// them, or another block of the row, has accepted.
__device__ __noinline__ void walk_all(const uint8_t* read,
                                      const uint8_t* window,
                                      const int32_t* p, int32_t* out,
                                      int read_len, int win_len, int d_lo,
                                      int d_hi, uint8_t* read_s) {
    __shared__ int done;
    const int tid = threadIdx.x;
    int first, last;
    arriba::aw_all_span(d_lo, d_hi, read_len, win_len, &first, &last);
    if (first > last) return;  // no valid cell in the strip (uniform)
    for (int t = tid; t < read_len; t += kBlock) read_s[t] = read[t];
    if (tid == 0) done = *(volatile const int32_t*)out != 0;
    __syncthreads();
    volatile int* row_done = &done;
    bool accept = false;
    for (int delta = first + tid; delta <= last && !*row_done;
         delta += kBlock) {
        if (arriba::aw_diagonal(read_s, window, delta, read_len, win_len,
                                p[2], p[3], p[4])) {
            accept = true;
            *row_done = 1;
        }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, accept);
    if ((tid & 31) == 0 && ballot != 0) atomicOr(out, 1);
}

__global__ void __launch_bounds__(kBlock)
accept_seeded_kernel(const uint8_t* __restrict__ reads,
                     const uint8_t* __restrict__ windows,
                     const int64_t* __restrict__ offsets,
                     const int32_t* __restrict__ params,
                     int32_t* __restrict__ out, int n_rows, int L, int W,
                     int strip, int vector_loads, long long read_bytes,
                     long long table_bytes) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int n_queue;
    __shared__ int done;
    const arriba::AwLayout lay = arriba::aw_layout(L, strip);
    uint32_t* bitmap = (uint32_t*)(smem + lay.bitmap);
    uint32_t* claimed = (uint32_t*)(smem + lay.claimed);
    uint16_t* queue = (uint16_t*)(smem + lay.queue);
    uint16_t* seeds = (uint16_t*)(smem + lay.seeds);
    uint8_t* read_s = smem + lay.read;
    uint8_t* codes = smem + lay.codes;

    // rows on y and z: any row count launches (65,535 x 65,535 > 2^31)
    const long long row_yz = blockIdx.y + (long long)gridDim.y * blockIdx.z;
    if (row_yz >= n_rows) return;
    const int row = (int)row_yz;
    const int tid = threadIdx.x;
    const int32_t* p = params + (size_t)row * kParams;
    // the caller checks 0 <= read_len <= L and win_len <= W on the host;
    // the clamps keep every access inside the row whatever params hold
    const int read_len = min(max(p[0], 0), L);
    const int win_len = min(p[1], W);
    const int min_score = p[2];
    const uint8_t* read;
    const uint8_t* window;
    if (!arriba::aw_row_bytes(reads, windows, offsets, row, L, W, read_len,
                              win_len, read_bytes, table_bytes, &read,
                              &window)) {
        return;  // a row outside its tables accepts nothing
    }
    const int d_lo = -(L - 1) + (int)blockIdx.x * strip;
    const int d_hi = min(d_lo + strip, W) - 1;
    if (arriba::aw_walks_all(read_len, min_score)) {
        walk_all(read, window, p, out + row, read_len, win_len, d_lo, d_hi,
                 read_s);
        return;
    }
    const int n_seeds = arriba::aw_seed_starts(read_len, min_score);
    int lo, hi;
    arriba::aw_window_span(win_len, p[3], p[4], &lo, &hi);
    int jb, je;
    arriba::aw_scan_span(d_lo, d_hi, n_seeds, lo, hi, &jb, &je);
    if (jb > je) return;  // no seed of this row names a diagonal of the strip

    // 1. clear, stage
    for (int w = tid; w < arriba::AW_BITMAP_WORDS; w += kBlock) bitmap[w] = 0;
    for (int w = tid; w < (strip + 31) / 32; w += kBlock) claimed[w] = 0;
    for (int t = tid; t < read_len; t += kBlock) read_s[t] = read[t];
    // the stretch from window + jb - shift: 16-byte loads from an aligned
    // address where vector_loads, each byte coded once
    int shift, n_bytes;
    arriba::aw_stage_span((uintptr_t)(window + jb), jb, je, vector_loads,
                          &shift, &n_bytes);
    const uint8_t* base = window + jb - shift;
    if (vector_loads) {
        for (int v = tid; v < n_bytes / 16; v += kBlock) {
            const uint4 raw = *(const uint4*)(base + 16 * v);
            const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
            uint32_t coded[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t word = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    word |= (uint32_t)arriba::aw_code_byte(
                                (in[q] >> (8 * b)) & 0xff) << (8 * b);
                }
                coded[q] = word;
            }
            *(uint4*)(codes + 16 * v) =
                make_uint4(coded[0], coded[1], coded[2], coded[3]);
        }
    } else {
        for (int t = tid; t < n_bytes; t += kBlock) {
            codes[t] = (uint8_t)arriba::aw_code_byte(base[t]);
        }
    }
    if (tid == 0) {
        n_queue = 0;
        done = *(volatile const int32_t*)(out + row) != 0;
    }
    __syncthreads();
    if (done) return;  // another block accepted this row (uniform here)

    // 2. the read's seeds
    for (int s = tid; s < n_seeds; s += kBlock) {
        const int kmer = arriba::aw_kmer_raw(read_s + s);
        seeds[s] = (uint16_t)kmer;
        atomicOr(bitmap + (kmer >> 5), 1u << (kmer & 31));
    }
    __syncthreads();

    // 3. window scan, claim each named diagonal once
    for (int j = jb + tid; j <= je; j += kBlock) {
        const int kmer =
            arriba::aw_window_seed(codes + (j - jb + shift), bitmap);
        if (kmer < 0) continue;
        int s_lo, s_hi;
        arriba::aw_seed_span(j, d_lo, d_hi, n_seeds, &s_lo, &s_hi);
        for (int s = s_lo; s <= s_hi; ++s) {
            if (seeds[s] != kmer) continue;
            const int bit = j - s - d_lo;
            const uint32_t mask = 1u << (bit & 31);
            if (atomicOr(claimed + (bit >> 5), mask) & mask) continue;
            queue[atomicAdd(&n_queue, 1)] = (uint16_t)bit;
        }
    }

    // 4. walk the queue
    __syncthreads();
    volatile int* row_done = &done;
    bool accept = false;
    const int n = n_queue;
    for (int q = tid; q < n && !*row_done; q += kBlock) {
        if (arriba::aw_diagonal(read_s, window, d_lo + queue[q], read_len,
                                win_len, min_score, p[3], p[4])) {
            accept = true;
            *row_done = 1;
        }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, accept);
    if ((tid & 31) == 0 && ballot != 0) atomicOr(out + row, 1);
}

// one launch of n rows; offsets null for dense rows
int launch(const void* reads, const void* windows, const void* offsets,
           const void* params, void* out, int n, int L, int W,
           int vector_loads, long long read_bytes, long long table_bytes,
           void* stream) {
    int strip, n_strips;
    arriba::aw_strips(L, W, &strip, &n_strips);
    if (n == 0 || n_strips == 0) return 0;
    const int smem = arriba::aw_layout(L, strip).bytes;
    if (smem > 48 * 1024) {
        const cudaError_t code = cudaFuncSetAttribute(
            accept_seeded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (code != cudaSuccess) return (int)code;
    }
    const int rows_y = n < 65535 ? n : 65535;
    accept_seeded_kernel<<<dim3(n_strips, rows_y, (n + rows_y - 1) / rows_y),
                           kBlock, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const uint8_t*)windows,
        (const int64_t*)offsets, (const int32_t*)params, (int32_t*)out, n, L,
        W, strip, vector_loads, read_bytes, table_bytes);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// reads uint8 [n, L], windows uint8 [n, W], params int32 [n, 5], out int32
// [n] zeroed by the caller; per row 0 <= read_len <= L and win_len <= W.
// Rows with min_score > read_len + AW_NEG take the seed lookup, the others
// walk every diagonal (accept_wavefront.cuh).
int arriba_accept_wavefront(const void* reads, const void* windows,
                            const void* params, void* out, int n, int L,
                            int W, void* stream) {
    const int vector_loads = W % 16 == 0 && ((uintptr_t)windows & 15) == 0;
    return launch(reads, windows, nullptr, params, out, n, L, W,
                  vector_loads, 0, 0, stream);
}

const char* arriba_accept_wavefront_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The same rows read by offset: reads uint8 [read_bytes] (a read table,
// each read's bytes from its offset, at most L of them), table uint8
// [table_bytes] (a window table, AW_TABLE_SLACK bytes past its last
// window), offsets int64 [n, 2] (each row's read and window offsets),
// params and out as above; per row 0 <= read_len <= L, win_len <= W, and
// its read and window spans inside their tables.
int arriba_accept_wavefront_indexed(const void* reads, const void* table,
                                    const void* offsets, const void* params,
                                    void* out, int n, int L, int W,
                                    long long read_bytes,
                                    long long table_bytes, void* stream) {
    const int vector_loads = ((uintptr_t)table & 15) == 0;
    return launch(reads, table, offsets, params, out, n, L, W, vector_loads,
                  read_bytes, table_bytes, stream);
}

const char* arriba_accept_wavefront_indexed_error(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
