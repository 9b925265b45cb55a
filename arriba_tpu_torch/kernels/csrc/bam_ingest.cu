// K6: the card pass over a BGZF BAM before the native scan, for sm_90a.
//
// Replaces no TPU kernel: the JAX package reads its BAM on the host only.
// Added because the port's time went to the native engine's scan of the
// sample's background of boring proper pairs (PERF.md, PR 18), work the
// card can take whole: inflate every member, frame the records, test each
// adjacent pair, and reduce the taken pairs into the engine's coverage and
// counters, so that the engine scans only the residue.
//
// What bounds it: the serial chains. A deflate stream decodes one symbol
// after the other, and a record's start is known only from the one before.
// The design keeps each chain short and runs thousands at once:
// - bgzf_inflate_kernel: a warp a BGZF member (<= 64 KB out). Lane 0 decodes
//   (bam_ingest.cuh: bi_run, tables of 10 / 8 bits in shared memory, the
//   canonical walk for longer codes); the warp fills each block's tables and
//   computes the member's CRC-32 in 32 segments folded by crc32_combine.
// - bam_frame_search_kernel: a warp a member's output range guesses its
//   first record start (bi_plausible over 32 offsets at a time), and lane 0
//   walks the block_size chain to the first start past the range.
//   bam_frame_fix_kernel then holds each range's entry to its predecessor's
//   exit, in order, walking again from the verified exit only where they
//   differ, and numbers the records; bam_frame_write_kernel writes each
//   range's starts.
// - bam_pair_test_kernel, bam_pair_take_kernel: a thread a record; a pair
//   is taken where the test holds and neither neighbour shares a name
//   (taken pairs never overlap), its coverage added with atomics into an
//   int32 plane and its flags stored into byte planes; a record that may
//   begin a chain the engine pairs by its tiles is flagged
//   (bi_chain_start).
// - bam_residue_copy_kernel: a warp a record copies the declined records,
//   in order, to their prefix-sum offsets (the sums are torch.cumsum over
//   the kept sizes).
// - bam_coverage_finish_kernel: the plane saturated to uint16, as the
//   engine's +1s saturate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_ingest.cuh"

using namespace arriba;

namespace {

constexpr int kWarps = 4;  // inflate: warps (members) a block
constexpr unsigned kFull = 0xffffffffu;

// per-chunk statistics, int64 each
enum {
    kStatRecords = 0,    // records whole inside the chunk
    kStatTail = 1,       // where the chain stops: a partial record, or end
    kStatChain = 2,      // BI_WALK_OK / _PARTIAL / _BAD
    kStatInflate = 3,    // members that failed
    kStatTaken = 4,      // records taken
    kStatMapped = 5,     // of them on interesting contigs
    kStatMaybeFirst = 6,  // bi_maybe_consumed of the previous chunk's last
                          // record and record 0
    kStatChains = 7,      // records that begin a chain (bi_chain_start)
    kStatCount = 16,
};

__global__ void __launch_bounds__(kWarps * 32)
bgzf_inflate_kernel(const uint8_t* __restrict__ comp,
                    const int64_t* __restrict__ member_offset,
                    const int64_t* __restrict__ member_size,
                    const int64_t* __restrict__ out_offset, int members,
                    uint8_t* __restrict__ out, int32_t* __restrict__ status,
                    int64_t* __restrict__ stats) {
    extern __shared__ uint8_t shared[];
    uint32_t* crc_table = reinterpret_cast<uint32_t*>(shared);
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
        crc_table[i] = bi_crc_entry((uint32_t)i);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int m = blockIdx.x * kWarps + warp;
    if (m >= members) return;
    BiTables t = bi_tables(shared + 1024 + warp * BI_TABLE_BYTES);
    const uint8_t* member = comp + member_offset[m];
    const int64_t size = member_size[m];
    const uint32_t want_crc = bi_rd32(member + size - 8);
    const int64_t isize = bi_rd32(member + size - 4);
    uint8_t* dst = out + out_offset[m];

    BiInflate s;
    int job = BI_JOB_ERROR;
    if (lane == 0)
        bi_start(&s, member + BI_MEMBER_HEADER,
                 size - BI_MEMBER_HEADER - BI_MEMBER_TRAILER, dst, isize);
    int nlit = 0;
    for (;;) {
        if (lane == 0) {
            job = bi_run(&s, t);
            nlit = s.nlit;
        }
        job = __shfl_sync(kFull, job, 0);
        if (job != BI_JOB_FILL) break;
        nlit = __shfl_sync(kFull, nlit, 0);
        __syncwarp();
        bi_zero(lane, 32, t);
        __syncwarp();
        bi_fill(lane, 32, t, nlit);
        __syncwarp();
    }
    int error = BI_OK;
    if (lane == 0) error = job == BI_JOB_DONE ? bi_finish(&s) : s.error;
    error = __shfl_sync(kFull, error, 0);
    __syncwarp();
    if (error == BI_OK) {
        int64_t begin;
        int64_t len = bi_crc_segment(lane, 32, isize, &begin);
        uint32_t crc = bi_crc(crc_table, 0, dst + begin, len);
        // fold the 32 segments in lane order: lane l takes l + step's group
        for (int step = 1; step < 32; step <<= 1) {
            const uint32_t other = __shfl_down_sync(kFull, crc, step);
            const int64_t other_len = __shfl_down_sync(kFull, len, step);
            if ((lane & (2 * step - 1)) == 0 && lane + step < 32) {
                crc = bi_crc_combine(crc, other, other_len);
                len += other_len;
            }
        }
        if (lane == 0 && crc != want_crc) error = BI_ERR_CRC;
    }
    if (lane == 0) {
        status[m] = error;
        if (error) atomicAdd(reinterpret_cast<unsigned long long*>(
                                 stats + kStatInflate), 1ull);
    }
}

// a warp a range [lo, hi): its entry (known for range 0) and the walk
__global__ void bam_frame_search_kernel(
        const uint8_t* __restrict__ buf, int64_t end,
        const int64_t* __restrict__ seg_lo, const int64_t* __restrict__ seg_hi,
        int segments, int n_ref, int64_t* __restrict__ entry,
        int64_t* __restrict__ exit_at, int64_t* __restrict__ count,
        int32_t* __restrict__ walked) {
    const int lane = threadIdx.x & 31;
    const int s = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
    if (s >= segments) return;
    const int64_t lo = seg_lo[s], hi = seg_hi[s];
    int64_t found = s == 0 ? lo : -1;
    for (int64_t base = lo; found < 0 && base < hi; base += 32) {
        const int64_t q = base + lane;
        const bool ok = q < hi && bi_plausible(buf, q, end, n_ref);
        const unsigned votes = __ballot_sync(kFull, ok);
        if (votes) found = base + __ffs(votes) - 1;
    }
    if (lane != 0) return;
    entry[s] = found;
    if (found < 0) {
        exit_at[s] = -1;
        count[s] = 0;
        walked[s] = BI_WALK_BAD;
        return;
    }
    const BiWalk w = bi_walk(buf, found, hi, end, nullptr);
    exit_at[s] = w.exit;
    count[s] = w.count;
    walked[s] = w.status;
}

// one block: every range's entry held to the verified exit before it (a
// range walked again from there where they differ), then the ranges'
// record numbers as an exclusive prefix sum
__global__ void __launch_bounds__(1024)
bam_frame_fix_kernel(const uint8_t* __restrict__ buf, int64_t end,
                     const int64_t* __restrict__ seg_hi, int segments,
                     int64_t* __restrict__ entry, int64_t* __restrict__ exit_at,
                     int64_t* __restrict__ count, int32_t* __restrict__ walked,
                     int64_t* __restrict__ first_record,
                     int64_t* __restrict__ stats) {
    __shared__ int first_bad;
    __shared__ int64_t carry;
    if (threadIdx.x == 0) first_bad = segments;
    __syncthreads();
    for (int s = threadIdx.x; s < segments; s += blockDim.x)
        if (bi_frame_unverified(s, segments, entry, exit_at, walked))
            atomicMin(&first_bad, s);
    __syncthreads();
    if (threadIdx.x == 0) {
        int64_t tail;
        const int status = bi_frame_fix(buf, end, seg_hi, segments, entry,
                                        exit_at, count, walked, first_bad,
                                        &tail);
        stats[kStatTail] = tail;
        stats[kStatChain] = status;
        carry = 0;
    }
    __syncthreads();
    // exclusive prefix sum of count in tiles of blockDim.x
    __shared__ int64_t tile[1024];
    for (int base = 0; base < segments; base += blockDim.x) {
        const int s = base + threadIdx.x;
        const int64_t v = s < segments ? count[s] : 0;
        tile[threadIdx.x] = v;
        __syncthreads();
        for (int step = 1; step < (int)blockDim.x; step <<= 1) {
            const int64_t add = threadIdx.x >= step ? tile[threadIdx.x - step] : 0;
            __syncthreads();
            tile[threadIdx.x] += add;
            __syncthreads();
        }
        if (s < segments) first_record[s] = carry + tile[threadIdx.x] - v;
        __syncthreads();
        if (threadIdx.x == 0) carry += tile[blockDim.x - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) stats[kStatRecords] = carry;
}

__global__ void bam_frame_write_kernel(const uint8_t* __restrict__ buf,
                                       int64_t end,
                                       const int64_t* __restrict__ seg_hi,
                                       int segments,
                                       const int64_t* __restrict__ entry,
                                       const int64_t* __restrict__ count,
                                       const int64_t* __restrict__ first_record,
                                       int64_t* __restrict__ starts) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= segments || count[s] == 0) return;
    bi_walk(buf, entry[s], seg_hi[s], end, starts + first_record[s]);
}

struct ContigArgs {
    const int64_t* bounds;
    const int64_t* bound_offset;
    const int64_t* plane_offset;
    const uint8_t* interesting;
    const uint8_t* viral;
    int n_tids;
    int external_duplicates;
};

__device__ inline BiContigs bi_contigs(const ContigArgs& a) {
    BiContigs c;
    c.n_tids = a.n_tids;
    c.bounds = a.bounds;
    c.bound_offset = a.bound_offset;
    c.plane_offset = a.plane_offset;
    c.interesting = a.interesting;
    c.viral = a.viral;
    c.external_duplicates = a.external_duplicates;
    return c;
}

// test[i]: the pair (i, i + 1) passes bi_pair; maybe[i]: bi_maybe_consumed
// of it; same[i]: record i shares its name with record i - 1. Record 0's
// neighbour is ctx, the key of the chunk before's last record (name_len -2
// where there is none).
__global__ void bam_pair_test_kernel(const uint8_t* __restrict__ buf,
                                     const int64_t* __restrict__ starts,
                                     int64_t* __restrict__ stats,
                                     int64_t capacity,
                                     const BiKey* __restrict__ ctx,
                                     ContigArgs contigs,
                                     uint8_t* __restrict__ test,
                                     uint8_t* __restrict__ maybe,
                                     uint8_t* __restrict__ same) {
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= capacity) return;
    const int64_t n = stats[kStatRecords];
    if (i >= n) {
        test[i] = maybe[i] = same[i] = 0;
        return;
    }
    const BiRecord a = bi_record(buf, starts[i]);
    BiKey ka;
    bi_key(buf, a, &ka, false);
    const uint8_t* a_name = buf + a.at + 36;
    if (i == 0) {
        same[i] = ctx->name_len != -2
                  && bi_names_equal(a_name, ka.name_len, ctx->name,
                                    ctx->name_len);
        stats[kStatMaybeFirst] = bi_maybe_consumed(*ctx, ctx->name, ka, a_name);
    } else {
        int64_t prev;
        const int prev_len = bi_name(buf, starts[i - 1], &prev);
        same[i] = bi_names_equal(a_name, ka.name_len, buf + prev, prev_len);
    }
    if (i + 1 >= n) {
        test[i] = maybe[i] = 0;
        return;
    }
    const BiContigs c = bi_contigs(contigs);
    const BiRecord b = bi_record(buf, starts[i + 1]);
    BiKey kb;
    bi_key(buf, b, &kb, false);
    test[i] = bi_pair(buf, a, b, c);
    maybe[i] = bi_maybe_consumed(ka, a_name, kb, buf + b.at + 36);
}

__device__ inline void add_range(int32_t* cov, int64_t lo, int64_t hi) {
    for (int64_t w = lo; w <= hi; ++w) atomicAdd(cov + w, 1);
}

// the taken pairs' reductions, and what each record leaves to the residue
__global__ void bam_pair_take_kernel(const uint8_t* __restrict__ buf,
                                     const int64_t* __restrict__ starts,
                                     int64_t* __restrict__ stats,
                                     int64_t capacity, int final,
                                     const uint8_t* __restrict__ test,
                                     const uint8_t* __restrict__ maybe,
                                     const uint8_t* __restrict__ same,
                                     ContigArgs contigs,
                                     int32_t* __restrict__ cov,
                                     uint8_t* __restrict__ cov_starts,
                                     uint8_t* __restrict__ cov_ends,
                                     int64_t* __restrict__ kept_size,
                                     int32_t* __restrict__ kept,
                                     uint8_t* __restrict__ chain_start,
                                     BiKey* __restrict__ ctx_out) {
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int64_t n = stats[kStatRecords];
    bool starts_pair = false, mapped = false, begins_run = false;
    if (i < n) {
        starts_pair = bi_take_at(i, n, final, test, same);
        const bool taken = starts_pair || bi_take_at(i - 1, n, final, test, same);
        const int64_t at = starts[i];
        kept_size[i] = taken ? 0 : 4 + (int64_t)bi_i32(buf + at);
        kept[i] = taken ? 0 : 1;
        begins_run = bi_chain_start(i, n, final, maybe,
                                    stats[kStatMaybeFirst] != 0);
        chain_start[i] = begins_run;
        if (starts_pair) {
            const BiContigs c = bi_contigs(contigs);
            const BiRecord a = bi_record(buf, at);
            const BiRecord b = bi_record(buf, starts[i + 1]);
            const int64_t offset = c.plane_offset[a.tid];
            const int64_t windows = c.plane_offset[a.tid + 1] - offset;
            const BiCover v = bi_cover(a, b, windows);
            if (v.start >= 0) cov_starts[offset + v.start] = 1;
            add_range(cov + offset, v.lo1, v.hi1);
            add_range(cov + offset, v.lo2, v.hi2);
            if (v.end >= 0) cov_ends[offset + v.end] = 1;
            mapped = c.interesting[a.tid] != 0;
        }
        if (i == n - 1) bi_key(buf, bi_record(buf, at), ctx_out, true);
    } else if (i < capacity) {
        kept_size[i] = 0;
        kept[i] = 0;
        chain_start[i] = 0;
    }
    // warp sums: two records a taken pair
    const unsigned pairs = __ballot_sync(kFull, starts_pair);
    const unsigned on_mapped = __ballot_sync(kFull, mapped);
    const unsigned runs = __ballot_sync(kFull, begins_run);
    if (lane == 0) {
        if (pairs)
            atomicAdd(reinterpret_cast<unsigned long long*>(stats + kStatTaken),
                      2ull * __popc(pairs));
        if (on_mapped)
            atomicAdd(reinterpret_cast<unsigned long long*>(stats + kStatMapped),
                      2ull * __popc(on_mapped));
        if (runs)
            atomicAdd(reinterpret_cast<unsigned long long*>(
                          stats + kStatChains), (unsigned long long)__popc(runs));
    }
}

// a warp a kept record: its bytes to their offset in res; its residue index
// gets its byte offset, its record index (base + i) and whether it begins a
// chain
__global__ void bam_residue_copy_kernel(const uint8_t* __restrict__ buf,
                                        const int64_t* __restrict__ starts,
                                        const int64_t* __restrict__ stats,
                                        int64_t capacity, int64_t base,
                                        const int64_t* __restrict__ kept_size,
                                        const int64_t* __restrict__ size_sum,
                                        const int32_t* __restrict__ kept_sum,
                                        const uint8_t* __restrict__ chain_start,
                                        uint8_t* __restrict__ res,
                                        int64_t* __restrict__ res_offset,
                                        int64_t* __restrict__ res_record,
                                        uint8_t* __restrict__ res_run) {
    const int lane = threadIdx.x & 31;
    const int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    if (i >= capacity || i >= stats[kStatRecords]) return;
    const int64_t size = kept_size[i];
    if (size == 0) return;
    const int64_t dst = size_sum[i] - size;
    const uint8_t* from = buf + starts[i];
    for (int64_t k = lane; k < size; k += 32) res[dst + k] = from[k];
    if (lane == 0) {
        const int64_t j = kept_sum[i] - 1;
        res_offset[j] = dst;
        res_record[j] = base + i;
        res_run[j] = chain_start[i];
    }
}

__global__ void bam_coverage_finish_kernel(const int32_t* __restrict__ cov,
                                           uint16_t* __restrict__ out,
                                           int64_t n) {
    const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i < n) out[i] = (uint16_t)(cov[i] < 0xFFFF ? cov[i] : 0xFFFF);
}

inline unsigned blocks_for(int64_t threads, int per_block) {
    return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Host: bi_index (bam_ingest.cuh) for the pass's reader.
int arriba_bgzf_index(const uint8_t* buf, long long avail, int max_members,
                      long long max_out, long long* offset, long long* size,
                      long long* isize, long long* consumed) {
    int64_t at = 0;
    const int count = bi_index(buf, avail, max_members, max_out,
                               (int64_t*)offset, (int64_t*)size,
                               (int64_t*)isize, &at);
    *consumed = at;
    return count;
}

int arriba_bgzf_inflate(const void* comp, const void* member_offset,
                        const void* member_size, const void* out_offset,
                        int members, void* out, void* status, void* stats,
                        void* stream) {
    if (members <= 0) return 0;
    const size_t smem = 1024 + (size_t)kWarps * BI_TABLE_BYTES;
    bgzf_inflate_kernel<<<blocks_for(members, kWarps), kWarps * 32, smem,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)comp, (const int64_t*)member_offset,
        (const int64_t*)member_size, (const int64_t*)out_offset, members,
        (uint8_t*)out, (int32_t*)status, (int64_t*)stats);
    return (int)cudaGetLastError();
}

int arriba_bam_frame(const void* buf, long long end, const void* seg_lo,
                     const void* seg_hi, int segments, int n_ref, void* entry,
                     void* exit_at, void* count, void* walked,
                     void* first_record, void* starts, void* stats,
                     void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (segments > 0) {
        bam_frame_search_kernel<<<blocks_for(segments, 4), 128, 0, s>>>(
            (const uint8_t*)buf, end, (const int64_t*)seg_lo,
            (const int64_t*)seg_hi, segments, n_ref, (int64_t*)entry,
            (int64_t*)exit_at, (int64_t*)count, (int32_t*)walked);
        cudaError_t e = cudaGetLastError();
        if (e) return (int)e;
    }
    bam_frame_fix_kernel<<<1, 1024, 0, s>>>(
        (const uint8_t*)buf, end, (const int64_t*)seg_hi, segments,
        (int64_t*)entry, (int64_t*)exit_at, (int64_t*)count, (int32_t*)walked,
        (int64_t*)first_record, (int64_t*)stats);
    cudaError_t e = cudaGetLastError();
    if (e) return (int)e;
    if (segments > 0) {
        bam_frame_write_kernel<<<blocks_for(segments, 128), 128, 0, s>>>(
            (const uint8_t*)buf, end, (const int64_t*)seg_hi, segments,
            (const int64_t*)entry, (const int64_t*)count,
            (const int64_t*)first_record, (int64_t*)starts);
    }
    return (int)cudaGetLastError();
}

int arriba_bam_pairs(const void* buf, const void* starts, void* stats,
                     long long capacity, int final, const void* ctx_in,
                     void* ctx_out, const void* bounds,
                     const void* bound_offset, const void* plane_offset,
                     const void* interesting, const void* viral, int n_tids,
                     int external_duplicates, void* test, void* maybe,
                     void* same, void* cov, void* cov_starts, void* cov_ends,
                     void* kept_size, void* kept, void* chain_start,
                     void* stream) {
    if (capacity <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    ContigArgs c{(const int64_t*)bounds, (const int64_t*)bound_offset,
                 (const int64_t*)plane_offset, (const uint8_t*)interesting,
                 (const uint8_t*)viral, n_tids, external_duplicates};
    const unsigned blocks = blocks_for(capacity, 256);
    bam_pair_test_kernel<<<blocks, 256, 0, s>>>(
        (const uint8_t*)buf, (const int64_t*)starts, (int64_t*)stats,
        capacity, (const BiKey*)ctx_in, c, (uint8_t*)test, (uint8_t*)maybe,
        (uint8_t*)same);
    cudaError_t e = cudaGetLastError();
    if (e) return (int)e;
    bam_pair_take_kernel<<<blocks, 256, 0, s>>>(
        (const uint8_t*)buf, (const int64_t*)starts, (int64_t*)stats,
        capacity, final, (const uint8_t*)test, (const uint8_t*)maybe,
        (const uint8_t*)same, c, (int32_t*)cov, (uint8_t*)cov_starts,
        (uint8_t*)cov_ends, (int64_t*)kept_size, (int32_t*)kept,
        (uint8_t*)chain_start, (BiKey*)ctx_out);
    return (int)cudaGetLastError();
}

int arriba_bam_residue(const void* buf, const void* starts, const void* stats,
                       long long capacity, long long base,
                       const void* kept_size, const void* size_sum,
                       const void* kept_sum, const void* chain_start, void* res,
                       void* res_offset, void* res_record, void* res_run,
                       void* stream) {
    if (capacity <= 0) return 0;
    bam_residue_copy_kernel<<<blocks_for(capacity * 32, 256), 256, 0,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)buf, (const int64_t*)starts, (const int64_t*)stats,
        capacity, base, (const int64_t*)kept_size, (const int64_t*)size_sum,
        (const int32_t*)kept_sum, (const uint8_t*)chain_start, (uint8_t*)res,
        (int64_t*)res_offset, (int64_t*)res_record, (uint8_t*)res_run);
    return (int)cudaGetLastError();
}

int arriba_bam_coverage_finish(const void* cov, void* out, long long n,
                               void* stream) {
    if (n <= 0) return 0;
    bam_coverage_finish_kernel<<<blocks_for(n, 256), 256, 0,
                                 (cudaStream_t)stream>>>(
        (const int32_t*)cov, (uint16_t*)out, n);
    return (int)cudaGetLastError();
}

#define BAM_INGEST_ERROR(name) \
    const char* name##_error(int code) { \
        return cudaGetErrorString((cudaError_t)code); \
    }
BAM_INGEST_ERROR(arriba_bgzf_inflate)
BAM_INGEST_ERROR(arriba_bam_frame)
BAM_INGEST_ERROR(arriba_bam_pairs)
BAM_INGEST_ERROR(arriba_bam_residue)
BAM_INGEST_ERROR(arriba_bam_coverage_finish)

}  // extern "C"
