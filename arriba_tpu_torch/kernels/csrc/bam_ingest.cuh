// The per-member, per-record and per-pair steps of K6 (bam_ingest.cu), the
// card pass over a BGZF BAM, as __host__ __device__ code: the kernels call
// them, and tests/test_torch_ingest_card.py compiles them with g++ into a
// harness that walks members, records and pairs the way the kernels do.
//
// The pass consumes the background of adjacent boring proper pairs that the
// native engine's consume_adjacent_boring_pair (native/ingest.cpp) would
// consume, into the same commutative reductions (record and mapped-read
// counts, the coverage windows and their start and end flags), and hands
// every other record to the engine. Its pair test is a strict subset of the
// engine's: anything it cannot prove boring is declined.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace arriba {

// ---------------------------------------------------------------- CRC-32

constexpr uint32_t BI_POLY = 0xedb88320u;

__host__ __device__ inline uint32_t bi_crc_entry(uint32_t n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ BI_POLY : c >> 1;
    return c;
}

// zlib's crc32(crc, p, n): table holds bi_crc_entry(0..255)
__host__ __device__ inline uint32_t bi_crc(const uint32_t* table, uint32_t crc,
                                           const uint8_t* p, int64_t n) {
    crc = ~crc;
    for (int64_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xff] ^ (crc >> 8);
    return ~crc;
}

// a * b modulo the CRC polynomial, reflected (zlib's multmodp)
__host__ __device__ inline uint32_t bi_multmodp(uint32_t a, uint32_t b) {
    uint32_t m = 1u << 31, p = 0;
    for (;;) {
        if (a & m) {
            p ^= b;
            if ((a & (m - 1)) == 0) break;
        }
        m >>= 1;
        b = b & 1 ? (b >> 1) ^ BI_POLY : b >> 1;
    }
    return p;
}

// zlib's crc32_combine: the CRC of A then B from crc(A), crc(B), |B|
__host__ __device__ inline uint32_t bi_crc_combine(uint32_t crc1, uint32_t crc2,
                                                   int64_t len2) {
    uint32_t p = 1u << 31;          // x^0
    uint32_t square = 1u << 23;     // x^8: one byte
    for (int64_t n = len2; n; n >>= 1) {
        if (n & 1) p = bi_multmodp(square, p);
        square = bi_multmodp(square, square);
    }
    return bi_multmodp(p, crc1) ^ crc2;
}

// ------------------------------------------------------------- BGZF member

constexpr int BI_MEMBER_HEADER = 18;   // gzip header with the BC subfield
constexpr int BI_MEMBER_TRAILER = 8;   // CRC-32, ISIZE

__host__ __device__ inline uint32_t bi_rd32(const uint8_t* p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16
           | (uint32_t)p[3] << 24;
}

// The member at p (avail bytes readable): its total size (BSIZE + 1), 0 when
// fewer bytes than the whole member are there, -1 when it is no BGZF member
// of the standard layout (FEXTRA with exactly the BC subfield).
__host__ __device__ inline int64_t bi_member_size(const uint8_t* p,
                                                  int64_t avail) {
    if (avail < BI_MEMBER_HEADER) return 0;
    if (p[0] != 31 || p[1] != 139 || p[2] != 8 || p[3] != 4) return -1;
    if (p[10] != 6 || p[11] != 0 || p[12] != 'B' || p[13] != 'C'
        || p[14] != 2 || p[15] != 0)
        return -1;
    const int64_t size = (int64_t)(p[16] | p[17] << 8) + 1;
    if (size < BI_MEMBER_HEADER + BI_MEMBER_TRAILER) return -1;
    return size <= avail ? size : 0;
}

// Index the complete members at buf (avail bytes) while their output fits in
// max_out bytes (the first always) and their count in max_members: offsets,
// sizes and ISIZEs; *consumed gets the bytes they span. Returns the count,
// or -1 at a member that is no standard BGZF member.
__host__ __device__ inline int bi_index(const uint8_t* buf, int64_t avail,
                                        int max_members, int64_t max_out,
                                        int64_t* offset, int64_t* size,
                                        int64_t* isize, int64_t* consumed) {
    int64_t at = 0, out = 0;
    int count = 0;
    while (count < max_members) {
        const int64_t member = bi_member_size(buf + at, avail - at);
        if (member < 0) return -1;
        if (member == 0) break;
        const int64_t in_size = bi_rd32(buf + at + member - 4);
        if (out + in_size > max_out && count > 0) break;
        offset[count] = at;
        size[count] = member;
        isize[count] = in_size;
        count += 1;
        at += member;
        out += in_size;
    }
    *consumed = at;
    return count;
}

// ----------------------------------------------------------------- inflate
//
// One member's raw deflate stream, decoded by one thread (lane 0 of the
// member's warp) except the table fills, which the warp shares: bi_run
// returns BI_JOB_FILL when a block's code lengths are ready, the warp runs
// bi_zero then bi_fill over its lanes, and lane 0 resumes. Canonical codes
// up to BI_LBITS (literal/length) and BI_DBITS (distance) bits decode with
// one lookup; longer ones by the canonical count walk (puff's decode). The
// rules on code sets are zlib's: an over-subscribed set, or an incomplete
// one other than a single code of one bit, is an error.

constexpr int BI_LBITS = 10;
constexpr int BI_DBITS = 8;
constexpr int BI_NLENS = 320;  // 288 literal/length + 32 distance lengths

struct BiTables {
    uint16_t* lfast;   // [1 << BI_LBITS]: 0x8000 | symbol << 4 | length
    uint16_t* dfast;   // [1 << BI_DBITS]
    uint16_t* lcount;  // [16] codes of each length
    uint16_t* lsym;    // [288] symbols by (length, value)
    uint16_t* dcount;  // [16]
    uint16_t* dsym;    // [32]
    uint16_t* codes;   // [BI_NLENS] each symbol's code, bits reversed
    uint8_t* lens;     // [BI_NLENS] code lengths, literal/length then distance
};

// the bytes of a warp's tables in shared memory
constexpr int BI_TABLE_BYTES =
    2 * ((1 << BI_LBITS) + (1 << BI_DBITS) + 16 + 288 + 16 + 32 + BI_NLENS)
    + BI_NLENS;

__host__ __device__ inline BiTables bi_tables(uint8_t* base) {
    BiTables t;
    uint16_t* w = reinterpret_cast<uint16_t*>(base);
    t.lfast = w; w += 1 << BI_LBITS;
    t.dfast = w; w += 1 << BI_DBITS;
    t.lcount = w; w += 16;
    t.lsym = w; w += 288;
    t.dcount = w; w += 16;
    t.dsym = w; w += 32;
    t.codes = w; w += BI_NLENS;
    t.lens = reinterpret_cast<uint8_t*>(w);
    return t;
}

enum {
    BI_OK = 0,
    BI_ERR_BLOCK = 1,     // block type 3, or a stored length check
    BI_ERR_CODES = 2,     // a code set zlib refuses
    BI_ERR_SYMBOL = 3,    // a code not in its set, or symbol 286/287, 30/31
    BI_ERR_DISTANCE = 4,  // a distance past the member's start
    BI_ERR_OUTPUT = 5,    // more output than ISIZE
    BI_ERR_INPUT = 6,     // the stream ends outside its last byte
    BI_ERR_SIZE = 7,      // less output than ISIZE
    BI_ERR_CRC = 8,
    BI_ERR_HEADER = 9,
};

enum { BI_JOB_DONE = 0, BI_JOB_FILL = 1, BI_JOB_ERROR = 2 };
enum { BI_STATE_HEADER = 0, BI_STATE_HUFF = 1 };

struct BiInflate {
    const uint8_t* in;
    int64_t in_len, in_pos;  // in_pos: bytes loaded into bits
    uint64_t bits;
    int nbits;
    uint8_t* out;
    int64_t out_len, out_pos;
    int state, last, error;
    int nlit;                // the block's literal/length code count
};

__host__ __device__ inline void bi_start(BiInflate* s, const uint8_t* in,
                                         int64_t in_len, uint8_t* out,
                                         int64_t out_len) {
    s->in = in;
    s->in_len = in_len;
    s->in_pos = 0;
    s->bits = 0;
    s->nbits = 0;
    s->out = out;
    s->out_len = out_len;
    s->out_pos = 0;
    s->state = BI_STATE_HEADER;
    s->last = 0;
    s->error = BI_OK;
    s->nlit = 0;
}

// at least 57 bits buffered (bytes past the stream read as 0; bi_finish
// refuses a stream that used them)
__host__ __device__ inline void bi_refill(BiInflate* s) {
    while (s->nbits <= 56) {
        const uint64_t b = s->in_pos < s->in_len ? s->in[s->in_pos] : 0;
        s->in_pos += 1;
        s->bits |= b << s->nbits;
        s->nbits += 8;
    }
}

__host__ __device__ inline uint32_t bi_take(BiInflate* s, int n) {
    if (s->nbits < n) bi_refill(s);
    const uint32_t v = (uint32_t)(s->bits & ((1ull << n) - 1));
    s->bits >>= n;
    s->nbits -= n;
    return v;
}

__host__ __device__ inline uint32_t bi_reverse(uint32_t code, int len) {
    uint32_t r = 0;
    for (int i = 0; i < len; ++i) {
        r = (r << 1) | (code & 1);
        code >>= 1;
    }
    return r;
}

// counts, symbols by (length, value) and reversed codes of one code set;
// 0, or an error where zlib's inflate_table refuses the set (codes_type:
// the code-length code, which may not be incomplete at all)
__host__ __device__ inline int bi_prepare(const uint8_t* lens, int n,
                                          uint16_t* count, uint16_t* sym,
                                          uint16_t* codes, bool codes_type) {
    for (int len = 0; len < 16; ++len) count[len] = 0;
    for (int i = 0; i < n; ++i) count[lens[i]] += 1;
    int max = 0;
    for (int len = 15; len >= 1; --len)
        if (count[len]) { max = len; break; }
    count[0] = 0;
    if (max == 0) return BI_OK;
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
        left <<= 1;
        left -= count[len];
        if (left < 0) return BI_ERR_CODES;
    }
    if (left > 0 && (codes_type || max != 1)) return BI_ERR_CODES;
    uint16_t offs[16], next[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    uint32_t code = 0;
    next[0] = 0;
    for (int len = 1; len < 16; ++len) {
        code = (code + count[len - 1]) << 1;
        next[len] = (uint16_t)code;
    }
    for (int i = 0; i < n; ++i) {
        const int len = lens[i];
        if (len) {
            sym[offs[len]++] = (uint16_t)i;
            codes[i] = (uint16_t)bi_reverse(next[len]++, len);
        }
    }
    return BI_OK;
}

// the warp's two steps between BI_JOB_FILL and resuming: every lane of
// lanes clears, then fills, its share of both fast tables
__host__ __device__ inline void bi_zero(int lane, int lanes, BiTables t) {
    for (int e = lane; e < (1 << BI_LBITS); e += lanes) t.lfast[e] = 0;
    for (int e = lane; e < (1 << BI_DBITS); e += lanes) t.dfast[e] = 0;
}

__host__ __device__ inline void bi_fill(int lane, int lanes, BiTables t,
                                        int nlit) {
    for (int i = lane; i < BI_NLENS; i += lanes) {
        const bool dist = i >= nlit;
        if (i >= nlit + 32 || (!dist && i >= 288)) continue;
        const int len = t.lens[i];
        const int bits = dist ? BI_DBITS : BI_LBITS;
        if (len == 0 || len > bits) continue;
        const int symbol = dist ? i - nlit : i;
        const uint16_t entry = (uint16_t)(0x8000 | symbol << 4 | len);
        uint16_t* fast = dist ? t.dfast : t.lfast;
        for (uint32_t e = t.codes[i]; e < (1u << bits); e += 1u << len)
            fast[e] = entry;
    }
}

// one symbol: the fast table, else the canonical walk; -1 if none
__host__ __device__ inline int bi_symbol(BiInflate* s, const uint16_t* fast,
                                         int bits, const uint16_t* count,
                                         const uint16_t* sym) {
    if (s->nbits < 15) bi_refill(s);
    const uint16_t e = fast[s->bits & ((1u << bits) - 1)];
    if (e & 0x8000) {
        const int len = e & 15;
        s->bits >>= len;
        s->nbits -= len;
        return (e >> 4) & 0x1ff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
        code |= (int)((s->bits >> (len - 1)) & 1);
        const int c = count[len];
        if (code - c < first) {
            s->bits >>= len;
            s->nbits -= len;
            return sym[index + (code - first)];
        }
        index += c;
        first += c;
        first <<= 1;
        code <<= 1;
    }
    return -1;
}

__host__ __device__ inline int bi_fail(BiInflate* s, int error) {
    s->error = error;
    return BI_JOB_ERROR;
}

// a dynamic block's header: its code lengths into t.lens, both sets prepared
__host__ __device__ inline int bi_dynamic(BiInflate* s, BiTables t) {
    const int nlen = (int)bi_take(s, 5) + 257;
    const int ndist = (int)bi_take(s, 5) + 1;
    const int ncode = (int)bi_take(s, 4) + 4;
    if (nlen > 286 || ndist > 30) return BI_ERR_CODES;
    // the order of the code-length code's lengths, 5 bits each
    const uint64_t order_lo = 0x022caa324e804a30ull;  // 16 17 18 0 8 7 9 6 10 5 11 4
    const uint64_t order_hi = 0x00000003c2e1346cull;  // 12 3 13 2 14 1 15
    uint8_t cl[19];
    for (int i = 0; i < 19; ++i) cl[i] = 0;
    for (int i = 0; i < ncode; ++i) {
        const int at = i < 12 ? (int)((order_lo >> (5 * i)) & 31)
                              : (int)((order_hi >> (5 * (i - 12))) & 31);
        cl[at] = (uint8_t)bi_take(s, 3);
    }
    int error = bi_prepare(cl, 19, t.lcount, t.lsym, t.codes, true);
    if (error) return error;
    int index = 0;
    while (index < nlen + ndist) {
        if (s->nbits < 15) bi_refill(s);
        int symbol = -1;
        {   // the canonical walk over the code-length code
            int code = 0, first = 0, at = 0;
            for (int len = 1; len <= 15; ++len) {
                code |= (int)((s->bits >> (len - 1)) & 1);
                const int c = t.lcount[len];
                if (code - c < first) {
                    s->bits >>= len;
                    s->nbits -= len;
                    symbol = t.lsym[at + (code - first)];
                    break;
                }
                at += c;
                first += c;
                first <<= 1;
                code <<= 1;
            }
        }
        if (symbol < 0) return BI_ERR_SYMBOL;
        if (symbol < 16) {
            t.lens[index++] = (uint8_t)symbol;
            continue;
        }
        int len = 0, repeat;
        if (symbol == 16) {
            if (index == 0) return BI_ERR_CODES;
            len = t.lens[index - 1];
            repeat = 3 + (int)bi_take(s, 2);
        } else if (symbol == 17) {
            repeat = 3 + (int)bi_take(s, 3);
        } else {
            repeat = 11 + (int)bi_take(s, 7);
        }
        if (index + repeat > nlen + ndist) return BI_ERR_CODES;
        while (repeat--) t.lens[index++] = (uint8_t)len;
    }
    if (t.lens[256] == 0) return BI_ERR_CODES;
    // distance lengths follow the literal/length ones in t.lens
    error = bi_prepare(t.lens, nlen, t.lcount, t.lsym, t.codes, false);
    if (error) return error;
    error = bi_prepare(t.lens + nlen, ndist, t.dcount, t.dsym, t.codes + nlen,
                       false);
    if (error) return error;
    s->nlit = nlen;
    for (int i = nlen + ndist; i < nlen + 32; ++i) t.lens[i] = 0;
    return BI_OK;
}

__host__ __device__ inline void bi_fixed(BiInflate* s, BiTables t) {
    for (int i = 0; i < 288; ++i)
        t.lens[i] = (uint8_t)(i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8);
    for (int i = 0; i < 32; ++i) t.lens[288 + i] = 5;
    bi_prepare(t.lens, 288, t.lcount, t.lsym, t.codes, false);
    bi_prepare(t.lens + 288, 32, t.dcount, t.dsym, t.codes + 288, false);
    s->nlit = 288;
}

// lane 0's decoder: runs until the warp must fill tables, or the member
// ends (BI_JOB_DONE) or fails (BI_JOB_ERROR, s->error)
__host__ __device__ inline int bi_run(BiInflate* s, BiTables t) {
    for (;;) {
        if (s->state == BI_STATE_HEADER) {
            if (s->last) return BI_JOB_DONE;
            s->last = (int)bi_take(s, 1);
            const uint32_t type = bi_take(s, 2);
            if (type == 0) {
                bi_take(s, s->nbits & 7);
                const uint32_t len = bi_take(s, 16);
                const uint32_t nlen = bi_take(s, 16);
                if (len != (~nlen & 0xffff)) return bi_fail(s, BI_ERR_BLOCK);
                if (s->out_pos + len > s->out_len)
                    return bi_fail(s, BI_ERR_OUTPUT);
                uint32_t left = len;
                while (left && s->nbits >= 8) {
                    s->out[s->out_pos++] = (uint8_t)bi_take(s, 8);
                    --left;
                }
                // the rest, if any, straight from the input (bits is empty)
                if (left && s->in_pos + left > s->in_len)
                    return bi_fail(s, BI_ERR_INPUT);
                for (uint32_t k = 0; k < left; ++k)
                    s->out[s->out_pos++] = s->in[s->in_pos++];
                continue;
            }
            if (type == 3) return bi_fail(s, BI_ERR_BLOCK);
            if (type == 1) {
                bi_fixed(s, t);
            } else {
                const int error = bi_dynamic(s, t);
                if (error) return bi_fail(s, error);
            }
            s->state = BI_STATE_HUFF;
            return BI_JOB_FILL;
        }
        // a Huffman block's symbols
        for (;;) {
            const int symbol = bi_symbol(s, t.lfast, BI_LBITS, t.lcount, t.lsym);
            if (symbol < 0 || symbol > 285) return bi_fail(s, BI_ERR_SYMBOL);
            if (symbol < 256) {
                if (s->out_pos >= s->out_len) return bi_fail(s, BI_ERR_OUTPUT);
                s->out[s->out_pos++] = (uint8_t)symbol;
                continue;
            }
            if (symbol == 256) break;
            const int li = symbol - 257;
            int length;
            if (li < 8) {
                length = 3 + li;
            } else if (li == 28) {
                length = 258;
            } else {
                const int extra = (li - 4) >> 2;
                length = ((4 + (li & 3)) << extra) + 3 + (int)bi_take(s, extra);
            }
            const int di = bi_symbol(s, t.dfast, BI_DBITS, t.dcount, t.dsym);
            if (di < 0 || di > 29) return bi_fail(s, BI_ERR_SYMBOL);
            int64_t distance;
            if (di < 4) {
                distance = 1 + di;
            } else {
                const int extra = (di - 2) >> 1;
                distance = ((int64_t)(2 + (di & 1)) << extra) + 1
                           + bi_take(s, extra);
            }
            if (distance > s->out_pos) return bi_fail(s, BI_ERR_DISTANCE);
            if (s->out_pos + length > s->out_len)
                return bi_fail(s, BI_ERR_OUTPUT);
            uint8_t* to = s->out + s->out_pos;
            const uint8_t* from = to - distance;
            for (int k = 0; k < length; ++k) to[k] = from[k];
            s->out_pos += length;
        }
        s->state = BI_STATE_HEADER;
    }
}

// after BI_JOB_DONE: the output is ISIZE bytes and the stream ends in its
// last byte
__host__ __device__ inline int bi_finish(const BiInflate* s) {
    if (s->out_pos != s->out_len) return BI_ERR_SIZE;
    const int64_t used_bits = s->in_pos * 8 - s->nbits;
    if ((used_bits + 7) / 8 != s->in_len) return BI_ERR_INPUT;
    return BI_OK;
}

// lane's share of a member's CRC: its segment of out, and the segment's
// length (the warp folds them with bi_crc_combine, lanes in order)
__host__ __device__ inline int64_t bi_crc_segment(int lane, int lanes,
                                                  int64_t n, int64_t* begin) {
    const int64_t per = (n + lanes - 1) / lanes;
    const int64_t lo = per * lane < n ? per * lane : n;
    const int64_t hi = lo + per < n ? lo + per : n;
    *begin = lo;
    return hi - lo;
}

// ------------------------------------------------------------ BAM records
//
// A record at p of the decompressed stream: block_size (4 bytes), then its
// body. Offsets past end are never read.

constexpr uint16_t BI_FPAIRED = 0x1, BI_FPROPER = 0x2, BI_FUNMAP = 0x4,
                   BI_FMUNMAP = 0x8, BI_FREVERSE = 0x10, BI_FSECONDARY = 0x100,
                   BI_FDUP = 0x400, BI_FSUPPLEMENTARY = 0x800;
constexpr int BI_COVERAGE_RESOLUTION = 20;
// the least record: block_size and the 32 fixed bytes
constexpr int BI_MIN_RECORD = 36;
// the largest block_size a speculative frame entry may have
constexpr int32_t BI_PLAUSIBLE_RECORD = 1 << 20;

__host__ __device__ inline int32_t bi_i32(const uint8_t* p) {
    return (int32_t)bi_rd32(p);
}

// the fixed fields of a record whose entry the framing guesses: sizes that
// fit together inside block_size, a NUL-terminated name, tids in range
__host__ __device__ inline bool bi_plausible_one(const uint8_t* buf, int64_t p,
                                                 int64_t end, int32_t n_ref) {
    if (p + BI_MIN_RECORD > end) return false;
    const uint8_t* r = buf + p;
    const int32_t bs = bi_i32(r);
    if (bs < 32 || bs > BI_PLAUSIBLE_RECORD) return false;
    const int32_t tid = bi_i32(r + 4), mtid = bi_i32(r + 24);
    if (tid < -1 || tid >= n_ref || mtid < -1 || mtid >= n_ref) return false;
    const int32_t pos = bi_i32(r + 8);
    if (pos < -1) return false;
    const int lrn = r[12];
    const int n_cigar = r[16] | r[17] << 8;
    const int32_t l_seq = bi_i32(r + 20);
    if (lrn < 1 || l_seq < 0 || l_seq > bs) return false;
    if (32 + lrn + 4 * (int64_t)n_cigar + (l_seq + 1) / 2 + (int64_t)l_seq > bs)
        return false;
    if (p + 4 + 32 + lrn > end) return false;
    return r[4 + 32 + lrn - 1] == 0;
}

// a guessed entry: plausible itself and in the next record too, where
// that one starts inside end
__host__ __device__ inline bool bi_plausible(const uint8_t* buf, int64_t p,
                                             int64_t end, int32_t n_ref) {
    if (!bi_plausible_one(buf, p, end, n_ref)) return false;
    const int64_t next = p + 4 + bi_i32(buf + p);
    if (next + BI_MIN_RECORD > end) return true;
    return bi_plausible_one(buf, next, end, n_ref);
}

enum { BI_WALK_OK = 0, BI_WALK_PARTIAL = 1, BI_WALK_BAD = 2 };

struct BiWalk {
    int64_t exit;   // the first record start at or past hi, or where it stopped
    int64_t count;  // records starting in [entry, hi)
    int status;     // OK; PARTIAL: the record at exit runs past end; BAD: a
                    // block_size <= 0 at exit
};

// the block_size chain from entry while it starts before hi
__host__ __device__ inline BiWalk bi_walk(const uint8_t* buf, int64_t entry,
                                          int64_t hi, int64_t end,
                                          int64_t* starts) {
    BiWalk w;
    w.count = 0;
    w.status = BI_WALK_OK;
    int64_t p = entry;
    while (p < hi) {
        if (p + 4 > end) { w.status = BI_WALK_PARTIAL; break; }
        const int32_t bs = bi_i32(buf + p);
        if (bs <= 0) { w.status = BI_WALK_BAD; break; }
        if (p + 4 + (int64_t)bs > end) { w.status = BI_WALK_PARTIAL; break; }
        if (starts) starts[w.count] = p;
        w.count += 1;
        p += 4 + (int64_t)bs;
    }
    w.exit = p;
    return w;
}

// Range s's walk is not yet known to continue the chain: its own walk
// failed, it stopped at a partial record before the last range, or its
// entry differs from the exit before it.
__host__ __device__ inline bool bi_frame_unverified(int s, int segments,
                                                    const int64_t* entry,
                                                    const int64_t* exit_at,
                                                    const int32_t* walked) {
    return walked[s] == BI_WALK_BAD
           || (walked[s] == BI_WALK_PARTIAL && s + 1 < segments)
           || (s > 0 && entry[s] != exit_at[s - 1]);
}

// The chain through every range, in order from first_bad (the least range
// bi_frame_unverified names; segments where none): each range whose entry
// differs from the verified exit before it is walked again from there, and
// once the chain has stopped (a partial record, a block_size <= 0) the
// ranges after it start none. Returns the chain's status; *tail gets where
// it stopped.
__host__ __device__ inline int bi_frame_fix(const uint8_t* buf, int64_t end,
                                            const int64_t* seg_hi,
                                            int segments, int64_t* entry,
                                            int64_t* exit_at, int64_t* count,
                                            int32_t* walked, int first_bad,
                                            int64_t* tail) {
    if (segments == 0) {
        *tail = 0;
        return BI_WALK_OK;
    }
    if (first_bad >= segments) {
        *tail = exit_at[segments - 1];
        return walked[segments - 1];
    }
    int s = first_bad;
    int64_t at = s == 0 ? entry[0] : exit_at[s - 1];
    int status = s == 0 ? BI_WALK_OK : walked[s - 1];
    for (; s < segments; ++s) {
        if (status != BI_WALK_OK) {
            entry[s] = at;
            exit_at[s] = at;
            count[s] = 0;
            walked[s] = status;
            continue;
        }
        if (entry[s] != at || walked[s] == BI_WALK_BAD) {
            const BiWalk w = bi_walk(buf, at, seg_hi[s], end, nullptr);
            entry[s] = at;
            exit_at[s] = w.exit;
            count[s] = w.count;
            walked[s] = w.status;
        }
        at = exit_at[s];
        status = walked[s];
    }
    *tail = at;
    return status;
}

// What the pair test reads of one record. valid: every check of the engine's
// decode_bam_record passes (sizes, the name's terminator, every aux
// payload).
struct BiRecord {
    int64_t at;        // offset of block_size
    int32_t bs, tid, pos;
    uint16_t flag;
    int n_cigar;
    int32_t l_seq;
    uint32_t cigar0;   // the first CIGAR word, where n_cigar > 0
    int64_t name;      // offset of the name
    int name_len;      // its C-string length
    bool valid, has_sa, hi_present, hi_odd;
    int64_t hi;
};

__host__ __device__ inline BiRecord bi_record(const uint8_t* buf, int64_t at) {
    BiRecord r;
    r.at = at;
    const uint8_t* b = buf + at + 4;  // the body
    r.bs = bi_i32(buf + at);
    r.valid = false;
    r.has_sa = r.hi_present = r.hi_odd = false;
    r.hi = 0;
    r.name = at + 4 + 32;
    r.name_len = 0;
    r.cigar0 = 0;
    if (r.bs < 32) return r;
    r.tid = bi_i32(b);
    r.pos = bi_i32(b + 4);
    const int lrn = b[8];
    r.n_cigar = b[12] | b[13] << 8;
    r.flag = (uint16_t)(b[14] | b[15] << 8);
    r.l_seq = bi_i32(b + 16);
    if (r.l_seq < 0 || lrn < 1) return r;
    const int64_t size = r.bs;
    int64_t offset = 32;
    if (size < offset + lrn + 4ll * r.n_cigar + (r.l_seq + 1) / 2 + (int64_t)r.l_seq)
        return r;
    if (b[offset + lrn - 1] != 0) return r;
    while (b[offset + r.name_len]) ++r.name_len;
    offset += lrn;
    if (r.n_cigar > 0) r.cigar0 = bi_rd32(b + offset);
    offset += 4ll * r.n_cigar + (r.l_seq + 1) / 2 + r.l_seq;
    // the aux fields, each payload bounds-checked as decode_bam_record does
    while (offset + 3 <= size) {
        const uint8_t t0 = b[offset], t1 = b[offset + 1], type = b[offset + 2];
        offset += 3;
        if (t0 == 'S' && t1 == 'A') r.has_sa = true;
        const bool is_hi = t0 == 'H' && t1 == 'I';
        int64_t width = 0;
        switch (type) {
            case 'c': case 'C': case 'A': width = 1; break;
            case 's': case 'S': width = 2; break;
            case 'i': case 'I': case 'f': width = 4; break;
            case 'd': width = 8; break;
            case 'Z': case 'H': {
                int64_t end = offset;
                while (end < size && b[end]) ++end;
                if (end >= size) return r;
                if (is_hi) r.hi_odd = true;
                offset = end + 1;
                continue;
            }
            case 'B': {
                if (offset + 5 > size) return r;
                const uint8_t sub = b[offset];
                const int32_t count = bi_i32(b + offset + 1);
                offset += 5;
                if (count < 0) return r;
                int64_t item;
                if (sub == 'c' || sub == 'C') item = 1;
                else if (sub == 's' || sub == 'S') item = 2;
                else if (sub == 'i' || sub == 'I' || sub == 'f') item = 4;
                else return r;
                if ((int64_t)count > (size - offset) / item) return r;
                offset += item * count;
                if (is_hi) r.hi_odd = true;
                continue;
            }
            default: return r;
        }
        if (offset + width > size) return r;
        if (is_hi) {
            r.hi_present = true;
            switch (type) {
                case 'c': r.hi = (int8_t)b[offset]; break;
                case 'C': r.hi = b[offset]; break;
                case 's': r.hi = (int16_t)(b[offset] | b[offset + 1] << 8); break;
                case 'S': r.hi = (uint16_t)(b[offset] | b[offset + 1] << 8); break;
                case 'i': r.hi = bi_i32(b + offset); break;
                case 'I': r.hi = bi_rd32(b + offset); break;
                default: r.hi_odd = true; r.hi_present = false; break;
            }
        }
        offset += width;
    }
    r.valid = true;
    return r;
}

// The name of the record at at: its offset in *name and its C-string
// length, -1 where the fixed fields leave it unreadable.
__host__ __device__ inline int bi_name(const uint8_t* buf, int64_t at,
                                       int64_t* name) {
    const int32_t bs = bi_i32(buf + at);
    *name = at + 36;
    if (bs < 32) return -1;
    const int lrn = buf[at + 4 + 8];
    if (lrn < 1 || 32 + lrn > bs || buf[at + 36 + lrn - 1] != 0) return -1;
    int len = 0;
    while (buf[at + 36 + len]) ++len;
    return len;
}

// two names (pointer, length) are one; an unreadable one counts as equal,
// so that its neighbours are declined
__host__ __device__ inline bool bi_names_equal(const uint8_t* a, int a_len,
                                               const uint8_t* b, int b_len) {
    if (a_len < 0 || b_len < 0) return true;
    if (a_len != b_len) return false;
    for (int i = 0; i < a_len; ++i)
        if (a[i] != b[i]) return false;
    return true;
}

// What the engine's consume test reads of a record, kept across chunks
// (the chunk after reads the last record of the one before from it).
struct BiKey {
    int32_t name_len;  // -1: the name is unreadable; -2: no record
    int32_t valid;     // bi_record's: else the fields below are not read
    int32_t flag, tid, has_sa, hi_present, hi_odd;
    int32_t pad;
    int64_t hi;
    uint8_t name[256];
};

// the key of r; its name copied only where with_name (else it stays at
// buf + r.at + 36)
__host__ __device__ inline void bi_key(const uint8_t* buf, const BiRecord& r,
                                       BiKey* k, bool with_name) {
    int64_t name;
    k->name_len = bi_name(buf, r.at, &name);
    if (with_name)
        for (int i = 0; i < k->name_len; ++i) k->name[i] = buf[name + i];
    k->valid = r.valid;
    k->flag = r.flag;
    k->tid = r.tid;
    k->has_sa = r.has_sa;
    k->hi_present = r.hi_present;
    k->hi_odd = r.hi_odd;
    k->hi = r.hi;
    k->pad = 0;
}

// The engine's consume test could pass on the adjacent records a, b (names
// at a_name, b_name): a superset of consume_adjacent_boring_pair's test
// (both primary proper pairs on one contig, one name and hit index, no SA
// tag), false only where the engine cannot pair them in place. Where it is
// false the engine's tiles cannot matter between a and b.
__host__ __device__ inline bool bi_maybe_consumed(const BiKey& a,
                                                  const uint8_t* a_name,
                                                  const BiKey& b,
                                                  const uint8_t* b_name) {
    if (a.name_len == -2 || b.name_len == -2) return false;
    if (!bi_names_equal(a_name, a.name_len, b_name, b.name_len)) return false;
    if (!a.valid || !b.valid) return true;
    const int bad = BI_FUNMAP | BI_FMUNMAP | BI_FSECONDARY | BI_FSUPPLEMENTARY;
    const int need = BI_FPAIRED | BI_FPROPER;
    if ((a.flag & bad) || (b.flag & bad) || (a.flag & need) != need
        || (b.flag & need) != need)
        return false;
    if (a.tid < 0 || a.tid != b.tid || a.has_sa || b.has_sa) return false;
    if (a.hi_odd || b.hi_odd) return true;
    return (a.hi_present ? a.hi : 1) == (b.hi_present ? b.hi : 1);
}

// Record i begins a chain of adjacent pairs the engine might consume (three
// records or more of one name, pairable in place): the engine's pairing
// there follows its 256-record decode tiles, so the residue places record i
// at its own index modulo 256. maybe[k]: bi_maybe_consumed of (k, k + 1),
// known for k < n - 1; the pair (n - 1, n) reaches into the next chunk and
// counts as maybe, except in the final chunk. maybe_before: of the pair
// (-1, 0), from the chunk before. A record flagged here that begins no
// chain only costs placeholders: nothing the engine might consume lies
// across them.
__host__ __device__ inline bool bi_chain_start(int64_t i, int64_t n, bool final,
                                               const uint8_t* maybe,
                                               bool maybe_before) {
    auto at = [&](int64_t k) -> bool {
        return k < n - 1 ? maybe[k] != 0 : !final;
    };
    const bool before = i == 0 ? maybe_before : maybe[i - 1] != 0;
    return !before && at(i) && at(i + 1);
}

// The pair (i, i + 1) of a chunk's n records is taken: its test holds and
// neither neighbour shares a name (same[i]: record i shares record i - 1's),
// so taken pairs never overlap. Record n, the next chunk's first, is known
// only in the final chunk, where there is none.
__host__ __device__ inline bool bi_take_at(int64_t i, int64_t n, bool final,
                                           const uint8_t* test,
                                           const uint8_t* same) {
    if (i < 0 || i + 1 >= n || !test[i] || same[i]) return false;
    if (i + 2 < n) return !same[i + 2];
    return final;
}

// The tables the pair test reads, per tid of the header.
struct BiContigs {
    int32_t n_tids;
    const int64_t* bounds;        // every tid's gene boundaries >= 0, sorted
    const int64_t* bound_offset;  // [n_tids + 1] into bounds
    const int64_t* plane_offset;  // [n_tids + 1] into the coverage planes
    const uint8_t* interesting;   // [n_tids]
    const uint8_t* viral;         // [n_tids]
    int external_duplicates;
};

// one record alone: everything the pass needs of each mate
__host__ __device__ inline bool bi_record_takes(const BiRecord& r,
                                                const BiContigs& c) {
    if (!r.valid || r.has_sa || r.hi_odd) return false;
    const uint16_t bad = BI_FUNMAP | BI_FMUNMAP | BI_FSECONDARY | BI_FSUPPLEMENTARY;
    if ((r.flag & bad) || (r.flag & (BI_FPAIRED | BI_FPROPER))
                          != (BI_FPAIRED | BI_FPROPER))
        return false;
    if (c.external_duplicates && (r.flag & BI_FDUP)) return false;
    if (r.tid < 0 || r.tid >= c.n_tids || c.viral[r.tid]) return false;
    if (c.plane_offset[r.tid + 1] == c.plane_offset[r.tid]) return false;
    if (r.pos < 0 || r.l_seq <= 0 || r.n_cigar != 1) return false;
    const uint32_t op = r.cigar0 & 0xf;
    if (op != 0 && op != 7 && op != 8) return false;  // M, =, X
    return (r.cigar0 >> 4) > 0;
}

__host__ __device__ inline bool bi_same_name(const uint8_t* buf,
                                             const BiRecord& a,
                                             const BiRecord& b) {
    if (a.name_len != b.name_len) return false;
    for (int i = 0; i < a.name_len; ++i)
        if (buf[a.name + i] != buf[b.name + i]) return false;
    return true;
}

// a gene boundary b >= 0 with lo - 3 <= b < hi + 3 (spans_gene_boundary)
__host__ __device__ inline bool bi_spans_boundary(const BiContigs& c, int tid,
                                                  int64_t lo, int64_t hi) {
    const int64_t* first = c.bounds + c.bound_offset[tid];
    int64_t n = c.bound_offset[tid + 1] - c.bound_offset[tid];
    const int64_t key = lo - 3;
    while (n > 0) {  // lower_bound
        const int64_t half = n / 2;
        if (first[half] < key) {
            first += half + 1;
            n -= half + 1;
        } else {
            n = half;
        }
    }
    return first < c.bounds + c.bound_offset[tid + 1] && *first < hi + 3;
}

// the pair test of adjacent records a (earlier) and b: both take, one tid,
// one name and hit index, and no gene boundary near the fragment
__host__ __device__ inline bool bi_pair(const uint8_t* buf, const BiRecord& a,
                                        const BiRecord& b, const BiContigs& c) {
    if (!bi_record_takes(a, c) || !bi_record_takes(b, c)) return false;
    if (a.tid != b.tid) return false;
    if ((a.hi_present ? a.hi : 1) != (b.hi_present ? b.hi : 1)) return false;
    if (!bi_same_name(buf, a, b)) return false;
    const int64_t end_a = a.pos + (int64_t)(a.cigar0 >> 4);
    const int64_t end_b = b.pos + (int64_t)(b.cigar0 >> 4);
    const int64_t lo = a.pos < b.pos ? a.pos : b.pos;
    const int64_t hi = end_a > end_b ? end_a : end_b;
    return !bi_spans_boundary(c, a.tid, lo, hi);
}

// The coverage of a taken pair, add_fragment's single-op path with the
// engine's argument order: mate1 is the later record (b). Window ranges are
// inclusive and empty where lo > hi; a flag of -1 is none.
struct BiCover {
    int64_t start, end;          // flag windows
    int64_t lo1, hi1, lo2, hi2;  // coverage += 1 over each
};

__host__ __device__ inline BiCover bi_cover(const BiRecord& a,
                                            const BiRecord& b,
                                            int64_t windows) {
    const int64_t R = BI_COVERAGE_RESOLUTION, half = R / 2;
    const BiRecord& m1 = b;
    const BiRecord& m2 = a;
    BiCover v;
    const int64_t pos1 = m1.pos, pos2 = m2.pos;
    const int64_t end1 = pos1 + (int64_t)(m1.cigar0 >> 4);
    const int64_t end2 = pos2 + (int64_t)(m2.cigar0 >> 4);
    const bool reverse = (m1.flag & BI_FREVERSE) != 0;
    int64_t w = (reverse ? pos2 : pos1) / R;
    v.start = w < windows ? w : -1;
    const int64_t window = (pos1 < pos2 ? pos1 : pos2) / R;
    const int64_t near_end = end1 < end2 ? end1 : end2;
    const int64_t far_end = end1 < end2 ? end2 : end1;
    const int64_t far_start = end1 < end2 ? pos2 : pos1;
    v.lo1 = window;
    v.hi1 = near_end >= half ? (near_end - half) / R : -1;
    if (v.hi1 > windows - 1) v.hi1 = windows - 1;
    const int64_t a2 = near_end / R + 1, b2 = far_start / R;
    v.lo2 = a2 > b2 ? a2 : b2;
    v.hi2 = far_end >= half ? (far_end - half) / R : -1;
    if (v.hi2 > windows - 1) v.hi2 = windows - 1;
    w = ((reverse ? end1 : end2) - 1) / R;
    v.end = w < windows ? w : -1;
    return v;
}

}  // namespace arriba
