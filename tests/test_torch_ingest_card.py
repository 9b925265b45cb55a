"""The card pass over a BGZF BAM (ingest/card.py; K6 in
kernels/csrc/bam_ingest.cu) on the CPU.

Its plain version (``card.plain_pass``: zlib, a serial framing walk, the
pair test and the reduction in Python) runs under the CLI in place of the
card and must leave the outputs of the engine alone byte for byte:
fusions.tsv, fusions.discarded.tsv, the stage counters and the coverage
planes the scan leaves. The kernels' steps (bam_ingest.cuh) compile with
g++ into a harness that runs them as the kernels do, a warp's lanes in
turn: inflate against zlib at every level, the framing on members cut
anywhere, and the pair test and reduction against the plain version; and
``card.card_pass``'s own chunk loop runs on the CPU with that harness in
place of the launches, in small chunks, so that records, pairs and runs of
one name straddle them.
"""

import ctypes
import os
import shutil
import struct
import subprocess
import tempfile
import zlib

import numpy as np
import pytest
import torch

from arriba_tpu_torch import kernels
from arriba_tpu_torch.ingest import card
from arriba_tpu_torch.io.bam import read_bam_header
from arriba_tpu_torch.kernels.build import CSRC

from . import scenario
from .bam_build import (assert_same, bgzf, cigar, edge_sample, header_bytes,
                        member, record, record_starts, run, spy, tag,
                        tile_runs)



def sample_record(r) -> bytes:
    """A scenario BamRecord as raw BAM (ints as "i", strings as "Z")."""
    tags = [tag(k, "i", v) if isinstance(v, int) else tag(k, "Z", str(v))
            for k, v in r.tags.items()]
    return record(r.qname, r.flag, r.tid, r.pos, list(r.cigar), r.seq, tags,
                  r.mtid, r.mpos, r.tlen)


# ------------------------------------------------------------ the harness

HARNESS = r"""
#include <stdint.h>
#include <vector>
#include "bam_ingest.cuh"
using namespace arriba;

extern "C" int emu_index(const uint8_t* buf, long long avail, int max_members,
                         long long max_out, long long* offset, long long* size,
                         long long* isize, long long* consumed) {
    int64_t at = 0;
    const int count = bi_index(buf, avail, max_members, max_out,
                               (int64_t*)offset, (int64_t*)size,
                               (int64_t*)isize, &at);
    *consumed = at;
    return count;
}

// bgzf_inflate_kernel's warp on one member: lane 0 decodes, the lanes
// clear and fill each block's tables in turn, and 32 segments' CRCs fold
// in the kernel's tree order. The tables start as garbage.
extern "C" int emu_inflate(const uint8_t* m, long long size, uint8_t* out) {
    uint32_t table[256];
    for (int i = 0; i < 256; ++i) table[i] = bi_crc_entry((uint32_t)i);
    std::vector<uint8_t> smem(BI_TABLE_BYTES, 0xA5);
    BiTables t = bi_tables(smem.data());
    const uint32_t want = bi_rd32(m + size - 8);
    const int64_t isize = bi_rd32(m + size - 4);
    BiInflate s;
    bi_start(&s, m + BI_MEMBER_HEADER,
             size - BI_MEMBER_HEADER - BI_MEMBER_TRAILER, out, isize);
    int job;
    for (;;) {
        job = bi_run(&s, t);
        if (job != BI_JOB_FILL) break;
        for (int lane = 0; lane < 32; ++lane) bi_zero(lane, 32, t);
        for (int lane = 0; lane < 32; ++lane) bi_fill(lane, 32, t, s.nlit);
    }
    const int error = job == BI_JOB_DONE ? bi_finish(&s) : s.error;
    if (error) return error;
    uint32_t crc[32];
    int64_t len[32];
    for (int lane = 0; lane < 32; ++lane) {
        int64_t begin;
        len[lane] = bi_crc_segment(lane, 32, isize, &begin);
        crc[lane] = bi_crc(table, 0, out + begin, len[lane]);
    }
    for (int step = 1; step < 32; step <<= 1)
        for (int lane = 0; lane + step < 32; lane += 2 * step) {
            crc[lane] = bi_crc_combine(crc[lane], crc[lane + step],
                                       len[lane + step]);
            len[lane] += len[lane + step];
        }
    return crc[0] == want ? BI_OK : BI_ERR_CRC;
}

// bam_frame_search_kernel's warps (the first plausible offset of 32 at a
// time), bam_frame_fix_kernel and bam_frame_write_kernel
extern "C" void emu_frame(const uint8_t* buf, long long end,
                          const long long* lo, const long long* hi,
                          int segments, int n_ref, long long* starts,
                          long long* stats) {
    std::vector<int64_t> entry(segments), exit_at(segments), count(segments);
    std::vector<int32_t> walked(segments);
    for (int s = 0; s < segments; ++s) {
        int64_t found = s == 0 ? lo[0] : -1;
        for (int64_t base = lo[s]; found < 0 && base < hi[s]; base += 32)
            for (int lane = 0; lane < 32; ++lane) {
                const int64_t q = base + lane;
                if (q < hi[s] && bi_plausible(buf, q, end, n_ref)) {
                    found = q;
                    break;
                }
            }
        entry[s] = found;
        if (found < 0) {
            exit_at[s] = -1;
            count[s] = 0;
            walked[s] = BI_WALK_BAD;
            continue;
        }
        const BiWalk w = bi_walk(buf, found, hi[s], end, nullptr);
        exit_at[s] = w.exit;
        count[s] = w.count;
        walked[s] = w.status;
    }
    int first_bad = segments;
    for (int s = segments - 1; s >= 0; --s)
        if (bi_frame_unverified(s, segments, entry.data(), exit_at.data(),
                                walked.data()))
            first_bad = s;
    int64_t tail;
    const int status = bi_frame_fix(buf, end, (const int64_t*)hi, segments,
                                    entry.data(), exit_at.data(), count.data(),
                                    walked.data(), first_bad, &tail);
    int64_t total = 0;
    for (int s = 0; s < segments; ++s) {
        if (count[s])
            bi_walk(buf, entry[s], hi[s], end, (int64_t*)starts + total);
        total += count[s];
    }
    stats[0] = total;
    stats[1] = tail;
    stats[2] = status;
}

// bam_pair_test_kernel's and bam_pair_take_kernel's threads in turn
extern "C" void emu_pairs(const uint8_t* buf, const long long* starts,
                          long long* stats, long long capacity, int final,
                          const BiKey* ctx, BiKey* ctx_out,
                          const long long* bounds, const long long* bound_offset,
                          const long long* plane_offset,
                          const uint8_t* interesting, const uint8_t* viral,
                          int n_tids, int external, uint8_t* test,
                          uint8_t* maybe, uint8_t* same, int32_t* cov,
                          uint8_t* cov_starts, uint8_t* cov_ends,
                          long long* kept_size, int32_t* kept,
                          uint8_t* chain_start) {
    BiContigs c;
    c.n_tids = n_tids;
    c.bounds = (const int64_t*)bounds;
    c.bound_offset = (const int64_t*)bound_offset;
    c.plane_offset = (const int64_t*)plane_offset;
    c.interesting = interesting;
    c.viral = viral;
    c.external_duplicates = external;
    const int64_t n = stats[0];
    for (int64_t i = 0; i < capacity; ++i) {
        if (i >= n) { test[i] = maybe[i] = same[i] = 0; continue; }
        const BiRecord a = bi_record(buf, starts[i]);
        BiKey ka;
        bi_key(buf, a, &ka, false);
        const uint8_t* a_name = buf + a.at + 36;
        if (i == 0) {
            same[i] = ctx->name_len != -2
                      && bi_names_equal(a_name, ka.name_len, ctx->name,
                                        ctx->name_len);
            stats[6] = bi_maybe_consumed(*ctx, ctx->name, ka, a_name);
        } else {
            int64_t prev;
            const int prev_len = bi_name(buf, starts[i - 1], &prev);
            same[i] = bi_names_equal(a_name, ka.name_len, buf + prev, prev_len);
        }
        if (i + 1 >= n) { test[i] = maybe[i] = 0; continue; }
        const BiRecord b = bi_record(buf, starts[i + 1]);
        BiKey kb;
        bi_key(buf, b, &kb, false);
        test[i] = bi_pair(buf, a, b, c);
        maybe[i] = bi_maybe_consumed(ka, a_name, kb, buf + b.at + 36);
    }
    for (int64_t i = 0; i < capacity; ++i) {
        if (i >= n) {
            kept_size[i] = 0; kept[i] = 0; chain_start[i] = 0;
            continue;
        }
        const bool starts_pair = bi_take_at(i, n, final, test, same);
        const bool taken = starts_pair || bi_take_at(i - 1, n, final, test, same);
        const int64_t at = starts[i];
        kept_size[i] = taken ? 0 : 4 + (int64_t)bi_i32(buf + at);
        kept[i] = taken ? 0 : 1;
        const bool begins = bi_chain_start(i, n, final, maybe, stats[6] != 0);
        chain_start[i] = begins;
        stats[7] += begins;
        if (starts_pair) {
            const BiRecord a = bi_record(buf, at);
            const BiRecord b = bi_record(buf, starts[i + 1]);
            const int64_t offset = c.plane_offset[a.tid];
            const int64_t windows = c.plane_offset[a.tid + 1] - offset;
            const BiCover v = bi_cover(a, b, windows);
            if (v.start >= 0) cov_starts[offset + v.start] = 1;
            for (int64_t w = v.lo1; w <= v.hi1; ++w) cov[offset + w] += 1;
            for (int64_t w = v.lo2; w <= v.hi2; ++w) cov[offset + w] += 1;
            if (v.end >= 0) cov_ends[offset + v.end] = 1;
            stats[4] += 2;
            stats[5] += c.interesting[a.tid] ? 2 : 0;
        }
        if (i == n - 1) bi_key(buf, bi_record(buf, at), ctx_out, true);
    }
}

// bam_residue_copy_kernel's warps in turn
extern "C" void emu_residue(const uint8_t* buf, const long long* starts,
                            const long long* stats, long long base,
                            const long long* kept_size,
                            const long long* size_sum, const int32_t* kept_sum,
                            const uint8_t* chain_start, uint8_t* res,
                            long long* res_offset, long long* res_record,
                            uint8_t* res_chain) {
    for (int64_t i = 0; i < stats[0]; ++i) {
        const int64_t size = kept_size[i];
        if (size == 0) continue;
        const int64_t dst = size_sum[i] - size;
        for (int64_t k = 0; k < size; ++k) res[dst + k] = buf[starts[i] + k];
        const int64_t j = kept_sum[i] - 1;
        res_offset[j] = dst;
        res_record[j] = base + i;
        res_chain[j] = chain_start[i];
    }
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("g++ is not installed: K6's steps are compiled with it")
    work = tmp_path_factory.mktemp("bam_ingest_harness")
    source = work / "harness.cpp"
    source.write_text("#include <cstring>\n" + HARNESS)
    lib = work / "libharness.so"
    subprocess.run([compiler, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(source)], check=True)
    return ctypes.CDLL(str(lib))


def ptr(x) -> int:
    return x.data_ptr() if isinstance(x, torch.Tensor) else x.ctypes.data


def emulated_launches(monkeypatch, lib):
    """kernels.launch_bgzf_inflate and the other K6 launches, and the
    indexer, as their g++ builds on CPU tensors."""
    c = ctypes.c_void_p
    ll = ctypes.c_longlong
    lib.emu_index.argtypes = [c, ll, ctypes.c_int, ll, c, c, c, c]
    lib.emu_index.restype = ctypes.c_int
    lib.emu_inflate.argtypes = [c, ll, c]
    lib.emu_inflate.restype = ctypes.c_int
    lib.emu_frame.argtypes = [c, ll, c, c, ctypes.c_int, ctypes.c_int, c, c]
    lib.emu_pairs.argtypes = ([c, c, c, ll, ctypes.c_int] + [c] * 7
                              + [ctypes.c_int] * 2 + [c] * 9)
    lib.emu_residue.argtypes = [c, c, c, ll] + [c] * 8

    def inflate(comp, member_offset, member_size, out_offset, out, status,
                stats):
        base = comp.data_ptr()
        for m, (at, size, to) in enumerate(zip(member_offset.tolist(),
                                               member_size.tolist(),
                                               out_offset.tolist())):
            status[m] = lib.emu_inflate(base + at, size, out.data_ptr() + to)
        stats[3] += int((status[:len(member_offset)] != 0).sum())

    def frame(buf, end, seg_lo, seg_hi, n_ref, seg, walked, starts, stats):
        lo, hi = seg_lo.contiguous(), seg_hi.contiguous()
        lib.emu_frame(ptr(buf), end, ptr(lo), ptr(hi), lo.shape[0], n_ref,
                      ptr(starts), ptr(stats))

    def pairs(buf, starts, stats, final, ctx_in, ctx_out, contigs, test,
              maybe, same, cov, cov_starts, cov_ends, kept_size, kept,
              chain_start):
        (bounds, bound_offset, plane_offset, interesting, viral, n_tids,
         external) = contigs
        lib.emu_pairs(ptr(buf), ptr(starts), ptr(stats), starts.shape[0],
                      int(final), ptr(ctx_in), ptr(ctx_out), ptr(bounds),
                      ptr(bound_offset), ptr(plane_offset), ptr(interesting),
                      ptr(viral), n_tids, external, ptr(test), ptr(maybe),
                      ptr(same), ptr(cov), ptr(cov_starts), ptr(cov_ends),
                      ptr(kept_size), ptr(kept), ptr(chain_start))

    def residue(buf, starts, stats, base, kept_size, size_sum, kept_sum,
                chain_start, res, res_offset, res_record, res_chain):
        lib.emu_residue(ptr(buf), ptr(starts), ptr(stats), base,
                        ptr(kept_size), ptr(size_sum), ptr(kept_sum),
                        ptr(chain_start), ptr(res), ptr(res_offset),
                        ptr(res_record), ptr(res_chain))

    def finish(cov, out):
        out.copy_(cov.clamp(max=0xFFFF).to(torch.int32).to(torch.int16))

    monkeypatch.setattr(kernels, "launch_bgzf_inflate", inflate)
    monkeypatch.setattr(kernels, "launch_bam_frame", frame)
    monkeypatch.setattr(kernels, "launch_bam_pairs", pairs)
    monkeypatch.setattr(kernels, "launch_bam_residue", residue)
    monkeypatch.setattr(kernels, "launch_bam_coverage_finish", finish)
    monkeypatch.setattr(card, "_indexer", lambda: lib.emu_index)


def small_chunks(monkeypatch, read=4096, out=12288, carry=4096):
    """card_pass in chunks of a few records (the real sizes fit a whole
    test sample in one)."""
    monkeypatch.setattr(card, "READ_BYTES", read)
    monkeypatch.setattr(card, "CHUNK_OUT", out)
    monkeypatch.setattr(card, "MAX_CARRY", carry)
    monkeypatch.setattr(card, "RESIDUE_PIECE", 1000)


def as_bam(tmp_path, args, cuts=(), level=1):
    """A scenario sample's SAM rewritten as a BGZF BAM."""
    from arriba_tpu.io.bam import open_alignment_file

    sam = args[args.index("-x") + 1]
    header, records = open_alignment_file(sam)
    raw = header_bytes(header.target_names, header.target_lengths)
    raw += b"".join(sample_record(r) for r in records)
    path = tmp_path / "aligned.bam"
    path.write_bytes(bgzf(raw, cuts, level))
    out = list(args)
    out[out.index("-x") + 1] = str(path)
    return out


SCENARIOS = ["translocation_sample", "multi_event_sample", "viral_sample",
             "duplicates_marked_sample", "itd_sample", "artifact_zoo_sample"]


@pytest.mark.parametrize("sample", SCENARIOS)
def test_plain_pass_leaves_the_engines_outputs(tmp_path, monkeypatch,
                                               sample):
    args = as_bam(tmp_path, getattr(scenario, sample)(tmp_path))
    alone = run(monkeypatch, args, tmp_path, "alone")
    seen = []
    passed = run(monkeypatch, args, tmp_path, "pass",
                 spy(card.plain_pass, seen))
    assert_same(alone, passed)
    assert len(seen) == 1 and seen[0].taken > 0


@pytest.mark.parametrize("flags", [[], ["-u"]], ids=["marked_kept", "u"])
def test_plain_pass_on_every_kind_of_record(tmp_path, monkeypatch, flags):
    args = edge_sample(tmp_path, saturate=70000).write() + flags
    alone = run(monkeypatch, args, tmp_path, "alone")
    seen = []
    passed = run(monkeypatch, args, tmp_path, "pass",
                 spy(card.plain_pass, seen))
    assert_same(alone, passed)
    result = seen[0]
    # the consumable pairs and most of the saturating ones went to the card
    assert result.taken >= 2 * (120 + 70000 * 15 // 16)
    assert result.chains > 0  # the three records of one name
    assert result.coverage.max() > 0xFFFF
    cov = alone[4][0][0][0]
    assert cov.max() == 0xFFFF


def test_plain_pass_holds_runs_at_their_tile(tmp_path, monkeypatch):
    """Runs of one name at every offset around the engine's 256-record
    tiles: the residue puts each where the engine met it."""
    sample = edge_sample(tmp_path)
    tile_runs(sample)
    args = sample.write()
    alone = run(monkeypatch, args, tmp_path, "alone")
    seen = []
    passed = run(monkeypatch, args, tmp_path, "pass",
                 spy(card.plain_pass, seen))
    assert_same(alone, passed)
    assert seen[0].placeholders > 0


# -------------------------------------------------------- the g++ harness


@pytest.mark.parametrize("level", range(10))
@pytest.mark.parametrize("size", [0, 1, 300, 65280], ids=lambda s: f"b{s}")
def test_inflate_matches_zlib(harness, level, size):
    rng = np.random.default_rng(level * 7 + size)
    # a BAM-like mix: repeats that match and noise that does not
    text = b"".join(bytes(rng.integers(65, 70, 40, dtype=np.uint8))
                    + b"ACGTTGCA" * int(rng.integers(0, 5))
                    for _ in range(size // 40 + 1))[:size]
    for strategy in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED, zlib.Z_HUFFMAN_ONLY,
                     zlib.Z_RLE):
        m = member(text, level, strategy)
        out = np.zeros(max(size, 1), np.uint8)
        harness.emu_inflate.restype = ctypes.c_int
        code = harness.emu_inflate(ctypes.c_char_p(m), ctypes.c_longlong(len(m)),
                                   out.ctypes.data_as(ctypes.c_void_p))
        assert code == 0
        assert out[:size].tobytes() == text


def test_inflate_refuses_a_flipped_crc_and_a_short_isize(harness):
    text = bytes(range(256)) * 40
    good = member(text, 6)
    out = np.zeros(len(text) + 16, np.uint8)
    harness.emu_inflate.restype = ctypes.c_int

    def code(m):
        return harness.emu_inflate(ctypes.c_char_p(m), ctypes.c_longlong(len(m)),
                                   out.ctypes.data_as(ctypes.c_void_p))

    assert code(good) == 0
    crc = bytearray(good)
    crc[-6] ^= 0x10
    assert code(bytes(crc)) == 8  # BI_ERR_CRC
    short = bytearray(good)
    short[-4:] = struct.pack("<I", len(text) - 1)
    assert code(bytes(short)) == 5  # BI_ERR_OUTPUT
    body = bytearray(good)
    body[30] ^= 0xFF
    assert code(bytes(body)) != 0


def emulated_card(monkeypatch, harness, chunks=True):
    emulated_launches(monkeypatch, harness)
    if chunks:
        small_chunks(monkeypatch)

    def backend(path, contigs):
        return card.card_pass(path, contigs, torch.device("cpu"))
    return backend


def test_card_steps_match_the_plain_pass(tmp_path, monkeypatch, harness):
    """One chunk: the kernels' steps take the same pairs, the same coverage
    and the same residue as the plain pass."""
    args = edge_sample(tmp_path, saturate=300).write(
        cuts=[700, 701, 5000, 5003])
    plain, emulated = [], []
    run(monkeypatch, args, tmp_path, "plain", spy(card.plain_pass, plain))
    run(monkeypatch, args, tmp_path, "card",
        spy(emulated_card(monkeypatch, harness, chunks=False), emulated))
    a, b = plain[0], emulated[0]
    assert (a.taken, a.residue, a.mapped, a.chains, a.placeholders) \
        == (b.taken, b.residue, b.mapped, b.chains, b.placeholders)
    assert np.array_equal(np.minimum(a.coverage, 0xFFFF),
                          b.coverage.numpy().view(np.uint16))
    assert np.array_equal(a.starts, b.starts.numpy())
    assert np.array_equal(a.ends, b.ends.numpy())


@pytest.mark.parametrize("cuts", ["members", "block_size", "records"])
def test_card_chunks_leave_the_engines_outputs(tmp_path, monkeypatch, harness,
                                              cuts):
    """The chunk loop of card_pass in chunks of a few records: members cut
    inside block_size fields, records and pairs across chunks, runs of one
    name across them."""
    sample = edge_sample(tmp_path, saturate=40)
    tile_runs(sample, runs=6)
    raw = sample.raw()
    starts = record_starts(raw)
    if cuts == "members":
        offsets = list(range(1000, len(raw), 1777))
    elif cuts == "block_size":  # a member boundary inside each 4-byte size
        offsets = [s + 1 + (k % 3) for k, s in enumerate(starts[::5])]
    else:
        offsets = starts[::3]
    args = sample.write(cuts=offsets, size=3000)
    alone = run(monkeypatch, args, tmp_path, "alone")
    seen, chunks, asked, bases = [], [], [], []
    read_chunk = card._read_chunk
    monkeypatch.setattr(card, "_read_chunk",
                        lambda *a: chunks.append(1) or read_chunk(*a))
    backend = emulated_card(monkeypatch, harness)
    residue = kernels.launch_bam_residue
    monkeypatch.setattr(kernels, "launch_bam_residue",
                        lambda *a: bases.append(a[3]) or residue(*a))

    def kept(path, contigs):
        result = backend(path, contigs)
        asked.append((path, contigs, open(result.path, "rb").read()))
        return result

    passed = run(monkeypatch, args, tmp_path, "card", spy(kept, seen))
    assert_same(alone, passed)
    assert seen[0].taken > 0 and seen[0].chains > 0
    assert len(chunks) >= 5
    # the plain pass cut where the card's chunks fell takes the same pairs
    # and leaves the same residue
    path, contigs, card_residue = asked[0]
    plain = card.plain_pass(path, contigs, cuts=[b for b in bases if b > 0])
    try:
        a, b = plain, seen[0]
        assert (a.taken, a.residue, a.mapped, a.chains, a.placeholders) \
            == (b.taken, b.residue, b.mapped, b.chains, b.placeholders)
        assert open(plain.path, "rb").read() == card_residue
        assert np.array_equal(np.minimum(a.coverage, 0xFFFF),
                              b.coverage.numpy().view(np.uint16))
        assert np.array_equal(a.starts, b.starts.numpy())
        assert np.array_equal(a.ends, b.ends.numpy())
    finally:
        plain.close()


def test_card_pass_falls_back_on_a_bad_member(tmp_path, monkeypatch, harness):
    """A member whose CRC fails drops the pass before the engine runs; the
    engine then reads the original file and reports it in its own words."""
    args = edge_sample(tmp_path, saturate=3000).write(level=0)
    path = args[args.index("-x") + 1]
    data = bytearray(open(path, "rb").read())
    assert len(data) > 3 << 16  # past what the header's reader inflates
    data[-28 - 6] ^= 0x01  # the last data member's CRC
    open(path, "wb").write(bytes(data))
    backend = emulated_card(monkeypatch, harness)
    seen = []

    def counted(path, contigs):
        seen.append(1)
        with pytest.raises(card.Fallback):
            backend(path, contigs)
        raise card.Fallback("a member failed its checks")

    errors = []
    for label, chosen in (("alone", None), ("bad", counted)):
        with pytest.raises(Exception) as caught:
            rc = run(monkeypatch, args, tmp_path, label, chosen)[0]
            assert rc != 0
            raise RuntimeError("the run failed with its status")
        errors.append((type(caught.value), str(caught.value)))
    assert seen == [1]
    assert errors[0] == errors[1]


@pytest.mark.parametrize("where", ["build", "launch"])
def test_card_errors_fail_the_run(tmp_path, monkeypatch, harness, capsys,
                                  where):
    """A build or launch error is no input the pass declines: the run
    fails with it, and the engine does not read the file in its place."""
    from arriba_tpu_torch import cli
    from arriba_tpu_torch.ingest import chimeric

    args = edge_sample(tmp_path, saturate=40).write(size=3000)
    backend = emulated_card(monkeypatch, harness)

    def fail(*a, **k):
        raise RuntimeError(f"the {where} failed")

    if where == "build":
        monkeypatch.setattr(card, "_indexer", fail)
    else:
        monkeypatch.setattr(kernels, "launch_bam_pairs", fail)
    scans = []
    monkeypatch.setattr(chimeric, "_scan", lambda *a: scans.append(a))
    monkeypatch.setattr(card, "backend", lambda: backend)
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = cli.main(list(args) + ["-o", str(tmp_path / "f.tsv"),
                                "-O", str(tmp_path / "d.tsv")])
    assert rc == 1
    assert f"ERROR: the {where} failed" in capsys.readouterr().err
    assert scans == []
    assert not list(tmp_path.glob("arriba_tpu_residue_*"))


def test_pass_leaves_a_coordinate_sorted_bam_to_the_engine(tmp_path,
                                                           monkeypatch):
    """A header that says SO:coordinate: mates lie apart, so the pass is
    not entered at all."""
    from arriba_tpu_torch import trace

    sample = edge_sample(tmp_path, saturate=40)
    sample.hd = "@HD\tVN:1.6\tSO:coordinate\n"
    args = sample.write()
    assert card.sorted_by_coordinate(read_bam_header(args[1]).raw)
    alone = run(monkeypatch, args, tmp_path, "alone")
    asked = []
    monkeypatch.setattr("arriba_tpu_torch.pipeline._STAGE_TIMES", True)
    passed = run(monkeypatch, args, tmp_path, "pass",
                 lambda *a: asked.append(a) or card.plain_pass(*a))
    assert_same(alone, passed)
    assert asked == []
    assert trace.finished()[-1].counters.get("ingest.card_skipped") == 1


@pytest.mark.parametrize("hd", ["", "@HD\tVN:1.6\tSO:unknown\n"],
                         ids=["no_hd", "unknown"])
def test_pass_drops_where_mates_lie_apart(tmp_path, monkeypatch, harness,
                                         hd):
    """Records in coordinate order under a header that does not say so:
    the first JUDGE_RECORDS records leave most to the residue, so the pass
    drops out (Unpaired) before the engine is called, removes its residue,
    and the engine reads the original file."""
    sample = edge_sample(tmp_path, saturate=40)
    sample.hd = hd
    sample.records.sort(key=lambda r: struct.unpack_from("<ii", r, 4))
    args = sample.write(size=3000)
    alone = run(monkeypatch, args, tmp_path, "alone")
    backend = emulated_card(monkeypatch, harness)
    monkeypatch.setattr(card, "JUDGE_RECORDS", 64)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    raised = []

    def judged(path, contigs):
        try:
            return backend(path, contigs)
        except card.Unpaired as error:
            raised.append(error)
            raise

    passed = run(monkeypatch, args, tmp_path, "pass", judged)
    assert_same(alone, passed)
    assert len(raised) == 1
    assert not list(tmp_path.glob("arriba_tpu_residue_*"))


def test_pass_goes_on_where_mates_lie_together(tmp_path, monkeypatch,
                                               harness):
    """The same judgement on mate-adjacent records keeps the pass."""
    sample = edge_sample(tmp_path, saturate=300)
    args = sample.write(size=3000)
    alone = run(monkeypatch, args, tmp_path, "alone")
    monkeypatch.setattr(card, "JUDGE_RECORDS", 64)
    seen = []
    passed = run(monkeypatch, args, tmp_path, "pass",
                 spy(emulated_card(monkeypatch, harness), seen))
    assert_same(alone, passed)
    assert seen[0].taken > 0


def key_thrice(tmp_path, place: int, earlier: bool, shift: int = 0):
    """A sample with one (name, HI) key on three primary proper-pair
    records: a lone one, and an adjacent pair whose first record sits at
    index place modulo the engine's tiles; the lone one before the pair
    (earlier) or after it. shift: unmapped records put in near the start,
    which moves the pair by as many places."""
    s = edge_sample(tmp_path)
    hi = [tag("HI", "i", 1)]
    lone = record("key3", 99, 0, 2400, cigar("50M"), s.seq("1", 2400, 50),
                  hi, 0, 2460)
    if earlier:
        s.records.append(lone)
    need = (place - len(s.records)) % card.TILE
    if need % 2:
        s.records.append(card.PLACEHOLDER)
    for i in range(need // 2):
        s.pair(f"f{i}", 0, 5200 + 3 * i)
    assert len(s.records) % card.TILE == place
    s.records[20:20] = [card.PLACEHOLDER] * shift
    s.records.append(record("key3", 99, 0, 2460, cigar("50M"),
                            s.seq("1", 2460, 50), hi, 0, 2520))
    s.records.append(record("key3", 147, 0, 2520, cigar("50M"),
                            s.seq("1", 2520, 50), hi, 0, 2460))
    s.pair("after", 0, 2700)
    if not earlier:
        s.records.append(lone)
    return s.write()


def differences(a, b) -> list:
    """What differs between two runs: the outputs by name, and each
    coverage plane's windows (tid, plane, windows)."""
    out = [name for name, x, y in zip(("rc", "fusions", "discarded",
                                       "counters"), a, b) if x != y]
    for tid, (pa, pb) in enumerate(zip(a[4][0], b[4][0])):
        for k, (x, y) in enumerate(zip(pa or (), pb or ())):
            if not np.array_equal(x, y):
                out.append((tid, k, np.flatnonzero(x != y).tolist()))
    return out


@pytest.mark.parametrize("place,earlier", [(255, False), (254, True),
                                           (255, True)],
                         ids=["later_at_tile_end", "earlier_inside_tile",
                              "earlier_across_tiles"])
def test_a_key_on_three_records(tmp_path, monkeypatch, place, earlier):
    """A key on three primary proper-pair records, an adjacent two of them
    taken by the pass (no aligner writes one: the engine consumes in place
    only a key's two records). Where the lone one comes after the pair, or
    the pair lies inside one of the engine's decode tiles, the outputs are
    the engine's. Where the lone one comes first and the pair straddles a
    tile, the engine alone pairs the lone record with the pair's first and
    the pass keeps the pair: the coverage planes differ at those windows,
    and nothing else. The engine alone differs from itself there by the
    same windows when one unmapped record moves the pair into one tile,
    and the pass then gives its outputs."""
    args = key_thrice(tmp_path, place, earlier)
    alone = run(monkeypatch, args, tmp_path, "alone")
    passed = run(monkeypatch, args, tmp_path, "pass", card.plain_pass)
    if not (earlier and place == card.TILE - 1):
        assert differences(alone, passed) == []
        return
    found = differences(alone, passed)
    assert found and all(isinstance(d, tuple) and d[0] == 0 for d in found)
    moved = tmp_path / "moved"
    moved.mkdir()
    shifted = run(monkeypatch, key_thrice(moved, place, earlier, shift=1),
                  moved, "alone")
    assert differences(alone, shifted) == found
    assert differences(passed, shifted) == []


# ------------------------------------------------------- where it runs


def test_pass_is_entered_only_on_a_regular_bgzf_bam(tmp_path, monkeypatch):
    """SAM, SAM.gz, CRAM, a pipe, a separate chimeric file and the host
    path read as before; only the regular BAM file asks for the pass."""
    import gzip

    from arriba_tpu.io.bam import open_alignment_file
    from arriba_tpu.io.cram import write_cram

    args = scenario.translocation_sample(tmp_path)
    sam = args[args.index("-x") + 1]
    bam_args = as_bam(tmp_path, args)
    bam = bam_args[bam_args.index("-x") + 1]
    (tmp_path / "aligned.sam.gz").write_bytes(
        gzip.compress(open(sam, "rb").read()))
    header, records = open_alignment_file(sam)
    fasta = args[args.index("-a") + 1]
    reference, name, chunks = {}, None, []
    for line in open(fasta):
        if line.startswith(">"):
            if name is not None:
                reference[name] = np.frombuffer("".join(chunks).encode(),
                                                np.uint8).copy()
            name, chunks = line[1:].split()[0], []
        else:
            chunks.append(line.strip())
    reference[name] = np.frombuffer("".join(chunks).encode(), np.uint8).copy()
    write_cram(str(tmp_path / "aligned.cram"), header, list(records),
               reference)
    asked = []
    monkeypatch.setattr(card, "run",
                        lambda path, *a: asked.append(path) or None)

    def with_input(path, extra=()):
        out = list(args)
        out[out.index("-x") + 1] = str(path)
        return out + list(extra)

    for path in (sam, tmp_path / "aligned.sam.gz", tmp_path / "aligned.cram"):
        assert run(monkeypatch, with_input(path), tmp_path, "x")[0] == 0
    assert run(monkeypatch, with_input(bam, ["-c", sam]), tmp_path, "c")[0] == 0
    fifo = tmp_path / "in.fifo"
    os.mkfifo(fifo)
    # a process feeds the pipe: the engine's scan_open keeps the GIL while
    # it waits for the first bytes
    feeder = subprocess.Popen(["sh", "-c", f"cat '{bam}' > '{fifo}'"])
    assert run(monkeypatch, with_input(fifo), tmp_path, "fifo")[0] == 0
    feeder.wait(timeout=60)
    assert asked == []
    assert run(monkeypatch, with_input(bam), tmp_path, "bam")[0] == 0
    assert asked == [bam]


@pytest.mark.parametrize("mode,card_there,wanted",
                         [("off", True, False), ("cpu", True, False),
                          ("cuda", False, False), ("cuda", True, True)])
def test_backend_is_the_card_only_with_one(monkeypatch, mode, card_there,
                                           wanted):
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card_there)
    assert (card.backend() is card.card_pass) is wanted
    if not wanted:
        assert card.backend() is None


def test_residue_writer_places_runs_at_their_tile(tmp_path):
    writer = card.ResidueWriter(b"BAM\x01")
    one = record("a", 4, -1, -1, [], "")
    writer.write(one * 10, 10, [(len(one) * 3, 3, 300)])
    writer.write(one * 2, 2, [(0, 0, 600)])
    writer.close()
    data = open(writer.path, "rb").read()
    card.Result(writer.path).close()
    # 3 records, then (300 - 3) % 256 = 41 placeholders put the run at 44,
    # 300's place in its tile; 7 more make 51, and 37 put the next at 88
    assert writer.placeholders == 41 + 37
    assert writer.records == 88 + 2
    assert len(data) == 4 + 12 * len(one) + writer.placeholders * len(
        card.PLACEHOLDER)
