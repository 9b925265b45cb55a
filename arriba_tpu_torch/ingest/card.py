"""The card pass over a BGZF BAM before the native scan.

Most of an RNA-seq BAM is its background of proper pairs, written mate
after mate, that cross no gene boundary and carry no split read. The native
engine (``_native.scan_sam``) consumes such an adjacent pair
(``consume_adjacent_boring_pair``, native/ingest.cpp) into commutative
reductions only: the record count, the mapped reads of interesting
contigs, and the coverage windows with their start and end flags
(``add_fragment``). This pass does that work on the card (K6,
kernels/csrc/bam_ingest.cu) and hands the engine every other record, in its
order, as an uncompressed BAM behind the original header: the residue.

Per chunk of whole BGZF members (read and indexed on the host, copied to
the card while the card works on the chunk before): inflate a member a
warp (CRC-32 and ISIZE checked), frame the records (block_size chains,
each member's guessed entry held to the exit before it), test each
adjacent pair (a strict subset of the engine's: both primary proper pairs
on one contig that is neither viral nor without a coverage plane, one name
and hit index, a single M / = / X CIGAR op, no SA tag, every aux payload
sound, no duplicate under external marking, no gene boundary within three
bases), take a pair whose neighbours share neither name, add its coverage,
and compact the rest. A record whose successor lies in the next chunk is
declined with it.

Records that share one name with a neighbour all go to the residue. Where
three or more adjacent records of one name could be paired in place by the
engine's consume test (a chain; no aligner writes one), the engine pairs
them by its own 256-record decode tiles, so a chain enters the residue
where its index modulo 256 is the one it had: the writer puts unmapped
placeholder records (skipped by the engine, which counts nothing of them
that the port reads) before the chain's first record. Placeholders lie
only where nothing the engine might consume lies across them, so a record
that only may begin a chain (at a chunk's end) costs nothing else. One
input stays outside this: a key on a lone record and, later, an adjacent
pair (no aligner writes one). Where that pair straddles one of the
engine's tiles, the engine alone pairs the lone record with the pair's
first and the pass keeps the pair, so the coverage planes differ at those
windows; the engine alone differs from itself there when an unmapped
record moves the pair into one tile (test_a_key_on_three_records).

The pass runs where the input is a regular-file BGZF BAM on the native
extraction path and the offload device is a card (``backend``). It pays
only where mates lie next to each other, as in an aligner's unsorted or
name-grouped output: a file whose header says SO:coordinate is left to
the engine, and so is one whose first JUDGE_RECORDS records leave more
than half to the residue (``Unpaired``); both count as
``ingest.card_skipped``. Anything it cannot read exactly (a member of
another layout, a CRC or size that fails, a chain that does not frame, a
record past the carry limit) drops it, counted as
``ingest.card_fallbacks``, before the engine is called, which then reads
the original file and reports its faults in its own words. A build,
launch or device error is not input the pass declines: it fails the run.
``plain_pass`` is the same pass in plain Python and zlib, for the tests.
"""

from __future__ import annotations

import os
import struct
import tempfile
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import trace

# the engine's decode tiles (native/ingest.cpp, the BAM shard pipeline)
TILE = 256
COVERAGE_RESOLUTION = 20
# an unmapped record the engine skips: block_size 33, tid and pos -1, a
# name of one NUL byte, flag 4
PLACEHOLDER = struct.pack("<iiiBBHHHiiii", 33, -1, -1, 1, 0, 4680, 0, 4, 0,
                          -1, -1, 0) + b"\0"

# the card path's chunks: compressed bytes read at a time (into each of two
# pinned buffers), the most decompressed bytes a chunk takes, the longest
# record carried between chunks, and the pinned buffer a chunk's residue
# comes back through, in pieces. Pinned blocks are powers of two (PyTorch's
# host allocator rounds up to one): 2 x 32 + 32 + 2 x 2 MB.
READ_BYTES = 32 << 20
CHUNK_OUT = 128 << 20
MAX_CARRY = 16 << 20
RESIDUE_PIECE = 32 << 20
MAX_MEMBERS = 1 << 14
# the pass goes on past the first JUDGE_RECORDS records only where it took
# at least MIN_TAKEN of them
JUDGE_RECORDS = 1 << 16
MIN_TAKEN = 0.5

FPAIRED, FPROPER, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FSECONDARY, FDUP, FSUPPLEMENTARY = 0x10, 0x100, 0x400, 0x800


class Fallback(Exception):
    """The input is not one the pass can read exactly: the engine reads
    the original file instead."""


class Unpaired(Exception):
    """The input's mates do not lie next to each other often enough for
    the pass to pay: the engine reads the original file instead."""


def sorted_by_coordinate(header: bytes) -> bool:
    """Whether the BAM header's @HD line says SO:coordinate."""
    if len(header) < 8:
        return False
    (l_text,) = struct.unpack_from("<i", header, 4)
    line = header[8:8 + max(l_text, 0)].split(b"\n", 1)[0]
    fields = line.rstrip(b"\r\0").split(b"\t")
    return fields[0] == b"@HD" and b"SO:coordinate" in fields[1:]


@dataclass
class Contigs:
    """What the pass reads of the sample's header: its bytes (the
    residue's header), and per tid what the pair test and the reduction
    read."""

    header: bytes
    bounds: np.ndarray          # int64: every tid's gene boundaries >= 0
    bound_offset: np.ndarray    # int64 [n_tids + 1]
    plane_offset: np.ndarray    # int64 [n_tids + 1] into the flat planes
    interesting: np.ndarray     # uint8 [n_tids]
    viral: np.ndarray           # uint8 [n_tids]
    external_duplicates: bool

    @property
    def n_tids(self) -> int:
        return len(self.interesting)

    @property
    def windows(self) -> int:
        return int(self.plane_offset[-1])


def contigs_for(header: bytes, boundaries: List[bytes], planes: list,
                interesting: bytes, viral: bytes,
                external_duplicates: bool) -> Contigs:
    """The tables from the header's bytes and scan_sam's own arguments:
    each tid's boundaries (int64 bytes, sorted), its coverage plane (or
    None), and its interesting and viral bytes."""
    kept = [np.frombuffer(b, np.int64) for b in boundaries]
    kept = [b[b >= 0] for b in kept]
    bound_offset = np.zeros(len(kept) + 1, np.int64)
    bound_offset[1:] = np.cumsum([len(b) for b in kept])
    windows = [0 if p is None else len(p[0]) for p in planes]
    plane_offset = np.zeros(len(windows) + 1, np.int64)
    plane_offset[1:] = np.cumsum(windows)
    return Contigs(
        header=header,
        bounds=np.concatenate(kept) if kept else np.zeros(0, np.int64),
        bound_offset=bound_offset, plane_offset=plane_offset,
        interesting=np.frombuffer(bytes(interesting), np.uint8).copy(),
        viral=np.frombuffer(bytes(viral), np.uint8).copy(),
        external_duplicates=bool(external_duplicates))


@dataclass
class Result:
    """A finished pass: the residue BAM, the reductions of the taken
    pairs over the flat planes (coverage, flags 0/1: fill_planes), and its
    counts."""

    path: str
    taken: int = 0
    residue: int = 0
    mapped: int = 0
    chains: int = 0
    placeholders: int = 0
    coverage: object = None  # numpy, or the card's tensors (fill_planes)
    starts: object = None
    ends: object = None

    def close(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ResidueWriter:
    """The residue BAM: the header, then the declined records in order,
    with placeholders before each chain so that it keeps its index modulo
    TILE."""

    def __init__(self, header: bytes):
        fd, self.path = tempfile.mkstemp(prefix="arriba_tpu_residue_",
                                         suffix=".bam")
        self.handle = os.fdopen(fd, "wb")
        self.handle.write(header)
        self.records = 0       # records written, placeholders included
        self.placeholders = 0
        self.chains = 0

    def write(self, data, count: int, chains=()) -> None:
        """data: count whole records; chains: (byte offset, index in data,
        record index in the file) of each record in data that begins a
        chain, in order."""
        view = memoryview(data).cast("B")
        at = done = 0
        for offset, index, record in chains:
            self.handle.write(view[at:offset])
            self.records += index - done
            self.align(record)
            at, done = offset, index
        self.handle.write(view[at:])
        self.records += count - done

    def align(self, record: int) -> None:
        """Placeholders so that the next record written lands where record
        (its index in the file) sits modulo TILE; count it a chain."""
        missing = (record - self.records) % TILE
        if missing:
            self.handle.write(PLACEHOLDER * missing)
            self.records += missing
            self.placeholders += missing
        self.chains += 1

    def close(self) -> None:
        self.handle.close()


def fill_planes(planes: list, contigs: Contigs, coverage, starts,
                ends) -> None:
    """Add the pass's coverage (saturating at 0xFFFF) and OR its flags into
    the engine's planes before it scans the residue: each increment is +1,
    so the sums commute with the engine's own saturating adds. coverage,
    starts and ends cover the flat planes: numpy (the plain pass), or
    tensors (the card's, coverage saturated already as int16 bits) that go
    straight into planes the engine has not touched."""
    import torch

    for tid, plane in enumerate(planes):
        if plane is None:
            continue
        lo, hi = contigs.plane_offset[tid], contigs.plane_offset[tid + 1]
        cov, plane_starts, plane_ends = plane
        fresh = not (cov.any() or plane_starts.any() or plane_ends.any())
        if isinstance(coverage, torch.Tensor):
            if fresh:
                torch.from_numpy(cov.view(np.int16)).copy_(coverage[lo:hi])
                torch.from_numpy(plane_starts).copy_(starts[lo:hi])
                torch.from_numpy(plane_ends).copy_(ends[lo:hi])
                continue
            part = coverage[lo:hi].cpu().numpy().view(np.uint16)
            flags = starts[lo:hi].cpu().numpy(), ends[lo:hi].cpu().numpy()
        else:
            part, flags = coverage[lo:hi], (starts[lo:hi], ends[lo:hi])
        cov[:] = np.minimum(cov.astype(np.int64) + part, 0xFFFF)
        np.bitwise_or(plane_starts, flags[0], out=plane_starts)
        np.bitwise_or(plane_ends, flags[1], out=plane_ends)


# ---------------------------------------------------------------- plain pass


def _members(data: bytes):
    """(offset, size) of each BGZF member (bam_ingest.cuh bi_member_size)."""
    at = 0
    while at < len(data):
        head = data[at:at + 18]
        if (len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04"
                or head[10:16] != b"\x06\x00BC\x02\x00"):
            raise Fallback("not a BGZF member")
        size = struct.unpack_from("<H", head, 16)[0] + 1
        if size < 26 or at + size > len(data):
            raise Fallback("bad member size")
        yield at, size
        at += size


def _inflate(data: bytes) -> bytes:
    """Every member inflated with zlib, its stream ending in its last byte,
    its CRC-32 and ISIZE checked."""
    out = []
    for at, size in _members(data):
        payload = data[at + 18:at + size - 8]
        crc, isize = struct.unpack_from("<II", data, at + size - 8)
        inflater = zlib.decompressobj(-15)
        try:
            raw = inflater.decompress(payload)
        except zlib.error as error:
            raise Fallback(str(error)) from None
        if not inflater.eof or inflater.unused_data or len(raw) != isize \
                or zlib.crc32(raw) != crc:
            raise Fallback("member does not check")
        out.append(raw)
    return b"".join(out)


@dataclass
class _Record:
    at: int
    bs: int
    name: Optional[bytes]   # C-string name, None where unreadable
    valid: bool = False
    tid: int = -1
    pos: int = -1
    flag: int = 0
    n_cigar: int = 0
    l_seq: int = 0
    cigar0: int = 0
    has_sa: bool = False
    hi: Optional[int] = None
    hi_odd: bool = False


_WIDTH = {ord("c"): 1, ord("C"): 1, ord("A"): 1, ord("s"): 2, ord("S"): 2,
          ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("d"): 8}
_HI = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
       ord("i"): "<i", ord("I"): "<I"}
_ITEM = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2, ord("i"): 4,
         ord("I"): 4, ord("f"): 4}


def _record(raw: bytes, at: int) -> _Record:
    """bi_record and bi_name of bam_ingest.cuh."""
    (bs,) = struct.unpack_from("<i", raw, at)
    r = _Record(at=at, bs=bs, name=None)
    if bs < 32:
        return r
    body = raw[at + 4:at + 4 + bs]
    lrn = body[8]
    if lrn >= 1 and 32 + lrn <= bs and body[32 + lrn - 1] == 0:
        r.name = body[32:32 + lrn].split(b"\0", 1)[0]
    tid, pos = struct.unpack_from("<ii", body, 0)
    n_cigar, flag, l_seq = struct.unpack_from("<HHi", body, 12)
    if l_seq < 0 or lrn < 1:
        return r
    if bs < 32 + lrn + 4 * n_cigar + (l_seq + 1) // 2 + l_seq:
        return r
    if body[32 + lrn - 1] != 0:
        return r
    r.tid, r.pos, r.flag, r.n_cigar, r.l_seq = tid, pos, flag, n_cigar, l_seq
    offset = 32 + lrn
    if n_cigar:
        (r.cigar0,) = struct.unpack_from("<I", body, offset)
    offset += 4 * n_cigar + (l_seq + 1) // 2 + l_seq
    while offset + 3 <= bs:
        t0, t1, kind = body[offset], body[offset + 1], body[offset + 2]
        offset += 3
        if (t0, t1) == (ord("S"), ord("A")):
            r.has_sa = True
        is_hi = (t0, t1) == (ord("H"), ord("I"))
        if kind in (ord("Z"), ord("H")):
            end = body.find(b"\0", offset, bs)
            if end < 0:
                return r
            r.hi_odd |= is_hi
            offset = end + 1
            continue
        if kind == ord("B"):
            if offset + 5 > bs:
                return r
            sub = body[offset]
            (count,) = struct.unpack_from("<i", body, offset + 1)
            offset += 5
            if count < 0 or sub not in _ITEM \
                    or count > (bs - offset) // _ITEM[sub]:
                return r
            offset += _ITEM[sub] * count
            r.hi_odd |= is_hi
            continue
        width = _WIDTH.get(kind)
        if width is None or offset + width > bs:
            return r
        if is_hi:
            if kind in _HI:
                (r.hi,) = struct.unpack_from(_HI[kind], body, offset)
            else:
                r.hi_odd, r.hi = True, None
        offset += width
    r.valid = True
    return r


def _takes(r: _Record, c: Contigs) -> bool:
    """bi_record_takes."""
    if not r.valid or r.has_sa or r.hi_odd:
        return False
    if r.flag & (FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY):
        return False
    if r.flag & (FPAIRED | FPROPER) != FPAIRED | FPROPER:
        return False
    if c.external_duplicates and r.flag & FDUP:
        return False
    if not 0 <= r.tid < c.n_tids or c.viral[r.tid]:
        return False
    if c.plane_offset[r.tid + 1] == c.plane_offset[r.tid]:
        return False
    if r.pos < 0 or r.l_seq <= 0 or r.n_cigar != 1:
        return False
    return r.cigar0 & 0xF in (0, 7, 8) and r.cigar0 >> 4 > 0


def _pair(a: _Record, b: _Record, c: Contigs) -> bool:
    """bi_pair: a the earlier record."""
    if not (_takes(a, c) and _takes(b, c)) or a.tid != b.tid:
        return False
    if (1 if a.hi is None else a.hi) != (1 if b.hi is None else b.hi):
        return False
    if a.name != b.name:
        return False
    lo = min(a.pos, b.pos)
    hi = max(a.pos + (a.cigar0 >> 4), b.pos + (b.cigar0 >> 4))
    bounds = c.bounds[c.bound_offset[a.tid]:c.bound_offset[a.tid + 1]]
    first = np.searchsorted(bounds, lo - 3, side="left")
    return not (first < len(bounds) and bounds[first] < hi + 3)


def _cover(a: _Record, b: _Record, windows: int):
    """bi_cover: (start flag, (lo, hi), (lo, hi), end flag) of the pair,
    add_fragment's single-op path with mate1 = b, the later record."""
    R, half = COVERAGE_RESOLUTION, COVERAGE_RESOLUTION // 2
    pos1, pos2 = b.pos, a.pos
    end1, end2 = pos1 + (b.cigar0 >> 4), pos2 + (a.cigar0 >> 4)
    reverse = bool(b.flag & FREVERSE)
    start = (pos2 if reverse else pos1) // R
    window = min(pos1, pos2) // R
    near, far = min(end1, end2), max(end1, end2)
    far_start = pos2 if end1 < end2 else pos1
    hi1 = min((near - half) // R if near >= half else -1, windows - 1)
    lo2 = max(near // R + 1, far_start // R)
    hi2 = min((far - half) // R if far >= half else -1, windows - 1)
    end = ((end1 if reverse else end2) - 1) // R
    return (start if start < windows else -1, (window, hi1), (lo2, hi2),
            end if end < windows else -1)


def _names_equal(a: Optional[bytes], b: Optional[bytes]) -> bool:
    return a is None or b is None or a == b


def _maybe_consumed(a: _Record, b: _Record) -> bool:
    """bi_maybe_consumed: the engine's consume test could pass on a, b."""
    if not _names_equal(a.name, b.name):
        return False
    if not (a.valid and b.valid):
        return True
    bad = FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY
    need = FPAIRED | FPROPER
    if (a.flag | b.flag) & bad or a.flag & need != need \
            or b.flag & need != need:
        return False
    if a.tid < 0 or a.tid != b.tid or a.has_sa or b.has_sa:
        return False
    if a.hi_odd or b.hi_odd:
        return True
    return (1 if a.hi is None else a.hi) == (1 if b.hi is None else b.hi)


def plain_pass(path: str, contigs: Contigs, times: dict = None,
               cuts=()) -> Result:
    """The pass in plain Python and zlib on the whole file at once: what
    the card's kernels compute, for the tests. cuts: the index of each
    chunk's first record after the first where the card's chunks fell (by
    default one final chunk); a chunk's last record then pairs with
    nothing and may begin a chain, as on the card, which does not see its
    successor. times, where given, gets each step's seconds (inflate,
    frame, pairs, residue)."""
    clock = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        if times is not None:
            times[name] = now - clock[0]
        clock[0] = now

    with open(path, "rb") as fh:
        raw = _inflate(fh.read())
    step("inflate")
    header = contigs.header
    starts, p = [], len(header)
    while p < len(raw):
        if p + 4 > len(raw):
            raise Fallback("partial block_size")
        (bs,) = struct.unpack_from("<i", raw, p)
        if bs <= 0 or p + 4 + bs > len(raw):
            raise Fallback("the chain does not frame")
        starts.append(p)
        p += 4 + bs
    step("frame")
    records = [_record(raw, at) for at in starts]
    n = len(records)
    same = [i > 0 and _names_equal(records[i].name, records[i - 1].name)
            for i in range(n)]
    test = [i + 1 < n and _pair(records[i], records[i + 1], contigs)
            for i in range(n)]
    maybe = [i + 1 < n and _maybe_consumed(records[i], records[i + 1])
             for i in range(n)]

    last = {cut - 1 for cut in cuts}  # the last record of each chunk cut

    def take_at(i):
        return (0 <= i and i + 1 < n and test[i] and not same[i]
                and i not in last and i + 1 not in last
                and (i + 2 >= n or not same[i + 2]))

    def chain_start(i):
        # past a cut chunk's last record the card assumes a chain goes on
        edge = i in last
        return (not (i > 0 and maybe[i - 1]) and (edge or maybe[i])
                and (edge or i + 1 in last or (i + 1 < n and maybe[i + 1])))

    windows = contigs.windows
    coverage = np.zeros(windows, np.int64)
    flag_starts = np.zeros(windows, np.uint8)
    flag_ends = np.zeros(windows, np.uint8)
    writer = ResidueWriter(header)
    result = Result(path=writer.path)
    try:
        kept, chains = [], []
        size = 0
        for i, r in enumerate(records):
            if take_at(i):
                a, b = r, records[i + 1]
                offset = int(contigs.plane_offset[a.tid])
                w = int(contigs.plane_offset[a.tid + 1]) - offset
                start, (lo1, hi1), (lo2, hi2), end = _cover(a, b, w)
                if start >= 0:
                    flag_starts[offset + start] = 1
                coverage[offset + lo1:offset + hi1 + 1] += 1
                coverage[offset + lo2:offset + hi2 + 1] += 1
                if end >= 0:
                    flag_ends[offset + end] = 1
                result.taken += 2
                result.mapped += 2 * int(contigs.interesting[a.tid])
                continue
            if take_at(i - 1):
                continue
            if chain_start(i):
                chains.append((size, len(kept), i))
            kept.append(raw[r.at:r.at + 4 + r.bs])
            size += 4 + r.bs
        step("pairs")
        writer.write(b"".join(kept), len(kept), chains)
        result.residue = len(kept)
    finally:
        writer.close()
    step("residue")
    result.placeholders, result.chains = writer.placeholders, writer.chains
    result.coverage = coverage
    result.starts, result.ends = flag_starts, flag_ends
    return result


# ----------------------------------------------------------------- card pass


class _Buffers:
    """The card pass's device and pinned buffers, sized for one chunk
    (two where a chunk's bytes are read or carried while another is in
    flight)."""

    def __init__(self, contigs: Contigs, device):
        import torch

        dev = self.device = device
        pin = device.type == "cuda"
        u8 = dict(dtype=torch.uint8, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        slack = 1 << 16
        self.out_bytes = CHUNK_OUT + MAX_CARRY + slack
        self.capacity = cap = self.out_bytes // 36 + 2

        def up(array):
            return trace.upload(np.ascontiguousarray(array), dev)

        self.contigs = (up(contigs.bounds if len(contigs.bounds)
                           else np.zeros(1, np.int64)),
                        up(contigs.bound_offset), up(contigs.plane_offset),
                        up(contigs.interesting), up(contigs.viral),
                        contigs.n_tids, int(contigs.external_duplicates))
        windows = max(contigs.windows, 1)
        self.cov = torch.zeros(windows, **i32)
        self.cov_starts = torch.zeros(windows, **u8)
        self.cov_ends = torch.zeros(windows, **u8)
        self.pinned = [torch.empty(READ_BYTES, dtype=torch.uint8,
                                   pin_memory=pin) for _ in range(2)]
        self.meta_pinned = [torch.empty(5 * MAX_MEMBERS, dtype=torch.int64,
                                        pin_memory=pin) for _ in range(2)]
        self.comp = [torch.empty(READ_BYTES, **u8) for _ in range(2)]
        self.meta = [torch.empty(5 * MAX_MEMBERS, **i64) for _ in range(2)]
        self.out = [torch.empty(self.out_bytes, **u8) for _ in range(2)]
        self.uploaded = [None, None]
        self.res = torch.empty(self.out_bytes, **u8)
        self.res_pinned = torch.empty(RESIDUE_PIECE, dtype=torch.uint8,
                                      pin_memory=pin)
        self.starts = torch.empty(cap, **i64)
        self.test = torch.empty(cap, **u8)
        self.same = torch.empty(cap, **u8)
        self.kept_size = torch.empty(cap, **i64)
        self.size_sum = torch.empty(cap, **i64)
        self.kept = torch.empty(cap, **i32)
        self.kept_sum = torch.empty(cap, **i32)
        self.maybe = torch.empty(cap, **u8)
        self.chain_start = torch.empty(cap, **u8)
        self.res_offset = torch.empty(cap, **i64)
        self.res_record = torch.empty(cap, **i64)
        self.res_chain = torch.empty(cap, **u8)
        self.status = torch.empty(MAX_MEMBERS, **i32)
        self.seg = torch.empty(4 * MAX_MEMBERS, **i64)
        self.walked = torch.empty(MAX_MEMBERS, **i32)
        self.stats = torch.empty(16, **i64)
        from .. import kernels

        self.ctx = [torch.zeros(kernels.CTX_BYTES, **u8) for _ in range(2)]
        # the key before the first record: name_len -2, none
        self.ctx[0][:4] = torch.tensor([254, 255, 255, 255], **u8)


@dataclass
class _Chunk:
    """Whole members indexed in pinned[b]: their offsets, sizes and
    ISIZEs, the bytes they span, the bytes read, and whether the file
    ended."""

    b: int
    offsets: np.ndarray
    sizes: np.ndarray
    isizes: np.ndarray
    consumed: int
    got: int
    eof: bool

    @property
    def final(self) -> bool:
        return self.eof and self.consumed == self.got


def _read_chunk(fh, buf: _Buffers, index, b: int, left: int) -> _Chunk:
    """Fill pinned[b] after its last upload (its first left bytes already
    hold the unindexed member the chunk before left), and index it."""
    import ctypes

    if buf.uploaded[b] is not None:
        buf.uploaded[b].synchronize()
    host = memoryview(buf.pinned[b].numpy())
    got, eof = left, False
    while got < READ_BYTES:
        n = fh.readinto(host[got:READ_BYTES])
        if not n:
            eof = True
            break
        got += n
    offsets = np.empty(MAX_MEMBERS, np.int64)
    sizes = np.empty(MAX_MEMBERS, np.int64)
    isizes = np.empty(MAX_MEMBERS, np.int64)
    consumed = ctypes.c_longlong(0)
    m = index(buf.pinned[b].data_ptr(), got, MAX_MEMBERS, CHUNK_OUT,
              offsets.ctypes.data, sizes.ctypes.data, isizes.ctypes.data,
              ctypes.byref(consumed))
    if m < 0 or (m == 0 and got > 0):
        raise Fallback("not a BGZF file the pass reads")
    return _Chunk(b, offsets[:m], sizes[:m], isizes[:m], consumed.value, got,
                  eof)


def _indexer():
    """bam_ingest.cuh's bi_index, from the kernel library's host entry."""
    import ctypes

    from ..kernels.build import host_function

    return host_function(
        "bam_ingest", "arriba_bgzf_index",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int)


def card_pass(path: str, contigs: Contigs, device=None) -> Result:
    """The pass on the card (K6), chunk by chunk; see the module note.
    device: the card (the default); the tests give the CPU, with the
    kernels' launches in their g++ build."""
    import torch

    from .. import kernels

    index = _indexer()
    header = contigs.header
    buf = _Buffers(contigs, device or torch.device("cuda"))
    dev = buf.device
    writer = ResidueWriter(header)
    result = Result(path=writer.path)
    carry = 0       # bytes of a partial record carried to the next chunk
    tail_at = 0     # where they start in out[1 - b]
    first = len(header)  # the first record start of the chunk
    base = 0        # records before the chunk
    ctx_in = 0
    judged = None   # whether the first JUDGE_RECORDS records paid
    try:
        with open(path, "rb", buffering=0) as fh:
            chunk = _read_chunk(fh, buf, index, 0, 0)
            while chunk is not None:
                b, m = chunk.b, len(chunk.isizes)
                # the output: the carried partial record, then each member's
                # ISIZE bytes; a range a member, the first from `first`
                out_offsets = carry + np.concatenate(
                    ([0], np.cumsum(chunk.isizes)[:-1])).astype(np.int64)
                out_end = carry + int(chunk.isizes.sum())
                if first > out_end:
                    raise Fallback("the header outruns the first chunk")
                lo = np.maximum(out_offsets[:m], first)
                hi = out_offsets[:m] + chunk.isizes
                if m:
                    lo[0] = first
                    hi[0] = max(hi[0], first)
                keep = hi > lo
                segments = int(keep.sum())
                host = buf.meta_pinned[b].numpy()
                host[:m] = chunk.offsets
                host[m:2 * m] = chunk.sizes
                host[2 * m:3 * m] = out_offsets[:m]
                host[3 * m:3 * m + segments] = lo[keep]
                host[3 * m + segments:3 * m + 2 * segments] = hi[keep]
                used = 3 * m + 2 * segments
                trace.upload(buf.pinned[b][:chunk.consumed], dev,
                             out=buf.comp[b][:chunk.consumed])
                trace.upload(buf.meta_pinned[b][:used], dev,
                             out=buf.meta[b][:used])
                if dev.type == "cuda":
                    buf.uploaded[b] = torch.cuda.Event()
                    buf.uploaded[b].record()
                meta = buf.meta[b]
                buf.stats.zero_()
                if carry:
                    buf.out[b][:carry].copy_(
                        buf.out[1 - b][tail_at:tail_at + carry])
                if m:
                    kernels.launch_bgzf_inflate(
                        buf.comp[b], meta[:m], meta[m:2 * m],
                        meta[2 * m:3 * m], buf.out[b], buf.status, buf.stats)
                if segments:
                    kernels.launch_bam_frame(
                        buf.out[b], out_end, meta[3 * m:3 * m + segments],
                        meta[3 * m + segments:used], contigs.n_tids, buf.seg,
                        buf.walked, buf.starts, buf.stats)
                    kernels.launch_bam_pairs(
                        buf.out[b], buf.starts, buf.stats, chunk.final,
                        buf.ctx[ctx_in], buf.ctx[1 - ctx_in], buf.contigs,
                        buf.test, buf.maybe, buf.same, buf.cov,
                        buf.cov_starts, buf.cov_ends, buf.kept_size,
                        buf.kept, buf.chain_start)
                    torch.cumsum(buf.kept_size, 0, out=buf.size_sum)
                    torch.cumsum(buf.kept, 0, dtype=torch.int32,
                                 out=buf.kept_sum)
                    kernels.launch_bam_residue(
                        buf.out[b], buf.starts, buf.stats, base,
                        buf.kept_size, buf.size_sum, buf.kept_sum,
                        buf.chain_start, buf.res, buf.res_offset,
                        buf.res_record, buf.res_chain)
                # the next chunk's bytes come off the file while the card
                # works on this one
                following = None
                if not chunk.final:
                    left = chunk.got - chunk.consumed
                    if buf.uploaded[1 - b] is not None:
                        buf.uploaded[1 - b].synchronize()
                    if left:
                        buf.pinned[1 - b][:left].copy_(
                            buf.pinned[b][chunk.consumed:chunk.got])
                    following = _read_chunk(fh, buf, index, 1 - b, left)
                figures = [int(v) for v in torch.cat((
                    buf.stats, buf.size_sum[-1:],
                    buf.kept_sum[-1:].long())).cpu()]
                n_rec, tail, chain, failed = figures[:4]
                if failed:
                    raise Fallback("a member failed its checks")
                if not segments:
                    tail = min(first, out_end)
                elif chain == 2:
                    raise Fallback("a block_size <= 0 on the chain")
                carry = out_end - tail
                if chunk.final and carry:
                    raise Fallback("the last record is truncated")
                if carry > MAX_CARRY:
                    raise Fallback("a record longer than the carry")
                result.taken += figures[4]
                result.mapped += figures[5]
                if n_rec:
                    _write_chunk(writer, figures, buf)
                    result.residue += figures[17]
                    ctx_in = 1 - ctx_in
                base += n_rec
                if judged is None and base >= JUDGE_RECORDS:
                    judged = result.taken >= MIN_TAKEN * base
                    if not judged:
                        raise Unpaired(f"{result.taken} of the first {base} "
                                       f"records taken")
                tail_at = tail
                first = 0
                chunk = following
        cov16 = torch.empty_like(buf.cov, dtype=torch.int16)
        kernels.launch_bam_coverage_finish(buf.cov, cov16)
        result.coverage, result.starts, result.ends = (
            cov16, buf.cov_starts, buf.cov_ends)
    except BaseException:
        writer.close()
        result.close()
        raise
    writer.close()
    result.placeholders, result.chains = writer.placeholders, writer.chains
    return result


def _write_chunk(writer, figures, buf):
    """A chunk's residue to the writer through the pinned buffer, a piece
    at a time, with placeholders before its chain starts (stats[7] of
    them)."""
    import torch

    size, count = figures[16], figures[17]
    chains = []
    if figures[7]:
        where = np.flatnonzero(buf.res_chain[:count].cpu().numpy())
        picked = torch.from_numpy(where).to(buf.device)
        offsets = buf.res_offset.index_select(0, picked).cpu().numpy()
        records = buf.res_record.index_select(0, picked).cpu().numpy()
        chains = list(zip(offsets.tolist(), where.tolist(), records.tolist()))
    at = done = 0
    for offset, index, record in chains + [(size, count, None)]:
        while at < offset:
            piece = min(offset - at, len(buf.res_pinned))
            buf.res_pinned[:piece].copy_(buf.res[at:at + piece])
            writer.handle.write(buf.res_pinned[:piece].numpy())
            at += piece
        writer.records += index - done
        done = index
        if record is not None:
            writer.align(record)


# ------------------------------------------------------------------- entry


def backend():
    """The pass to run, or None: the card's where the offload device is a
    card that is there."""
    from .. import device

    if device.mode() != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    return card_pass


def run(path: str, header: bytes, boundaries: List[bytes], planes: list,
        interesting: bytes, viral: bytes,
        external_duplicates: bool) -> Optional[Result]:
    """The pass over path, its reductions already in planes, or None where
    it does not run (no card, or a coordinate-sorted file) or drops out
    (Fallback: input it cannot read exactly, the planes then untouched).
    A build, launch or device error is raised: the card that is there
    must run, or the run fails."""
    chosen = backend()
    if chosen is None:
        return None
    if sorted_by_coordinate(header):
        trace.count("ingest.card_skipped")
        return None
    contigs = contigs_for(header, boundaries, planes, interesting, viral,
                          external_duplicates)
    with trace.span("ingest.card"):
        try:
            result = chosen(path, contigs)
        except Fallback:
            trace.count("ingest.card_fallbacks")
            return None
        except Unpaired:
            trace.count("ingest.card_skipped")
            return None
        fill_planes(planes, contigs, result.coverage, result.starts,
                    result.ends)
    trace.count("ingest.card_records", result.taken)
    trace.count("ingest.residue_records", result.residue)
    return result
