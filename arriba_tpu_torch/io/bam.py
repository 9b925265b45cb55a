"""SAM/BAM record decoding (and SAM writing for test fixtures).

This replaces the reference's use of htslib (read_chimeric_alignments.cpp
opens SAM/BAM/CRAM via sam_read1). BAM is BGZF-framed little-endian binary;
BGZF blocks are standard gzip members, decoded with zlib. CRAM is not
supported (gate: raise with a clear message).

The decoder exposes htslib-shaped accessors (flag/tid/pos/cigar/seq/tags) so
ingest code reads like the reference's record loop while producing our
structures.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..constants import (CIGAR_CONSUMES_QUERY, CIGAR_CONSUMES_REF, CIGAR_OPS,
                         cigar_op, cigar_oplen)
from .compressed import decompress_gzip_multi

# BAM flags (sam.h)
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"


@dataclass
class BamRecord:
    qname: str = ""
    flag: int = 0
    tid: int = -1
    pos: int = 0  # 0-based leftmost
    mapq: int = 0
    cigar: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint32))
    mtid: int = -1
    mpos: int = 0
    tlen: int = 0
    seq: str = ""
    qual: str = ""
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def l_qseq(self) -> int:
        return len(self.seq)

    @property
    def n_cigar(self) -> int:
        return len(self.cigar)

    def endpos(self) -> int:
        """htslib bam_endpos: one past the last reference base consumed; pos+1
        if the alignment consumes no reference. Memoized: records are not
        mutated after parsing (only the flag field is ever rewritten)."""
        cached = getattr(self, "_endpos", None)
        if cached is not None:
            return cached
        length = 0
        for word in self.cigar.tolist():
            if CIGAR_CONSUMES_REF & (1 << (word & 0xF)):
                length += word >> 4
        result = self.pos + length if length > 0 else self.pos + 1
        object.__setattr__(self, "_endpos", result)
        return result

    def cigar2qlen(self, n_ops: int | None = None) -> int:
        """htslib bam_cigar2qlen over the first n_ops operations."""
        words = self.cigar if n_ops is None else self.cigar[:n_ops]
        length = 0
        for word in words:
            op = cigar_op(int(word))
            if CIGAR_CONSUMES_QUERY & (1 << op):
                length += cigar_oplen(int(word))
        return length

    def cigar2rlen(self, n_ops: int | None = None) -> int:
        """htslib bam_cigar2rlen over the first n_ops operations."""
        words = self.cigar if n_ops is None else self.cigar[:n_ops]
        length = 0
        for word in words:
            op = cigar_op(int(word))
            if CIGAR_CONSUMES_REF & (1 << op):
                length += cigar_oplen(int(word))
        return length

    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)


@dataclass
class SamHeader:
    target_names: List[str] = field(default_factory=list)
    target_lengths: List[int] = field(default_factory=list)
    text: str = ""
    raw: bytes = b""  # a BAM's header bytes, "BAM\1" through the last target

    @property
    def n_targets(self) -> int:
        return len(self.target_names)


_CIGAR_TOKEN = re.compile(r"(\d+)([MIDNSHP=XB])")
_CIGAR_OP_CODE = {op: i for i, op in enumerate("MIDNSHP=XB")}


def cigar_from_string(cigar_str: str) -> np.ndarray:
    if cigar_str == "*" or not cigar_str:
        return np.empty(0, np.uint32)
    code = _CIGAR_OP_CODE
    words = [(int(length) << 4) | code[op]
             for length, op in _CIGAR_TOKEN.findall(cigar_str)]
    if any(w > 0xFFFFFFFF for w in words):
        # op length would truncate in the 28-bit packed field; reject the
        # record like the native parser (and htslib) instead of wrapping
        raise ValueError(f"CIGAR op length too large: {cigar_str[:60]}")
    return np.array(words, np.uint32)


def cigar_to_string(cigar: np.ndarray) -> str:
    if len(cigar) == 0:
        return "*"
    return "".join(f"{cigar_oplen(int(w))}{CIGAR_OPS[cigar_op(int(w))]}" for w in cigar)



def read_sam_text(path: str) -> Tuple[SamHeader, Iterator[BamRecord]]:
    """Parse a SAM text file (optionally gzipped); returns the header and a
    lazy record iterator."""
    header = SamHeader()
    with open(path, "rb") as probe:
        gzipped = probe.read(2) == b"\x1f\x8b"
    if gzipped:
        import gzip
        fh = gzip.open(path, "rt")
    else:
        fh = open(path, "rt")
    body_lines: List[str] = []
    for line in fh:
        if line.startswith("@"):
            header.text += line
            if line.startswith("@SQ"):
                name, length = "", 0
                for part in line.rstrip("\n").split("\t")[1:]:
                    if part.startswith("SN:"):
                        name = part[3:]
                    elif part.startswith("LN:"):
                        length = int(part[3:])
                header.target_names.append(name)
                header.target_lengths.append(length)
        else:
            body_lines.append(line)
            break
    name_to_tid = {n: i for i, n in enumerate(header.target_names)}

    def records() -> Iterator[BamRecord]:
        import itertools
        import sys
        warned = 0
        for line in itertools.chain(body_lines, fh):
            try:
                record = parse_sam_record(line, name_to_tid)
            except (ValueError, OverflowError, IndexError):
                # unparseable line: skip with a warning, like the native
                # scan's malformed-record accounting (the reference aborts
                # here; the rest of the pipeline warns and continues)
                warned += 1
                if warned <= 5:
                    print(f"WARNING: skipping unparseable SAM record: "
                          f"{line[:80]!r}", file=sys.stderr)
                continue
            yield record
        fh.close()

    return header, records()


def parse_sam_record(line: str, name_to_tid: Dict[str, int]) -> BamRecord:
    """Parse one SAM body line into a BamRecord."""
    parts = line.rstrip("\n").split("\t")
    rec = BamRecord(
        qname=parts[0], flag=int(parts[1]),
        tid=name_to_tid.get(parts[2], -1), pos=int(parts[3]) - 1,
        mapq=int(parts[4]), cigar=cigar_from_string(parts[5]),
        mtid=(name_to_tid.get(parts[6], -1) if parts[6] != "=" else name_to_tid.get(parts[2], -1)),
        mpos=int(parts[7]) - 1, tlen=int(parts[8]),
        seq=parts[9] if parts[9] != "*" else "",
        qual=parts[10] if parts[10] != "*" else "")
    tags = rec.tags
    for tag_field in parts[11:]:
        # TAG:TYPE:VALUE (inlined _parse_sam_tag for the ingest hot path)
        type_char = tag_field[3]
        if type_char == "i":
            tags[tag_field[:2]] = int(tag_field[5:])
        elif type_char == "f":
            tags[tag_field[:2]] = float(tag_field[5:])
        else:
            tags[tag_field[:2]] = tag_field[5:]
    return rec


_TAG_STRUCT = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}
_TAG_SIZE = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _parse_bam_tags(buf: memoryview) -> Dict[str, object]:
    tags: Dict[str, object] = {}
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        name = bytes(buf[pos:pos + 2]).decode("ascii")
        typ = chr(buf[pos + 2])
        pos += 3
        if typ in _TAG_STRUCT:
            size = _TAG_SIZE[typ]
            (value,) = struct.unpack_from("<" + _TAG_STRUCT[typ], buf, pos)
            pos += size
        elif typ == "A":
            value = chr(buf[pos])
            pos += 1
        elif typ in ("Z", "H"):
            end = pos
            while end < n and buf[end] != 0:
                end += 1
            value = bytes(buf[pos:end]).decode("ascii")
            pos = end + 1
        elif typ == "B":
            sub = chr(buf[pos])
            (count,) = struct.unpack_from("<I", buf, pos + 1)
            size = _TAG_SIZE[sub]
            value = list(struct.unpack_from(f"<{count}{_TAG_STRUCT[sub]}", buf, pos + 5))
            pos += 5 + count * size
        else:
            break  # unknown tag type: stop parsing
        tags[name] = value
    return tags


# decode table: packed 4-bit pairs -> two ASCII chars
_SEQ_PAIR_TABLE = [
    (SEQ_NT16_STR[hi] + SEQ_NT16_STR[lo]).encode("ascii")
    for hi in range(16) for lo in range(16)
]


def read_bam_header(path: str) -> SamHeader:
    """Decompress only as much of a BAM as the header needs (the native
    loader consumes the records; full-file decode would be wasted work)."""
    import zlib

    decompressor = zlib.decompressobj(wbits=31)
    data = b""
    needed = 12

    with open(path, "rb") as fh:
        def ensure(n: int) -> bool:
            nonlocal data, decompressor
            while len(data) < n:
                chunk = fh.read(1 << 16)
                if not chunk:
                    return False
                buffered = chunk
                while buffered:
                    try:
                        data += decompressor.decompress(buffered)
                    except zlib.error as exc:
                        raise IOError(
                            f"corrupt BGZF stream in '{path}': {exc}") from exc
                    if decompressor.eof:  # next BGZF member
                        buffered = decompressor.unused_data
                        decompressor = zlib.decompressobj(wbits=31)
                    else:
                        buffered = b""
            return True

        if not ensure(needed) or data[:4] != b"BAM":
            raise ValueError(f"not a BAM file: {path}")
        (l_text,) = struct.unpack_from("<i", data, 4)
        ensure(8 + l_text + 4)
        header = SamHeader(text=data[8:8 + l_text].decode("ascii", "replace"))
        pos = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", data, pos)
        pos += 4
        for _ in range(n_ref):
            ensure(pos + 8)
            (l_name,) = struct.unpack_from("<i", data, pos)
            ensure(pos + 8 + l_name)
            name = data[pos + 4:pos + 4 + l_name - 1].decode("ascii")
            (l_ref,) = struct.unpack_from("<i", data, pos + 4 + l_name)
            header.target_names.append(name)
            header.target_lengths.append(l_ref)
            pos += 8 + l_name
    header.raw = bytes(data[:pos])
    return header


def read_bam(path: str) -> Tuple[SamHeader, Iterator[BamRecord]]:
    """Decode a BAM file (BGZF-compressed binary). Whole-file decode into
    memory — matching the reference's single linear pass."""
    with open(path, "rb") as fh:
        raw = fh.read()
    data = decompress_gzip_multi(raw)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"not a BAM file: {path}")
    view = memoryview(data)
    (l_text,) = struct.unpack_from("<i", view, 4)
    pos = 8 + l_text
    header = SamHeader(text=bytes(view[8:8 + l_text]).decode("ascii", "replace"))
    (n_ref,) = struct.unpack_from("<i", view, pos)
    pos += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", view, pos)
        name = bytes(view[pos + 4:pos + 4 + l_name - 1]).decode("ascii")
        (l_ref,) = struct.unpack_from("<i", view, pos + 4 + l_name)
        header.target_names.append(name)
        header.target_lengths.append(l_ref)
        pos += 8 + l_name

    def records(start: int) -> Iterator[BamRecord]:
        p = start
        total = len(data)
        unpack_core = struct.Struct("<iiiBBHHHiiii").unpack_from
        while p + 4 <= total:
            if p + 36 > total:
                raise ValueError("truncated BAM record (unexpected end of "
                                 "file inside a record header)")
            (block_size, refid, rpos, l_read_name, mapq, _bin, n_cigar, flag,
             l_seq, next_refid, next_pos, tlen) = unpack_core(view, p)
            rec_end = p + 4 + block_size
            if block_size < 32 or rec_end > total:
                raise ValueError("truncated BAM record (unexpected end of "
                                 "file inside a record body)")
            q = p + 36
            qname = bytes(view[q:q + l_read_name - 1]).decode("ascii")
            q += l_read_name
            cigar = np.frombuffer(data, np.uint32, n_cigar, q).copy()
            q += 4 * n_cigar
            n_seq_bytes = (l_seq + 1) // 2
            if l_seq:
                packed = np.frombuffer(data, np.uint8, n_seq_bytes, q)
                pairs = b"".join([_SEQ_PAIR_TABLE[b] for b in packed])
                seq = pairs[:l_seq].decode("ascii")
            else:
                seq = ""
            q += n_seq_bytes
            qual = ""  # qualities are unused by the pipeline; skip decode
            q += l_seq
            tags = _parse_bam_tags(view[q:rec_end])
            # long-CIGAR convention (SAM spec 4.2.2): records with >65535
            # ops store a placeholder kS/mN cigar and the real one in a
            # CG:B,I tag; htslib expands it transparently for the reference
            if (n_cigar == 2 and "CG" in tags
                    and (int(cigar[0]) & 0xF) == 4        # soft clip
                    and (int(cigar[0]) >> 4) == l_seq
                    and (int(cigar[1]) & 0xF) == 3):      # ref skip
                real = tags.pop("CG")
                if isinstance(real, list) and real:
                    cigar = np.asarray(real, np.uint32)
            yield BamRecord(qname=qname, flag=flag, tid=refid, pos=rpos,
                            mapq=mapq, cigar=cigar, mtid=next_refid,
                            mpos=next_pos, tlen=tlen, seq=seq, qual=qual,
                            tags=tags)
            p = rec_end

    return header, records(pos)


def open_alignment_file(path: str, reference_by_name=None
                        ) -> Tuple[SamHeader, Iterator[BamRecord]]:
    """Open SAM, BAM, or CRAM by magic byte sniffing. CRAM decoding uses
    `reference_by_name` (contig name -> uint8 sequence array) for sequence
    reconstruction; without it, reference bases decode as N."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:2] == b"\x1f\x8b":
        # gzip wraps either BAM or plain SAM text: sniff the decompressed
        # magic the way htslib's format detection does (undecodable gzip
        # routes to the BAM reader, whose corruption handling raises)
        import gzip
        import zlib
        try:
            with gzip.open(path, "rb") as gz:
                inner = gz.read(4)
        except (OSError, EOFError, zlib.error):
            inner = b"BAM\x01"
        if inner == b"BAM\x01":
            return read_bam(path)
        return read_sam_text(path)
    if magic == b"CRAM":
        from .cram import read_cram
        return read_cram(path, reference_by_name)
    return read_sam_text(path)


# ---- SAM writing (test fixtures + supporting-read extraction) ----------------

def write_sam(path: str, header: SamHeader, records: List[BamRecord]) -> None:
    with open(path, "wt") as fh:
        fh.write("@HD\tVN:1.6\tSO:unsorted\n")
        for name, length in zip(header.target_names, header.target_lengths):
            fh.write(f"@SQ\tSN:{name}\tLN:{length}\n")
        for rec in records:
            fields = [
                rec.qname, str(rec.flag),
                header.target_names[rec.tid] if rec.tid >= 0 else "*",
                str(rec.pos + 1), str(rec.mapq), cigar_to_string(rec.cigar),
                header.target_names[rec.mtid] if rec.mtid >= 0 else "*",
                str(rec.mpos + 1), str(rec.tlen),
                rec.seq or "*", rec.qual or "*",
            ]
            for name, value in rec.tags.items():
                if isinstance(value, bool):
                    fields.append(f"{name}:i:{int(value)}")
                elif isinstance(value, int):
                    fields.append(f"{name}:i:{value}")
                elif isinstance(value, float):
                    fields.append(f"{name}:f:{value}")
                elif isinstance(value, (list, tuple, np.ndarray)):
                    # B-array tags (SAM spec 1.5): subtype + comma list
                    items = [int(v) if float(v).is_integer() else float(v)
                             for v in value]
                    subtype = "i" if all(isinstance(v, int)
                                         for v in items) else "f"
                    fields.append(f"{name}:B:{subtype}," +
                                  ",".join(str(v) for v in items))
                else:
                    fields.append(f"{name}:Z:{value}")
            fh.write("\t".join(fields) + "\n")
