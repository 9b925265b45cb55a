"""BGZF BAM samples built byte by byte, importing nothing of the JAX
package (the card's tests use them too): records with any aux types,
members cut anywhere, at any zlib level, and a sample of every kind of
record the card pass over a BAM (ingest/card.py) must take or leave; and
in-process CLI runs of the port that keep what must not change when the
pass takes part."""

import contextlib
import io
import re
import struct
import zlib

import numpy as np

COUNTER = re.compile(r"\((?:remaining|total|marked)=\d+\)")

NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
EOF_MEMBER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def cigar(text: str) -> list:
    return [int(n) << 4 | OPS[op] for n, op in re.findall(r"(\d+)(\D)", text)]


def query_length(text: str) -> int:
    return sum(int(n) for n, op in re.findall(r"(\d+)(\D)", text)
               if op in "MIS=X")


def tag(name: str, kind: str, value) -> bytes:
    """One aux field: kind a BAM type letter, or "B" + subtype."""
    if kind == "Z":
        return name.encode() + b"Z" + value.encode() + b"\0"
    if kind.startswith("B"):
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}[kind[1]]
        return (name.encode() + b"B" + kind[1].encode()
                + struct.pack(f"<i{len(value)}{fmt}", len(value), *value))
    fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
           "f": "f", "A": "B"}[kind]
    return name.encode() + kind.encode() + struct.pack("<" + fmt, value)


def record(name: str, flag: int, tid: int, pos: int, ops: list, seq: str,
           tags=(), mtid=None, mpos=0, tlen=0) -> bytes:
    """block_size and body of one BAM record."""
    qname = name.encode() + b"\0"
    seq4 = bytearray((len(seq) + 1) // 2)
    for i, base in enumerate(seq):
        seq4[i >> 1] |= NT16.get(base, 15) << ((~i & 1) << 2)
    body = struct.pack("<iiBBHHHiiii", tid, pos, len(qname), 60, 4680,
                       len(ops), flag, len(seq),
                       tid if mtid is None else mtid, mpos, tlen)
    body += qname + b"".join(struct.pack("<I", w) for w in ops)
    body += bytes(seq4) + bytes([30] * len(seq)) + b"".join(tags)
    return struct.pack("<i", len(body)) + body


def header_bytes(names, lengths, hd: str = "") -> bytes:
    """hd: the @HD line, if any (newline included)."""
    text = hd + "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                        for n, l in zip(names, lengths))
    out = b"BAM\x01" + struct.pack("<i", len(text) + 1) + text.encode() + b"\0"
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lengths):
        out += struct.pack("<i", len(n) + 1) + n.encode() + b"\0"
        out += struct.pack("<i", l)
    return out


def member(raw: bytes, level: int = 1, strategy: int = zlib.Z_DEFAULT_STRATEGY
           ) -> bytes:
    """One BGZF member of raw (at most 65,536 bytes)."""
    deflater = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    data = deflater.compress(raw) + deflater.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(data) + 25) + data
            + struct.pack("<II", zlib.crc32(raw), len(raw)))


def bgzf(raw: bytes, cuts=(), level: int = 1, size: int = 65280) -> bytes:
    """raw as BGZF members cut at each offset of cuts and at most size
    bytes apart, then the EOF member."""
    edges = sorted(set([0, len(raw)] + [c for c in cuts if 0 < c < len(raw)]))
    out = bytearray()
    for lo, hi in zip(edges, edges[1:]):
        for at in range(lo, hi, size):
            out += member(raw[at:min(at + size, hi)], level)
    return bytes(out + EOF_MEMBER)


def record_starts(raw: bytes) -> list:
    """The offset of each record of a raw BAM stream."""
    (l_text,) = struct.unpack_from("<i", raw, 4)
    at = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, at)
    at += 4
    for _ in range(n_ref):
        at += 8 + struct.unpack_from("<i", raw, at)[0]
    starts = []
    while at < len(raw):
        starts.append(at)
        at += 4 + struct.unpack_from("<i", raw, at)[0]
    return starts


class Sample:
    """A genome of random bases, genes and records, written as the CLI's
    inputs: genome.fa, genes.gtf, blacklist.tsv and aligned.bam."""

    def __init__(self, tmp_path, contigs: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.tmp_path = tmp_path
        self.names = list(contigs)
        self.genome = {name: np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, length)] for name, length in contigs.items()}
        self.gtf = []
        self.records = []
        self.hd = ""  # the header's @HD line

    def seq(self, contig: str, pos: int, length: int) -> str:
        return self.genome[contig][pos:pos + length].tobytes().decode()

    def gene(self, contig, start, end, strand, gene_id, name, exons):
        attrs = (f'gene_id "{gene_id}"; gene_name "{name}"; '
                 f'transcript_id "{gene_id}.1";')
        for lo, hi in exons or [(start, end)]:
            for feature in ("exon", "CDS"):
                self.gtf.append(f"{contig}\ttest\t{feature}\t{lo + 1}\t"
                                f"{hi + 1}\t.\t{strand}\t.\t{attrs}")

    def split(self, name, contig1, mate1_pos, split_pos, matched, clip,
              contig2, supp_pos, hi=1):
        """Mate 1, the split mate (clipped, SA tag), the supplementary."""
        t1, t2 = self.names.index(contig1), self.names.index(contig2)
        hi_tag = tag("HI", "i", hi)
        self.records.append(record(
            name, 99, t1, mate1_pos, cigar("50M"),
            self.seq(contig1, mate1_pos, 50), [hi_tag], t1, split_pos, 150))
        self.records.append(record(
            name, 147, t1, split_pos, cigar(f"{matched}M{clip}S"),
            self.seq(contig1, split_pos, matched)
            + self.seq(contig2, supp_pos, clip),
            [hi_tag, tag("SA", "Z", f"{contig2},{supp_pos + 1},-,"
                                    f"{matched}S{clip}M,60,0;")],
            t1, mate1_pos, -150))
        self.records.append(record(
            name, 2195, t2, supp_pos, cigar(f"{matched}H{clip}M"),
            self.seq(contig2, supp_pos, clip), [hi_tag], t1, mate1_pos))

    def discordant(self, name, contig1, pos1, contig2, pos2):
        t1, t2 = self.names.index(contig1), self.names.index(contig2)
        self.records.append(record(name, 1 | 64 | 32, t1, pos1, cigar("50M"),
                                   self.seq(contig1, pos1, 50),
                                   [tag("HI", "i", 1)], t2, pos2))
        self.records.append(record(name, 1 | 128 | 16, t2, pos2, cigar("50M"),
                                   self.seq(contig2, pos2, 50),
                                   [tag("HI", "i", 1)], t1, pos1))

    def pair(self, name, tid, pos, ops1="50M", ops2="50M", gap=100,
             tags1=None, tags2=None, flags=(99, 147)):
        contig = self.names[tid]
        hi = [tag("HI", "i", 1)]
        self.records.append(record(
            name, flags[0], tid, pos, cigar(ops1),
            self.seq(contig, pos, query_length(ops1)),
            hi if tags1 is None else tags1, tid, pos + gap))
        self.records.append(record(
            name, flags[1], tid, pos + gap, cigar(ops2),
            self.seq(contig, pos + gap, query_length(ops2)),
            hi if tags2 is None else tags2, tid, pos))

    def raw(self) -> bytes:
        return header_bytes(self.names, [len(self.genome[n])
                                         for n in self.names], self.hd) \
            + b"".join(self.records)

    def write(self, cuts=(), level=1, size=65280) -> list:
        """The files; returns the CLI's arguments (without -o / -O)."""
        with open(self.tmp_path / "genome.fa", "w") as fh:
            for name in self.names:
                data = self.genome[name].tobytes().decode()
                fh.write(f">{name}\n")
                for at in range(0, len(data), 80):
                    fh.write(data[at:at + 80] + "\n")
        (self.tmp_path / "genes.gtf").write_text("\n".join(self.gtf) + "\n")
        (self.tmp_path / "blacklist.tsv").write_text("1:19000\t1:19500\n")
        (self.tmp_path / "aligned.bam").write_bytes(
            bgzf(self.raw(), cuts, level, size))
        return ["-x", str(self.tmp_path / "aligned.bam"),
                "-g", str(self.tmp_path / "genes.gtf"),
                "-a", str(self.tmp_path / "genome.fa"),
                "-b", str(self.tmp_path / "blacklist.tsv"),
                "-i", "1 2 AC_*", "-v", "AC_*", "-s", "no"]


def edge_sample(tmp_path, saturate: int = 0, seed: int = 5) -> Sample:
    """A translocation among every kind of record the pass must take or
    leave: consumable pairs, pairs across a gene boundary, viral pairs,
    spliced and clipped mates, SA tags, a missing HI, HI of other widths,
    duplicates, three records of one name; saturate: pairs of 20 bases on
    one window, every 16th with an SA tag, so that both the card and the
    engine count there (70,000 drive the card's own count past 0xFFFF)."""
    s = Sample(tmp_path, {"1": 30000, "2": 30000, "AC_000001.1": 6000}, seed)
    s.gene("1", 1000, 4999, "+", "G1", "GENE1", [(1000, 2999), (4000, 4999)])
    s.gene("2", 11000, 14999, "+", "G2", "GENE2",
           [(11000, 12999), (14000, 14999)])
    s.gene("1", 20000, 24999, "-", "G3", "GENE3", None)
    for i in range(6):
        s.split(f"s{i}", "1", 2800, 2950, 25, 25, "2", 11000)
    for i in range(4):
        s.discordant(f"d{i}", "1", 2800, "2", 11100)
    for i in range(40):  # consumable, inside GENE1 / GENE3 / between genes
        s.pair(f"c{i}", 0, 1100 + 37 * i)
        s.pair(f"e{i}", 0, 20100 + 53 * i)
        s.pair(f"g{i}", 1, 6000 + 41 * i, flags=(163, 83))
    for i, pos in enumerate((960, 990, 4950, 2980, 3990)):  # gene edges
        s.pair(f"x{i}", 0, pos)
    for i in range(6):  # viral
        s.pair(f"v{i}", 2, 300 + 500 * i)
    s.pair("sp0", 0, 1500, ops1="20M300N30M", gap=400)  # spliced
    s.pair("sc0", 0, 1600, ops1="10S40M")  # soft-clipped
    s.pair("sc1", 0, 1700, ops2="40M10S")
    s.pair("hc0", 0, 1800, ops1="5H45M")
    s.pair("sa0", 0, 1900, tags1=[tag("HI", "i", 1),
                                  tag("SA", "Z", "2,11001,+,25S25M,60,0;")])
    s.pair("nh0", 0, 2000, tags1=[], tags2=[])  # no HI on either: 1 and 1
    s.pair("nh1", 0, 2050, tags1=[], tags2=[tag("HI", "C", 1)])
    s.pair("nh2", 0, 2100, tags1=[tag("HI", "s", 2)],
           tags2=[tag("HI", "I", 2)])
    s.pair("nh3", 0, 2150, tags1=[tag("HI", "i", 1)],
           tags2=[tag("HI", "i", 2)])
    s.pair("hz0", 0, 2200, tags1=[tag("HI", "Z", "1")])
    s.pair("ab0", 0, 2250, tags1=[tag("HI", "i", 1), tag("XB", "Bs", [1, -2]),
                                  tag("XF", "f", 0.5), tag("XA", "A", 65)])
    s.pair("du0", 0, 2300, flags=(99 | 1024, 147 | 1024))
    s.pair("du1", 0, 2350, flags=(99, 147 | 1024))
    for k in range(3):  # three records of one name, then a pair
        s.records.append(record("tri", 99 if k % 2 == 0 else 147, 0,
                                2400 + 60 * k, cigar("50M"),
                                s.seq("1", 2400 + 60 * k, 50),
                                [tag("HI", "i", 1)]))
    s.pair("post", 0, 2600)
    for i in range(saturate):
        sa = [tag("HI", "i", 1), tag("SA", "Z", "2,11001,+,5S15M,60,0;")]
        s.records.append(record(f"z{i}", 99, 0, 3000, cigar("20M"),
                                s.seq("1", 3000, 20),
                                sa if i % 16 == 0 else [tag("HI", "i", 1)],
                                0, 3000))
        s.records.append(record(f"z{i}", 147, 0, 3000, cigar("20M"),
                                s.seq("1", 3000, 20), [tag("HI", "i", 1)], 0,
                                3000))
    return s


def tile_runs(s: Sample, runs: int = 40) -> None:
    """Runs of three or four records of one name between stretches of
    consumable pairs of growing length, so that the runs fall at every
    offset of the engine's 256-record decode tiles."""
    for k in range(runs):
        for j in range(3 + k % 2):
            s.records.append(record(f"run{k}", 99 if j % 2 == 0 else 147, 0,
                                    1200 + 10 * j, cigar("50M"),
                                    s.seq("1", 1200 + 10 * j, 50),
                                    [tag("HI", "i", 1)]))
        for i in range(60 + 7 * k):
            s.pair(f"k{k}_{i}", 0, 1100 + 7 * k + 3 * i, gap=0)


def run(monkeypatch, args, out_dir, label, backend=None, device="cpu"):
    """(rc, fusions, discarded, counters, planes after the scan) of one
    in-process CLI run of the port on device, the pass taken by backend
    (None: the engine alone; "card": the one card.backend picks)."""
    from arriba_tpu_torch import cli
    from arriba_tpu_torch.ingest import card, chimeric

    planes = []
    scan = chimeric._scan

    def kept_planes(*a):
        result = scan(*a)
        planes.append([None if p is None else tuple(x.copy() for x in p)
                       for p in a[8]])
        return result

    with monkeypatch.context() as m:
        m.setenv("ARRIBA_TPU_TORCH_DEVICE", device)
        m.setattr(chimeric, "_scan", kept_planes)
        if backend != "card":
            m.setattr(card, "backend", lambda: backend)
        err = io.StringIO()
        out = out_dir / f"{label}.tsv"
        discarded = out_dir / f"{label}.discarded.tsv"
        with contextlib.redirect_stderr(err):
            rc = cli.main(list(args) + ["-o", str(out), "-O", str(discarded)])
    return (rc, out.read_bytes(), discarded.read_bytes(),
            COUNTER.findall(err.getvalue()), planes)


def assert_same(a, b):
    assert a[0] == b[0] == 0
    assert a[1] == b[1]
    assert a[2] == b[2]
    assert a[3] == b[3]
    assert len(a[4]) == len(b[4]) == 1
    for pa, pb in zip(a[4][0], b[4][0]):
        assert (pa is None) == (pb is None)
        if pa is not None:
            for x, y in zip(pa, pb):
                assert np.array_equal(x, y)


def spy(backend, seen):
    def wrapped(path, contigs):
        result = backend(path, contigs)
        seen.append(result)
        return result
    return wrapped
