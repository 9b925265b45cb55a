"""The benchmark's RNA-seq samples: a synthetic genome, its annotation and a
STAR-like BAM, made in bulk with NumPy.

A sample has two parts.

- The background, which no seed changes: the assembly (host contigs of
  random bases with low-complexity tracts between genes, and one viral
  contig), a GTF of multi-exon genes on alternating strands, a blacklist,
  and the proper pairs that give the sample its depth. It is built once
  per checkout into a cache directory under a version marker, and the
  proper pairs are kept as BGZF blocks.
- The chimeric fragments, which the seed draws (the traffic file gives
  their numbers): sense fusions between random genes at exon boundaries,
  each with split fragments (mate, split read with its supplementary
  alignment) and discordant pairs in numbers spread over orders of
  magnitude; the artifacts that outnumber them in a real sample (lone
  chimeric fragments and pairs between random places of two genes,
  clipped segments aligned to low-complexity tracts); and host-virus
  pairs. They are written as BGZF blocks after the cached ones (BGZF
  blocks concatenate), so a run writes only those.

The generator keeps what it planted (`Planted`), which the reference reads
to judge the program's tables.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VERSION = "benchmark-sample v2"
BGZF_BLOCK = 65280          # uncompressed bytes a BGZF block, as htslib
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
ACGT = np.frombuffer(b"ACGT", np.uint8)
# BAM's 4-bit base codes (=ACMGRSVTWYHKDBN), by ASCII byte
NT16 = np.full(256, 15, np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    NT16[_c] = _i
CIGAR_M, CIGAR_S, CIGAR_H = 0, 4, 5
# SAM flags of the records, as STAR writes them within one BAM
F_MATE1, F_SPLIT, F_SUPPLEMENTARY = 99, 147, 2195
F_DISCORDANT1, F_DISCORDANT2 = 97, 145
PROPER_GAP = 180            # mate 2 starts this far after mate 1
BACKGROUND_SEED = 20260820  # the background is the same for every seed
BACKGROUND_CHUNK = 250_000  # pairs a chunk
VIRAL_HOST = 6              # host-virus pairs' host mates lie on contig 7
# low-complexity tracts in the intergenic gaps, a tract after every
# TRACT_EVERY-th gene, each a repeat of one of TRACT_UNITS
TRACT_EVERY = 4
TRACT_LENGTH = 300
TRACT_UNITS = (b"A", b"AC", b"AG", b"CT", b"TG")


# --------------------------------------------------------------------------
# the deployment's fixed part: assembly, annotation, background pairs

@dataclasses.dataclass(frozen=True)
class Layout:
    """The sizes of a configuration's genome and annotation."""

    host_contigs: int
    genes_per_contig: int
    exons_per_gene: int
    gene_spacing: int
    exon_pitch: int
    exon_length: int
    contig_margin: int
    viral_length: int
    read_length: int
    background_pairs: int

    @classmethod
    def of(cls, config: dict) -> "Layout":
        return cls(**{f.name: int(config[f.name])
                      for f in dataclasses.fields(cls)})

    @property
    def contig_length(self) -> int:
        return 2 * self.contig_margin + self.genes_per_contig * self.gene_spacing

    @property
    def contig_names(self) -> list:
        names = [str(i) for i in range(1, self.host_contigs + 1)]
        if self.host_contigs == 24:
            names[22:] = ["X", "Y"]
        return names + ["AC_1"]

    @property
    def contig_lengths(self) -> np.ndarray:
        return np.array([self.contig_length] * self.host_contigs
                        + [self.viral_length], np.int64)

    @property
    def contig_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.contig_lengths)[:-1]])

    def gene_start(self, gene_in_contig):
        return self.contig_margin + np.asarray(gene_in_contig) * self.gene_spacing

    def key(self) -> str:
        text = json.dumps(dataclasses.asdict(self), sort_keys=True) + VERSION
        return hashlib.sha256(text.encode()).hexdigest()[:16]


def _write_fasta(path: pathlib.Path, layout: Layout, genome: np.ndarray):
    with open(path, "wb") as fa:
        for name, start, n in zip(layout.contig_names, layout.contig_offsets,
                                  layout.contig_lengths):
            seq = genome[start:start + n]
            fa.write(b">" + name.encode() + b"\n")
            full = n // 80 * 80
            body = np.empty((full // 80, 81), np.uint8)
            body[:, :80] = seq[:full].reshape(-1, 80)
            body[:, 80] = ord("\n")
            fa.write(body.tobytes())
            if full < n:
                fa.write(seq[full:].tobytes() + b"\n")


def plant_tracts(layout: Layout, genome: np.ndarray) -> None:
    """Write the low-complexity tracts into the assembly: poly-A runs and
    dinucleotide repeats, where STAR aligns the clipped ends of reads
    that run into such sequence (an artifact that the homopolymer and
    low-entropy filters remove)."""
    starts = tract_starts(layout) + layout.contig_offsets[
        :layout.host_contigs, None]
    for k, start in enumerate(starts.ravel().tolist()):
        unit = np.frombuffer(TRACT_UNITS[k % len(TRACT_UNITS)], np.uint8)
        genome[start:start + TRACT_LENGTH] = np.resize(unit, TRACT_LENGTH)


def _gtf_text(layout: Layout) -> bytes:
    lines = []
    row = 0
    for contig in layout.contig_names[:-1]:
        for g in range(layout.genes_per_contig):
            start = int(layout.gene_start(g))
            strand = "+" if row % 2 == 0 else "-"
            attrs = (f'gene_id "G{row}"; gene_name "GENE{row}"; '
                     f'transcript_id "T{row}";')
            for e in range(layout.exons_per_gene):
                s = start + e * layout.exon_pitch + 1
                t = s + layout.exon_length - 1
                lines.append(f"{contig}\tbench\texon\t{s}\t{t}\t.\t{strand}"
                             f"\t.\t{attrs}")
                lines.append(f"{contig}\tbench\tCDS\t{s}\t{t}\t.\t{strand}"
                             f"\t0\t{attrs}")
            row += 1
    return ("\n".join(lines) + "\n").encode()


BLACKLIST = b"1:14000000\t1:14100000\n5:2000000\t5:2100000\n"


def _bam_header(layout: Layout) -> bytes:
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{n}\n"
        for name, n in zip(layout.contig_names, layout.contig_lengths))
    out = [b"BAM\x01", struct.pack("<i", len(text)), text.encode(),
           struct.pack("<i", len(layout.contig_names))]
    for name, n in zip(layout.contig_names, layout.contig_lengths):
        out += [struct.pack("<i", len(name) + 1), name.encode() + b"\0",
                struct.pack("<i", int(n))]
    return b"".join(out)


# --------------------------------------------------------------------------
# BAM records and BGZF blocks, in bulk

def _i32(values, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(values, "<i4"), (n,)).copy().view(
        np.uint8).reshape(n, 4)


def _u16(values, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(values, "<u2"), (n,)).copy().view(
        np.uint8).reshape(n, 2)


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's reg2bin, vectorised (end exclusive)."""
    end = end - 1
    out = np.zeros_like(beg)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        same = ~done & ((beg >> shift) == (end >> shift))
        out[same] = base + (beg[same] >> shift)
        done |= same
    return out


def _names(prefix: str, ids: np.ndarray, width: int) -> np.ndarray:
    """[n, width + 2] read names prefix + zero-padded id + NUL."""
    digits = (ids[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
    out = np.empty((len(ids), width + 2), np.uint8)
    out[:, 0] = ord(prefix)
    out[:, 1:-1] = ord("0") + digits
    out[:, -1] = 0
    return out


def records(name, flag, ref, pos, cigar, seq, mref, mpos, tlen,
            tags=None) -> np.ndarray:
    """n BAM records of one layout, [n, bytes]: every record has the same
    name width, number of CIGAR operations, read length and tag bytes.
    cigar is [n, ops] (length << 4 | op), seq ASCII [n, l], tags [n, t]."""
    n, n_ops, l_seq = len(name), cigar.shape[1], seq.shape[1]
    consumes_ref = np.isin(cigar & 15, (0, 2, 3, 7, 8))
    ref_span = np.where(consumes_ref, cigar >> 4, 0).astype(np.int64).sum(
        axis=1)
    start = np.asarray(pos, np.int64) + np.zeros(n, np.int64)
    codes = NT16[seq]
    if l_seq % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    tags = np.zeros((n, 0), np.uint8) if tags is None else tags
    body = [
        _i32(ref, n), _i32(pos, n),
        np.full((n, 1), name.shape[1], np.uint8), np.full((n, 1), 60, np.uint8),
        _u16(_reg2bin(start, start + np.maximum(ref_span, 1)), n),
        _u16(n_ops, n), _u16(flag, n), _i32(l_seq, n),
        _i32(mref, n), _i32(mpos, n), _i32(tlen, n),
        name, cigar.astype("<u4").view(np.uint8).reshape(n, 4 * n_ops),
        packed, np.full((n, l_seq), 255, np.uint8), tags]
    size = sum(part.shape[1] for part in body)
    return np.concatenate([_i32(size, n)] + body, axis=1)


HI_TAG = np.frombuffer(b"HIC\x01", np.uint8)


def _hi(n: int) -> np.ndarray:
    return np.broadcast_to(HI_TAG, (n, 4))


def _compress(piece: bytes, level: int) -> bytes:
    deflater = zlib.compressobj(level, zlib.DEFLATED, -15)
    data = deflater.compress(piece) + deflater.flush()
    header = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6,
                         66, 67, 2, len(data) + 25)
    return header + data + struct.pack("<II", zlib.crc32(piece), len(piece))


def bgzf(data: bytes, level: int, pool: ThreadPoolExecutor) -> list:
    """data as BGZF blocks (the last one partial), compressed by pool."""
    view = memoryview(data)
    pieces = [view[i:i + BGZF_BLOCK] for i in range(0, len(data), BGZF_BLOCK)]
    return list(pool.map(lambda p: _compress(bytes(p), level), pieces))


# --------------------------------------------------------------------------
# the cache: assembly, annotation, blacklist, background blocks

@dataclasses.dataclass
class Background:
    layout: Layout
    directory: pathlib.Path
    genome: np.ndarray          # the assembly's bases, contigs concatenated
    prefix_bytes: int           # the background blocks' length in sample.bam

    @property
    def sample(self) -> pathlib.Path:
        return self.directory / "sample.bam"

    def cli_files(self) -> list:
        d = self.directory
        return ["-g", str(d / "genes.gtf"), "-a", str(d / "genome.fa"),
                "-b", str(d / "blacklist.tsv")]


def background(layout: Layout, cache: pathlib.Path, level: int,
               threads: int) -> Background:
    """The background of layout, built into cache/<key> unless its marker
    says it is there."""
    directory = cache / layout.key()
    marker = directory / "complete.json"
    if marker.exists():
        info = json.loads(marker.read_text())
        if info.get("version") == VERSION and info.get("level") == level:
            genome = np.memmap(directory / "genome.u8", np.uint8, "r")
            return Background(layout, directory, genome, info["prefix_bytes"])
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(BACKGROUND_SEED)
    genome = ACGT[rng.integers(0, 4, int(layout.contig_lengths.sum()),
                               dtype=np.uint8)]
    plant_tracts(layout, genome)
    genome.tofile(directory / "genome.u8")
    _write_fasta(directory / "genome.fa", layout, genome)
    (directory / "genes.gtf").write_bytes(_gtf_text(layout))
    (directory / "blacklist.tsv").write_bytes(BLACKLIST)
    L = layout.read_length
    span = layout.contig_length - 1000 - PROPER_GAP - L
    offsets = np.arange(L)
    written = 0
    with open(directory / "sample.bam", "wb") as out, \
            ThreadPoolExecutor(threads) as pool:
        pending = _bam_header(layout)
        while written < layout.background_pairs:
            m = min(BACKGROUND_CHUNK, layout.background_pairs - written)
            contig = rng.integers(0, layout.host_contigs, m)
            pos = rng.integers(1000, span, m)
            at = layout.contig_offsets[contig] + pos
            ids = written + np.arange(m)
            name = _names("n", ids, 8)
            cigar = np.full((m, 1), L << 4 | CIGAR_M, np.uint32)
            mate1 = records(name, 99, contig, pos, cigar,
                            genome[at[:, None] + offsets], contig,
                            pos + PROPER_GAP, PROPER_GAP + L, _hi(m))
            mate2 = records(name, 147, contig, pos + PROPER_GAP, cigar,
                            genome[(at + PROPER_GAP)[:, None] + offsets],
                            contig, pos, -(PROPER_GAP + L), _hi(m))
            data = pending + np.concatenate([mate1, mate2], axis=1).tobytes()
            keep = len(data) // BGZF_BLOCK * BGZF_BLOCK
            if written + m == layout.background_pairs:
                keep = len(data)
            for block in bgzf(data[:keep], level, pool):
                out.write(block)
            pending = data[keep:]
            written += m
        prefix = out.tell()
    marker.write_text(json.dumps({"version": VERSION, "level": level,
                                  "prefix_bytes": prefix}) + "\n")
    return Background(layout, directory, np.memmap(
        directory / "genome.u8", np.uint8, "r"), prefix)


# --------------------------------------------------------------------------
# the seeded chimeric fragments

@dataclasses.dataclass
class Fragments:
    """Chimeric fragments of one kind, one entry each: mate 1's (or the
    split read's) contig and breakpoint side, the partner's, and the
    fragment's id (its read name's number). junction is the planted
    junction a fragment supports, or -1 for an artifact."""

    contig1: np.ndarray
    pos1: np.ndarray
    contig2: np.ndarray
    pos2: np.ndarray
    fid: np.ndarray
    junction: np.ndarray
    anchor: np.ndarray = None    # split fragments only
    gap: np.ndarray = None

    def __len__(self) -> int:
        return len(self.fid)

    def take(self, keep: np.ndarray) -> "Fragments":
        return Fragments(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name)[keep]
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Planted:
    """What the generator wrote for one seed. Junction j joins contig1[j]
    (0-based host contig) at bp1[j] (the last base before the junction,
    0-based exclusive end) to contig2[j] at bp2[j] (the first base after
    it, 0-based); gene1[j] and gene2[j] are the genes' annotation rows.
    split holds every split fragment written (a split read ends at pos1,
    its clipped part aligns at pos2): the junctions' and the artifacts'
    (junction -1: a lone chimera between random places of two genes, or
    a split read anchored in a low-complexity tract). discordant holds the
    discordant pairs (mate 1 at pos1, mate 2 at pos2)."""

    contig1: np.ndarray
    bp1: np.ndarray
    gene1: np.ndarray
    contig2: np.ndarray
    bp2: np.ndarray
    gene2: np.ndarray
    split: Fragments
    discordant: Fragments
    viral_gene: int
    viral_fragments: int
    # set by chimeric_bytes: [n, 2] bases that differ from the assembly in
    # the two alignments of each fragment that Arriba's mismatch filter
    # tests (a split fragment's mate 1 and its supplementary's aligned
    # part; a discordant pair's two mates)
    split_mismatches: np.ndarray = None
    discordant_mismatches: np.ndarray = None

    @property
    def fragments(self) -> int:
        return len(self.split) + len(self.discordant) + self.viral_fragments


def _seed_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))


def support_sizes(traffic: dict) -> np.ndarray:
    """Split fragments a junction, the same set for every seed:
    log-uniform quantiles from junction_split_min to junction_split_max
    (fusion expression spans orders of magnitude)."""
    n_j = int(traffic["junctions"])
    lo = float(traffic["junction_split_min"])
    hi = float(traffic["junction_split_max"])
    q = (np.arange(n_j) + 0.5) / n_j
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def _every(n: np.ndarray, keep: int) -> np.ndarray:
    """Of groups of n[k] items in a row, each group's 0th, keep-th, ...
    item: a mask over the concatenation."""
    within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return within % keep == 0


def tract_starts(layout: Layout) -> np.ndarray:
    """[host contigs, tracts] 0-based starts of the low-complexity tracts:
    one in the middle of the intergenic gap after every TRACT_EVERY-th
    gene."""
    span = (layout.exons_per_gene - 1) * layout.exon_pitch \
        + layout.exon_length
    gap = layout.gene_spacing - span
    assert gap >= TRACT_LENGTH + 20, "no room for a tract between genes"
    genes = np.arange(TRACT_EVERY // 2, layout.genes_per_contig, TRACT_EVERY)
    starts = layout.gene_start(genes) + span + (gap - TRACT_LENGTH) // 2
    return np.broadcast_to(starts, (layout.host_contigs, len(genes)))


def _lone_pairs(layout: Layout, rng, first: np.ndarray,
                taken: np.ndarray) -> np.ndarray:
    """For each gene (global row) of first, a partner gene on another
    contig such that no two pairs, and no pair of taken (unordered keys
    lo * genes + hi), join the same two genes: each lone artifact is an
    event of its own, with the one read it was given."""
    gpc = layout.genes_per_contig
    n_genes = layout.host_contigs * gpc
    second = np.zeros(len(first), np.int64)
    todo = np.arange(len(first))
    while len(todo):
        contig = (first[todo] // gpc + 1 + rng.integers(
            0, layout.host_contigs - 1, len(todo))) % layout.host_contigs
        second[todo] = contig * gpc + rng.integers(0, gpc, len(todo))
        key = np.minimum(first, second) * n_genes + np.maximum(first, second)
        _, at = np.unique(key, return_index=True)
        clash = np.ones(len(first), bool)
        clash[at] = False
        clash |= np.isin(key, taken)
        todo = np.flatnonzero(clash)
    return second


def _inside(layout: Layout, rng, gene: np.ndarray) -> tuple:
    """A random place inside each gene (global row): (contig, 0-based
    position)."""
    span = (layout.exons_per_gene - 1) * layout.exon_pitch \
        + layout.exon_length
    contig, local = np.divmod(gene, layout.genes_per_contig)
    return contig, layout.gene_start(local) + rng.integers(300, span,
                                                           len(gene))


def plant(layout: Layout, traffic: dict, seed: int) -> Planted:
    """Draw the junctions and fragments of one seed (what the sample
    holds, before any byte is written). Every seed writes the same number
    of fragments of each kind and the same support sizes, in another
    order and at other places."""
    rng = _seed_rng(seed)
    n_j = int(traffic["junctions"])
    gpc = layout.genes_per_contig
    keep = int(traffic["keep_every"])
    # 2 n_j distinct genes: partners on two contigs and on one strand, so
    # that each junction is a sense fusion, spliced at both ends (the end
    # of exon 5 joined to the start of exon 6), and an event of its own;
    # never at the same place of two contigs (Arriba tests a discordant
    # mate against the partner gene's span without its contig)
    order = rng.permutation(layout.host_contigs * gpc)
    genes = np.empty(2 * n_j, np.int64)
    genes[0::2] = order[:n_j]
    free = list(order[n_j:])
    for k, first in enumerate(order[:n_j].tolist()):
        c, g = divmod(first, gpc)
        at = next(i for i, other in enumerate(free)
                  if other % 2 == first % 2 and other // gpc != c
                  and other % gpc != g)
        genes[2 * k + 1] = free.pop(at)
    c1, g1 = np.divmod(genes[0::2], gpc)
    c2, g2 = np.divmod(genes[1::2], gpc)
    bp1 = layout.gene_start(g1) + 4 * layout.exon_pitch + layout.exon_length
    bp2 = layout.gene_start(g2) + 5 * layout.exon_pitch
    L = layout.read_length

    def split_of(junction, c_1, p_1, c_2, p_2):
        n = len(junction)
        return Fragments(c_1, p_1, c_2, p_2, np.zeros(n, np.int64), junction,
                         rng.integers(traffic["anchor_min"],
                                      traffic["anchor_max"], n),
                         rng.integers(traffic["mate_gap_min"],
                                      traffic["mate_gap_max"], n))

    # the junctions' split fragments, then the lone chimeras, then split
    # reads anchored in a low-complexity tract (the anchor inside it)
    # whose clipped part aligns in a gene
    sizes = rng.permutation(support_sizes(traffic))
    j = np.repeat(np.arange(n_j), sizes)
    junction = split_of(j, c1[j], bp1[j], c2[j], bp2[j]).take(
        _every(sizes, keep))
    # the lone artifacts' gene pairs: the split fragments', the
    # discordant pairs', then the low-complexity reads' (the tract's
    # preceding gene and a partner)
    n_a = int(traffic["artifact_split_fragments"])
    n_b = int(traffic["artifact_discordant_pairs"])
    n_l = int(traffic["low_complexity_fragments"])
    n_genes = layout.host_contigs * gpc
    tracts = tract_starts(layout)
    l1 = rng.integers(0, layout.host_contigs, n_l)
    tract = rng.integers(0, tracts.shape[1], n_l)
    first = np.concatenate([
        rng.integers(0, n_genes, n_a + n_b),
        l1 * gpc + TRACT_EVERY // 2 + TRACT_EVERY * tract])
    taken = (np.minimum(genes[0::2], genes[1::2]) * n_genes
             + np.maximum(genes[0::2], genes[1::2]))
    second = _lone_pairs(layout, rng, first, taken)
    a1, p1 = _inside(layout, rng, first[:n_a])
    a2, p2 = _inside(layout, rng, second[:n_a])
    artifact = split_of(np.full(n_a, -1), a1, p1, a2, p2).take(
        _every(np.array([n_a]), keep))
    q1 = tracts[l1, tract] + rng.integers(int(traffic["anchor_max"]),
                                          TRACT_LENGTH + 1, n_l)
    l2, q2 = _inside(layout, rng, second[n_a + n_b:])
    low = split_of(np.full(n_l, -1), l1, q1, l2, q2).take(
        _every(np.array([n_l]), keep))
    split = Fragments(**{f.name: np.concatenate([
        getattr(part, f.name) for part in (junction, artifact, low)])
        for f in dataclasses.fields(Fragments)})
    split.fid = rng.permutation(len(split))

    # discordant pairs: the junctions' (mate 1 ending 30 to 149 bases
    # before bp1, within exon 5, mate 2 30 bases after bp2), then lone
    # pairs between two random genes
    d_sizes = np.round(sizes * float(traffic["discordant_per_split"])
                       ).astype(np.int64)
    dj = np.repeat(np.arange(n_j), d_sizes)
    d_pos = bp1[dj] - 180 - rng.integers(0, 120, len(dj))
    pairs = Fragments(c1[dj], d_pos, c2[dj], bp2[dj] + 30,
                      np.zeros(len(dj), np.int64), dj).take(
        _every(d_sizes, keep))
    b1, r1 = _inside(layout, rng, first[n_a:n_a + n_b])
    b2, r2 = _inside(layout, rng, second[n_a:n_a + n_b])
    lone = Fragments(b1, r1, b2, r2, np.zeros(n_b, np.int64),
                     np.full(n_b, -1)).take(_every(np.array([n_b]), keep))
    discordant = Fragments(**{f.name: None if f.name in ("anchor", "gap")
                              else np.concatenate([getattr(pairs, f.name),
                                                   getattr(lone, f.name)])
                              for f in dataclasses.fields(Fragments)})
    discordant.fid = rng.permutation(len(discordant))
    return Planted(c1, bp1, genes[0::2], c2, bp2, genes[1::2], split,
                   discordant, _viral_gene(layout, genes, rng),
                   int(traffic["viral_fragments"]))


def _viral_gene(layout: Layout, genes: np.ndarray, rng) -> int:
    """A gene of the host contig of the host-virus pairs that no junction
    uses, by its index in that contig."""
    host = VIRAL_HOST if layout.host_contigs > VIRAL_HOST else 0
    gpc = layout.genes_per_contig
    free = np.setdiff1d(np.arange(host * gpc, (host + 1) * gpc), genes)
    return int(rng.choice(free)) - host * gpc


def _with_errors(seq: np.ndarray, rate: float, rng) -> np.ndarray:
    hit = rng.random(seq.shape) < rate
    seq = seq.copy()
    seq[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    return seq


def _digits(values: np.ndarray) -> np.ndarray:
    """Decimal digits of positive integers."""
    return 1 + sum((values >= 10 ** k).astype(np.int64) for k in range(1, 12))


def _sa_tags(contig_names, contig2, bp2, anchor, clip) -> np.ndarray:
    """[n, t] SA:Z tags of one length, NUL-terminated."""
    text = [f"SAZ{contig_names[c]},{p + 1},-,{a}S{k}M,60,0;"
            for c, p, a, k in zip(contig2.tolist(), bp2.tolist(),
                                  anchor.tolist(), clip.tolist())]
    raw = np.array(text, dtype="S")
    width = raw.dtype.itemsize
    return np.concatenate([raw.view(np.uint8).reshape(len(text), width),
                           np.zeros((len(text), 1), np.uint8)], axis=1)


def chimeric_bytes(bg: Background, planted: Planted, traffic: dict,
                   seed: int) -> bytes:
    """The seeded records, uncompressed: split fragments grouped by
    layout, then discordant pairs, then host-virus pairs. Records in
    planted the mismatches its base errors make."""
    layout = bg.layout
    genome = bg.genome
    L = layout.read_length
    off = layout.contig_offsets
    rate = float(traffic["error_rate"])
    rng = _seed_rng(seed ^ 0x5EED)
    offsets = np.arange(L)
    parts = []
    # split fragments: mate 1 (L M) upstream, the split read (anchor M,
    # clip S) ending at pos1 with the partner's first bases clipped, and
    # its supplementary alignment (anchor H, clip M) at pos2
    s = planted.split
    ids = np.arange(len(s))
    anchor, clip = s.anchor, L - s.anchor
    sr_pos = s.pos1 - anchor
    m1_pos = sr_pos - L - s.gap
    name_len = np.array([len(n) for n in layout.contig_names])[s.contig2]
    planted.split_mismatches = np.zeros((len(s), 2), np.int64)
    group = anchor * 1000 + _digits(s.pos2 + 1) * 10 + name_len
    for key in np.unique(group):
        sel = ids[group == key]
        n, a = len(sel), int(anchor[sel[0]])
        c1, c2, p2 = s.contig1[sel], s.contig2[sel], s.pos2[sel]
        name = _names("f", s.fid[sel], 7)
        plain_m1 = genome[(off[c1] + m1_pos[sel])[:, None] + offsets]
        plain_sr = np.concatenate(
            [genome[(off[c1] + sr_pos[sel])[:, None] + np.arange(a)],
             genome[(off[c2] + p2)[:, None] + np.arange(L - a)]], axis=1)
        s_m1 = _with_errors(plain_m1, rate, rng)
        s_sr = _with_errors(plain_sr, rate, rng)
        planted.split_mismatches[sel] = np.stack(
            [(s_m1 != plain_m1).sum(1), (s_sr != plain_sr)[:, a:].sum(1)], 1)
        tlen = sr_pos[sel] - m1_pos[sel] + L
        full = np.full((n, 1), L << 4 | CIGAR_M, np.uint32)
        clipped = np.tile(np.array([[a << 4 | CIGAR_M,
                                     (L - a) << 4 | CIGAR_S]], np.uint32),
                          (n, 1))
        hard = np.tile(np.array([[a << 4 | CIGAR_H,
                                  (L - a) << 4 | CIGAR_M]], np.uint32), (n, 1))
        sa = _sa_tags(layout.contig_names, c2, p2, anchor[sel], clip[sel])
        mate1 = records(name, F_MATE1, c1, m1_pos[sel], full, s_m1,
                        c1, sr_pos[sel], tlen, _hi(n))
        split = records(name, F_SPLIT, c1, sr_pos[sel], clipped, s_sr,
                        c1, m1_pos[sel], -tlen,
                        np.concatenate([_hi(n), sa], axis=1))
        supp = records(name, F_SUPPLEMENTARY, c2, p2, hard, s_sr[:, a:], c1,
                       m1_pos[sel], 0, _hi(n))
        parts.append(np.concatenate([mate1, split, supp], axis=1).tobytes())
    # discordant pairs
    d = planted.discordant
    n = len(d)
    planted.discordant_mismatches = np.zeros((n, 2), np.int64)
    if n:
        c1, c2, p1, p2 = d.contig1, d.contig2, d.pos1, d.pos2
        name = _names("d", d.fid, 7)
        full = np.full((n, 1), L << 4 | CIGAR_M, np.uint32)
        plain1 = genome[(off[c1] + p1)[:, None] + offsets]
        plain2 = genome[(off[c2] + p2)[:, None] + offsets]
        s1 = _with_errors(plain1, rate, rng)
        s2 = _with_errors(plain2, rate, rng)
        planted.discordant_mismatches[:] = np.stack(
            [(s1 != plain1).sum(1), (s2 != plain2).sum(1)], 1)
        parts.append(np.concatenate([
            records(name, F_DISCORDANT1, c1, p1, full, s1, c2, p2, 0, _hi(n)),
            records(name, F_DISCORDANT2, c2, p2, full, s2, c1, p1, 0, _hi(n)),
        ], axis=1).tobytes())
    # host-virus pairs: mate 1 on contig 7 before an exon end of one gene,
    # mate 2 on the viral contig
    n = planted.viral_fragments
    if n:
        v = np.arange(n)
        host = VIRAL_HOST if layout.host_contigs > VIRAL_HOST else 0
        viral = layout.host_contigs
        host_bp = int(layout.gene_start(planted.viral_gene)) \
            + 2 * layout.exon_pitch + layout.exon_length
        p1 = host_bp - 280 - v % 40
        p2 = 50_000 + (v % 50) * 13
        name = _names("v", v, 7)
        full = np.full((n, 1), L << 4 | CIGAR_M, np.uint32)
        s1 = _with_errors(genome[(off[host] + p1)[:, None] + offsets], rate,
                          rng)
        s2 = _with_errors(genome[(off[viral] + p2)[:, None] + offsets], rate,
                          rng)
        parts.append(np.concatenate([
            records(name, F_DISCORDANT1, host, p1, full, s1, viral, p2, 0,
                    _hi(n)),
            records(name, F_DISCORDANT2, viral, p2, full, s2, host, p1, 0,
                    _hi(n)),
        ], axis=1).tobytes())
    return b"".join(parts)


def write_sample(bg: Background, planted: Planted, traffic: dict, seed: int,
                 level: int, threads: int) -> int:
    """Cut sample.bam back to its background blocks and append this seed's
    chimeric blocks and the EOF block. Returns the bytes written."""
    data = chimeric_bytes(bg, planted, traffic, seed)
    with ThreadPoolExecutor(threads) as pool:
        blocks = bgzf(data, level, pool)
    with open(bg.sample, "r+b") as out:
        out.truncate(bg.prefix_bytes)
        out.seek(bg.prefix_bytes)
        for block in blocks:
            out.write(block)
        out.write(BGZF_EOF)
        written = out.tell() - bg.prefix_bytes
    return written


def warm_files(path: pathlib.Path) -> None:
    """Read a file once, so that the first sample finds it in the page
    cache."""
    with open(path, "rb") as handle:
        while handle.read(1 << 24):
            pass


def make(config: dict, traffic: dict, seed: int, cache: pathlib.Path,
         threads: int = None) -> tuple:
    """(Background, Planted, bytes written) for one run: the cached
    background, built if missing, and this seed's fragments appended."""
    threads = threads or os.cpu_count() or 1
    layout = Layout.of(config)
    level = int(config["bam_compression_level"])
    bg = background(layout, cache, level, threads)
    planted = plant(layout, traffic, seed)
    written = write_sample(bg, planted, traffic, seed, level, threads)
    return bg, planted, written
