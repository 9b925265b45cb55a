"""GTF gene-model parser.

Reference parity: source/annotation.cpp:28-377 — configurable GTF dialect
(feature/attribute aliasing), gene-bound expansion over exons, rejection of
malformed genes (non-unique ids, >3 Mb, beyond contig end), CDS→exon mapping,
doubly-linked exon lists per transcript, coding lengths, and the hard-coded
Gencode annotation fixes (FIP1L1, GOPC, MTAP, mouse Fgfr2).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

import re as _re

from .._native_build import engine
from ..annotation.tables import Annotation, ExonTable, GeneTable, TranscriptTable
from ..contigs import ContigRegistry
from .compressed import iter_lines
from .fasta import Assembly

MAX_GENE_SIZE = 3_000_000  # annotation.cpp:173

DEFAULT_GTF_FEATURES = (
    "gene_name=gene_name|gene_id gene_id=gene_id transcript_id=transcript_id "
    "feature_exon=exon feature_CDS=CDS"
)  # annotation.hpp:23


@dataclass
class GtfFeatures:
    """Aliases for GTF attribute/feature names (annotation.cpp:28-61)."""

    gene_name: List[str] = field(default_factory=list)
    gene_id: List[str] = field(default_factory=list)
    transcript_id: List[str] = field(default_factory=list)
    feature_exon: List[str] = field(default_factory=list)
    feature_cds: List[str] = field(default_factory=list)


def parse_gtf_features(spec: str) -> GtfFeatures:
    features = GtfFeatures()
    for pair in spec.replace(",", " ").split():
        if "=" not in pair:
            raise ValueError(f"malformed GTF feature spec: {pair}")
        key, value = pair.split("=", 1)
        values = [v for v in value.split("|") if v]
        if key == "gene_name":
            features.gene_name = values
        elif key == "gene_id":
            features.gene_id = values
        elif key == "transcript_id":
            features.transcript_id = values
        elif key == "feature_exon":
            features.feature_exon = values
        elif key == "feature_CDS":
            features.feature_cds = values
        else:
            raise ValueError(f"unknown GTF feature: {key}")
    if not all([features.gene_name, features.gene_id, features.transcript_id,
                features.feature_exon, features.feature_cds]):
        raise ValueError("incomplete GTF feature spec")
    return features


def strip_ensembl_version_number(identifier: str) -> str:
    """annotation.hpp:27-33."""
    if identifier.startswith("ENS") and "." in identifier:
        return identifier[: identifier.rfind(".")]
    return identifier


def _get_attribute(attributes: str, names: List[str], warn_context: str) -> str | None:
    start = -1
    for name in names:
        start = attributes.find(name + ' "')
        if start >= 0:
            break
    if start >= 0:
        start = attributes.find('"', start)
    if start < 0:
        print(f"WARNING: failed to extract {'|'.join(names)} from line in GTF file: {warn_context}",
              file=sys.stderr)
        return None
    start += 1
    end = attributes.find('"', start)
    if end < 0:
        print(f"WARNING: failed to extract {'|'.join(names)} from line in GTF file: {warn_context}",
              file=sys.stderr)
        return None
    return attributes[start:end]


# temporary per-exon record used during parsing
@dataclass
class _Exon:
    contig: int
    start: int
    end: int
    strand: bool
    gene_key: Tuple[str, int, bool]
    transcript_key: Tuple[str, int, bool]       # short id key (shared across versions)
    full_transcript_key: Tuple[str, int, bool]  # full id key (links + CDS grouping)
    coding_region_start: int = -1
    coding_region_end: int = -1
    removed: bool = False


# the hard-coded Gencode annotation fixes (annotation.cpp:344-366)
GENCODE_FIXES = [
    ("4", "ENST00000507166", True),      # FIP1L1:PDGFRA
    ("6", "ENST00000467125", False),     # GOPC:ROS1
    ("9", "ENST00000404796", True),      # MTAP:CDKN2B-AS1
    ("9", "ENST00000577563", True),      # MTAP:CDKN2B-AS1
    ("9", "ENST00000580900", True),      # MTAP:CDKN2B-AS1
    ("7", "ENSMUST00000124096", False),  # Fgfr2 in mouse
]


def _read_annotation_gtf_native(native, path: str, features: GtfFeatures,
                                contigs: ContigRegistry,
                                assembly: Assembly) -> Annotation:
    """Native fast path: the C++ tokenizer/assembler in native/gtf.cpp
    produces the final columnar tables with identical semantics (and
    identical stderr warnings) to the Python loop below."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.endswith(".gz"):
        from .compressed import decompress_gzip_multi
        raw = decompress_gzip_multi(raw)

    contig_lens = np.full(len(contigs), -1, np.int64)
    for cid in range(len(contigs)):
        if cid in assembly:
            contig_lens[cid] = len(assembly[cid])

    result = native.gtf_parse(
        raw,
        [n.encode() for n in features.gene_name],
        [n.encode() for n in features.gene_id],
        [n.encode() for n in features.transcript_id],
        [n.encode() for n in features.feature_exon],
        [n.encode() for n in features.feature_cds],
        [n.encode() for n in contigs.names],
        contig_lens.tobytes(),
        [(c, t, s) for c, t, s in GENCODE_FIXES])
    (new_contigs, gene_ids, gene_names, g_contig, g_start, g_end, g_strand,
     g_protein, t_names, t_first, t_last, t_coding, e_contig, e_start, e_end,
     e_strand, e_gene, e_transcript, e_cstart, e_cend, e_prev,
     e_next) = result

    for name in new_contigs:
        contigs.add(name.decode("latin-1"))

    gt = GeneTable()
    gt.gene_id = [b.decode("latin-1") for b in gene_ids]
    gt.name = [b.decode("latin-1") for b in gene_names]
    gt.contig = np.frombuffer(g_contig, np.int64).astype(np.int32)
    gt.start = np.frombuffer(g_start, np.int64).copy()
    gt.end = np.frombuffer(g_end, np.int64).copy()
    gt.strand = np.frombuffer(g_strand, np.uint8).astype(np.bool_)
    n_genes = len(gt.gene_id)
    gt.exonic_length = np.zeros(n_genes, np.int64)
    gt.is_dummy = np.zeros(n_genes, np.bool_)
    gt.is_protein_coding = np.frombuffer(g_protein, np.uint8).astype(np.bool_)

    tt = TranscriptTable()
    tt.name = [b.decode("latin-1") for b in t_names]
    tt.first_exon = np.frombuffer(t_first, np.int64).copy()
    tt.last_exon = np.frombuffer(t_last, np.int64).copy()
    tt.coding_length = np.frombuffer(t_coding, np.int64).copy()

    et = ExonTable()
    et.contig = np.frombuffer(e_contig, np.int64).astype(np.int32)
    et.start = np.frombuffer(e_start, np.int64).copy()
    et.end = np.frombuffer(e_end, np.int64).copy()
    et.strand = np.frombuffer(e_strand, np.uint8).astype(np.bool_)
    et.gene = np.frombuffer(e_gene, np.int64).copy()
    et.transcript = np.frombuffer(e_transcript, np.int64).copy()
    et.coding_region_start = np.frombuffer(e_cstart, np.int64).copy()
    et.coding_region_end = np.frombuffer(e_cend, np.int64).copy()
    et.prev_exon = np.frombuffer(e_prev, np.int64).copy()
    et.next_exon = np.frombuffer(e_next, np.int64).copy()

    annotation = Annotation(genes=gt, transcripts=tt, exons=et)
    for row, name in enumerate(gt.name):
        annotation.gene_names[name] = row
    return annotation


# strtoll grammar mirrored from native/gtf.cpp parse_coord: optional leading
# C whitespace, optional sign, ASCII digits, optional trailing spaces, max 30
# chars, int64 range — NOT Python int()'s wider grammar (underscores, unicode
# digits), so the pure-Python and native engines accept/warn identically
_COORD_RE = _re.compile(r"[ \t\n\v\f\r]*[+-]?[0-9]+ *\Z")


def _parse_coord(text: str) -> int:
    if len(text) > 30 or not _COORD_RE.match(text):
        raise ValueError(text)
    value = int(text)
    if not (-(1 << 63) <= value < (1 << 63)):
        raise ValueError(text)
    return value


def read_annotation_gtf(path: str, gtf_features_spec: str, contigs: ContigRegistry,
                        assembly: Assembly) -> Annotation:
    features = parse_gtf_features(gtf_features_spec)

    native = engine()
    if native is not None:
        return _read_annotation_gtf_native(native, path, features, contigs,
                                           assembly)

    exons: List[_Exon] = []
    # gene_key -> [gene_id, name, contig, start, end, strand, parse_order]
    genes: Dict[Tuple[str, int, bool], list] = {}
    gene_order: List[Tuple[str, int, bool]] = []
    # transcript_key (short id) -> [name, parse_order]
    transcripts: Dict[Tuple[str, int, bool], list] = {}
    transcript_order: List[Tuple[str, int, bool]] = []
    exons_by_full_transcript: Dict[Tuple[str, int, bool], List[int]] = {}
    coding_regions: List[Tuple[bool, int, int, int, str]] = []  # strand, contig, start, end, transcript_id
    malformed_genes: set = set()
    non_unique_items: set = set()

    for line in iter_lines(path):
        if not line or line[0] == "#":
            continue
        parts = line.split("\t")
        if len(parts) < 9:
            print(f"WARNING: failed to parse line in GTF file: {line}", file=sys.stderr)
            continue
        contig_name, _source, feature, start_s, end_s, _score, strand_s, _frame, attributes = parts[:9]
        try:
            # GTF is one-based (annotation.cpp:210-211); _parse_coord follows
            # the same strtoll grammar as the native engine (native/gtf.cpp)
            # so the native and the pure-Python engines warn identically
            start = _parse_coord(start_s) - 1
            end = _parse_coord(end_s) - 1
        except ValueError:
            print(f"WARNING: failed to parse line in GTF file: {line}", file=sys.stderr)
            continue
        if not contig_name or not feature or not strand_s:
            print(f"WARNING: failed to parse line in GTF file: {line}", file=sys.stderr)
            continue

        gene_name = _get_attribute(attributes, features.gene_name, attributes)
        gene_id = _get_attribute(attributes, features.gene_id, attributes)
        if gene_name is None or gene_id is None:
            continue
        short_gene_id = strip_ensembl_version_number(gene_id)

        contig = contigs.add(contig_name)
        strand = strand_s[0] == "+"

        if feature in features.feature_exon:
            transcript_id = _get_attribute(attributes, features.transcript_id, attributes)
            if transcript_id is None:
                continue
            short_transcript_id = strip_ensembl_version_number(transcript_id)

            tkey = (short_transcript_id, contig, strand)
            if tkey not in transcripts:
                transcripts[tkey] = [transcript_id]
                transcript_order.append(tkey)

            gkey = (short_gene_id, contig, strand)
            gene = genes.get(gkey)
            if gene is None:
                genes[gkey] = [gene_id, gene_name, contig, start, end, strand]
                gene_order.append(gkey)
                gene = genes[gkey]
            else:
                # expand the gene so all exons fit inside (annotation.cpp:257-260)
                if gene[3] > start:
                    gene[3] = start
                if gene[4] < end:
                    gene[4] = end
                if gene[2] != contig or gene[4] - gene[3] > MAX_GENE_SIZE:
                    if gene_id not in non_unique_items:
                        print(f"WARNING: gene ID '{gene_id}' appears to be non-unique and will be ignored",
                              file=sys.stderr)
                        non_unique_items.add(gene_id)
                    malformed_genes.add(gkey)
            if gene[2] in assembly and gene[4] >= len(assembly[gene[2]]):
                if gene_id not in non_unique_items:
                    print(f"WARNING: gene with ID '{gene_id}' extends beyond end of contig and will be ignored",
                          file=sys.stderr)
                    non_unique_items.add(gene_id)
                malformed_genes.add(gkey)

            exon = _Exon(contig, start, end, strand, gkey, tkey,
                         (transcript_id, contig, strand))
            exons.append(exon)
            exons_by_full_transcript.setdefault(exon.full_transcript_key, []).append(len(exons) - 1)

        elif feature in features.feature_cds:
            transcript_id = _get_attribute(attributes, features.transcript_id, attributes)
            if transcript_id is None:
                continue
            coding_regions.append((strand, contig, start, end, transcript_id))

    if not genes:
        raise RuntimeError("failed to parse GTF file, please consider using -G")

    # map coding regions to exons (annotation.cpp:302-320)
    protein_coding_genes: set = set()
    for strand, contig, cstart, cend, transcript_id in coding_regions:
        group = exons_by_full_transcript.get((transcript_id, contig, strand))
        if group is None:
            print(f"WARNING: CDS record has unknown transcript ID: {transcript_id}", file=sys.stderr)
            continue
        for ei in group:
            e = exons[ei]
            if (e.start <= cstart <= e.end) or (e.start <= cend <= e.end) or (e.start >= cstart and e.end <= cend):
                e.coding_region_start = max(cstart, e.start)
                e.coding_region_end = min(cend, e.end)
                protein_coding_genes.add(e.gene_key)

    # doubly-linked exon lists per full transcript id, in genomic order
    # (annotation.cpp:322-329); link arrays are filled after removals below
    for group in exons_by_full_transcript.values():
        group.sort(key=lambda ei: (exons[ei].contig, exons[ei].end, exons[ei].start))

    # transcript spans and the hard-coded Gencode fixes (annotation.cpp:344-366)
    malformed_transcripts: List[Tuple[str, int, bool]] = []
    for fix_contig, fix_id, fix_strand in GENCODE_FIXES:
        cid = contigs.get(fix_contig)
        if cid is not None:
            malformed_transcripts.append((fix_id, cid, fix_strand))

    # transcripts spanning more than MAX_GENE_SIZE are non-unique ids
    transcript_span: Dict[Tuple[str, int, bool], Tuple[int, int]] = {}
    for ei, e in enumerate(exons):
        lo, hi = transcript_span.get(e.transcript_key, (1 << 62, -1))
        transcript_span[e.transcript_key] = (min(lo, e.start), max(hi, e.end))
    for tkey, (lo, hi) in transcript_span.items():
        if hi - lo > MAX_GENE_SIZE:
            malformed_transcripts.append(tkey)
            print(f"WARNING: transcript ID '{tkey[0]}' appears to be non-unique and will be ignored",
                  file=sys.stderr)

    # remove malformed transcripts: drop their exons, shrink or drop their gene
    # (annotation.cpp:63-111)
    removed_genes: set = set(malformed_genes)
    for tkey in malformed_transcripts:
        if tkey not in transcripts:
            continue
        gene_of_transcript = None
        for e in exons:
            if e.transcript_key == tkey and not e.removed:
                e.removed = True
                gene_of_transcript = e.gene_key
        if gene_of_transcript is None:
            continue
        remaining = [e for e in exons if e.gene_key == gene_of_transcript and not e.removed]
        if not remaining:
            removed_genes.add(gene_of_transcript)
        else:
            gene = genes[gene_of_transcript]
            gene[3] = min(e.start for e in remaining)
            gene[4] = max(e.end for e in remaining)

    # drop exons of malformed genes
    for e in exons:
        if e.gene_key in removed_genes:
            e.removed = True

    # ---- finalize into SoA tables -------------------------------------------
    gene_rows: Dict[Tuple[str, int, bool], int] = {}
    gt = GeneTable()
    g_contig, g_start, g_end, g_strand = [], [], [], []
    for gkey in gene_order:
        if gkey in removed_genes:
            continue
        gene = genes[gkey]
        gene_rows[gkey] = len(gt.gene_id)
        gt.gene_id.append(gene[0])
        gt.name.append(gene[1])
        g_contig.append(gene[2])
        g_start.append(gene[3])
        g_end.append(gene[4])
        g_strand.append(gene[5])
    n_genes = len(gt.gene_id)
    gt.contig = np.array(g_contig, np.int32)
    gt.start = np.array(g_start, np.int64)
    gt.end = np.array(g_end, np.int64)
    gt.strand = np.array(g_strand, np.bool_)
    gt.exonic_length = np.zeros(n_genes, np.int64)
    gt.is_dummy = np.zeros(n_genes, np.bool_)
    gt.is_protein_coding = np.zeros(n_genes, np.bool_)
    for gkey in protein_coding_genes:
        row = gene_rows.get(gkey)
        if row is not None:
            gt.is_protein_coding[row] = True

    transcript_rows: Dict[Tuple[str, int, bool], int] = {}
    tt = TranscriptTable()
    for tkey in transcript_order:
        # keep transcript rows even if their exons were removed (harmless)
        transcript_rows[tkey] = len(tt.name)
        tt.name.append(transcripts[tkey][0])
    n_transcripts = len(tt.name)
    tt.first_exon = np.full(n_transcripts, -1, np.int64)
    tt.last_exon = np.full(n_transcripts, -1, np.int64)
    tt.coding_length = np.zeros(n_transcripts, np.int64)

    exon_rows: Dict[int, int] = {}  # parse index -> row
    et = ExonTable()
    e_contig, e_start, e_end, e_strand, e_gene, e_transcript = [], [], [], [], [], []
    e_cstart, e_cend = [], []
    for ei, e in enumerate(exons):
        if e.removed:
            continue
        exon_rows[ei] = len(e_contig)
        e_contig.append(e.contig)
        e_start.append(e.start)
        e_end.append(e.end)
        e_strand.append(e.strand)
        e_gene.append(gene_rows[e.gene_key])
        e_transcript.append(transcript_rows[e.transcript_key])
        e_cstart.append(e.coding_region_start)
        e_cend.append(e.coding_region_end)
    n_exons = len(e_contig)
    et.contig = np.array(e_contig, np.int32)
    et.start = np.array(e_start, np.int64)
    et.end = np.array(e_end, np.int64)
    et.strand = np.array(e_strand, np.bool_)
    et.gene = np.array(e_gene, np.int64)
    et.transcript = np.array(e_transcript, np.int64)
    et.coding_region_start = np.array(e_cstart, np.int64)
    et.coding_region_end = np.array(e_cend, np.int64)
    et.prev_exon = np.full(n_exons, -1, np.int64)
    et.next_exon = np.full(n_exons, -1, np.int64)

    # prev/next links over surviving exons, per full transcript id
    for group in exons_by_full_transcript.values():
        rows = [exon_rows[ei] for ei in group if ei in exon_rows]
        for i, row in enumerate(rows):
            et.prev_exon[row] = rows[i - 1] if i > 0 else -1
            et.next_exon[row] = rows[i + 1] if i + 1 < len(rows) else -1

    # transcript first/last exon = min start / max end (annotation.cpp:331-337)
    for row in range(n_exons):
        t = et.transcript[row]
        fe = tt.first_exon[t]
        if fe < 0 or et.start[row] < et.start[fe]:
            tt.first_exon[t] = row
        le = tt.last_exon[t]
        if le < 0 or et.end[row] > et.end[le]:
            tt.last_exon[t] = row
        if et.coding_region_start[row] != -1 and et.coding_region_end[row] != -1:
            tt.coding_length[t] += et.coding_region_end[row] - et.coding_region_start[row] + 1

    annotation = Annotation(genes=gt, transcripts=tt, exons=et)
    # gene_name -> gene row; collisions resolved by last-wins (annotation.cpp:372-375)
    for row, name in enumerate(gt.name):
        annotation.gene_names[name] = row
    return annotation
