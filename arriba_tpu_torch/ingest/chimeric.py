"""Chimeric-alignment extraction from STAR-aligned SAM/BAM.

Reference parity: source/read_chimeric_alignments.cpp — a single linear pass
over alignment records: mate collation by read name, direct extraction of
supplementary and discordant records, SA-tag split reads, read-through
extraction (splitting gene-boundary-spanning introns into synthetic split
reads), ITD rescue realignment of clipped reads, pristine viral read
counting, and per-fragment coverage accumulation; followed by
remove_malformed_alignments() normalization.
"""

from __future__ import annotations

import copy
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import trace
from .._native_build import engine
from ..annotation.index import IntervalIndex, combine_annotations
from ..annotation.queries import (complement_strand_if,
                                  get_boundaries_of_biggest_gene)
from ..annotation.tables import GeneTable
from ..constants import (CIGAR_CONSUMES_REF, CIGAR_DIFF, CIGAR_HARD_CLIP,
                         CIGAR_MATCH, CIGAR_REF_SKIP, CIGAR_SOFT_CLIP,
                         FORWARD, MATE1, MATE2, REVERSE, SPLIT_READ,
                         STRANDEDNESS_NO, STRANDEDNESS_REVERSE, SUPPLEMENTARY,
                         cigar_op, cigar_oplen, make_cigar_word)
from ..contigs import ContigRegistry, is_interesting_contig
from ..io.bam import (BamRecord, FDUP, FPAIRED, FPROPER_PAIR, FREAD1,
                      FREVERSE, FSECONDARY, FSUPPLEMENTARY, FUNMAP, FMUNMAP,
                      open_alignment_file)
from ..io.fasta import Assembly
from ..model import Alignment, ChimericAlignments, Fragment
from .stats import Coverage

# the native data loader (C++): decode, collation, extraction and coverage
# in one scan; None for the pure-Python engine
_native = engine()


def _path_is_bam(path: str) -> bool:
    """BAM = gzip/BGZF wrapping the 'BAM\\1' magic; a gzipped SAM is gzip
    too, so sniff the decompressed leading bytes (read_chimeric_alignments
    .cpp defers this to htslib's format detection)."""
    try:
        with open(path, "rb") as fh:
            if fh.read(2) != b"\x1f\x8b":
                return False
    except OSError:
        return False
    import gzip
    import zlib
    try:
        with gzip.open(path, "rb") as gz:
            return gz.read(4) == b"BAM\x01"
    except (OSError, EOFError, zlib.error):
        # corrupt gzip: route to the BAM reader, whose corruption handling
        # raises the proper IOError
        return True


def _path_is_stream(path: str) -> bool:
    """True for readable non-regular-file inputs (a FIFO or /dev/stdin fed
    by a pipe): they can be consumed only once, so header sniffing and the
    record scan must share a single open stream (the reference lets htslib
    stream `STAR ... | arriba -x /dev/stdin` the same way,
    read_chimeric_alignments.cpp:560)."""
    import stat as _stat
    try:
        mode = os.stat(path).st_mode
    except OSError:
        return False
    return (_stat.S_ISFIFO(mode) or _stat.S_ISCHR(mode)
            or _stat.S_ISSOCK(mode))


def _native_loader_supported(path: str) -> bool:
    """True when the input is a regular SAM/SAM.gz/BAM file (the formats the
    native loader parses; it sniffs BAM vs SAM after decompression)."""
    if not os.path.isfile(path):
        return False
    try:
        with open(path, "rb") as fh:
            magic = fh.read(4)
    except OSError:
        return False
    return magic != b"CRAM"


CLIP_NONE = 0
CLIP_START = 1
CLIP_END = 2


def get_strand(record: BamRecord) -> bool:
    return REVERSE if record.flag & FREVERSE else FORWARD


def find_spanning_intron(record: BamRecord, gene1_end: int, gene2_start: int) -> Tuple[bool, int, int]:
    """read_chimeric_alignments.cpp:19-41 — find a REF_SKIP spanning a gene
    boundary; returns (found, cigar_op_index, read_pos)."""
    if record.n_cigar < 3:
        return False, 0, 0
    before = record.pos
    for i in range(record.n_cigar):
        word = int(record.cigar[i])
        op = cigar_op(word)
        op_length = cigar_oplen(word) if (CIGAR_CONSUMES_REF >> op) & 1 else 0
        after = before + op_length
        if op == CIGAR_REF_SKIP and (
            (before <= gene1_end < after) or (before < gene2_start <= after)
        ):
            return True, i, record.cigar2qlen(i)
        before = after
    return False, 0, 0


def add_chimeric_alignment(mates: Fragment, record: BamRecord,
                           is_supplementary: bool = False, cigar_op_idx: int = 0,
                           clip: int = CLIP_NONE) -> None:
    """read_chimeric_alignments.cpp:50-91 — convert a record into an
    alignment_t, optionally rewriting the CIGAR for read-through splitting."""
    mates.single_end = not (record.flag & FPAIRED)
    mates.duplicate = mates.duplicate or bool(record.flag & FDUP)
    alignment = Alignment()
    mates.append(alignment)
    alignment.strand = get_strand(record)
    alignment.first_in_pair = bool(record.flag & FREAD1)
    alignment.contig = record.tid
    alignment.supplementary = is_supplementary
    if not is_supplementary:
        alignment.sequence = record.seq

    cigar = record.cigar
    if clip == CLIP_START:
        alignment.start = record.pos + record.cigar2rlen(cigar_op_idx)
        alignment.end = record.endpos() - 1
        clip_type = CIGAR_HARD_CLIP if cigar_op(int(cigar[0])) == CIGAR_HARD_CLIP else CIGAR_SOFT_CLIP
        new_cigar = np.empty(record.n_cigar - cigar_op_idx + 1, np.uint32)
        new_cigar[0] = make_cigar_word(clip_type, record.cigar2qlen(cigar_op_idx))
        new_cigar[1:] = cigar[cigar_op_idx:]
        alignment.cigar = new_cigar
    elif clip == CLIP_END:
        alignment.start = record.pos
        alignment.end = record.pos + record.cigar2rlen(cigar_op_idx + 1) - 1
        clip_type = CIGAR_HARD_CLIP if cigar_op(int(cigar[-1])) == CIGAR_HARD_CLIP else CIGAR_SOFT_CLIP
        new_cigar = np.empty(cigar_op_idx + 2, np.uint32)
        new_cigar[:cigar_op_idx + 1] = cigar[:cigar_op_idx + 1]
        new_cigar[cigar_op_idx + 1] = make_cigar_word(
            clip_type, record.l_qseq - record.cigar2qlen(cigar_op_idx + 1))
        alignment.cigar = new_cigar
    else:
        alignment.start = record.pos
        alignment.end = record.endpos() - 1
        alignment.cigar = cigar.copy()


def extract_read_through_alignment(chimeric_alignments: ChimericAlignments,
                                   read_name: str, forward_mate: Optional[BamRecord],
                                   reverse_mate: Optional[BamRecord],
                                   gene_index: IntervalIndex) -> bool:
    """read_chimeric_alignments.cpp:93-193."""
    if forward_mate is not None and get_strand(forward_mate) == REVERSE:
        forward_mate, reverse_mate = reverse_mate, forward_mate

    if forward_mate is not None:
        forward_genes = gene_index.point_query(forward_mate.tid, forward_mate.pos)
    else:
        forward_genes = gene_index.point_query(reverse_mate.tid, reverse_mate.pos)
    if reverse_mate is not None:
        reverse_genes = gene_index.point_query(reverse_mate.tid, reverse_mate.endpos())
    else:
        reverse_genes = gene_index.point_query(forward_mate.tid, forward_mate.endpos())

    common_genes = combine_annotations(forward_genes, reverse_genes, make_union=False)
    if len(common_genes) != 0 or (len(forward_genes) == 0 and len(reverse_genes) == 0):
        return False

    # boundaries of the biggest overlapped genes (genes table accessed via index)
    forward_gene_start, forward_gene_end = _gene_hull(forward_genes, gene_index)
    reverse_gene_start, reverse_gene_end = _gene_hull(reverse_genes, gene_index)
    if forward_gene_end == -1:
        forward_gene_end = reverse_gene_start - 1
    if reverse_gene_start == -1:
        reverse_gene_start = forward_gene_end + 1

    fwd_has_intron, fwd_op, fwd_read_pos = (False, 0, 0) if forward_mate is None else \
        find_spanning_intron(forward_mate, forward_gene_end, reverse_gene_start)
    rev_has_intron, rev_op, rev_read_pos = (False, 0, 0) if reverse_mate is None else \
        find_spanning_intron(reverse_mate, forward_gene_end, reverse_gene_start)

    if fwd_has_intron and (not rev_has_intron or fwd_read_pos < reverse_mate.l_qseq - rev_read_pos):
        if read_name not in chimeric_alignments:
            mates = Fragment()
            chimeric_alignments[read_name] = mates
            add_chimeric_alignment(mates, forward_mate, False, fwd_op + 1, CLIP_START)
            add_chimeric_alignment(mates, forward_mate, True, fwd_op - 1, CLIP_END)
            if reverse_mate is not None:
                if rev_has_intron:
                    add_chimeric_alignment(mates, reverse_mate, False, rev_op + 1, CLIP_START)
                else:
                    add_chimeric_alignment(mates, reverse_mate)
            return True
    elif rev_has_intron:
        if read_name not in chimeric_alignments:
            mates = Fragment()
            chimeric_alignments[read_name] = mates
            add_chimeric_alignment(mates, reverse_mate, True, rev_op + 1, CLIP_START)
            add_chimeric_alignment(mates, reverse_mate, False, rev_op - 1, CLIP_END)
            if forward_mate is not None:
                if fwd_has_intron:
                    add_chimeric_alignment(mates, forward_mate, False, fwd_op - 1, CLIP_END)
                else:
                    add_chimeric_alignment(mates, forward_mate)
            return True
    elif (forward_mate is not None and reverse_mate is not None
          and reverse_mate.pos >= reverse_gene_start
          and forward_mate.endpos() <= forward_gene_end):
        if read_name not in chimeric_alignments:
            mates = Fragment()
            chimeric_alignments[read_name] = mates
            add_chimeric_alignment(mates, forward_mate)
            add_chimeric_alignment(mates, reverse_mate)
        return True

    return False


# the gene hull needs gene start/end; the IntervalIndex stores only feature
# rows, so the caller provides the gene table through a module-level binding
# set per read_chimeric_alignments invocation
_GENES: GeneTable | None = None


def _gene_hull(gene_set: np.ndarray, gene_index: IntervalIndex) -> Tuple[int, int]:
    return get_boundaries_of_biggest_gene(gene_set, _GENES)


def clipped_sequence_is_adapter(mate1: Optional[BamRecord], mate2: Optional[BamRecord]) -> bool:
    """read_chimeric_alignments.cpp:197-211."""
    if mate1 is None or mate2 is None:
        return False
    if mate1.pos != mate2.pos:
        return False
    if (get_strand(mate1) == REVERSE and mate1.n_cigar and cigar_op(int(mate1.cigar[0])) == CIGAR_SOFT_CLIP
            and get_strand(mate2) == FORWARD and mate2.n_cigar and cigar_op(int(mate2.cigar[-1])) == CIGAR_SOFT_CLIP
            and cigar_oplen(int(mate1.cigar[0])) == cigar_oplen(int(mate2.cigar[-1]))):
        return True
    if (get_strand(mate2) == REVERSE and mate2.n_cigar and cigar_op(int(mate2.cigar[0])) == CIGAR_SOFT_CLIP
            and get_strand(mate1) == FORWARD and mate1.n_cigar and cigar_op(int(mate1.cigar[-1])) == CIGAR_SOFT_CLIP
            and cigar_oplen(int(mate2.cigar[0])) == cigar_oplen(int(mate1.cigar[-1]))):
        return True
    return False


def is_tandem_duplication(record: Optional[BamRecord], assembly: Assembly,
                          max_itd_length: int) -> Optional[Alignment]:
    """read_chimeric_alignments.cpp:215-336 — brute-force alignment of the
    clipped segment within an ITD-sized window; returns the tandem alignment
    or None."""
    min_clipped_length = 12
    min_duplication_length = 9
    max_duplication_length = max_itd_length
    max_mismatches = 1
    max_non_template_bases = 6
    min_alignment_length = 15

    if record is None or record.n_cigar == 0:
        return None

    clipped_len = 0
    clipped_pos = 0
    clipped_start = True
    direction = 1
    window_start = window_end = extended_read_start = 0
    first = int(record.cigar[0])
    last = int(record.cigar[-1])
    if cigar_op(first) == CIGAR_SOFT_CLIP and cigar_oplen(first) >= min_clipped_length:
        clipped_len = cigar_oplen(first)
        clipped_pos = 0
        direction = -1
        window_start = record.pos + min_duplication_length - clipped_len
        window_end = record.pos + max_duplication_length - clipped_len
        extended_read_start = record.pos - clipped_len
        clipped_start = True
    if cigar_op(last) == CIGAR_SOFT_CLIP and cigar_oplen(last) >= max(min_clipped_length, clipped_len):
        clipped_len = cigar_oplen(last)
        clipped_pos = record.l_qseq - clipped_len
        direction = 1
        window_start = record.endpos() - max_duplication_length
        window_end = record.endpos() - min_duplication_length
        extended_read_start = record.endpos()
        clipped_start = False
    if clipped_len == 0:
        return None

    if record.tid not in assembly:
        return None
    # the clipped slice must exist in the read sequence: a record with
    # SEQ '*' (l_qseq 0) or an inconsistent CIGAR cannot be scanned (the
    # native decoder rejects the same shapes, native/ingest.cpp)
    if clipped_pos < 0 or clipped_pos + clipped_len > len(record.seq):
        return None
    contig_sequence = assembly[record.tid]
    if (window_end + max_duplication_length + clipped_len + 1 >= len(contig_sequence)
            or window_start <= max_duplication_length + clipped_len + 1):
        return None

    clipped = record.seq[clipped_pos:clipped_pos + clipped_len]
    clipped_arr = np.frombuffer(clipped.encode("ascii"), np.uint8)

    # premature-clipping check: does the clipped segment extend linearly?
    lo = extended_read_start
    ref_window = contig_sequence[max(lo, 0):lo + clipped_len]
    pad_left = max(0, -lo)
    matches = 0
    usable = len(ref_window)
    if usable > 0:
        matches = int(np.count_nonzero(
            ref_window[:clipped_len - pad_left] == clipped_arr[pad_left:pad_left + usable]))
    if matches / clipped_len >= 0.7:
        return None

    hit = None
    if _native is not None:
        hit = _native.tandem_scan(clipped.encode("latin-1"), contig_sequence,
                                  window_start, window_end, direction)
    else:
        for contig_pos in range(window_start, window_end + 1):
            window_seq = contig_sequence[contig_pos:contig_pos + clipped_len]
            eq = window_seq == clipped_arr
            matches = 0
            mismatches = 0
            aln_start = len(contig_sequence)
            aln_end = -1
            for i in range(clipped_len):
                read_pos = i if direction == 1 else clipped_len - 1 - i
                if eq[read_pos]:
                    matches += 1
                    if contig_pos + read_pos < aln_start:
                        aln_start = contig_pos + read_pos
                    if contig_pos + read_pos > aln_end:
                        aln_end = contig_pos + read_pos
                elif i >= max_non_template_bases:
                    mismatches += 1
                    if mismatches > max_mismatches:
                        break
            if matches >= min_alignment_length or matches + mismatches == clipped_len:
                hit = (contig_pos, aln_start, aln_end)
                break

    if hit is not None:
        contig_pos, aln_start, aln_end = hit
        tandem = Alignment()
        tandem.start = aln_start
        tandem.end = aln_end
        tandem.strand = get_strand(record)
        tandem.first_in_pair = bool(record.flag & FREAD1)
        tandem.contig = record.tid
        tandem.supplementary = (not (record.flag & FPAIRED)
                                or (clipped_start and get_strand(record) == FORWARD)
                                or (not clipped_start and get_strand(record) == REVERSE))
        if not tandem.supplementary:
            tandem.sequence = record.seq
        clip_left = 0 if clipped_start else record.l_qseq - clipped_len
        clip_right = record.l_qseq - clipped_len if clipped_start else 0
        if aln_start > contig_pos:
            clip_left += aln_start - contig_pos
        if aln_end < contig_pos + clipped_len - 1:
            clip_right += contig_pos + clipped_len - 1 - aln_end
        cigar: List[int] = []
        if clip_left > 0:
            cigar.append(make_cigar_word(CIGAR_SOFT_CLIP, clip_left))
        cigar.append(make_cigar_word(CIGAR_MATCH, aln_end - aln_start + 1))
        if clip_right > 0:
            cigar.append(make_cigar_word(CIGAR_SOFT_CLIP, clip_right))
        tandem.cigar = np.array(cigar, np.uint32)
        return tandem

    return None


def disjoin_split_read_segments(split_read: Alignment, supplementary: Alignment) -> bool:
    """read_chimeric_alignments.cpp:340-373 — trim DRAGEN-style overlapping
    split segments."""
    min_remaining = 10
    clipped_split = split_read.preclipping() if split_read.strand == FORWARD else split_read.postclipping()
    clipped_supp = supplementary.postclipping() if supplementary.strand == FORWARD else supplementary.preclipping()
    overlap = len(split_read.sequence) - clipped_split - clipped_supp
    if overlap <= 0:
        return True

    clipped_idx = len(supplementary.cigar) - 1 if supplementary.strand == FORWARD else 0
    matching_idx = clipped_idx - 1 if supplementary.strand == FORWARD else 1
    if (len(supplementary.cigar) < 2
            or cigar_op(int(supplementary.cigar[matching_idx])) != CIGAR_MATCH
            or cigar_oplen(int(supplementary.cigar[matching_idx])) < overlap + min_remaining):
        return False

    supplementary.cigar[clipped_idx] = make_cigar_word(
        cigar_op(int(supplementary.cigar[clipped_idx])),
        cigar_oplen(int(supplementary.cigar[clipped_idx])) + overlap)
    supplementary.cigar[matching_idx] = make_cigar_word(
        cigar_op(int(supplementary.cigar[matching_idx])),
        cigar_oplen(int(supplementary.cigar[matching_idx])) - overlap)
    if supplementary.strand == FORWARD:
        supplementary.end -= overlap
    else:
        supplementary.start += overlap
    return True


def _to_soft_clip(cigar: np.ndarray, idx: int) -> None:
    cigar[idx] = make_cigar_word(CIGAR_SOFT_CLIP, cigar_oplen(int(cigar[idx])))


def remove_malformed_alignments(chimeric_alignments: ChimericAlignments) -> int:
    """read_chimeric_alignments.cpp:377-506 — normalize single-end fragments
    into a pseudo-paired-end layout, enforce exactly one supplementary, and
    reject hard-clipped anchors."""
    malformed: List[str] = []
    for read_name, mates in chimeric_alignments.items():
        ok = _normalize_fragment(mates)
        if not ok:
            malformed.append(read_name)
    for read_name in malformed:
        del chimeric_alignments[read_name]
    return len(malformed)


def _normalize_fragment(mates: Fragment) -> bool:
    if mates.single_end:
        if not (len(mates) == 2 and (mates[MATE1].supplementary != mates[MATE2].supplementary)):
            return False
        # simulate paired-end: the shorter anchor becomes SUPPLEMENTARY, the
        # longer becomes SPLIT_READ, and MATE1 is a copy of the split read
        if mates[MATE1].end - mates[MATE1].start > mates[MATE2].end - mates[MATE2].start:
            mates.append(copy.deepcopy(mates[MATE2]))
            mates[MATE2] = copy.deepcopy(mates[MATE1])
        else:
            mates.append(copy.deepcopy(mates[MATE1]))
            mates[MATE1] = copy.deepcopy(mates[MATE2])

        if not mates[MATE1].supplementary:
            mates[SPLIT_READ].sequence = mates[MATE1].sequence
        elif not mates[SPLIT_READ].supplementary:
            mates[MATE1].sequence = mates[SPLIT_READ].sequence
        else:
            mates[MATE1].sequence = mates[SUPPLEMENTARY].sequence
            mates[SPLIT_READ].sequence = mates[SUPPLEMENTARY].sequence
        mates[SUPPLEMENTARY].sequence = ""

        for m in (mates[MATE1], mates[SPLIT_READ]):
            if len(m.cigar):
                if cigar_op(int(m.cigar[0])) == CIGAR_HARD_CLIP:
                    _to_soft_clip(m.cigar, 0)
                if cigar_op(int(m.cigar[-1])) == CIGAR_HARD_CLIP:
                    _to_soft_clip(m.cigar, len(m.cigar) - 1)

        mates[SUPPLEMENTARY].supplementary = True
        mates[MATE1].supplementary = False
        mates[SPLIT_READ].supplementary = False

        split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
        same_strand = split.strand == supp.strand
        left_anchor = (len(split.sequence) - split.preclipping()
                       - (supp.postclipping() if same_strand else supp.preclipping()))
        right_anchor = (len(split.sequence) - split.postclipping()
                        - (supp.preclipping() if same_strand else supp.postclipping()))
        if left_anchor < right_anchor:
            flip_mate1_strand = split.strand == FORWARD
        else:
            flip_mate1_strand = split.strand == REVERSE
        mates[MATE1].strand = complement_strand_if(mates[MATE1].strand, flip_mate1_strand)
        mates[SPLIT_READ].strand = complement_strand_if(mates[SPLIT_READ].strand, not flip_mate1_strand)
        mates[SUPPLEMENTARY].strand = complement_strand_if(mates[SUPPLEMENTARY].strand, not flip_mate1_strand)

        mates[MATE1].first_in_pair = not flip_mate1_strand
        mates[SPLIT_READ].first_in_pair = flip_mate1_strand
        mates[SUPPLEMENTARY].first_in_pair = flip_mate1_strand

        if not disjoin_split_read_segments(mates[SPLIT_READ], mates[SUPPLEMENTARY]):
            return False

    else:  # paired-end
        if len(mates) == 3:
            if mates[MATE1].supplementary:
                mates[MATE1], mates[SUPPLEMENTARY] = mates[SUPPLEMENTARY], mates[MATE1]
            elif mates[MATE2].supplementary:
                mates[MATE2], mates[SUPPLEMENTARY] = mates[SUPPLEMENTARY], mates[MATE2]
            if mates[SPLIT_READ].first_in_pair != mates[SUPPLEMENTARY].first_in_pair:
                mates[MATE1], mates[MATE2] = mates[MATE2], mates[MATE1]
            if (mates[MATE1].supplementary or mates[SPLIT_READ].supplementary
                    or not mates[SUPPLEMENTARY].supplementary):
                return False
            if (mates[MATE1].contig != mates[SPLIT_READ].contig
                    or mates[MATE1].strand == mates[SPLIT_READ].strand):
                return False
            if not disjoin_split_read_segments(mates[SPLIT_READ], mates[SUPPLEMENTARY]):
                return False
        elif len(mates) == 2:
            if mates[MATE1].supplementary or mates[MATE2].supplementary:
                return False
        else:
            return False

    for m in (mates[MATE1], mates[MATE2]):
        if len(m.cigar) == 0:
            return False
        if (cigar_op(int(m.cigar[0])) == CIGAR_HARD_CLIP
                or cigar_op(int(m.cigar[-1])) == CIGAR_HARD_CLIP):
            return False
    return True


def is_clipped_at_correct_end(record: BamRecord) -> bool:
    """read_chimeric_alignments.cpp:511-522."""
    if not (record.flag & FPAIRED):
        return True
    if record.n_cigar == 0:
        return False
    if record.flag & FSUPPLEMENTARY:
        clipped_end = record.n_cigar - 1 if get_strand(record) == FORWARD else 0
    else:
        clipped_end = 0 if get_strand(record) == FORWARD else record.n_cigar - 1
    op = cigar_op(int(record.cigar[clipped_end]))
    return op in (CIGAR_SOFT_CLIP, CIGAR_HARD_CLIP)


def is_pristine_alignment(record: BamRecord) -> bool:
    """read_chimeric_alignments.cpp:526-558 — no indels/clips, and no run of
    >=8 dimer/trimer tandem repeats."""
    for word in record.cigar:
        op = cigar_op(int(word))
        if op not in (CIGAR_REF_SKIP, CIGAR_MATCH, CIGAR_DIFF):
            return False
    sequence = record.seq
    repeat = 0
    count = 1
    i = 2
    while i + 2 < len(sequence):
        if sequence[i] == sequence[repeat] and sequence[i + 1] == sequence[repeat + 1]:
            count += 1
        elif sequence[i + 1] == sequence[repeat + 1] and sequence[i + 2] == sequence[repeat + 2]:
            count += 1
            i += 1
        else:
            count = 1
            repeat = i
        if count >= 8:
            return False
        i += 2
    return True


def _build_fragment(frag_flags: int, filter_id: int, mate_rows) -> Fragment:
    """One Fragment from the retained store's per-mate export rows
    (native/extract.cpp extract_export_fragment)."""
    mates = Fragment.__new__(Fragment)
    mates.single_end = bool(frag_flags & 1)
    mates.duplicate = bool(frag_flags & 2)
    mates.multimapper = bool(frag_flags & 4)
    mates.filter = filter_id
    new_alignment = Alignment.__new__
    from ..model import EMPTY_GENES
    for flags, contig, start, end, cigar_b, seq_b, genes_b in mate_rows:
        alignment = new_alignment(Alignment)
        alignment.__dict__ = {
            "supplementary": bool(flags & 1),
            "first_in_pair": bool(flags & 2),
            "strand": bool(flags & 4),
            "predicted_strand": bool(flags & 8),
            "predicted_strand_ambiguous": bool(flags & 16),
            "exonic": bool(flags & 32),
            "contig": contig,
            "start": start,
            "end": end,
            "cigar": np.frombuffer(bytearray(cigar_b), np.uint32),
            "sequence": seq_b.decode("latin-1"),
            "genes": (np.frombuffer(genes_b, np.int64) if genes_b
                      else EMPTY_GENES),
        }
        mates.append(alignment)
    return mates


class _RowIndexView:
    """Read-only name -> store-row mapping over LazyChimericAlignments:
    pre-materialization rows live as the dict values themselves."""

    __slots__ = ("_d",)

    def __init__(self, d) -> None:
        self._d = d

    def __getitem__(self, name: str) -> int:
        value = dict.__getitem__(self._d, name)
        return value if type(value) is int else self._d._overlay_rows[name]

    def __contains__(self, name: str) -> bool:
        return dict.__contains__(self._d, name)


class LazyChimericAlignments(dict):
    """Read-name -> Fragment mapping over the retained native extraction
    store (native/extract.cpp). Keys are in store (byte-sorted) order;
    Fragment values materialize on demand, so the default native pipeline
    builds Python objects only for the reads the output writer touches.
    Fallback paths that iterate every fragment (values()/items()) trigger a
    one-shot bulk materialization."""

    is_lazy_native = True

    def __init__(self, native, names, multimapper_count: int) -> None:
        super().__init__()
        self.native = native
        self.multimapper_count = multimapper_count
        # a not-yet-materialized entry stores its store row as an int (one
        # dict instead of a names dict plus a separate index dict); rows of
        # individually materialized entries move to the overlay
        self._overlay_rows: Dict[str, int] = {}
        if names is None:
            native.extract_fill_names(self)
        else:
            for i, name in enumerate(names):
                dict.__setitem__(self, name, i)
        self._materialized = False

    @property
    def _index(self):
        """name -> store row view for the native writer paths."""
        return _RowIndexView(self)

    def __getitem__(self, name: str) -> Fragment:
        value = dict.__getitem__(self, name)
        if type(value) is int:
            frag_flags, filter_id, mate_rows = \
                self.native.extract_export_fragment(value)
            self._overlay_rows[name] = value
            value = _build_fragment(frag_flags, filter_id, mate_rows)
            dict.__setitem__(self, name, value)
        return value

    def get(self, name, default=None):
        if dict.__contains__(self, name):
            return self[name]
        return default

    def values(self):
        self.ensure_materialized()
        return dict.values(self)

    def items(self):
        self.ensure_materialized()
        return dict.items(self)

    def ensure_materialized(self) -> None:
        """Bulk-materialize every fragment (fallback paths only)."""
        if self._materialized:
            return
        self._materialized = True
        (names_blob, name_offsets_b, frag_offsets_b, frag_flags_b,
         frag_filter_b, contig_b, start_b, end_b, flags_b, cigar_offsets_b,
         cigar_words_b, (seq_offsets_b, seq_blob, genes_offsets_b,
                         genes_items_b), _n) = self.native.extract_export_all()
        names = names_blob.decode("latin-1")
        name_offsets = np.frombuffer(name_offsets_b, np.int64).tolist()
        frag_offsets = np.frombuffer(frag_offsets_b, np.int64).tolist()
        frag_flags = np.frombuffer(frag_flags_b, np.int64).tolist()
        frag_filter = np.frombuffer(frag_filter_b, np.int64).tolist()
        contig = np.frombuffer(contig_b, np.int64).tolist()
        start = np.frombuffer(start_b, np.int64).tolist()
        end = np.frombuffer(end_b, np.int64).tolist()
        flags = np.frombuffer(flags_b, np.int64).tolist()
        cigar_offsets = np.frombuffer(cigar_offsets_b, np.int64).tolist()
        cigar_words = np.frombuffer(bytearray(cigar_words_b), np.uint32)
        seq_offsets = np.frombuffer(seq_offsets_b, np.int64).tolist()
        sequences = seq_blob.decode("latin-1")
        genes_offsets = np.frombuffer(genes_offsets_b, np.int64).tolist()
        genes_items = np.frombuffer(genes_items_b, np.int64)

        from ..model import EMPTY_GENES
        new_alignment = Alignment.__new__
        new_fragment = Fragment.__new__
        for f in range(len(frag_flags)):
            name = names[name_offsets[f]:name_offsets[f + 1]]
            if type(dict.__getitem__(self, name)) is not int:
                continue  # keep the already-materialized object (identity)
            mates = new_fragment(Fragment)
            mates.single_end = bool(frag_flags[f] & 1)
            mates.duplicate = bool(frag_flags[f] & 2)
            mates.multimapper = bool(frag_flags[f] & 4)
            mates.filter = frag_filter[f]
            for row in range(frag_offsets[f], frag_offsets[f + 1]):
                alignment = new_alignment(Alignment)
                row_flags = flags[row]
                genes = genes_items[genes_offsets[row]:genes_offsets[row + 1]]
                alignment.__dict__ = {
                    "supplementary": bool(row_flags & 1),
                    "first_in_pair": bool(row_flags & 2),
                    "strand": bool(row_flags & 4),
                    "predicted_strand": bool(row_flags & 8),
                    "predicted_strand_ambiguous": bool(row_flags & 16),
                    "exonic": bool(row_flags & 32),
                    "contig": contig[row],
                    "start": start[row],
                    "end": end[row],
                    "cigar": cigar_words[cigar_offsets[row]:cigar_offsets[row + 1]],
                    "sequence": sequences[seq_offsets[row]:seq_offsets[row + 1]],
                    "genes": genes if len(genes) else EMPTY_GENES,
                }
                mates.append(alignment)
            dict.__setitem__(self, name, mates)


def _materialize_fragments(chimeric_alignments: ChimericAlignments,
                           arrays: tuple, seq_part: tuple) -> None:
    """Build Fragment/Alignment objects from the columnar output of the
    native extraction (native/ingest.cpp scan_sam extraction mode)."""
    # empty arrays arrive as None (Py_BuildValue "y#" with a null pointer)
    (names_blob, name_offsets_b, frag_offsets_b, frag_flags_b, contig_b,
     start_b, end_b, flags_b, cigar_offsets_b, cigar_words_b) = (
        value or b"" for value in arrays)
    seq_offsets_b, seq_blob = (value or b"" for value in seq_part)

    names = names_blob.decode("latin-1")
    name_offsets = np.frombuffer(name_offsets_b, np.int64).tolist()
    frag_offsets = np.frombuffer(frag_offsets_b, np.int64).tolist()
    frag_flags = np.frombuffer(frag_flags_b, np.int64).tolist()
    contig = np.frombuffer(contig_b, np.int64).tolist()
    start = np.frombuffer(start_b, np.int64).tolist()
    end = np.frombuffer(end_b, np.int64).tolist()
    flags = np.frombuffer(flags_b, np.int64).tolist()
    cigar_offsets = np.frombuffer(cigar_offsets_b, np.int64).tolist()
    # writable backing store: alignments keep views into it
    cigar_words = np.frombuffer(bytearray(cigar_words_b), np.uint32)
    seq_offsets = np.frombuffer(seq_offsets_b, np.int64).tolist()
    sequences = seq_blob.decode("latin-1")

    from ..constants import FILTER_NONE
    from ..model import EMPTY_GENES
    new_alignment = Alignment.__new__
    new_fragment = Fragment.__new__
    for f in range(len(frag_flags)):
        # skip Fragment.__init__: list.__new__ already yields an empty list
        mates = new_fragment(Fragment)
        fragment_flags = frag_flags[f]
        mates.single_end = bool(fragment_flags & 1)
        mates.multimapper = False
        mates.duplicate = bool(fragment_flags & 2)
        mates.filter = FILTER_NONE
        for row in range(frag_offsets[f], frag_offsets[f + 1]):
            alignment = new_alignment(Alignment)
            alignment_flags = flags[row]
            alignment.__dict__ = {
                "supplementary": bool(alignment_flags & 1),
                "first_in_pair": bool(alignment_flags & 2),
                "exonic": False,
                "strand": bool(alignment_flags & 4),
                "predicted_strand": FORWARD,
                "predicted_strand_ambiguous": True,
                "contig": contig[row],
                "start": start[row],
                "end": end[row],
                "cigar": cigar_words[cigar_offsets[row]:cigar_offsets[row + 1]],
                "sequence": sequences[seq_offsets[row]:seq_offsets[row + 1]],
                "genes": EMPTY_GENES,
            }
            mates.append(alignment)
        chimeric_alignments[names[name_offsets[f]:name_offsets[f + 1]]] = mates


def _scan(path, stream_native, name_to_tid, boundaries, interesting_per_tid,
          viral_per_tid, external_duplicate_marking, threads, planes,
          extract_tables):
    """The native extraction scan of path (resumed on a stream that
    scan_open has read the header of)."""
    return _native.scan_sam(
        path, name_to_tid, boundaries, bytes(interesting_per_tid),
        bytes(viral_per_tid), planes, external_duplicate_marking, threads,
        extract_tables, 1 if stream_native else 0)


def read_chimeric_alignments(path: str, assembly: Assembly,
                             chimeric_alignments: ChimericAlignments,
                             contigs: ContigRegistry,
                             interesting_contigs: str, viral_contigs: str,
                             genes: GeneTable, gene_index: IntervalIndex,
                             coverage: Coverage,
                             mapped_viral_reads_by_contig: List[int],
                             separate_chimeric_bam_file: bool,
                             is_rna_bam_file: bool,
                             external_duplicate_marking: bool,
                             max_itd_length: int,
                             threads: int = 1,
                             retain_native: bool = False) -> Tuple[int, int]:
    """read_chimeric_alignments.cpp:560-773 — returns (n_fragments,
    mapped_reads delta)."""
    global _GENES
    _GENES = genes

    is_stream = _path_is_stream(path)
    stream_native = (is_stream and _native is not None
                     and is_rna_bam_file and not separate_chimeric_bam_file)
    if is_stream and not stream_native:
        # a single-consumer stream the native streaming scan cannot take
        # (pure-Python install, or the separate-chimeric path): spool it to
        # a temporary file and run the regular seekable path on that
        import shutil
        import tempfile
        with open(path, "rb") as src, tempfile.NamedTemporaryFile(
                prefix="arriba_tpu_stream_", delete=False) as spool:
            shutil.copyfileobj(src, spool, 1 << 20)
            spooled = spool.name
        try:
            return read_chimeric_alignments(
                spooled, assembly, chimeric_alignments, contigs,
                interesting_contigs, viral_contigs, genes, gene_index,
                coverage, mapped_viral_reads_by_contig,
                separate_chimeric_bam_file, is_rna_bam_file,
                external_duplicate_marking, max_itd_length, threads,
                retain_native)
        finally:
            os.unlink(spooled)

    bam_header = None  # a regular BAM file's header bytes (ingest/card.py)
    native_eligible = stream_native or (
        _native is not None and is_rna_bam_file
        and not separate_chimeric_bam_file
        and _native_loader_supported(path))
    if stream_native:
        # consume only the header from the stream; scan_sam(resume=1) below
        # continues from where scan_open() left the pipe positioned
        kind, header_text, target_names, target_lengths = \
            _native.scan_open(path)
        if kind == 2:
            raise RuntimeError(
                f"CRAM input cannot be read from a pipe ('{path}'); "
                "provide a regular file")
        from ..io.bam import SamHeader
        header = SamHeader(target_names=list(target_names),
                           target_lengths=list(target_lengths),
                           text=header_text)
    elif native_eligible and _path_is_bam(path):
        from ..io.bam import read_bam_header
        header = read_bam_header(path)
        bam_header = header.raw
    elif native_eligible:
        # SAM/SAM.gz on the native path: only the @ header lines are needed
        # here (the native scan re-reads the whole file itself) — a full
        # open_alignment_file would parse the header twice and leave an
        # unconsumed generator holding the file handle
        from ..io.bam import SamHeader
        from ..io.compressed import iter_lines
        header = SamHeader()
        for line in iter_lines(path):
            if not line.startswith("@"):
                break
            header.text += line + "\n"
            if line.startswith("@SQ"):
                name = length = None
                for field in line.split("\t")[1:]:
                    if field.startswith("SN:"):
                        name = field[3:]
                    elif field.startswith("LN:"):
                        length = int(field[3:])
                if name is not None:
                    header.target_names.append(name)
                    header.target_lengths.append(length or 0)
    else:
        header, records = open_alignment_file(path, reference_by_name={
            contigs.names[cid]: seq for cid, seq in assembly.items()})

    # register contigs from the header; map tid -> our contig ids
    tid_to_contig = []
    for name in header.target_names:
        tid_to_contig.append(contigs.add(name))
    interesting_tids = [False] * len(contigs)
    if is_rna_bam_file:
        for tid, cid in enumerate(tid_to_contig):
            interesting_tids[cid] = is_interesting_contig(header.target_names[tid], interesting_contigs)
    coverage.resize(len(contigs), assembly)
    coverage.bind_native()

    for cid, name in enumerate(contigs.names):
        if cid not in assembly and is_interesting_contig(name, interesting_contigs):
            raise RuntimeError(f"could not find sequence of contig '{name}'")

    viral_contigs_mask = contigs.interesting_mask(viral_contigs)
    while len(mapped_viral_reads_by_contig) < len(contigs):
        mapped_viral_reads_by_contig.append(0)

    if native_eligible:
        # the C++ loader runs the entire extraction loop (ITD rescue,
        # read-through splitting, SA split reads, viral counting, coverage)
        # and the malformed-alignment normalization, emitting fragments as
        # columnar arrays
        name_to_tid = {name: tid for tid, name in enumerate(header.target_names)}
        boundaries = []
        planes = []
        interesting_per_tid = bytearray(len(tid_to_contig))
        viral_per_tid = bytearray(len(tid_to_contig))
        gene_offsets = []
        gene_items = []
        for tid, cid in enumerate(tid_to_contig):
            if cid < gene_index.n_contigs:
                boundaries.append(np.ascontiguousarray(
                    gene_index.boundaries[cid], np.int64).tobytes())
                gene_offsets.append(np.ascontiguousarray(
                    gene_index.offsets[cid], np.int64).tobytes())
                gene_items.append(np.ascontiguousarray(
                    gene_index.items[cid], np.int64).tobytes())
            else:
                boundaries.append(b"")
                gene_offsets.append(np.zeros(1, np.int64).tobytes())
                gene_items.append(b"")
            if cid < len(coverage.coverage) and len(coverage.coverage[cid]):
                planes.append((coverage.coverage[cid],
                               coverage.fragment_starts[cid].view(np.uint8),
                               coverage.fragment_ends[cid].view(np.uint8)))
            else:
                planes.append(None)
            interesting_per_tid[tid] = 1 if interesting_tids[cid] else 0
            viral_per_tid[tid] = 1 if viral_contigs_mask[cid] else 0
        assembly_list = [assembly.get(cid) for cid in tid_to_contig]
        # retained mode: the native store keeps the fragments (sorted,
        # multimappers marked); Python receives names only and fragments
        # materialize lazily. Only usable when this call owns the whole
        # dict (no prior chimeric file merged in).
        retain = retain_native and not chimeric_alignments
        extract_tables = (
            gene_offsets, gene_items,
            np.ascontiguousarray(genes.start, np.int64).tobytes(),
            np.ascontiguousarray(genes.end, np.int64).tobytes(),
            assembly_list,
            np.array(tid_to_contig, np.int64).tobytes(),
            int(max_itd_length), 1 if retain else 0)
        # a regular-file BGZF BAM: the card takes its background of boring
        # proper pairs (ingest/card.py) and the scan reads the residue; the
        # pass's coverage is in the planes already
        card_result = None
        if bam_header is not None:
            from . import card
            card_result = card.run(
                path, bam_header, boundaries, planes,
                bytes(interesting_per_tid), bytes(viral_per_tid),
                external_duplicate_marking)
        try:
            with trace.span("ingest.scan"):
                result = _scan(
                    path if card_result is None else card_result.path,
                    stream_native, name_to_tid, boundaries,
                    interesting_per_tid, viral_per_tid,
                    external_duplicate_marking, threads, planes,
                    extract_tables)
        finally:
            if card_result is not None:
                card_result.close()
        if retain:
            (_header_bytes, total_mapped, viral_counts, _n_records,
             (missing_hi_tag, malformed_count, no_chimeric_flag),
             _names_blob, _name_offsets_b, multimapper_count) = result
            # the scan no longer serializes a name blob (always empty);
            # the lazy view fills its dict straight from the store
            retained_result = LazyChimericAlignments(_native, None,
                                                     multimapper_count)
        else:
            main, seq_part = result
            (_header_bytes, total_mapped, viral_counts, _n_records,
             (missing_hi_tag, malformed_count, no_chimeric_flag),
             arrays) = main
        if card_result is not None:
            total_mapped += card_result.mapped
        for tid, count in enumerate(viral_counts):
            mapped_viral_reads_by_contig[tid_to_contig[tid]] += count
        if not retain:
            _materialize_fragments(chimeric_alignments, arrays, seq_part)

        if is_rna_bam_file and total_mapped == 0:
            raise RuntimeError("no normal reads found")
        if malformed_count > 0:
            print(f"WARNING: {malformed_count} SAM records were malformed and ignored",
                  file=sys.stderr)
        if no_chimeric_flag:
            raise RuntimeError(
                "no split reads or discordant mates found (STAR must either be run with "
                "'--chimOutType WithinBAM' or the file 'Chimeric.out.sam' must be passed "
                "to Arriba via the argument -c)")
        if missing_hi_tag > 0:
            print(f"WARNING: {missing_hi_tag} secondary alignments lack the 'HI' tag and were ignored",
                  file=sys.stderr)
        if retain:
            return retained_result, total_mapped
        return len(chimeric_alignments), total_mapped

    collated: Dict[str, BamRecord] = {}
    no_chimeric_reads = True
    missing_hi_tag = 0
    malformed_count = 0
    mapped_reads = 0

    for record in records:
        if is_rna_bam_file:
            if (record.flag & FUNMAP) or ((record.flag & FPAIRED) and (record.flag & FMUNMAP)):
                continue
            if record.tid < 0:
                # mapped flag but no usable RNAME ('*' or unknown): the
                # reference indexes its contig map out of bounds here (UB);
                # treat the record as malformed in both engines
                malformed_count += 1
                continue

        hit_index = 1
        if not separate_chimeric_bam_file:
            hi = record.tags.get("HI")
            if hi is not None:
                hit_index = int(hi)
            elif record.flag & FSECONDARY:
                missing_hi_tag += 1
                continue
        read_name = f"{record.qname},{hit_index}"

        record.tid = tid_to_contig[record.tid] if record.tid >= 0 else record.tid

        if separate_chimeric_bam_file and not is_rna_bam_file and (record.flag & FSECONDARY):
            add_chimeric_alignment(chimeric_alignments.setdefault(read_name, Fragment()),
                                   record, True)
            no_chimeric_reads = False
            continue

        if is_rna_bam_file and (record.flag & FSUPPLEMENTARY):
            if not separate_chimeric_bam_file:
                if is_clipped_at_correct_end(record):
                    add_chimeric_alignment(chimeric_alignments.setdefault(read_name, Fragment()),
                                           record, True)
                else:
                    malformed_count += 1
                no_chimeric_reads = False
            continue

        if record.tid < len(interesting_tids) and record.tid >= 0 and interesting_tids[record.tid]:
            mapped_reads += 1

        if is_rna_bam_file and (record.flag & FPAIRED) and not (record.flag & FPROPER_PAIR):
            if not separate_chimeric_bam_file:
                add_chimeric_alignment(chimeric_alignments.setdefault(read_name, Fragment()), record)
                no_chimeric_reads = False
            if not external_duplicate_marking or not (record.flag & FDUP):
                # the reference clears ALL flags here (flag &= !BAM_FPAIRED is
                # a logical-not bug, read_chimeric_alignments.cpp:664)
                record.flag = 0
                coverage.add_fragment(record, None, True)
            continue

        previously_seen_mate: Optional[BamRecord] = None
        if record.flag & FPAIRED:
            if read_name in collated:
                previously_seen_mate = collated.pop(read_name)
            else:
                collated[read_name] = record
                continue

        if separate_chimeric_bam_file and not is_rna_bam_file:
            mates = chimeric_alignments.setdefault(read_name, Fragment())
            add_chimeric_alignment(mates, record)
            if previously_seen_mate is not None:
                add_chimeric_alignment(mates, previously_seen_mate)
            no_chimeric_reads = False
        else:
            is_tandem_alignment = False
            tandem: Optional[Alignment] = None
            if not clipped_sequence_is_adapter(record, previously_seen_mate) and (
                    previously_seen_mate is None
                    or get_strand(record) != get_strand(previously_seen_mate)):
                tandem = is_tandem_duplication(record, assembly, max_itd_length)
                if tandem is None:
                    tandem = is_tandem_duplication(previously_seen_mate, assembly, max_itd_length)
            if tandem is not None:
                if is_rna_bam_file:
                    mates = chimeric_alignments.setdefault(read_name + "ITD", Fragment())
                    add_chimeric_alignment(
                        mates, record,
                        get_strand(record) == tandem.strand and not tandem.supplementary)
                    if previously_seen_mate is not None:
                        add_chimeric_alignment(
                            mates, previously_seen_mate,
                            get_strand(previously_seen_mate) == tandem.strand and not tandem.supplementary)
                    mates.append(tandem)
                is_tandem_alignment = True

            is_read_through_alignment = False
            if ((record.tags.get("SA") is not None and is_clipped_at_correct_end(record))
                    or (previously_seen_mate is not None
                        and previously_seen_mate.tags.get("SA") is not None
                        and is_clipped_at_correct_end(previously_seen_mate))):
                if not separate_chimeric_bam_file:
                    mates = chimeric_alignments.setdefault(read_name, Fragment())
                    add_chimeric_alignment(mates, record)
                    if previously_seen_mate is not None:
                        add_chimeric_alignment(mates, previously_seen_mate)
                    no_chimeric_reads = False
            elif not is_tandem_alignment:
                is_read_through_alignment = extract_read_through_alignment(
                    chimeric_alignments, read_name, record, previously_seen_mate, gene_index)
                if record.tid >= 0 and record.tid < len(viral_contigs_mask) and viral_contigs_mask[record.tid]:
                    for mate in ([record] if previously_seen_mate is None else [record, previously_seen_mate]):
                        if is_pristine_alignment(mate):
                            mapped_viral_reads_by_contig[mate.tid] += 1

            if not external_duplicate_marking or not (record.flag & FDUP):
                coverage.add_fragment(record, previously_seen_mate, is_read_through_alignment)

    if is_rna_bam_file and mapped_reads == 0:
        raise RuntimeError("no normal reads found")
    malformed_count += remove_malformed_alignments(chimeric_alignments)
    if malformed_count > 0:
        print(f"WARNING: {malformed_count} SAM records were malformed and ignored", file=sys.stderr)
    if (separate_chimeric_bam_file and not is_rna_bam_file) or not separate_chimeric_bam_file:
        if no_chimeric_reads:
            raise RuntimeError(
                "no split reads or discordant mates found (STAR must either be run with "
                "'--chimOutType WithinBAM' or the file 'Chimeric.out.sam' must be passed "
                "to Arriba via the argument -c)")
    if missing_hi_tag > 0:
        print(f"WARNING: {missing_hi_tag} secondary alignments lack the 'HI' tag and were ignored",
              file=sys.stderr)
    return len(chimeric_alignments), mapped_reads


def assign_strands_from_strandedness(chimeric_alignments: ChimericAlignments,
                                     strandedness: int) -> None:
    """read_chimeric_alignments.cpp:775-790."""
    if strandedness == STRANDEDNESS_NO:
        return
    for mates in chimeric_alignments.values():
        first = MATE1 if mates[MATE1].first_in_pair else MATE2
        second = MATE2 if mates[MATE1].first_in_pair else MATE1
        mates[first].predicted_strand = complement_strand_if(
            mates[first].strand, strandedness == STRANDEDNESS_REVERSE)
        mates[first].predicted_strand_ambiguous = False
        mates[second].predicted_strand = complement_strand_if(
            mates[first].predicted_strand, mates[first].strand == mates[second].strand)
        mates[second].predicted_strand_ambiguous = False
        if len(mates) == 3:
            mates[SUPPLEMENTARY].predicted_strand = complement_strand_if(
                mates[SPLIT_READ].predicted_strand,
                mates[SUPPLEMENTARY].strand != mates[SPLIT_READ].strand)
            mates[SUPPLEMENTARY].predicted_strand_ambiguous = False
