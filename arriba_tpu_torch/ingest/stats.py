"""Genome-wide coverage and read statistics.

Reference parity: source/read_stats.{cpp,hpp}. Coverage is tracked in 20 bp
windows as uint16 counters plus fragment start/end bitmaps; the fragment-
length estimator trims outliers until the mate-gap distribution is ~normal;
strandedness is detected from spliced intra-gene split reads.

Two reference quirks are replicated deliberately (they affect byte-equality):
- the soft-clip checks in add_fragment compare bam_cigar_type() against
  BAM_CSOFT_CLIP and can never be true (read_stats.cpp:173-181), so they are
  omitted here;
- records passed without a mate walk their own CIGAR twice in the dual-mate
  loop, double-counting coverage (read_stats.cpp:164-165 aliases mate2=mate1).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .._native_build import engine
from ..constants import (CIGAR_CONSUMES_QUERY, CIGAR_CONSUMES_REF, DOWNSTREAM,
                         FORWARD, MATE1, REVERSE, SPLIT_READ, SUPPLEMENTARY,
                         STRANDEDNESS_NO, STRANDEDNESS_REVERSE,
                         STRANDEDNESS_YES, UPSTREAM, cigar_op, cigar_oplen)
from ..io.bam import BamRecord, FPAIRED, FPROPER_PAIR, FREVERSE
from ..model import ChimericAlignments
from ..annotation.index import IntervalIndex
from ..annotation.queries import get_spliced_distance, is_breakpoint_spliced
from ..annotation.tables import ExonTable, GeneTable

COVERAGE_RESOLUTION = 20  # read_stats.hpp:14


class Coverage:
    """coverage_t (read_stats.hpp:17-27)."""

    def __init__(self) -> None:
        self.fragment_starts: List[np.ndarray] = []
        self.fragment_ends: List[np.ndarray] = []
        self.coverage: List[np.ndarray] = []

    def resize(self, n_contigs: int, assembly: Dict[int, np.ndarray]) -> None:
        while len(self.coverage) < n_contigs:
            self.fragment_starts.append(np.empty(0, np.bool_))
            self.fragment_ends.append(np.empty(0, np.bool_))
            self.coverage.append(np.empty(0, np.uint16))
        for contig, seq in assembly.items():
            if len(seq) and len(self.coverage[contig]) == 0:
                windows = len(seq) // COVERAGE_RESOLUTION + 2
                self.fragment_starts[contig] = np.zeros(windows, np.bool_)
                self.fragment_ends[contig] = np.zeros(windows, np.bool_)
                self.coverage[contig] = np.zeros(windows, np.uint16)

    def bind_native(self) -> None:
        """Register the coverage arrays with the native engine (called after
        resize); add_fragment then runs the walk in C++."""
        native = engine()
        if native is None:
            return
        planes = []
        for contig in range(len(self.coverage)):
            if len(self.coverage[contig]):
                planes.append((self.coverage[contig],
                               self.fragment_starts[contig].view(np.uint8),
                               self.fragment_ends[contig].view(np.uint8)))
            else:
                planes.append(None)
        native.coverage_bind(planes)
        self._native_bound = True

    def add_fragment(self, mate1: BamRecord, mate2: Optional[BamRecord],
                     is_chimeric: bool) -> None:
        """read_stats.cpp:161-266 — dual-CIGAR walk over both mates."""
        if getattr(self, "_native_bound", False):
            native = engine()
            if mate2 is None:
                native.coverage_add(mate1.tid, mate1.pos, mate1.flag,
                                    memoryview(mate1.cigar), 0, -1, 0, 0, b"",
                                    is_chimeric)
            else:
                native.coverage_add(mate1.tid, mate1.pos, mate1.flag,
                                    memoryview(mate1.cigar), 1, mate2.tid,
                                    mate2.pos, mate2.flag,
                                    memoryview(mate2.cigar), is_chimeric)
            return
        if mate2 is None:
            mate2 = mate1
        # the reference's '(unsigned int) tid >= size' comparison also
        # rejects NEGATIVE tids (read_stats.cpp:167); without the guard a
        # tid of -1 would silently update the LAST contig's planes
        if (mate1.tid < 0 or mate2.tid < 0
                or mate1.tid >= len(self.fragment_starts)
                or len(self.fragment_starts[mate1.tid]) == 0
                or mate2.tid >= len(self.fragment_starts)
                or len(self.fragment_starts[mate2.tid]) == 0):
            return

        if mate1.flag & FPAIRED:
            if not (mate1.flag & FPROPER_PAIR):
                is_chimeric = True
            # (dead soft-clip checks of the reference omitted, see module doc)

        if not is_chimeric:
            if not (mate1.flag & FREVERSE) or not (mate1.flag & FPAIRED):
                self.fragment_starts[mate1.tid][mate1.pos // COVERAGE_RESOLUTION] = True
            else:
                self.fragment_starts[mate2.tid][mate2.pos // COVERAGE_RESOLUTION] = True

        position1 = mate1.pos
        position2 = mate2.pos
        window = min(position1, position2) // COVERAGE_RESOLUTION
        i1 = 0
        i2 = 0
        cigar1 = mate1.cigar
        cigar2 = mate2.cigar
        n1 = len(cigar1)
        n2 = len(cigar2)
        while True:
            if i1 < n1:
                word1 = int(cigar1[i1])
                op_length1 = cigar_oplen(word1) if (CIGAR_CONSUMES_REF >> cigar_op(word1)) & 1 else 0
            else:
                op_length1 = 0
                window = max(window, position2 // COVERAGE_RESOLUTION)
            if i2 < n2:
                word2 = int(cigar2[i2])
                op_length2 = cigar_oplen(word2) if (CIGAR_CONSUMES_REF >> cigar_op(word2)) & 1 else 0
            else:
                op_length2 = 0
                window = max(window, position1 // COVERAGE_RESOLUTION)

            if i1 < n1 and (position1 + op_length1 < position2 + op_length2 or i2 >= n2):
                i1 += 1
                if op_length1 == 0:
                    continue
                word = word1
                contig = mate1.tid
                position1 += op_length1
                position = position1
            elif i2 < n2:
                i2 += 1
                if op_length2 == 0:
                    continue
                word = word2
                contig = mate2.tid
                position2 += op_length2
                position = position2
            else:
                break

            cov = self.coverage[contig]
            if (CIGAR_CONSUMES_QUERY >> cigar_op(word)) & 1:
                while window <= position // COVERAGE_RESOLUTION:
                    if cov[window] < 0xFFFF and position - window * COVERAGE_RESOLUTION >= COVERAGE_RESOLUTION // 2:
                        cov[window] += 1
                    window += 1
            else:
                window = position // COVERAGE_RESOLUTION

        if not is_chimeric:
            if (mate1.flag & FREVERSE) or not (mate1.flag & FPAIRED):
                self.fragment_ends[mate1.tid][(position1 - 1) // COVERAGE_RESOLUTION] = True
            else:
                self.fragment_ends[mate2.tid][(position2 - 1) // COVERAGE_RESOLUTION] = True

    def fragment_starts_here(self, contig: int, start: int, end: int) -> bool:
        """read_stats.cpp:269-279 — trunc division like the reference's int
        arithmetic; its `(unsigned) window` cast makes a negative window an
        immediate miss."""
        if contig >= len(self.fragment_starts):
            return False
        starts = self.fragment_starts[contig]
        window = int(start / COVERAGE_RESOLUTION) + 1
        last = int(end / COVERAGE_RESOLUTION)
        while window <= last:
            if window < 0 or window >= len(starts):
                return False
            if starts[window]:
                return True
            window += 1
        return False

    def fragment_ends_here(self, contig: int, start: int, end: int) -> bool:
        """read_stats.cpp:282-292."""
        if contig >= len(self.fragment_ends):
            return False
        ends = self.fragment_ends[contig]
        window = int(start / COVERAGE_RESOLUTION)
        last = int(end / COVERAGE_RESOLUTION)
        while window < last:
            if window < 0 or window >= len(ends):
                return False
            if ends[window]:
                return True
            window += 1
        return False

    def get_coverage(self, contig: int, position: int, direction: bool) -> int:
        """read_stats.cpp:295-306."""
        if contig >= len(self.coverage) or len(self.coverage[contig]) == 0:
            return -1
        if direction == UPSTREAM:
            if position < COVERAGE_RESOLUTION:
                return 0
            return int(self.coverage[contig][position // COVERAGE_RESOLUTION - 1])
        return int(self.coverage[contig][position // COVERAGE_RESOLUTION + 1])


def estimate_fragment_length(chimeric_alignments: ChimericAlignments,
                             genes: GeneTable, exons: ExonTable,
                             exon_index: IntervalIndex):
    """read_stats.cpp:11-92 — returns (ok, mate_gap_mean, mate_gap_stddev,
    read_length_mean)."""
    mate_gaps: List[int] = []
    read_length_sum = 0.0
    read_length_count = 0
    for fragment in chimeric_alignments.values():
        # the reference divides on size_t (read_stats.cpp:20): floor, not
        # float — odd length sums otherwise skew the mean by 0.5
        read_length_sum += (len(fragment[MATE1].sequence) + len(fragment[1].sequence)) // 2
        read_length_count += 1
        if fragment.filter != 0 or fragment.single_end:
            continue
        if len(fragment) == 3:
            forward_mate = fragment[MATE1]
            reverse_mate = fragment[SPLIT_READ]
            if forward_mate.strand == REVERSE:
                forward_mate, reverse_mate = reverse_mate, forward_mate
            gene = int(forward_mate.genes[0]) if len(forward_mate.genes) else 0
            distance = get_spliced_distance(forward_mate.contig, forward_mate.end,
                                            reverse_mate.start, gene, exons, exon_index)
            if forward_mate.end > reverse_mate.start:
                distance = -distance
            distance = max(distance, -len(forward_mate.sequence))
            distance = max(distance, -len(reverse_mate.sequence))
            mate_gaps.append(distance)
            if len(mate_gaps) > 100000:
                break

    return fragment_length_stats(np.array(mate_gaps, np.int64),
                                 read_length_sum, read_length_count)


def fragment_length_stats(mate_gaps: np.ndarray, read_length_sum: float,
                          read_length_count: int):
    """Statistics half of read_stats.cpp:11-92 (iterative outlier trimming),
    shared by the Python and native gap-collection paths."""
    if len(mate_gaps) < 10000:
        return False, 0.0, 0.0, (read_length_sum / read_length_count if read_length_count else 0.0)

    read_length_mean = read_length_sum / read_length_count
    gaps = mate_gaps.astype(np.float64)
    no_more_outliers = False
    while True:
        mean = float(gaps.sum() / len(gaps))
        stddev = float(np.sqrt(((gaps - mean) ** 2).sum() / (len(gaps) - 1)))
        # NOTE: the reference's within-range test uses || so it always passes
        # (read_stats.cpp:73); loop exit is driven by no_more_outliers
        within_range = np.count_nonzero((gaps > mean - stddev) | (gaps < mean + stddev))
        if within_range / len(gaps) < 0.683 or no_more_outliers:
            break
        no_more_outliers = True
        keep = (gaps >= mean - 3 * stddev) & (gaps <= mean + 3 * stddev)
        if not keep.all():
            gaps = gaps[keep]
            no_more_outliers = False
    return True, mean, stddev, read_length_mean


def detect_strandedness(chimeric_alignments: ChimericAlignments, genes: GeneTable,
                        exons: ExonTable, gene_index: IntervalIndex,
                        exon_index: IntervalIndex) -> int:
    """read_stats.cpp:94-143."""
    sample_size = 100
    threshold = 0.95
    count = 0
    matching_strand = 0
    for fragment in chimeric_alignments.values():
        if len(fragment) != 3:
            continue
        split = fragment[SPLIT_READ]
        supp = fragment[SUPPLEMENTARY]
        if (split.contig == supp.contig and split.strand == supp.strand
                and abs(split.start - supp.start) < 400000):
            gene_set = gene_index.range_query(split.contig, split.start, split.end)
            if len(gene_set) == 1:
                direction = UPSTREAM if split.strand == FORWARD else DOWNSTREAM
                position = split.start if split.strand == FORWARD else split.end
                g = int(gene_set[0])
                if is_breakpoint_spliced(g, direction, position, genes, exons, exon_index):
                    if (split.first_in_pair and split.strand == bool(genes.strand[g])) or \
                       (fragment[MATE1].first_in_pair and fragment[MATE1].strand == bool(genes.strand[g])):
                        matching_strand += 1
                    count += 1
                    if count >= sample_size:
                        break
    if count < sample_size:
        return STRANDEDNESS_NO
    if matching_strand < (1 - threshold) * count:
        return STRANDEDNESS_REVERSE
    if matching_strand > threshold * count:
        return STRANDEDNESS_YES
    return STRANDEDNESS_NO
