"""Read-level filters (#1-14 of the cascade).

Reference parity: one function per reference file, in cascade order:
filter_duplicates.cpp, filter_uninteresting_contigs.cpp,
filter_viral_contigs.cpp, filter_top_expressed_viral_contigs.cpp,
filter_low_coverage_viral_contigs.cpp, filter_proximal_read_through.cpp,
filter_inconsistently_clipped.cpp, filter_homopolymer.cpp,
filter_small_insert_size.cpp, filter_long_gap.cpp, filter_same_gene.cpp,
filter_hairpin.cpp, filter_mismatches.cpp, filter_low_entropy.cpp.

These are the embarrassingly-parallel-over-reads stages; ops/readfilters.py
provides the batched device path for the compute-heavy ones, with these
host implementations as the semantic oracle.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..annotation.index import IntervalIndex, combine_annotations
from ..annotation.queries import (get_boundaries_of_biggest_gene,
                                  is_breakpoint_spliced)
from ..annotation.tables import ExonTable, GeneTable
from ..constants import (CIGAR_DEL, CIGAR_DIFF, CIGAR_EQUAL, CIGAR_HARD_CLIP,
                         CIGAR_INS, CIGAR_MATCH, CIGAR_PAD, CIGAR_REF_SKIP,
                         CIGAR_SOFT_CLIP, FILTER_DUPLICATES, FILTER_HAIRPIN,
                         FILTER_HOMOPOLYMER, FILTER_INCONSISTENTLY_CLIPPED,
                         FILTER_LONG_GAP, FILTER_LOW_COVERAGE_VIRAL_CONTIGS,
                         FILTER_LOW_ENTROPY, FILTER_MISMATCHES, FILTER_NONE,
                         FILTER_READ_THROUGH, FILTER_SAME_GENE,
                         FILTER_SMALL_INSERT_SIZE,
                         FILTER_TOP_EXPRESSED_VIRAL_CONTIGS,
                         FILTER_UNINTERESTING_CONTIGS, FILTER_VIRAL_CONTIGS,
                         FORWARD, MATE1, MATE2, REVERSE, SPLIT_READ,
                         SUPPLEMENTARY, UPSTREAM, DOWNSTREAM, cigar_op,
                         cigar_oplen)
from ..ingest.stats import COVERAGE_RESOLUTION, Coverage
from ..io.fasta import Assembly
from ..model import Alignment, ChimericAlignments, Fragment
from ..seq import reverse_complement_str


def filter_duplicates(chimeric_alignments: ChimericAlignments,
                      external_duplicate_marking: bool) -> int:
    """filter_duplicates.cpp:8-55 — PCR duplicates by clip-adjusted fragment
    end coordinates (or the BAM duplicate flag with -u)."""
    remaining = 0
    duplicate_count: Dict[Tuple[int, int, int, int], int] = {}
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if external_duplicate_marking:
            if mates.duplicate:
                mates.filter = FILTER_DUPLICATES
            else:
                remaining += 1
            continue
        m1 = mates[MATE1]
        position1 = (m1.start - m1.preclipping()) if m1.strand == FORWARD else (m1.end + m1.postclipping())
        mate2 = mates[MATE2] if len(mates) == 2 else mates[SUPPLEMENTARY]
        position2 = (mate2.start - mate2.preclipping()) if mate2.strand == FORWARD else (mate2.end + mate2.postclipping())
        contig1, contig2 = m1.contig, mate2.contig
        if position1 > position2:
            position1, position2 = position2, position1
            contig1, contig2 = contig2, contig1
        key = (contig1, contig2, position1, position2)
        count = duplicate_count.get(key, 0)
        duplicate_count[key] = count + 1
        if count > 0:
            mates.filter = FILTER_DUPLICATES
        else:
            remaining += 1
    return remaining


def filter_uninteresting_contigs(chimeric_alignments: ChimericAlignments,
                                 interesting_contigs: List[bool]) -> int:
    """filter_uninteresting_contigs.cpp:7-26 — all mates must be interesting."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if all(interesting_contigs[m.contig] for m in mates):
            remaining += 1
        else:
            mates.filter = FILTER_UNINTERESTING_CONTIGS
    return remaining


def filter_viral_contigs(chimeric_alignments: ChimericAlignments,
                         viral_contigs: List[bool]) -> int:
    """filter_viral_contigs.cpp:7-27 — at least one mate must map to host."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if any(not viral_contigs[m.contig] for m in mates):
            remaining += 1
        else:
            mates.filter = FILTER_VIRAL_CONTIGS
    return remaining


def kmer_to_int(sequence: str, position: int, kmer_length: int) -> int:
    """filter_mismappers.cpp:33-45 — T=0 G=1 C=2 other=3, big-endian 2-bit."""
    result = 0
    for base in sequence[position:position + kmer_length]:
        result <<= 2
        if base == "T":
            result += 0
        elif base == "G":
            result += 1
        elif base == "C":
            result += 2
        else:
            result += 3
    return result


def related_viral_strains(virus1: np.ndarray, virus2: np.ndarray) -> bool:
    """filter_top_expressed_viral_contigs.cpp:23-49 — >=10% shared 12-mers."""
    small, big = (virus1, virus2) if len(virus1) <= len(virus2) else (virus2, virus1)
    kmer_length = 12
    small_str = small.tobytes().decode("ascii")
    big_str = big.tobytes().decode("ascii")
    small_kmers = {kmer_to_int(small_str, i, kmer_length): 0
                   for i in range(len(small_str) - kmer_length + 1)}
    shared = 0
    min_shared = len(small_kmers) // 10
    for i in range(len(big_str) - kmer_length + 1):
        k = kmer_to_int(big_str, i, kmer_length)
        if k in small_kmers:
            if small_kmers[k] == 0:
                small_kmers[k] = 1
                shared += 1
                if shared >= min_shared:
                    return True
    return False


def filter_top_expressed_viral_contigs(chimeric_alignments: ChimericAlignments,
                                       top_count: int, viral_contigs: List[bool],
                                       interesting_contigs: List[bool],
                                       mapped_viral_reads_by_contig: List[int],
                                       assembly: Assembly,
                                       genes: GeneTable) -> int:
    """filter_top_expressed_viral_contigs.cpp:51-153."""
    n_contigs = len(mapped_viral_reads_by_contig)
    expression = np.zeros(n_contigs, np.float32)
    for contig in range(n_contigs):
        if contig in assembly and len(assembly[contig]):
            expression[contig] = mapped_viral_reads_by_contig[contig] / len(assembly[contig])

    # sort descending by expression, ties broken by higher contig id
    order = sorted(range(n_contigs), key=lambda c: (-expression[c], -c))

    corrected_top_count = 0
    i = 1
    remaining_top = top_count
    while i < len(order) and expression[order[i]] > 0 and remaining_top > 0:
        corrected_top_count += 1
        if (order[i] not in assembly or order[i - 1] not in assembly
                or not related_viral_strains(assembly[order[i]], assembly[order[i - 1]])):
            remaining_top -= 1
        i += 1
    if corrected_top_count != 0:
        corrected_top_count -= 1
    min_expression_threshold = expression[order[corrected_top_count]] if order else 0.0

    min_fraction_intergenic = 0.33
    top_intergenic = min(50, n_contigs)
    top_intergenic = n_contigs - top_intergenic
    min_expr_high_intergenic = expression[order[top_intergenic]] if order else 0.0

    integration_sites: List[set] = [set() for _ in range(len(viral_contigs))]
    for mates in chimeric_alignments.values():
        viral_read = None
        host_read = None
        if viral_contigs[mates[MATE1].contig]:
            viral_read = mates[MATE1]
        elif interesting_contigs[mates[MATE1].contig]:
            host_read = mates[MATE1]
        mate2 = mates[SUPPLEMENTARY] if len(mates) == 3 else mates[MATE2]
        if viral_contigs[mate2.contig]:
            viral_read = mate2
        elif interesting_contigs[mate2.contig]:
            host_read = mate2
        if viral_read is not None and host_read is not None:
            integration_sites[viral_read.contig].update(int(g) for g in host_read.genes)

    fraction_intergenic = np.zeros(len(viral_contigs), np.float32)
    for contig in range(len(viral_contigs)):
        intergenic = sum(1 for g in integration_sites[contig] if genes.is_dummy[g])
        genic = len(integration_sites[contig]) - intergenic
        if intergenic > 0:
            fraction_intergenic[contig] = intergenic / (genic + intergenic)

    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        filtered = False
        for m in mates:
            if viral_contigs[m.contig]:
                if expression[m.contig] == 0 or expression[m.contig] < min_expression_threshold:
                    if (fraction_intergenic[m.contig] < min_fraction_intergenic
                            or expression[m.contig] == 0
                            or expression[m.contig] < min_expr_high_intergenic):
                        mates.filter = FILTER_TOP_EXPRESSED_VIRAL_CONTIGS
                        filtered = True
                        break
        if not filtered:
            remaining += 1
    return remaining


def filter_low_coverage_viral_contigs(chimeric_alignments: ChimericAlignments,
                                      coverage: Coverage, viral_contigs: List[bool],
                                      min_covered_fraction: float,
                                      min_covered_bases: float) -> int:
    """filter_low_coverage_viral_contigs.cpp:11-51."""
    n = len(viral_contigs)
    windows_sufficient = np.zeros(n, np.float32)
    n_windows = np.zeros(n, np.int64)
    for contig in range(n):
        cov = coverage.coverage[contig] if contig < len(coverage.coverage) else np.empty(0, np.uint16)
        n_windows[contig] = len(cov)
        if len(cov):
            avg = float(cov.sum(dtype=np.float64) / len(cov))
            windows_sufficient[contig] = int(np.count_nonzero(cov > 0.05 * avg))

    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        filtered = False
        for m in mates:
            if viral_contigs[m.contig]:
                insufficient_fraction = (n_windows[m.contig] > 0
                                         and windows_sufficient[m.contig] / n_windows[m.contig] < min_covered_fraction)
                if insufficient_fraction or COVERAGE_RESOLUTION * windows_sufficient[m.contig] <= min_covered_bases:
                    mates.filter = FILTER_LOW_COVERAGE_VIRAL_CONTIGS
                    filtered = True
                    break
        if not filtered:
            remaining += 1
    return remaining


def filter_proximal_read_through(chimeric_alignments: ChimericAlignments,
                                 genes: GeneTable, min_distance: int) -> int:
    """filter_proximal_read_through.cpp:8-47."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 2:
            forward = mates[MATE1] if mates[MATE1].strand == FORWARD else mates[MATE2]
            reverse = mates[MATE2] if mates[MATE1].strand == FORWARD else mates[MATE1]
        else:
            forward = mates[SUPPLEMENTARY] if mates[SPLIT_READ].strand == FORWARD else mates[SPLIT_READ]
            reverse = mates[SPLIT_READ] if mates[SPLIT_READ].strand == FORWARD else mates[SUPPLEMENTARY]

        proper = ((len(mates) == 2 and forward.strand != reverse.strand
                   and forward.contig == reverse.contig and forward.end < reverse.start)
                  or (len(mates) == 3 and forward.strand == reverse.strand
                      and forward.contig == reverse.contig and forward.end < reverse.start))
        if proper:
            _, forward_gene_end = get_boundaries_of_biggest_gene(forward.genes, genes)
            reverse_gene_start, _ = get_boundaries_of_biggest_gene(reverse.genes, genes)
            if (forward.end >= reverse_gene_start - min_distance
                    or reverse.start <= forward_gene_end + min_distance):
                mates.filter = FILTER_READ_THROUGH
                continue
        remaining += 1
    return remaining


def filter_inconsistently_clipped_mates(chimeric_alignments: ChimericAlignments) -> int:
    """filter_inconsistently_clipped.cpp:6-25."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 3:
            if ((mates[MATE1].strand == FORWARD and mates[MATE1].end > mates[SPLIT_READ].end + 3)
                    or (mates[MATE1].strand == REVERSE and mates[MATE1].start < mates[SPLIT_READ].start - 3)):
                mates.filter = FILTER_INCONSISTENTLY_CLIPPED
                continue
        remaining += 1
    return remaining


def _is_split_read_spliced(split_read: Alignment, genes: GeneTable,
                           exons: ExonTable, exon_index: IntervalIndex) -> bool:
    """filter_homopolymer.cpp:7-14."""
    direction = UPSTREAM if split_read.strand == FORWARD else DOWNSTREAM
    breakpoint = split_read.start if split_read.strand == FORWARD else split_read.end
    for g in split_read.genes:
        if is_breakpoint_spliced(int(g), direction, breakpoint, genes, exons, exon_index):
            return True
    return False


def filter_homopolymer(chimeric_alignments: ChimericAlignments,
                       homopolymer_length: int, genes: GeneTable,
                       exons: ExonTable, exon_index: IntervalIndex) -> int:
    """filter_homopolymer.cpp:16-62 — homopolymer adjacent to a non-spliced
    breakpoint."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        filtered = False
        if len(mates) == 3:
            split = mates[SPLIT_READ]
            sequence = ""
            if split.strand == FORWARD:
                pre = split.preclipping()
                if pre >= homopolymer_length:
                    sequence += split.sequence[pre - homopolymer_length:pre] + " "
                if len(split.sequence) - pre >= homopolymer_length:
                    sequence += split.sequence[pre:pre + homopolymer_length] + " "
            else:
                post = split.postclipping()
                if post >= homopolymer_length:
                    sequence += split.sequence[len(split.sequence) - post:
                                               len(split.sequence) - post + homopolymer_length] + " "
                if len(split.sequence) - post >= homopolymer_length:
                    sequence += split.sequence[len(split.sequence) - post - homopolymer_length:
                                               len(split.sequence) - post] + " "
            run = 1
            for c in range(1, len(sequence)):
                if sequence[c - 1] == sequence[c]:
                    run += 1
                    if run == homopolymer_length:
                        if not _is_split_read_spliced(split, genes, exons, exon_index):
                            mates.filter = FILTER_HOMOPOLYMER
                            filtered = True
                            break
                else:
                    run = 1
        if not filtered:
            remaining += 1
    return remaining


def filter_small_insert_size(chimeric_alignments: ChimericAlignments,
                             max_overhang: int) -> int:
    """filter_small_insert_size.cpp:7-30."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 2:
            m1, m2 = mates[MATE1], mates[MATE2]
            if (m1.strand != m2.strand and m1.contig == m2.contig
                    and (abs(m1.start - m2.start) <= max_overhang
                         or abs(m1.end - m2.end) <= max_overhang)):
                mates.filter = FILTER_SMALL_INSERT_SIZE
                continue
        remaining += 1
    return remaining


def filter_long_gap(chimeric_alignments: ChimericAlignments) -> int:
    """filter_long_gap.cpp:7-89 — alignIntronMax artifacts."""
    min_long_gap = 700000
    max_long_gap = 1500000
    short_segment = 15
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        size_of_deletion = 0
        if len(mates) == 3:
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            if split.contig == supp.contig:
                if split.strand == REVERSE and supp.strand == REVERSE:
                    size_of_deletion = supp.start - split.end
                elif split.strand == FORWARD and supp.strand == FORWARD:
                    size_of_deletion = split.start - supp.end

        filtered = False
        for m in mates:
            cig = m.cigar
            for i in range(1, len(cig) - 1):
                op = cigar_op(int(cig[i]))
                if op == CIGAR_REF_SKIP and (cigar_oplen(int(cig[i])) >= min_long_gap
                                             or min_long_gap <= size_of_deletion <= max_long_gap):
                    matching_left = 0
                    for j in range(i - 1, -1, -1):
                        opj = cigar_op(int(cig[j]))
                        if opj in (CIGAR_MATCH, CIGAR_DIFF, CIGAR_EQUAL):
                            matching_left += cigar_oplen(int(cig[j]))
                        elif opj in (CIGAR_DEL, CIGAR_INS, CIGAR_PAD):
                            pass
                        else:
                            break
                    matching_right = 0
                    for j in range(i + 1, len(cig)):
                        opj = cigar_op(int(cig[j]))
                        if opj in (CIGAR_MATCH, CIGAR_DIFF, CIGAR_EQUAL):
                            matching_right += cigar_oplen(int(cig[j]))
                        elif opj in (CIGAR_DEL, CIGAR_INS, CIGAR_PAD):
                            pass
                        else:
                            break
                    if matching_left <= short_segment and matching_right <= short_segment:
                        mates.filter = FILTER_LONG_GAP
                        filtered = True
                        break
            if filtered:
                break
        if not filtered:
            remaining += 1
    return remaining


def filter_same_gene(chimeric_alignments: ChimericAlignments) -> int:
    """filter_same_gene.cpp:7-46 — both mates in one gene in canonical-splice
    orientation."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 2:
            common = combine_annotations(mates[MATE1].genes, mates[MATE2].genes, make_union=False)
        else:
            common = combine_annotations(mates[MATE2].genes, mates[SUPPLEMENTARY].genes, make_union=False)
        if len(common) == 0:
            remaining += 1
            continue
        if len(mates) == 2:
            m1, m2 = mates[MATE1], mates[MATE2]
            if ((m1.strand == FORWARD and m2.strand == REVERSE and m1.start <= m2.end)
                    or (m1.strand == REVERSE and m2.strand == FORWARD and m1.end >= m2.start)):
                mates.filter = FILTER_SAME_GENE
                continue
        else:
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            if ((split.strand == FORWARD and supp.strand == FORWARD and split.start >= supp.end)
                    or (split.strand == REVERSE and supp.strand == REVERSE and split.end <= supp.start)):
                mates.filter = FILTER_SAME_GENE
                continue
        remaining += 1
    return remaining


def _breakpoint_within_aligned_segment(breakpoint: int, alignment: Alignment) -> bool:
    """filter_hairpin.cpp:8-27."""
    reference_position = alignment.start
    for word in alignment.cigar:
        op = cigar_op(int(word))
        oplen = cigar_oplen(int(word))
        if op in (CIGAR_REF_SKIP, CIGAR_DEL):
            reference_position += oplen
        elif op in (CIGAR_MATCH, CIGAR_DIFF, CIGAR_EQUAL):
            if reference_position <= breakpoint <= reference_position + oplen:
                return True
            reference_position += oplen
    return False


def filter_hairpin(chimeric_alignments: ChimericAlignments, max_mate_gap: int) -> int:
    """filter_hairpin.cpp:29-80 — intragenic events with breakpoint distance
    shorter than the fragment size."""
    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 2:
            common = combine_annotations(mates[MATE1].genes, mates[MATE2].genes, make_union=False)
            if len(common) == 0 and mates[MATE1].contig != mates[MATE2].contig:
                remaining += 1
                continue
        else:
            common = combine_annotations(mates[SPLIT_READ].genes, mates[SUPPLEMENTARY].genes, make_union=False)
            if len(common) == 0 and mates[SPLIT_READ].contig != mates[SUPPLEMENTARY].contig:
                remaining += 1
                continue

        if len(mates) == 2:
            m1, m2 = mates[MATE1], mates[MATE2]
            breakpoint1 = m1.end if m1.strand == FORWARD else m1.start
            breakpoint2 = m2.end if m2.strand == FORWARD else m2.start
            if (_breakpoint_within_aligned_segment(breakpoint1, m2)
                    or _breakpoint_within_aligned_segment(breakpoint2, m1)):
                mates.filter = FILTER_HAIRPIN
                continue
        else:
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            bp_split = split.start if split.strand == FORWARD else split.end
            bp_supp = supp.end if supp.strand == FORWARD else supp.start
            if (_breakpoint_within_aligned_segment(bp_split, supp)
                    or _breakpoint_within_aligned_segment(bp_supp, split)
                    or _breakpoint_within_aligned_segment(bp_supp, mates[MATE1])):
                mates.filter = FILTER_HAIRPIN
                continue
        remaining += 1
    return remaining


def count_mismatches(alignment: Alignment, sequence: str, assembly: Assembly) -> Tuple[int, int]:
    """filter_mismatches.cpp:12-53 — returns (mismatches, alignment_length)."""
    mismatches = 0
    alignment_length = 0
    reference_position = alignment.start
    read_position = 0
    contig_seq = assembly[alignment.contig]
    n_ops = len(alignment.cigar)
    for i in range(n_ops):
        op = cigar_op(int(alignment.cigar[i]))
        oplen = cigar_oplen(int(alignment.cigar[i]))
        if op in (CIGAR_SOFT_CLIP, CIGAR_HARD_CLIP):
            read_position += oplen
            if not ((i == 0 and alignment.strand == REVERSE)
                    or (i == n_ops - 1 and alignment.strand == FORWARD)):
                mismatches += 1
        elif op == CIGAR_DEL:
            mismatches += 1
            reference_position += oplen
        elif op == CIGAR_REF_SKIP:
            reference_position += oplen
        elif op == CIGAR_INS:
            mismatches += 1
            read_position += oplen
        elif op in (CIGAR_MATCH, CIGAR_EQUAL, CIGAR_DIFF):
            read_chunk = np.frombuffer(
                sequence[read_position:read_position + oplen].encode("ascii"), np.uint8)
            ref_chunk = contig_seq[reference_position:reference_position + oplen]
            not_n = read_chunk != ord("N")
            alignment_length += int(np.count_nonzero(not_n))
            mismatches += int(np.count_nonzero(not_n & (read_chunk != ref_chunk[:len(read_chunk)])))
            reference_position += oplen
            read_position += oplen
    return mismatches, alignment_length


def calculate_binomial_coefficient(k: int, n: int) -> float:
    """filter_mismatches.cpp:55-64 — float semantics preserved."""
    result = 1.0
    for i in range(n - k + 1, n + 1):
        result *= i
    for i in range(1, k + 1):
        result /= i
    return result


def _mismatch_decision(mismatches: int, alignment_length: int,
                       mismatch_probability: float, genome_size: int,
                       pvalue_cutoff: float) -> bool:
    """filter_mismatches.cpp:76-103 (decision half; counts precomputed)."""
    pvalue = (calculate_binomial_coefficient(mismatches, alignment_length)
              * math.pow(mismatch_probability, mismatches)
              * math.pow(1 - mismatch_probability, alignment_length - mismatches))
    if pvalue < pvalue_cutoff:
        return True
    if mismatches > 0:
        permutations = math.pow(4, alignment_length - mismatches)
        if genome_size >= permutations:
            return True
        return (1 - math.pow(1 - genome_size / permutations,
                             calculate_binomial_coefficient(mismatches, alignment_length))) > 0.01
    return False


def test_mismatch_probability(alignment: Alignment, sequence: str, assembly: Assembly,
                              mismatch_probability: float, genome_size: int,
                              pvalue_cutoff: float, is_multimapper: bool) -> bool:
    """filter_mismatches.cpp:76-103."""
    mismatches, alignment_length = count_mismatches(alignment, sequence, assembly)
    if is_multimapper:
        mismatches += 2
    return _mismatch_decision(mismatches, alignment_length, mismatch_probability,
                              genome_size, pvalue_cutoff)


def filter_mismatches(chimeric_alignments: ChimericAlignments, assembly: Assembly,
                      interesting_contigs: List[bool], viral_contigs: List[bool],
                      mismatch_probability: float, pvalue_cutoff: float) -> int:
    """filter_mismatches.cpp:105-135."""
    genome_size = sum(len(assembly[c]) for c in range(len(interesting_contigs))
                      if interesting_contigs[c] and c in assembly)

    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter != FILTER_NONE:
            continue
        if len(mates) == 2:
            m1, m2 = mates[MATE1], mates[MATE2]
            if ((not viral_contigs[m1.contig]
                 and test_mismatch_probability(m1, m1.sequence, assembly, mismatch_probability,
                                               genome_size, pvalue_cutoff,
                                               mates.multimapper and not viral_contigs[m2.contig]))
                    or (not viral_contigs[m2.contig]
                        and test_mismatch_probability(m2, m2.sequence, assembly, mismatch_probability,
                                                      genome_size, pvalue_cutoff,
                                                      mates.multimapper and not viral_contigs[m1.contig]))):
                mates.filter = FILTER_MISMATCHES
                continue
        else:
            m1 = mates[MATE1]
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            supp_sequence = split.sequence if supp.strand == split.strand else reverse_complement_str(split.sequence)
            if ((not viral_contigs[m1.contig]
                 and test_mismatch_probability(m1, m1.sequence, assembly, mismatch_probability,
                                               genome_size, pvalue_cutoff,
                                               mates.multimapper and not viral_contigs[supp.contig]))
                    or (not viral_contigs[supp.contig]
                        and test_mismatch_probability(supp, supp_sequence, assembly, mismatch_probability,
                                                      genome_size, pvalue_cutoff,
                                                      mates.multimapper and not viral_contigs[m1.contig]))):
                mates.filter = FILTER_MISMATCHES
                continue
        remaining += 1
    return remaining


def _low_entropy_flags(codes: np.ndarray, lengths: np.ndarray,
                       a1s: np.ndarray, a1e: np.ndarray, a2s: np.ndarray,
                       a2e: np.ndarray, kmer_content: float,
                       kmer_length: int) -> np.ndarray:
    """Vectorized core of the recurrent-k-mer scan (filter_low_entropy.cpp:
    60-100): per row, does any k-mer recur (non-overlapping) often enough to
    cross any of the three thresholds? The reference's early-exit check is
    monotone in the counters, so evaluating it on the final counters
    (restricted to k-mers counted at least once) is equivalent. Mirrors
    ops/readfilters.low_entropy_batch (the device op)."""
    n, L = codes.shape
    n_kmers = 4 ** kmer_length
    kv = np.zeros((n, L), np.int32)
    for j in range(kmer_length):
        shifted = np.roll(codes, -j, axis=1)
        kv = (kv << 2) | np.minimum(shifted, 3).astype(np.int32)
    kv_by_pos = np.ascontiguousarray(kv.T)  # column access dominates the scan

    def threshold(segment_length):
        # Exact reference types (filter_low_entropy.cpp:67-69): float32
        # length * float32 kmer_content / kmer_length, +0.5 in double,
        # then unsigned truncation. trunc(q+0.5) is computed as
        # floor(q) + (frac(q) >= 0.5), exact for float32 q. Inverted
        # windows (end < start) get a huge threshold: the reference
        # converts the negative product to unsigned (never filters).
        q = (segment_length.astype(np.float32)
             * np.float32(kmer_content)) / np.float32(kmer_length)
        base = np.floor(q)
        t = (base + (q - base >= np.float32(0.5))).astype(np.int64)
        return np.where(segment_length < 0, np.int64(1) << 30, t)

    th_all = threshold(lengths)
    th_a1 = threshold(a1e - a1s)
    th_a2 = threshold(a2e - a2s)

    prev_pos = np.zeros((n, n_kmers), np.int32)
    c_all = np.zeros((n, n_kmers), np.int32)
    c_a1 = np.zeros((n, n_kmers), np.int32)
    c_a2 = np.zeros((n, n_kmers), np.int32)
    rows = np.arange(n)
    for pos in range(0, max(0, int(lengths.max()) - kmer_length)):
        v = kv_by_pos[pos]
        eligible = (pos < lengths - kmer_length) & (prev_pos[rows, v] <= pos)
        idx = rows[eligible]
        vv = v[eligible]
        prev_pos[idx, vv] = pos + kmer_length
        c_all[idx, vv] += 1
        in_a1 = eligible & (pos + 1 >= a1s) & (pos < a1e)
        c_a1[rows[in_a1], v[in_a1]] += 1
        in_a2 = eligible & (pos + 1 >= a2s) & (pos < a2e)
        c_a2[rows[in_a2], v[in_a2]] += 1

    crossed = (c_all >= 1) & ((c_all >= th_all[:, None])
                              | (c_a1 >= th_a1[:, None])
                              | (c_a2 >= th_a2[:, None]))
    return crossed.any(axis=1) & (lengths >= kmer_length)


def filter_low_entropy(chimeric_alignments: ChimericAlignments, kmer_length: int,
                       kmer_content: float, max_itd_length: int) -> int:
    """filter_low_entropy.cpp:9-112 — recurrent non-overlapping k-mers
    covering too much of the read or its aligned segments. The per-mate scan
    is batched over all fragments via _low_entropy_flags."""
    from .mismappers import KMER_BASE_LUT

    row_fragment: List[Fragment] = []
    row_seq: List[str] = []
    row_windows: List[Tuple[int, int, int, int]] = []
    for mates in chimeric_alignments.values():
        is_itd = (len(mates) == 3
                  and mates[SPLIT_READ].strand == mates[SUPPLEMENTARY].strand
                  and mates[SPLIT_READ].contig == mates[SUPPLEMENTARY].contig
                  and ((mates[SPLIT_READ].strand == FORWARD
                        and mates[SPLIT_READ].start < mates[SUPPLEMENTARY].end
                        and mates[SPLIT_READ].start + max_itd_length >= mates[SUPPLEMENTARY].end)
                       or (mates[SPLIT_READ].strand == REVERSE
                           and mates[SPLIT_READ].end > mates[SUPPLEMENTARY].start
                           and mates[SPLIT_READ].end <= mates[SUPPLEMENTARY].start + max_itd_length)))
        if not is_itd or mates.filter == FILTER_DUPLICATES:
            if mates.filter != FILTER_NONE:
                continue

        for mate_idx in (MATE1, MATE2):
            mate = mates[mate_idx]
            if len(mate.sequence) < kmer_length:
                continue
            aligned_start1 = mate.preclipping() if (len(mate.cigar) and cigar_op(int(mate.cigar[0])) == CIGAR_SOFT_CLIP) else 0
            aligned_end1 = len(mate.sequence)
            if len(mate.cigar) and cigar_op(int(mate.cigar[-1])) == CIGAR_SOFT_CLIP:
                aligned_end1 -= cigar_oplen(int(mate.cigar[-1]))
            if len(mates) == 3 and mate_idx == SPLIT_READ:
                supp = mates[SUPPLEMENTARY]
                aligned_start2 = cigar_oplen(int(supp.cigar[0])) if cigar_op(int(supp.cigar[0])) == CIGAR_SOFT_CLIP else 0
                aligned_end2 = len(mates[SPLIT_READ].sequence)
                if cigar_op(int(supp.cigar[-1])) == CIGAR_SOFT_CLIP:
                    aligned_end2 -= cigar_oplen(int(supp.cigar[-1]))
                if supp.strand != mates[SPLIT_READ].strand:
                    aligned_start2 = len(mates[SPLIT_READ].sequence) - aligned_start2
                    aligned_end2 = len(mates[SPLIT_READ].sequence) - aligned_end2
                    aligned_start2, aligned_end2 = aligned_end2, aligned_start2
            else:
                aligned_start2 = aligned_start1
                aligned_end2 = aligned_end1

            row_fragment.append(mates)
            row_seq.append(mate.sequence)
            row_windows.append((aligned_start1, aligned_end1,
                                aligned_start2, aligned_end2))

    if row_seq:
        n = len(row_seq)
        lengths = np.fromiter((len(s) for s in row_seq), np.int32, n)
        windows = np.array(row_windows, np.int32)
        L = max(len(s) for s in row_seq)
        codes = np.full((n, L), 3, np.uint8)  # pad = code 3, same as N
        for i, s in enumerate(row_seq):
            codes[i, :len(s)] = KMER_BASE_LUT[np.frombuffer(
                s.encode("latin-1"), np.uint8)]
        from ..device import offload_enabled
        if offload_enabled():
            # device path: the same recurrence as a batched device op (K2 on
            # CUDA); a device error raises
            from ..ops.readfilters import low_entropy_batch_chunked
            flags = low_entropy_batch_chunked(
                codes, lengths,
                np.ascontiguousarray(windows[:, 0]),
                np.ascontiguousarray(windows[:, 1]),
                np.ascontiguousarray(windows[:, 2]),
                np.ascontiguousarray(windows[:, 3]),
                kmer_content)
        else:
            flags = _low_entropy_flags(codes, lengths, windows[:, 0],
                                       windows[:, 1], windows[:, 2],
                                       windows[:, 3], kmer_content,
                                       kmer_length)
        for i in np.nonzero(flags)[0]:
            row_fragment[int(i)].filter = FILTER_LOW_ENTROPY

    remaining = 0
    for mates in chimeric_alignments.values():
        if mates.filter == FILTER_NONE:
            remaining += 1
    return remaining
