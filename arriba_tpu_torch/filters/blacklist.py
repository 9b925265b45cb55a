"""Blacklist / known-fusions matching machinery.

Reference parity: source/filter_blacklisted_ranges.{cpp,hpp} and
source/recover_known_fusions.cpp. Blacklist rules are (range|position|gene|
keyword) pairs indexed into 100 kb genome bins; fusions are matched 5'/3'-
aware with strand and proximity rules. The same item parser/matcher is
reused by the known-fusions recovery and the tags annotator.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import sys

from .. import trace
from ..annotation.tables import GeneTable
from ..constants import (DOWNSTREAM, FILTER_BLACKLIST, FILTER_MIN_SUPPORT,
                         FILTER_NONE, FILTER_RELATIVE_SUPPORT, FORWARD,
                         REVERSE, TRANSCRIPT_START_GENE1, UPSTREAM)
from ..contigs import ContigRegistry, remove_chr
from ..fusion import Fusion, Fusions
from ..ingest.stats import Coverage
from ..io.compressed import iter_lines

# blacklist item types (filter_blacklisted_ranges.hpp:14)
BLACKLIST_RANGE = 0
BLACKLIST_POSITION = 1
BLACKLIST_GENE = 2
BLACKLIST_ANY = 3
BLACKLIST_SPLIT_READ_DONOR = 4
BLACKLIST_SPLIT_READ_ACCEPTOR = 5
BLACKLIST_SPLIT_READ_ANY = 6
BLACKLIST_DISCORDANT_MATES = 7
BLACKLIST_READ_THROUGH = 8
BLACKLIST_LOW_SUPPORT = 9
BLACKLIST_FILTER_SPLICED = 10
BLACKLIST_NOT_BOTH_SPLICED = 11

_KEYWORDS = {
    "any": BLACKLIST_ANY,
    "split_read_donor": BLACKLIST_SPLIT_READ_DONOR,
    "split_read_acceptor": BLACKLIST_SPLIT_READ_ACCEPTOR,
    "split_read_any": BLACKLIST_SPLIT_READ_ANY,
    "discordant_mates": BLACKLIST_DISCORDANT_MATES,
    "read_through": BLACKLIST_READ_THROUGH,
    "low_support": BLACKLIST_LOW_SUPPORT,
    "filter_spliced": BLACKLIST_FILTER_SPLICED,
    "not_both_spliced": BLACKLIST_NOT_BOTH_SPLICED,
}

GENOME_BIN_SIZE = 100000  # filter_blacklisted_ranges.cpp:228

GenomeBin = Tuple[int, int]


@dataclass
class BlacklistItem:
    """blacklist_item_t (filter_blacklisted_ranges.hpp:15-23)."""

    type: int = BLACKLIST_RANGE
    strand_defined: bool = False
    strand: bool = FORWARD
    contig: int = -1
    start: int = 0
    end: int = 0
    gene: int = -1


def _parse_range(range_text: str, contigs: ContigRegistry,
                 item: BlacklistItem) -> bool:
    """filter_blacklisted_ranges.cpp:17-82."""
    separator = range_text.rfind(":")
    if separator < 0:
        print(f"WARNING: unknown gene or malformed range: {range_text}", file=sys.stderr)
        return False
    contig_name = range_text[:separator]
    start_and_end = range_text[separator + 1:]
    if not contig_name or not start_and_end:
        print(f"WARNING: unknown gene or malformed range: {range_text}", file=sys.stderr)
        return False

    if contig_name[0] == "+":
        item.strand_defined = True
        item.strand = FORWARD
        contig_name = contig_name[1:]
    elif contig_name[0] == "-":
        item.strand_defined = True
        item.strand = REVERSE
        contig_name = contig_name[1:]
    else:
        item.strand_defined = False

    contig_name = remove_chr(contig_name)
    if len(contig_name) >= 2 and contig_name.endswith("*"):
        # wildcard: lexicographic lower_bound over sorted contig names
        prefix = contig_name[:-1]
        names = sorted(contigs.name_to_id)
        idx = bisect_left(names, prefix)
        if idx >= len(names) or not names[idx].startswith(prefix):
            return False
        item.contig = contigs.name_to_id[names[idx]]
    else:
        cid = contigs.name_to_id.get(contig_name)
        if cid is None:
            print(f"WARNING: unknown gene or malformed range: {range_text}", file=sys.stderr)
            return False
        item.contig = cid

    try:
        if "-" in start_and_end:
            start_text, end_text = start_and_end.split("-", 1)
            item.start = int(start_text) - 1
            item.end = int(end_text) - 1
        else:
            item.start = int(start_and_end) - 1
            item.end = item.start
    except ValueError:
        print(f"WARNING: unknown gene or malformed range: {range_text}", file=sys.stderr)
        return False
    return True


def parse_blacklist_item(text: str, contigs: ContigRegistry,
                         gene_names: Dict[str, int], genes: GeneTable,
                         allow_keyword: bool) -> Optional[BlacklistItem]:
    """filter_blacklisted_ranges.cpp:85-121."""
    if not text:
        print("WARNING: encountered a line with an empty column => skipped", file=sys.stderr)
        return None
    item = BlacklistItem()
    if allow_keyword and text in _KEYWORDS:
        item.type = _KEYWORDS[text]
        return item
    gene = gene_names.get(text)
    if gene is not None:
        item.type = BLACKLIST_GENE
        item.gene = gene
        item.contig = int(genes.contig[gene])
        item.start = int(genes.start[gene])
        item.end = int(genes.end[gene])
        return item
    if _parse_range(text, contigs, item):
        item.type = BLACKLIST_POSITION if item.start == item.end else BLACKLIST_RANGE
        return item
    return None


def overlapping_fraction(start1: int, end1: int, start2: int, end2: int) -> float:
    """filter_blacklisted_ranges.cpp:124-136 — fraction of range1 inside range2."""
    if start1 >= start2 and end1 <= end2:
        return 1.0
    if start1 < start2 and end1 > end2:
        return 1.0 * (end2 - start2) / (end1 - start1 + 1)
    if start2 <= start1 <= end2:
        return 1.0 * (end2 - start1) / (end1 - start1 + 1)
    if start2 <= end1 <= end2:
        return 1.0 * (end1 - start2) / (end1 - start1 + 1)
    return 0.0


def matches_blacklist_item(item: BlacklistItem, fusion: Fusion, which_breakpoint: int,
                           genes: GeneTable, max_mate_gap: int,
                           evalue_cutoff: float = 0.0) -> bool:
    """filter_blacklisted_ranges.cpp:139-219."""
    t = item.type
    if t == BLACKLIST_ANY:
        return True
    if t == BLACKLIST_SPLIT_READ_DONOR:
        return ((which_breakpoint == 1 and fusion.discordant_mates + fusion.split_reads1 == 0)
                or (which_breakpoint == 2 and fusion.discordant_mates + fusion.split_reads2 == 0))
    if t == BLACKLIST_SPLIT_READ_ACCEPTOR:
        return ((which_breakpoint == 1 and fusion.discordant_mates + fusion.split_reads2 == 0)
                or (which_breakpoint == 2 and fusion.discordant_mates + fusion.split_reads1 == 0))
    if t == BLACKLIST_SPLIT_READ_ANY:
        return fusion.discordant_mates == 0
    if t == BLACKLIST_DISCORDANT_MATES:
        return fusion.split_reads1 + fusion.split_reads2 == 0
    if t == BLACKLIST_READ_THROUGH:
        return fusion.is_read_through()
    if t == BLACKLIST_LOW_SUPPORT:
        return fusion.evalue > evalue_cutoff
    if t == BLACKLIST_FILTER_SPLICED:
        return fusion.evalue > evalue_cutoff and fusion.spliced1 and fusion.spliced2
    if t == BLACKLIST_NOT_BOTH_SPLICED:
        return not fusion.spliced1 or not fusion.spliced2
    if t == BLACKLIST_GENE:
        return ((which_breakpoint == 1 and fusion.gene1 == item.gene)
                or (which_breakpoint == 2 and fusion.gene2 == item.gene))

    contig = fusion.contig1 if which_breakpoint == 1 else fusion.contig2
    if contig != item.contig:
        return False
    if item.strand_defined and not fusion.predicted_strands_ambiguous:
        strand = fusion.predicted_strand1 if which_breakpoint == 1 else fusion.predicted_strand2
        if strand != item.strand:
            return False

    if t == BLACKLIST_POSITION:
        breakpoint = fusion.breakpoint1 if which_breakpoint == 1 else fusion.breakpoint2
        if breakpoint == item.start:
            return True
        if fusion.split_reads1 + fusion.split_reads2 == 0:
            direction = fusion.direction1 if which_breakpoint == 1 else fusion.direction2
            if (direction == DOWNSTREAM and item.start - max_mate_gap <= breakpoint <= item.start) or \
               (direction == UPSTREAM and item.start <= breakpoint <= item.start + max_mate_gap):
                return True
        return False

    # BLACKLIST_RANGE
    gene = fusion.gene1 if which_breakpoint == 1 else fusion.gene2
    return overlapping_fraction(int(genes.start[gene]), int(genes.end[gene]),
                                item.start, item.end) > 0.5


def get_genome_bins_from_range(contig: int, start: int, end: int,
                               genome_bins: List[GenomeBin]) -> None:
    """filter_blacklisted_ranges.cpp:226-230."""
    position = start // GENOME_BIN_SIZE
    last = (end + GENOME_BIN_SIZE - 1) // GENOME_BIN_SIZE
    while position <= last:
        genome_bins.append((contig, position * GENOME_BIN_SIZE))
        position += 1


def _iter_item_pair_lines(path: str) -> Iterable[Tuple[str, str]]:
    for line in iter_lines(path):
        if not line or line[0] == "#":
            continue
        columns = line.split("\t")
        if len(columns) < 2:
            # tsv_stream_t leaves the second field empty => parse fails later
            columns = columns + [""]
        yield columns[0], columns[1]


def _device_blacklist_triage(candidates, items, genes: GeneTable,
                             n_contigs: int, max_mate_gap: int):
    """Batch-screen candidate fusions on the device (ops/blacklist.py):
    a fusion whose breakpoint/gene-span genome bins overlap NO range-typed
    blacklist item's (mate-gap-padded) bins can never be matched by any
    item pair — bin membership is a necessary condition for the host's
    per-item matching loop — so it can skip bin registration entirely.
    Returns bool[n_candidates] ("may match"), or None when offload is off
    or there are no candidates."""
    import numpy as np

    from ..device import offload_enabled, torch_device
    if not candidates or not offload_enabled():
        return None
    rangeish = [item for pair in items for item in pair
                if item.type in (BLACKLIST_POSITION, BLACKLIST_RANGE,
                                 BLACKLIST_GENE)]
    if not rangeish:
        return np.zeros(len(candidates), bool)

    from ..ops.blacklist import (build_range_index, contig_offsets,
                                 query_intervals)
    B = GENOME_BIN_SIZE

    def bin_span(start: int, end: int):
        """Quantize to whole genome bins, clamped at 0 (bin -1 can never
        hold a fusion, whose coordinates are non-negative)."""
        lo = max(0, start) // B * B
        hi = (max(0, end) // B + 1) * B - 1
        return lo, hi

    # synthetic contig lengths: everything is quantized to bins, so one
    # bin of slack past the largest coordinate seen suffices
    lengths = np.zeros(n_contigs, np.int64)
    r_contig, r_lo, r_hi = [], [], []
    for item in rangeish:
        lo, hi = bin_span(item.start - max_mate_gap, item.end + max_mate_gap)
        r_contig.append(item.contig)
        r_lo.append(lo)
        r_hi.append(hi)
        lengths[item.contig] = max(lengths[item.contig], hi + B)
    q_contig, q_lo, q_hi = [], [], []
    for f in candidates:
        for contig, start, end in (
                (f.contig1, f.breakpoint1, f.breakpoint1),
                (f.contig2, f.breakpoint2, f.breakpoint2),
                (f.contig1, int(genes.start[f.gene1]), int(genes.end[f.gene1])),
                (f.contig2, int(genes.start[f.gene2]), int(genes.end[f.gene2]))):
            lo, hi = bin_span(start, end)
            q_contig.append(contig)
            q_lo.append(lo)
            q_hi.append(hi)
            lengths[contig] = max(lengths[contig], hi + B)
    offsets = contig_offsets(lengths)
    device = torch_device()
    starts, prefix_max_end = build_range_index(
        np.asarray(r_contig), np.asarray(r_lo), np.asarray(r_hi), offsets,
        device)
    base = offsets[np.asarray(q_contig, np.int64)]
    hits = query_intervals(
        starts, prefix_max_end,
        trace.upload(np.asarray(q_lo, np.int64) + base, device),
        trace.upload(np.asarray(q_hi, np.int64) + base, device)).cpu().numpy()
    return hits.reshape(len(candidates), 4).any(axis=1)


def filter_blacklisted_ranges(fusions: Fusions, blacklist_file_path: str,
                              contigs: ContigRegistry, gene_names: Dict[str, int],
                              genes: GeneTable, evalue_cutoff: float,
                              max_mate_gap: int) -> int:
    """filter_blacklisted_ranges.cpp:233-300."""
    from ..device import offload_enabled
    device = offload_enabled()

    items: List[Tuple[BlacklistItem, BlacklistItem]] = []
    item_pairs: Iterable[Tuple[BlacklistItem, BlacklistItem]]
    if device:
        # materialize the parsed items so the device triage sees all
        # range coordinates before fusions are binned
        for range1, range2 in _iter_item_pair_lines(blacklist_file_path):
            item1 = parse_blacklist_item(range1, contigs, gene_names, genes,
                                         False)
            if item1 is None:
                continue
            item2 = parse_blacklist_item(range2, contigs, gene_names, genes,
                                         True)
            if item2 is None:
                continue
            items.append((item1, item2))

    # index fusions by coordinate (100 kb genome bins)
    candidates = [f for f in fusions.values()
                  if f.filter == FILTER_NONE or f.closest_genomic_breakpoint1 >= 0]
    may_match = None
    if device:
        may_match = _device_blacklist_triage(candidates, items, genes,
                                             len(contigs), max_mate_gap)
    fusions_by_coordinate: Dict[GenomeBin, Dict[int, Fusion]] = defaultdict(dict)
    candidate_index = 0
    for order, f in enumerate(fusions.values()):
        if f.filter != FILTER_NONE and f.closest_genomic_breakpoint1 < 0:
            continue  # already filtered and not recoverable by genomic_support
        skip = may_match is not None and not may_match[candidate_index]
        candidate_index += 1
        if skip:
            continue  # device-triaged: overlaps no range-typed item's bins
        genome_bins: List[GenomeBin] = []
        get_genome_bins_from_range(f.contig1, f.breakpoint1, f.breakpoint1, genome_bins)
        get_genome_bins_from_range(f.contig2, f.breakpoint2, f.breakpoint2, genome_bins)
        get_genome_bins_from_range(f.contig1, int(genes.start[f.gene1]),
                                   int(genes.end[f.gene1]), genome_bins)
        get_genome_bins_from_range(f.contig2, int(genes.start[f.gene2]),
                                   int(genes.end[f.gene2]), genome_bins)
        for genome_bin in genome_bins:
            fusions_by_coordinate[genome_bin][order] = f

    if device:
        item_pairs = items
    else:
        def _stream():
            for range1, range2 in _iter_item_pair_lines(blacklist_file_path):
                item1 = parse_blacklist_item(range1, contigs, gene_names,
                                             genes, False)
                if item1 is None:
                    continue
                item2 = parse_blacklist_item(range2, contigs, gene_names,
                                             genes, True)
                if item2 is None:
                    continue
                yield item1, item2
        item_pairs = _stream()

    for item1, item2 in item_pairs:
        genome_bins = []
        if item1.type in (BLACKLIST_POSITION, BLACKLIST_RANGE, BLACKLIST_GENE):
            get_genome_bins_from_range(item1.contig, item1.start - max_mate_gap,
                                       item1.end + max_mate_gap, genome_bins)
        if item2.type in (BLACKLIST_POSITION, BLACKLIST_RANGE, BLACKLIST_GENE):
            get_genome_bins_from_range(item2.contig, item2.start - max_mate_gap,
                                       item2.end + max_mate_gap, genome_bins)
        for genome_bin in genome_bins:
            bin_fusions = fusions_by_coordinate.get(genome_bin)
            if bin_fusions is None:
                continue
            matched = []
            for order, f in bin_fusions.items():
                if (matches_blacklist_item(item1, f, 1, genes, max_mate_gap, evalue_cutoff)
                        and matches_blacklist_item(item2, f, 2, genes, max_mate_gap, evalue_cutoff)) or \
                   (matches_blacklist_item(item1, f, 2, genes, max_mate_gap, evalue_cutoff)
                        and matches_blacklist_item(item2, f, 1, genes, max_mate_gap, evalue_cutoff)):
                    f.filter = FILTER_BLACKLIST
                    matched.append(order)
            for order in matched:  # don't check this fusion again in this bin
                del bin_fusions[order]

    return sum(1 for f in fusions.values() if f.filter == FILTER_NONE)


# ---------------------------------------------------------------------------
# recover_known_fusions.cpp


def recover_known_fusions(fusions: Fusions, known_fusions_file_path: str,
                          contigs: ContigRegistry, gene_names: Dict[str, int],
                          genes: GeneTable, coverage: Coverage,
                          max_mate_gap: int) -> int:
    """recover_known_fusions.cpp:14-100."""
    known_by_coordinate: Dict[GenomeBin, List[Tuple[BlacklistItem, BlacklistItem]]] = \
        defaultdict(list)
    for range1, range2 in _iter_item_pair_lines(known_fusions_file_path):
        item1 = parse_blacklist_item(range1, contigs, gene_names, genes, False)
        item2 = parse_blacklist_item(range2, contigs, gene_names, genes, False)
        if item1 is None or item2 is None:
            continue
        genome_bins: List[GenomeBin] = []
        get_genome_bins_from_range(item1.contig, item1.start, item1.end, genome_bins)
        get_genome_bins_from_range(item2.contig, item2.start, item2.end, genome_bins)
        for genome_bin in genome_bins:
            known_by_coordinate[genome_bin].append((item1, item2))

    for f in fusions.values():
        if f.filter == FILTER_NONE:
            continue
        if f.gene1 == f.gene2:
            continue
        if f.filter not in (FILTER_RELATIVE_SUPPORT, FILTER_MIN_SUPPORT):
            continue

        genome_bins = []
        get_genome_bins_from_range(f.contig1, f.breakpoint1, f.breakpoint1, genome_bins)
        get_genome_bins_from_range(f.contig2, f.breakpoint2, f.breakpoint2, genome_bins)
        get_genome_bins_from_range(f.contig1, int(genes.start[f.gene1]),
                                   int(genes.end[f.gene1]), genome_bins)
        get_genome_bins_from_range(f.contig2, int(genes.start[f.gene2]),
                                   int(genes.end[f.gene2]), genome_bins)
        for genome_bin in genome_bins:
            for item1, item2 in known_by_coordinate.get(genome_bin, ()):
                gene_5 = 1 if f.transcript_start == TRANSCRIPT_START_GENE1 else 2
                gene_3 = 2 if f.transcript_start == TRANSCRIPT_START_GENE1 else 1
                match_found = (matches_blacklist_item(item1, f, gene_5, genes, max_mate_gap)
                               and matches_blacklist_item(item2, f, gene_3, genes, max_mate_gap))
                if (not match_found and f.transcript_start_ambiguous
                        and not (f.contig1 == f.contig2
                                 and abs(f.breakpoint2 - f.breakpoint1) < 1000000)):
                    match_found = (matches_blacklist_item(item1, f, gene_3, genes, max_mate_gap)
                                   and matches_blacklist_item(item2, f, gene_5, genes, max_mate_gap))
                if match_found:
                    if ((item1.type == BLACKLIST_POSITION and item2.type == BLACKLIST_POSITION)
                            or f.supporting_reads() >= 2
                            or (f.both_breakpoints_spliced(genes)
                                and coverage.get_coverage(
                                    f.contig1, f.breakpoint1,
                                    DOWNSTREAM if f.direction1 == UPSTREAM else UPSTREAM)
                                + coverage.get_coverage(
                                    f.contig2, f.breakpoint2,
                                    DOWNSTREAM if f.direction2 == UPSTREAM else UPSTREAM) < 200
                                and (f.contig1 != f.contig2
                                     or abs(f.breakpoint2 - f.breakpoint1) > 1000000))):
                        f.filter = FILTER_NONE

    return sum(1 for f in fusions.values() if f.filter == FILTER_NONE)
