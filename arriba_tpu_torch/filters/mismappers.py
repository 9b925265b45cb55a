"""Realignment filter: k-mer seeded seed-and-extend against the partner gene.

Reference parity: source/filter_mismappers.cpp. The 8-mer index over padded
fusion genes lives in the native realignment engine when it is loaded, and
is otherwise built vectorized (numpy rolling 2-bit encoding); align() is
the reference's bounded recursive seed-and-extend with splice-site and
single-deletion recursion and early exit at 80 % identity. With device
offload on (ARRIBA_TPU_TORCH_DEVICE=cuda or cpu), filter_mismappers first
batches every (read sequence, padded gene window) pair it would realign
through the device screen (ops/realign.screen_resident, kernel K5 on CUDA,
a sound shared-8-mer REJECT) and the exact single-seed ACCEPT
(ops/realign.accept_resident, kernel K1 on CUDA), both reading the distinct
windows and reads from tables copied to the device once; only undecided
pairs reach the exact recursion.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import trace
from .._native_build import engine
from ..annotation.index import IntervalIndex
from ..annotation.queries import is_breakpoint_spliced
from ..annotation.tables import ExonTable, GeneTable
from ..constants import (DOWNSTREAM, FILTER_MISMAPPERS, FILTER_NONE, FORWARD,
                         MATE1, MATE2, SPLIT_READ, SUPPLEMENTARY, UPSTREAM)
from ..fusion import Fusions
from ..io.fasta import Assembly
from ..model import Alignment, ChimericAlignments
from ..seq import reverse_complement_str

# the native realignment engine (exact recursion in C++); None for the
# pure-Python engine
_native = engine()

# 2-bit base encoding of the reference's kmer_to_int: T=0, G=1, C=2, other=3
KMER_BASE_LUT = np.full(256, 3, dtype=np.int64)
KMER_BASE_LUT[ord("T")] = 0
KMER_BASE_LUT[ord("G")] = 1
KMER_BASE_LUT[ord("C")] = 2

# kmer value -> sorted unique positions, one dict per contig
KmerIndex = Dict[int, np.ndarray]


class KmerIndices(dict):
    """contig -> KmerIndex (empty where the native engine holds the
    positions: in_engine), plus the coverage metadata the device accept
    path needs for soundness: which genes were indexed and with what
    padding (a device single-seed accept is only honored where the host
    index provably contains the seed position)."""

    padding: int = -1
    indexed_genes: frozenset = frozenset()
    in_engine: bool = False


def kmer_to_int(sequence: str, position: int, kmer_length: int) -> int:
    """filter_mismappers.cpp:33-45."""
    result = 0
    for base in sequence[position:position + kmer_length]:
        result = (result << 2) | int(KMER_BASE_LUT[ord(base)])
    return result


def _rolling_kmers(codes: np.ndarray, kmer_length: int) -> np.ndarray:
    """2-bit rolling k-mer values for every start position (vectorized)."""
    n = len(codes) - kmer_length + 1
    if n <= 0:
        return np.empty(0, np.int64)
    values = np.zeros(n, np.int64)
    for j in range(kmer_length):
        values = (values << 2) | codes[j:j + n]
    return values


def make_kmer_index(fusions: Fusions, assembly: Assembly, genes: GeneTable,
                    padding: int, kmer_length: int) -> KmerIndices:
    """filter_mismappers.cpp:47-84 — index k-mer positions over the padded
    regions of genes involved in unfiltered inter-gene fusions."""
    genes_to_filter: Set[int] = set()
    for f in fusions.values():
        if f.filter != FILTER_NONE or f.gene1 == f.gene2:
            continue
        genes_to_filter.add(f.gene1)
        genes_to_filter.add(f.gene2)

    if padding < 0:
        padding = 0

    kmer_indices = KmerIndices()
    kmer_indices.padding = padding
    kmer_indices.indexed_genes = frozenset(genes_to_filter)

    # mirror the index into the native realignment engine; the table says
    # so (in_engine), every reader of the positions (align_both_strands,
    # is_homolog) then asks the engine, and the table keeps only its
    # contigs, each with an empty index, for the presence test
    _NATIVE_SPLICE_REGISTERED.clear()
    if _native is not None:
        _native.realign_reset()
        for contig in sorted({int(genes.contig[g]) for g in genes_to_filter}):
            seq = assembly.get(contig)
            if seq is not None:
                _native.realign_set_contig(contig, seq)
        for gene in sorted(genes_to_filter):
            contig = int(genes.contig[gene])
            seq = assembly.get(contig)
            if seq is None:
                continue
            gene_start = max(int(genes.start[gene]) - padding, 0)
            gene_end = min(int(genes.end[gene]) + padding, len(seq) - 1)
            _native.realign_add_kmers(contig, gene_start, gene_end)
            kmer_indices.setdefault(contig, {})
        _native.realign_finalize()
        kmer_indices.in_engine = True
        return kmer_indices

    # collect (kmer, position) pairs per contig, then group
    per_contig: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for gene in sorted(genes_to_filter):
        contig = int(genes.contig[gene])
        contig_sequence = assembly.get(contig)
        if contig_sequence is None:
            continue
        gene_start = max(int(genes.start[gene]) - padding, 0)
        gene_end = min(int(genes.end[gene]) + padding, len(contig_sequence) - 1)
        # reference indexes pos in [gene_start, gene_end - kmer_length)
        window = contig_sequence[gene_start:gene_end]
        codes = KMER_BASE_LUT[window]
        values = _rolling_kmers(codes, kmer_length)
        # exclude the final position (pos + kmer_length < gene_end is strict)
        n = max(0, (gene_end - kmer_length) - gene_start)
        values = values[:n]
        positions = np.arange(gene_start, gene_start + len(values), dtype=np.int64)
        not_n = window[:len(values)] != ord("N")
        per_contig.setdefault(contig, []).append((values[not_n], positions[not_n]))

    for contig, chunks in per_contig.items():
        values = np.concatenate([v for v, _ in chunks])
        positions = np.concatenate([p for _, p in chunks])
        order = np.lexsort((positions, values))
        values = values[order]
        positions = positions[order]
        # unique positions per kmer (overlapping genes index twice)
        index: KmerIndex = {}
        boundaries = np.nonzero(np.diff(values))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(values)]])
        for s, e in zip(starts, ends):
            pos = positions[s:e]
            keep = np.concatenate([[True], pos[1:] != pos[:-1]]) if len(pos) > 1 else \
                np.ones(len(pos), bool)
            index[int(values[s])] = pos[keep]
        kmer_indices[contig] = index
    return kmer_indices


def indexed_bases(kmer_indices: KmerIndices, assembly: Assembly,
                  genes: GeneTable) -> int:
    """The bases of the padded gene windows make_kmer_index indexed."""
    total = 0
    for gene in kmer_indices.indexed_genes:
        contig_sequence = assembly.get(int(genes.contig[gene]))
        if contig_sequence is None:
            continue
        gene_start = max(int(genes.start[gene]) - kmer_indices.padding, 0)
        gene_end = min(int(genes.end[gene]) + kmer_indices.padding,
                       len(contig_sequence) - 1)
        total += max(gene_end - gene_start, 0)
    return total


def get_downstream_splice_sites(gene: int, genes: GeneTable, exons: ExonTable,
                                exon_index: IntervalIndex) -> List[int]:
    """filter_mismappers.cpp:16-31 — sorted downstream splice sites of a gene."""
    contig = int(genes.contig[gene])
    if contig >= exon_index.n_contigs or len(exon_index.boundaries[contig]) == 0:
        return []
    bounds = exon_index.boundaries[contig]
    gene_start = int(genes.start[gene])
    gene_end = int(genes.end[gene])
    splice_sites: List[int] = []
    idx = int(np.searchsorted(bounds, gene_start, side="left"))
    while idx < len(bounds) and bounds[idx] <= gene_end:
        position = int(bounds[idx])
        if is_breakpoint_spliced(gene, DOWNSTREAM, position, genes, exons, exon_index):
            splice_sites.append(position)
        idx += 1
    return splice_sites


def align(score: int, read_sequence: str, read_pos: int, contig_sequence: np.ndarray,
          gene_pos: int, gene_start: int, gene_end: int, kmer_index: KmerIndex,
          kmer_length: int, splice_sites: List[int], min_score: int,
          max_deletions: int) -> bool:
    """filter_mismappers.cpp:86-187 — recursive seed-and-extend.

    Recursion depth is structurally bounded: both the splice-site and the
    single-deletion recursions restart the seed search at
    extended_read_pos >= read_pos + kmer_length, so the stack never grows
    deeper than ~read_length / kmer_length (reads are < 300 nt, see
    align_both_strands), well inside Python's default recursion limit."""
    skipped_bases = 0
    read_length = len(read_sequence)

    while (read_pos + kmer_length < read_length
           and read_pos + min_score <= read_length + score + 2 * kmer_length):

        hits = kmer_index.get(kmer_to_int(read_sequence, read_pos, kmer_length))
        if hits is not None:
            for hit_idx in range(int(np.searchsorted(hits, gene_pos, side="left")), len(hits)):
                kmer_hit = int(hits[hit_idx])
                if kmer_hit >= gene_end:
                    break

                extended_score = score + kmer_length
                if read_pos == skipped_bases:
                    extended_score += skipped_bases  # local alignment: free leading skips
                if extended_score >= min_score:
                    return True

                # extend match locally to the left (score carries over into
                # the right extension, as in the reference)
                extended_read_pos = read_pos - 1
                extended_gene_pos = kmer_hit - 1
                mismatch_count = 0
                while extended_read_pos >= read_pos - skipped_bases and extended_gene_pos >= gene_start:
                    if ord(read_sequence[extended_read_pos]) == contig_sequence[extended_gene_pos]:
                        extended_score += 1 if read_pos == skipped_bases else 2
                        if extended_score >= min_score:
                            return True
                    else:
                        mismatch_count += 1
                        if mismatch_count > 1:
                            break
                    extended_read_pos -= 1
                    extended_gene_pos -= 1

                # extend match locally to the right
                extended_read_pos = read_pos + kmer_length
                extended_gene_pos = kmer_hit + kmer_length
                mismatch_count = 0
                consecutive_mismatches = 0
                splice_idx = bisect_left(splice_sites, extended_gene_pos - 1)
                while extended_read_pos < read_length and extended_gene_pos <= gene_end:
                    if splice_idx < len(splice_sites):
                        if extended_gene_pos - 1 > splice_sites[splice_idx]:
                            splice_idx += 1
                        if splice_idx < len(splice_sites) and \
                                extended_gene_pos - 1 == splice_sites[splice_idx]:
                            if align(extended_score, read_sequence, extended_read_pos,
                                     contig_sequence, extended_gene_pos, gene_start, gene_end,
                                     kmer_index, kmer_length, splice_sites, min_score,
                                     max_deletions):
                                return True

                    if ord(read_sequence[extended_read_pos]) == contig_sequence[extended_gene_pos]:
                        extended_score += 1
                        if extended_score >= min_score:
                            return True
                        consecutive_mismatches = 0
                    else:
                        mismatch_count += 1
                        if mismatch_count == 1:
                            if (max_deletions > 0 and read_length >= 30
                                    and align(extended_score, read_sequence, extended_read_pos,
                                              contig_sequence, extended_gene_pos, gene_start,
                                              gene_end, kmer_index, kmer_length, splice_sites,
                                              min_score, max_deletions - 1)):
                                return True
                        extended_score -= 1
                        consecutive_mismatches += 1
                        if consecutive_mismatches >= 4:
                            break
                    extended_read_pos += 1
                    extended_gene_pos += 1

        read_pos += 1
        score -= 1
        skipped_bases += 1

    return False


def align_both_strands(read_sequence: str, read_length: int, max_mate_gap: int,
                       breakpoints_on_same_contig: bool, alignment_start: int,
                       alignment_end: int, kmer_indices: KmerIndices,
                       assembly: Assembly, genes: GeneTable, exons: ExonTable,
                       exon_index: IntervalIndex,
                       splice_sites_by_gene: Dict[int, List[int]],
                       gene_set: np.ndarray, kmer_length: int,
                       min_align_fraction: float,
                       screen: Optional[Callable[[int], int]] = None) -> bool:
    """filter_mismappers.cpp:189-230. `screen(gene)` (when given) returns a
    tri-state device verdict: SCREEN_REJECT for genes the device prefilter
    proved cannot align, SCREEN_ACCEPT for genes an exact device single-seed
    path already aligned (skip the recursion entirely), SCREEN_UNDECIDED
    otherwise."""
    if len(read_sequence) >= 300:
        return False

    min_score = int(min_align_fraction * len(read_sequence) + 0.5)
    for gene in gene_set:
        gene = int(gene)
        verdict = SCREEN_UNDECIDED if screen is None else screen(gene)
        if verdict == SCREEN_REJECT:
            continue
        if gene not in splice_sites_by_gene:
            splice_sites_by_gene[gene] = get_downstream_splice_sites(gene, genes, exons,
                                                                     exon_index)
        contig = int(genes.contig[gene])
        contig_sequence = assembly.get(contig)
        if contig_sequence is None:
            continue
        gene_start = max(int(genes.start[gene]) - max_mate_gap - read_length, 0)
        gene_end = min(int(genes.end[gene]) + max_mate_gap + read_length,
                       len(contig_sequence) - 1)

        # for intragenic events, both genes overlap the breakpoint => skip
        if breakpoints_on_same_contig and (
                gene_start <= alignment_start <= gene_end
                or gene_start <= alignment_end <= gene_end):
            continue

        kmer_index = kmer_indices.get(contig)
        if kmer_index is None:
            continue

        # the device proved an exact single-seed align() path for this
        # (read, gene): the recursion would accept too — skip it
        if verdict == SCREEN_ACCEPT:
            return True

        splice_sites = splice_sites_by_gene[gene]
        if kmer_indices.in_engine:
            if gene not in _NATIVE_SPLICE_REGISTERED:
                _native.realign_set_splice_sites(
                    gene, np.asarray(splice_sites, np.int64).tobytes())
                _NATIVE_SPLICE_REGISTERED.add(gene)
            read_bytes = read_sequence.encode("latin-1")
            if _native.realign_align(read_bytes, contig, gene_start, gene_end,
                                     gene, min_score, 1):
                return True
            if _native.realign_align(
                    reverse_complement_str(read_sequence).encode("latin-1"),
                    contig, gene_start, gene_end, gene, min_score, 1):
                return True
            continue
        if align(0, read_sequence, 0, contig_sequence, gene_start, gene_start, gene_end,
                 kmer_index, kmer_length, splice_sites, min_score, 1):
            return True
        if align(0, reverse_complement_str(read_sequence), 0, contig_sequence, gene_start,
                 gene_start, gene_end, kmer_index, kmer_length, splice_sites, min_score, 1):
            return True
    return False


_NATIVE_SPLICE_REGISTERED: Set[int] = set()


def extend_split_read(split_read: Alignment, assembly: Assembly,
                      min_align_fraction: float) -> bool:
    """filter_mismappers.cpp:247-270 — check whether STAR clipped prematurely."""
    contig_sequence = assembly[split_read.contig]
    if split_read.strand == FORWARD:
        clipped_count = min(split_read.preclipping(), split_read.start)
        clipped = split_read.sequence[split_read.preclipping() - clipped_count:
                                     split_read.preclipping()]
        reference = contig_sequence[split_read.start - clipped_count:split_read.start]
    else:
        clipped_count = min(split_read.postclipping(),
                            len(contig_sequence) - split_read.end - 2)
        clipped = split_read.sequence[len(split_read.sequence) - split_read.postclipping():
                                     len(split_read.sequence) - split_read.postclipping()
                                     + clipped_count]
        reference = contig_sequence[split_read.end + 1:split_read.end + 1 + clipped_count]

    matching_bases = 0
    for i in range(len(clipped)):
        if ord(clipped[i]) == reference[i]:
            matching_bases += 1
    return matching_bases >= int(np.floor(len(clipped) * min_align_fraction))


def _count_mismappers(read_list: List[str], chimeric_alignments: ChimericAlignments,
                      counters: List[int], supporting_reads: int) -> int:
    """filter_mismappers.cpp:232-244; counters = [mismappers, total_reads]."""
    for name in read_list:
        mates = chimeric_alignments[name]
        if mates.filter == FILTER_NONE:
            counters[1] += 1
        elif mates.filter == FILTER_MISMAPPERS:
            counters[1] += 1
            counters[0] += 1
            if supporting_reads > 0:
                supporting_reads -= 1
    return supporting_reads


# tri-state device verdicts for a (read, kind, gene) realignment candidate
SCREEN_REJECT = 0     # no shared 8-mer in either orientation: align() False
SCREEN_UNDECIDED = 1  # run the host recursion
SCREEN_ACCEPT = 2     # a single-seed align() path reaches min_score: True


def collect_screen_tasks(fusions: Fusions,
                         chimeric_alignments: ChimericAlignments,
                         assembly: Assembly, genes: GeneTable,
                         max_mate_gap: int,
                         min_align_fraction: float = 0.8,
                         kmer_indices: Optional[KmerIndices] = None):
    """Enumerate every (read sequence, padded gene window) pair that
    filter_mismappers may hand to align_both_strands, deduplicated by
    (read name, sequence kind, gene). Kinds: 0 = clipped segment vs the
    split read's genes, 1 = mate1 segment vs the supplementary's genes,
    2/3 = discordant mate1/mate2 vs the partner's genes
    (filter_mismappers.cpp:282-341).

    Returns (keys, seqs, windows, window_ids, min_scores, accept_ok):
    window_ids[i] names the distinct window (contig, gene_start, gene_end)
    of windows[i]; min_scores is the reference's per-call threshold
    arithmetic; accept_ok[i] is True only if
    at least one fusion context actually runs align() for this pair (the
    intragenic same-contig skip at filter_mismappers.cpp:205-210 never
    fires) AND the host k-mer index provably covers the whole window (gene
    indexed by make_kmer_index with padding >= this window's padding), so
    every seed the device finds is one the host lookup would find too."""
    index_padding = getattr(kmer_indices, "padding", -1)
    indexed_genes = getattr(kmer_indices, "indexed_genes", frozenset())
    seen: Dict[Tuple[str, int, int], int] = {}
    keys: List[Tuple[str, int, int]] = []
    seqs: List[str] = []
    windows: List[np.ndarray] = []
    window_ids: List[int] = []
    min_scores: List[int] = []
    accept_ok: List[bool] = []
    # an id and a view a distinct window
    views: Dict[Tuple[int, int, int], Tuple[int, np.ndarray]] = {}

    def add(name: str, kind: int, seq: str, read_length: int,
            gene_set, fraction: float, same_contig: bool,
            alignment_start: int, alignment_end: int) -> None:
        if len(seq) >= 300:
            return
        min_score = int(fraction * len(seq) + 0.5)
        for gene in gene_set:
            gene = int(gene)
            key = (name, kind, gene)
            contig = int(genes.contig[gene])
            contig_sequence = assembly.get(contig)
            if contig_sequence is None:
                continue
            gene_start = max(int(genes.start[gene]) - max_mate_gap - read_length, 0)
            gene_end = min(int(genes.end[gene]) + max_mate_gap + read_length,
                           len(contig_sequence) - 1)
            skipped = same_contig and (
                gene_start <= alignment_start <= gene_end
                or gene_start <= alignment_end <= gene_end)
            # host-index coverage of the whole window: the indexed window
            # of this gene (make_kmer_index padding) must contain ours
            covered = (gene in indexed_genes
                       and max(int(genes.start[gene]) - index_padding, 0)
                       <= gene_start
                       and gene_end <= min(int(genes.end[gene]) + index_padding,
                                           len(contig_sequence) - 1))
            row = seen.get(key)
            if row is not None:
                accept_ok[row] = accept_ok[row] or (not skipped and covered)
                continue
            seen[key] = len(keys)
            keys.append(key)
            seqs.append(seq)
            window = views.get((contig, gene_start, gene_end))
            if window is None:
                window = views[(contig, gene_start, gene_end)] = (
                    len(views), contig_sequence[gene_start:gene_end + 1])
            window_ids.append(window[0])
            windows.append(window[1])
            min_scores.append(min_score)
            accept_ok.append(not skipped and covered)

    for f in fusions.values():
        if f.filter != FILTER_NONE:
            continue
        same_contig = f.contig1 == f.contig2
        for name in f.split_read1_list + f.split_read2_list:
            mates = chimeric_alignments[name]
            if mates.filter != FILTER_NONE:
                continue
            split_read = mates[SPLIT_READ]
            supplementary = mates[SUPPLEMENTARY]
            mate1 = mates[MATE1]
            if split_read.strand == FORWARD:
                clipped_seq = split_read.sequence[:split_read.preclipping()]
                mate1_seq = mate1.sequence[mate1.preclipping():]
            else:
                clipped_seq = split_read.sequence[len(split_read.sequence)
                                                  - split_read.postclipping():]
                mate1_seq = mate1.sequence[:len(mate1.sequence) - mate1.postclipping()]
            add(name, 0, clipped_seq, len(split_read.sequence), split_read.genes,
                min_align_fraction, same_contig,
                supplementary.start, supplementary.end)
            add(name, 1, mate1_seq, len(mate1.sequence), supplementary.genes,
                min_align_fraction, same_contig, mate1.start, mate1.end)
        for name in f.discordant_mate_list:
            mates = chimeric_alignments[name]
            if mates.filter != FILTER_NONE:
                continue
            mate1, mate2 = mates[MATE1], mates[MATE2]
            clipped_fraction1 = float(mate1.preclipping() + mate1.postclipping()) / len(mate1.sequence)
            clipped_fraction2 = float(mate2.preclipping() + mate2.postclipping()) / len(mate2.sequence)
            add(name, 2, mate1.sequence, len(mate1.sequence), mate2.genes,
                min(min_align_fraction,
                    min_align_fraction * (1 - clipped_fraction1)),
                same_contig, mate1.start, mate1.end)
            add(name, 3, mate2.sequence, len(mate2.sequence), mate1.genes,
                min(min_align_fraction,
                    min_align_fraction * (1 - clipped_fraction2)),
                same_contig, mate2.start, mate2.end)
    return keys, seqs, windows, window_ids, min_scores, accept_ok


def device_screen(fusions: Fusions, chimeric_alignments: ChimericAlignments,
                  assembly: Assembly, genes: GeneTable, max_mate_gap: int,
                  kmer_indices: Optional[KmerIndices] = None
                  ) -> Dict[Tuple[str, int, int], int]:
    """Batch-classify all realignment candidates on the device into
    tri-state verdicts: REJECT when the read (either strand) shares no
    8-mer with the padded gene window (the seed lookup at
    filter_mismappers.cpp:97-99 can never fire), ACCEPT when an exact
    single-seed align() path reaches min_score (ops/realign.accept_wavefront
    reproduces the reference's scoring arithmetic), UNDECIDED otherwise
    (host recursion decides — only it can accept via splice/deletion
    chains). Both steps read the distinct windows and reads from tables
    copied to the device once (ops/realign.resident_pairs): K5 screens
    each pair against its whole window, K1's rows index the tables."""
    from ..ops.realign import accept_resident, resident_pairs, screen_resident
    with trace.span("screen.collect"):
        keys, seqs, windows, window_ids, min_scores, accept_ok = \
            collect_screen_tasks(fusions, chimeric_alignments, assembly,
                                 genes, max_mate_gap,
                                 kmer_indices=kmer_indices)
    trace.count("screen.pairs", len(keys))
    if not keys:
        return {}
    # the distinct windows and reads go to the device once, for both steps
    resident = resident_pairs(seqs, windows, window_ids=window_ids)
    shared = screen_resident(resident)
    verdict = np.where(shared, SCREEN_UNDECIDED, SCREEN_REJECT)
    rows = np.flatnonzero(shared & np.asarray(accept_ok, bool))
    if len(rows):
        accepted = accept_resident(resident, rows,
                                   np.asarray(min_scores, np.int64)[rows])
        verdict[rows[accepted]] = SCREEN_ACCEPT
    if trace.active():
        trace.count("screen.undecided",
                    np.count_nonzero(verdict == SCREEN_UNDECIDED))
    return dict(zip(keys, verdict.tolist()))


def filter_mismappers(fusions: Fusions, chimeric_alignments: ChimericAlignments,
                      kmer_indices: KmerIndices, kmer_length: int, assembly: Assembly,
                      genes: GeneTable, exons: ExonTable, exon_index: IntervalIndex,
                      max_mismapper_fraction: float, max_mate_gap: int) -> int:
    """filter_mismappers.cpp:272-359."""
    min_align_fraction = 0.8
    min_extended_align_fraction = 0.7

    splice_sites_by_gene: Dict[int, List[int]] = {}

    from ..device import offload_enabled
    screen_map: Optional[Dict[Tuple[str, int, int], int]] = None
    if offload_enabled():
        screen_map = device_screen(fusions, chimeric_alignments, assembly,
                                   genes, max_mate_gap, kmer_indices)

    def _screen(name: str, kind: int) -> Optional[Callable[[int], int]]:
        if screen_map is None:
            return None
        return lambda gene: screen_map.get((name, kind, int(gene)),
                                           SCREEN_UNDECIDED)

    # the host recursion: align() on every pair the screen left UNDECIDED
    # (on every pair without the screen)
    with trace.span("screen.host_recursion"):
        for f in fusions.values():
            if f.filter != FILTER_NONE:
                continue

            same_contig = f.contig1 == f.contig2

            # re-align split reads
            for name in f.split_read1_list + f.split_read2_list:
                mates = chimeric_alignments[name]
                if mates.filter != FILTER_NONE:
                    continue
                split_read = mates[SPLIT_READ]
                supplementary = mates[SUPPLEMENTARY]
                mate1 = mates[MATE1]

                if split_read.strand == FORWARD:
                    clipped_seq = split_read.sequence[:split_read.preclipping()]
                    mate1_seq = mate1.sequence[mate1.preclipping():]
                else:
                    clipped_seq = split_read.sequence[len(split_read.sequence)
                                                      - split_read.postclipping():]
                    mate1_seq = mate1.sequence[:len(mate1.sequence) - mate1.postclipping()]

                if (extend_split_read(split_read, assembly, min_extended_align_fraction)
                        or align_both_strands(clipped_seq, len(split_read.sequence), max_mate_gap,
                                              same_contig, supplementary.start, supplementary.end,
                                              kmer_indices, assembly, genes, exons, exon_index,
                                              splice_sites_by_gene, split_read.genes, kmer_length,
                                              min_align_fraction, _screen(name, 0))
                        or align_both_strands(mate1_seq, len(mate1.sequence), max_mate_gap,
                                              same_contig, mate1.start, mate1.end, kmer_indices,
                                              assembly, genes, exons, exon_index,
                                              splice_sites_by_gene, supplementary.genes,
                                              kmer_length, min_align_fraction,
                                              _screen(name, 1))):
                    mates.filter = FILTER_MISMAPPERS

            # re-align discordant mates
            for name in f.discordant_mate_list:
                mates = chimeric_alignments[name]
                if mates.filter != FILTER_NONE:
                    continue
                mate1, mate2 = mates[MATE1], mates[MATE2]
                clipped_fraction1 = float(mate1.preclipping() + mate1.postclipping()) / len(mate1.sequence)
                clipped_fraction2 = float(mate2.preclipping() + mate2.postclipping()) / len(mate2.sequence)
                if (align_both_strands(mate1.sequence, len(mate1.sequence), max_mate_gap,
                                       same_contig, mate1.start, mate1.end, kmer_indices, assembly,
                                       genes, exons, exon_index, splice_sites_by_gene, mate2.genes,
                                       kmer_length,
                                       min(min_align_fraction, min_align_fraction * (1 - clipped_fraction1)),
                                       _screen(name, 2))
                        or align_both_strands(mate2.sequence, len(mate2.sequence), max_mate_gap,
                                              same_contig, mate2.start, mate2.end, kmer_indices,
                                              assembly, genes, exons, exon_index,
                                              splice_sites_by_gene, mate1.genes, kmer_length,
                                              min(min_align_fraction,
                                                  min_align_fraction * (1 - clipped_fraction2)),
                                              _screen(name, 3))):
                    mates.filter = FILTER_MISMAPPERS

    # discard all fusions with more than max_mismapper_fraction mismappers
    remaining = 0
    for f in fusions.values():
        if f.filter != FILTER_NONE:
            continue
        counters = [0, 0]  # [mismappers, total_reads]
        f.split_reads1 = _count_mismappers(f.split_read1_list, chimeric_alignments,
                                           counters, f.split_reads1)
        f.split_reads2 = _count_mismappers(f.split_read2_list, chimeric_alignments,
                                           counters, f.split_reads2)
        f.discordant_mates = _count_mismappers(f.discordant_mate_list, chimeric_alignments,
                                               counters, f.discordant_mates)
        mismappers, total_reads = counters
        if mismappers > 0 and mismappers >= int(np.floor(max_mismapper_fraction * total_reads)):
            f.filter = FILTER_MISMAPPERS
        else:
            remaining += 1
    return remaining
