"""Homology filter: discard fusions between genes with high sequence identity.

Reference parity: source/filter_homologs.cpp — 8+8-mer matches of the
smaller gene's sequence inside the bigger gene, plus cross-fusion homolog
arbitration that keeps the better-supported of two events sharing a gene.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .._native_build import engine
from ..annotation.tables import GeneTable
from ..constants import FILTER_HOMOLOGS, FILTER_NONE
from ..fusion import Fusion, Fusions
from ..io.fasta import Assembly
from ..seq import reverse_complement
from .mismappers import KmerIndices, kmer_to_int


def is_homolog(gene1: int, gene2: int, kmer_indices: KmerIndices, kmer_length: int,
               assembly: Assembly, genes: GeneTable, max_identity_fraction: float) -> bool:
    """filter_homologs.cpp:13-63."""
    extended_kmer_length = 8

    if gene1 == gene2:
        return False

    small_gene, big_gene = gene1, gene2
    if genes.length(small_gene) > genes.length(big_gene):
        small_gene, big_gene = big_gene, small_gene

    # overlapping genes trivially share sequence
    if genes.contig[small_gene] == genes.contig[big_gene] and (
            genes.start[big_gene] <= genes.start[small_gene] <= genes.end[big_gene]
            or genes.start[big_gene] <= genes.end[small_gene] <= genes.end[big_gene]):
        return False

    small_contig = int(genes.contig[small_gene])
    big_contig = int(genes.contig[big_gene])
    small_start = int(genes.start[small_gene])
    small_end = int(genes.end[small_gene])
    big_start = int(genes.start[big_gene])
    big_end = int(genes.end[big_gene])
    small_length = genes.length(small_gene)

    small_gene_sequence = assembly[small_contig][small_start:small_start + small_length]
    if bool(genes.strand[small_gene]) != bool(genes.strand[big_gene]):
        small_gene_sequence = reverse_complement(small_gene_sequence)

    if getattr(kmer_indices, "in_engine", False):  # {}: no table was made
        return bool(engine().realign_is_homolog(
            small_gene_sequence.tobytes(), small_contig, small_start, small_end,
            big_contig, big_start, big_end, small_length, max_identity_fraction))

    small_seq_str = small_gene_sequence.tobytes().decode("latin-1")
    big_contig_sequence = assembly[big_contig]

    big_kmer_index = kmer_indices.get(big_contig, {})

    matching_kmers = 0
    pos = 0
    size = len(small_seq_str)
    threshold = small_length * max_identity_fraction
    while pos + 2 * kmer_length < size:
        if matching_kmers * kmer_length + (size - pos) < threshold:
            return False  # cannot possibly reach max_identity_fraction

        hits = big_kmer_index.get(kmer_to_int(small_seq_str, pos, kmer_length))
        if hits is not None:
            for hit_idx in range(int(np.searchsorted(hits, big_start, side="left")), len(hits)):
                kmer_hit = int(hits[hit_idx])
                if kmer_hit > big_end:
                    break
                if small_contig != big_contig or kmer_hit < small_start or kmer_hit > small_end:
                    # strncmp semantics: compare 8 bytes, NUL-terminated at
                    # sequence ends (zero-pad replicates early termination)
                    extension = big_contig_sequence[
                        kmer_hit + kmer_length:
                        kmer_hit + kmer_length + extended_kmer_length].tobytes()
                    small_extension = small_gene_sequence[
                        pos + kmer_length:
                        pos + kmer_length + extended_kmer_length].tobytes()
                    if (extension.ljust(extended_kmer_length, b"\0")
                            == small_extension.ljust(extended_kmer_length, b"\0")):
                        matching_kmers += 1
                        if matching_kmers * kmer_length >= threshold:
                            return True
                        break
        pos += kmer_length
    return False


def filter_homologs(fusions: Fusions, kmer_indices: KmerIndices, kmer_length: int,
                    assembly: Assembly, genes: GeneTable,
                    max_identity_fraction: float) -> int:
    """filter_homologs.cpp:65-140."""
    # the reference collects unfiltered fusions with list::push_front while
    # iterating its unordered_map (filter_homologs.cpp:69-72) — i.e. the
    # REVERSE of the emulated hash-map iteration order, NOT of insertion
    # order (exact-tie arbitration below depends on this walk order)
    from ..output.stdmap_order import fusion_map_order
    values = list(fusions.values())
    order = fusion_map_order(list(fusions.keys()))
    remaining_fusions: List[Fusion] = [
        values[i] for i in order if values[i].filter == FILTER_NONE][::-1]

    for i, fusion in enumerate(remaining_fusions):
        if fusion.filter != FILTER_NONE:
            continue

        if is_homolog(fusion.gene1, fusion.gene2, kmer_indices, kmer_length,
                      assembly, genes, max_identity_fraction):
            fusion.filter = FILTER_HOMOLOGS
            continue

        # cross-fusion homolog arbitration
        for other in remaining_fusions[i + 1:]:
            if other.filter != FILTER_NONE:
                continue
            if fusion.gene1 == other.gene1 and fusion.breakpoint2 != other.breakpoint2:
                homolog1, homolog2 = fusion.gene2, other.gene2
            elif fusion.gene1 == other.gene2 and fusion.breakpoint2 != other.breakpoint1:
                homolog1, homolog2 = fusion.gene2, other.gene1
            elif fusion.gene2 == other.gene1 and fusion.breakpoint1 != other.breakpoint2:
                homolog1, homolog2 = fusion.gene1, other.gene2
            elif fusion.gene2 == other.gene2 and fusion.breakpoint1 != other.breakpoint1:
                homolog1, homolog2 = fusion.gene1, other.gene1
            else:
                continue

            anchor1 = ((fusion.split_reads1 > 0) + (fusion.split_reads2 > 0)
                       + (fusion.discordant_mates > 0))
            anchor2 = ((other.split_reads1 > 0) + (other.split_reads2 > 0)
                       + (other.discordant_mates > 0))

            if is_homolog(homolog1, homolog2, kmer_indices, kmer_length, assembly,
                          genes, max_identity_fraction):
                if (anchor1 > anchor2
                        or (anchor1 == anchor2
                            and fusion.supporting_reads() > other.supporting_reads())
                        or (anchor1 == anchor2
                            and fusion.supporting_reads() == other.supporting_reads()
                            and fusion.evalue <= other.evalue)):
                    other.filter = FILTER_HOMOLOGS
                else:
                    fusion.filter = FILTER_HOMOLOGS
                    break

    return sum(1 for f in remaining_fusions if f.filter == FILTER_NONE)
