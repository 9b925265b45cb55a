"""RPKM per viral contig with related-strain merging.

Reference parity: scripts/quantify_virus_expression.sh — counts pristine
alignments (proper pair or single-end, fully aligned CIGAR of M/X/N only,
no tandem repeats) on viral contigs, computes RPKM, merges related strains
sharing >10% of their 12-mers (keeping the higher-expressed strain), and
reports viruses with >=5% and >=100 bp of their genome covered, sorted by
RPKM descending.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from typing import Dict, Set

from ..constants import (CIGAR_MATCH, CIGAR_DIFF, CIGAR_INS, CIGAR_REF_SKIP,
                         cigar_op, cigar_oplen)
from ..io.bam import open_alignment_file

VIRAL_CONTIGS_REGEX = r"^[AN]C_"
KMER_LENGTH = 12
MAX_SHARED_KMERS_PCT = 10.0
MIN_COVERED_GENOME_PCT = 5.0
MIN_COVERED_GENOME_BASES = 100

TANDEM_REPEAT_REGEX = re.compile("|".join(
    f"{a}{b}.?{a}{b}.?{a}{b}.?{a}{b}.?{a}{b}.?{a}{b}.?{a}{b}.?{a}{b}"
    for a in "ACGT" for b in "ACGT"))

FULLY_ALIGNED_OPS = {CIGAR_MATCH, CIGAR_DIFF, CIGAR_REF_SKIP}


def quantify_virus_expression(alignments_path: str, output_tsv: str,
                              viral_contigs_regex: str = VIRAL_CONTIGS_REGEX) -> None:
    viral = re.compile(viral_contigs_regex)
    header, records = open_alignment_file(alignments_path)
    names = header.target_names
    sizes = {i: header.target_lengths[i] for i in range(len(names))}

    total_mapped_reads = 0
    viral_mapped_reads: Dict[int, int] = defaultdict(int)
    covered_positions: Dict[int, Set[int]] = defaultdict(set)
    kmers_by_virus: Dict[int, Set[str]] = defaultdict(set)

    for record in records:
        if record.flag & 4:  # unmapped
            continue
        total_mapped_reads += 1
        if record.tid < 0 or not viral.search(names[record.tid]):
            continue
        # proper pair unless single-end
        if (record.flag & 1) and not (record.flag & 2):
            continue
        ops = [cigar_op(int(word)) for word in record.cigar]
        if not ops or any(op not in FULLY_ALIGNED_OPS for op in ops):
            continue
        if TANDEM_REPEAT_REGEX.search(record.seq):
            continue

        virus = record.tid
        viral_mapped_reads[virus] += 1
        seq = record.seq
        for i in range(len(seq) - KMER_LENGTH + 1):
            kmers_by_virus[virus].add(seq[i:i + KMER_LENGTH])
        reference_pos = record.pos + 1
        for word in record.cigar:
            op = cigar_op(int(word))
            oplen = cigar_oplen(int(word))
            if op in (CIGAR_MATCH, CIGAR_DIFF):
                covered_positions[virus].update(
                    range(reference_pos, reference_pos + oplen))
                reference_pos += oplen
            elif op in (CIGAR_REF_SKIP, CIGAR_INS):
                reference_pos += oplen

    rpkm: Dict[int, float] = {}
    for virus, n_reads in viral_mapped_reads.items():
        if sizes.get(virus, 0) > 0 and total_mapped_reads > 0:
            rpkm[virus] = 1e9 * n_reads / sizes[virus] / total_mapped_reads

    # merge related strains: drop the lower-expressed of any pair sharing
    # more than MAX_SHARED_KMERS_PCT of the lower one's kmers
    removed: Set[int] = set()
    viruses = sorted(rpkm)
    for i in viruses:
        for j in viruses:
            if i == j:
                continue
            if rpkm[i] > rpkm[j] or (rpkm[i] == rpkm[j] and i < j):
                shared = len(kmers_by_virus[i] & kmers_by_virus[j])
                if shared > len(kmers_by_virus[j]) * MAX_SHARED_KMERS_PCT / 100:
                    removed.add(j)

    rows = []
    for virus in rpkm:
        if virus in removed:
            continue
        covered = len(covered_positions[virus])
        if covered >= MIN_COVERED_GENOME_BASES and \
                covered / sizes[virus] > MIN_COVERED_GENOME_PCT / 100:
            rows.append((names[virus], sizes[virus], covered,
                         covered / sizes[virus], viral_mapped_reads[virus],
                         rpkm[virus]))
    rows.sort(key=lambda row: -row[5])

    with open(output_tsv, "w") as fh:
        fh.write("VIRUS\tGENOME_SIZE\tCOVERED_BASES\tCOVERED_GENOME_FRACTION\t"
                 "HIGH_QUALITY_ALIGNMENTS\tRPKM\n")
        for row in rows:
            fh.write("\t".join(str(value) for value in row) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("Usage: quantify_virus_expression alignments.bam virus_expression.tsv",
              file=sys.stderr)
        return 1
    quantify_virus_expression(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
