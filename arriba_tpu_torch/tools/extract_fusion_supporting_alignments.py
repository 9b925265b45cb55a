"""Per-fusion mini alignment files from the read_identifiers column.

Reference parity: scripts/extract_fusion-supporting_alignments.sh — for
each fusion in fusions.tsv, writes <prefix>_<rank>.sam containing the
alignments whose read names appear in the read_identifiers column (no
samtools required; output is SAM text).
"""

from __future__ import annotations

import sys
from typing import List

from ..io.bam import open_alignment_file, write_sam


def extract_fusion_supporting_alignments(fusions_tsv: str, alignments_path: str,
                                         output_prefix: str) -> List[str]:
    with open(fusions_tsv) as fh:
        lines = fh.read().rstrip("\n").split("\n")
    header_fields = lines[0].lstrip("#").split("\t")
    column = {name: i for i, name in enumerate(header_fields)}
    read_column = column.get("read_identifiers")
    if read_column is None:
        raise RuntimeError("fusions.tsv lacks a read_identifiers column")

    wanted = []  # per fusion: set of read names
    for line in lines[1:]:
        identifiers = line.split("\t")[read_column]
        wanted.append(set() if identifiers == "." else set(identifiers.split(",")))

    header, records = open_alignment_file(alignments_path)
    records = list(records)

    outputs = []
    for rank, read_names in enumerate(wanted, start=1):
        matching = [record for record in records if record.qname in read_names]
        path = f"{output_prefix}_{rank}.sam"
        write_sam(path, header, matching)
        outputs.append(path)
    return outputs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: extract_fusion_supporting_alignments fusions.tsv "
              "alignments.bam output_prefix", file=sys.stderr)
        return 1
    extract_fusion_supporting_alignments(argv[0], argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
