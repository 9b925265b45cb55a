"""Append exon_number1/2 columns to fusions.tsv from a GTF.

Reference parity: scripts/annotate_exon_numbers.sh — breakpoints within
±2 bp of an exon of the transcript named in transcript_id1/2 get that
exon's exon_number attribute (last match wins, like the awk loop).
"""

from __future__ import annotations

import sys
from typing import List, Tuple

from ..io.compressed import iter_lines


def _gtf_attribute(attributes: str, name: str) -> str:
    idx = attributes.find(name)
    if idx < 0:
        return ""
    value = attributes[idx + len(name):].lstrip(' "')
    for end_char in ('";', '"', ';'):
        end = value.find(end_char)
        if end >= 0:
            value = value[:end]
            break
    return value


def annotate_exon_numbers(fusions_tsv: str, annotation_gtf: str,
                          output_tsv: str) -> None:
    with open(fusions_tsv) as fh:
        lines = fh.read().rstrip("\n").split("\n")
    header = lines[0].lstrip("#").split("\t")
    column = {name: i for i, name in enumerate(header)}

    wanted_transcripts = set()
    for line in lines[1:]:
        fields = line.split("\t")
        for key in ("transcript_id1", "transcript_id2"):
            value = fields[column[key]]
            if value != ".":
                wanted_transcripts.add(value)

    # (transcript, start, end, exon_number) in GTF order
    exons: List[Tuple[str, int, int, str]] = []
    for line in iter_lines(annotation_gtf):
        if not line or line[0] == "#":
            continue
        parts = line.split("\t")
        if len(parts) < 9 or parts[2] != "exon":
            continue
        attributes = parts[8]
        if "transcript_id" not in attributes or "exon_number" not in attributes:
            continue
        transcript = _gtf_attribute(attributes, "transcript_id")
        if transcript not in wanted_transcripts:
            continue
        exon_number = _gtf_attribute(attributes, "exon_number")
        exons.append((transcript, int(parts[3]), int(parts[4]), exon_number))

    out = [lines[0] + "\texon_number1\texon_number2"]
    for line in lines[1:]:
        fields = line.split("\t")
        position1 = int(fields[column["breakpoint1"]].rsplit(":", 1)[1])
        position2 = int(fields[column["breakpoint2"]].rsplit(":", 1)[1])
        transcript1 = fields[column["transcript_id1"]]
        transcript2 = fields[column["transcript_id2"]]
        exon_number1 = exon_number2 = "."
        for transcript, start, end, number in exons:
            if transcript == transcript1 and start - 2 <= position1 <= end + 2:
                exon_number1 = number
            if transcript == transcript2 and start - 2 <= position2 <= end + 2:
                exon_number2 = number
        out.append(line + f"\t{exon_number1}\t{exon_number2}")

    with open(output_tsv, "w") as fh:
        fh.write("\n".join(out) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: annotate_exon_numbers fusions.tsv annotation.gtf output.tsv",
              file=sys.stderr)
        return 1
    annotate_exon_numbers(argv[0], argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
