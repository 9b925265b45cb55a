"""fusions.tsv -> VCF 4.3 BND records.

Reference parity: scripts/convert_fusions_to_vcf.sh — same header lines,
breakend bracket notation, non-template-base handling (reverse/complement
by strand and direction), and confidence-derived QUAL.
"""

from __future__ import annotations

import sys
from typing import Dict, List

COMPLEMENT = str.maketrans("ATCG", "TAGC")


def _load_assembly_plain(path: str) -> Dict[str, str]:
    from ..io.compressed import iter_lines
    sequences: Dict[str, List[str]] = {}
    name = None
    for line in iter_lines(path):
        if line.startswith(">"):
            name = line[1:].split()[0]
            sequences[name] = []
        elif name is not None:
            sequences[name].append(line)
    return {name: "".join(chunks) for name, chunks in sequences.items()}


def convert_fusions_to_vcf(assembly_path: str, input_tsv: str, output_vcf: str) -> None:
    with open(input_tsv) as fh:
        lines = fh.read().rstrip("\n").split("\n")
    header = lines[0].lstrip("#").split("\t")
    column = {name: i for i, name in enumerate(header)}
    has_exons = "exon_number1" in column

    assembly = _load_assembly_plain(assembly_path)

    # contigs that appear in breakpoints, VCF-declared with their lengths
    used_contigs = set()
    for line in lines[1:]:
        fields = line.split("\t")
        used_contigs.add(fields[4].rsplit(":", 1)[0])
        used_contigs.add(fields[5].rsplit(":", 1)[0])

    out = [
        "##fileformat=VCFv4.3",
        f"##reference=file://{assembly_path}",
    ]
    for name, sequence in assembly.items():
        if name in used_contigs:
            out.append(f"##contig=<ID={name},length={len(sequence)}>")
    out.extend([
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
        '##INFO=<ID=MATEID,Number=.,Type=String,Description="ID of mate breakends">',
        '##INFO=<ID=GENE_NAME,Number=.,Type=String,Description="Name of gene hit by breakpoint">',
        '##INFO=<ID=GENE_ID,Number=.,Type=String,Description="ID of gene hit by breakpoint">',
    ])
    if has_exons:
        out.append('##INFO=<ID=EXON_NUMBER,Number=.,Type=Integer,'
                   'Description="Exon hit by breakpoint">')
    out.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")

    qual_map = {"low": "0.5", "medium": "2", "high": "5"}
    for fusion_id, line in enumerate(lines[1:], start=1):
        fields = line.split("\t")
        site1, site2 = fields[6], fields[7]
        gene_name1 = "" if site1 == "intergenic" else fields[0]
        gene_name2 = "" if site2 == "intergenic" else fields[1]
        gene_id1 = "" if site1 == "intergenic" else fields[20]
        gene_id2 = "" if site2 == "intergenic" else fields[21]
        breakpoint1, breakpoint2 = fields[4], fields[5]
        chromosome1, position1 = breakpoint1.rsplit(":", 1)
        chromosome2, position2 = breakpoint2.rsplit(":", 1)
        qual = qual_map.get(fields[14], fields[14])
        ref1 = assembly[chromosome1][int(position1) - 1].upper()
        ref2 = assembly[chromosome2][int(position2) - 1].upper()

        # non-template bases: between two pipes of the fusion transcript
        transcript = fields[27].upper()
        non_template = ""
        parts = transcript.split("|")
        if len(parts) == 3:
            non_template = parts[1]
        strand1 = fields[2].split("/")[1] if "/" in fields[2] else "."
        if strand1 == "-":
            non_template = non_template.translate(COMPLEMENT)
        direction1, direction2 = fields[24], fields[25]

        alt1 = ref1 + non_template
        alt2 = non_template + ref2
        if direction1 == "upstream":
            alt1 = alt1[::-1]
        if direction2 == "downstream":
            alt2 = alt2[::-1]
        alt2_breakpoint = (f"]{breakpoint1}]" if direction1 == "downstream"
                           else f"[{breakpoint1}[")
        alt1_breakpoint = (f"]{breakpoint2}]" if direction2 == "downstream"
                           else f"[{breakpoint2}[")
        if direction1 == "downstream":
            alt1 = alt1 + alt1_breakpoint
        else:
            alt1 = alt1_breakpoint + alt1
        if direction2 == "downstream":
            alt2 = alt2 + alt2_breakpoint
        else:
            alt2 = alt2_breakpoint + alt2

        info1 = (f"SVTYPE=BND;MATEID={fusion_id}b;GENE_NAME={gene_name1};"
                 f"GENE_ID={gene_id1}")
        info2 = (f"SVTYPE=BND;MATEID={fusion_id}a;GENE_NAME={gene_name2};"
                 f"GENE_ID={gene_id2}")
        if has_exons:
            exon1 = fields[30].replace(".", "")
            exon2 = fields[31].replace(".", "")
            info1 += f";EXON_NUMBER={exon1}"
            info2 += f";EXON_NUMBER={exon2}"
        out.append(f"{chromosome1}\t{position1}\t{fusion_id}a\t{ref1}\t{alt1}\t"
                   f"{qual}\tPASS\t{info1}")
        out.append(f"{chromosome2}\t{position2}\t{fusion_id}b\t{ref2}\t{alt2}\t"
                   f"{qual}\tPASS\t{info2}")

    with open(output_vcf, "w") as fh:
        fh.write("\n".join(out) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("Usage: convert_fusions_to_vcf assembly.fa input_fusions.tsv "
              "output_fusions.vcf", file=sys.stderr)
        return 1
    convert_fusions_to_vcf(argv[0], argv[1], argv[2])
    return 0


if __name__ == "__main__":
    sys.exit(main())
