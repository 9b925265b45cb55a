"""Publication-quality fusion plots: one page per fusion.

Capability equivalent of the reference's draw_fusions.R (reimplemented from
scratch on matplotlib, same CLI surface and layout): per fusion a page with
the fusion panel (ideograms, coverage tracks, exon diagrams with squished or
to-scale introns, the fused transcript with trajectories, fusion transcript
sequence, scale bar), a circos panel, a retained-protein-domain panel and a
read-count panel — each selectable via --plotPanels. Transcript selection
supports provided/canonical/coverage (draw_fusions.R:7-33, 814-899).

draw_fusions() returns a per-page render report (panels drawn, label texts,
exon counts) so tests can assert on content rather than just file size.
"""

from __future__ import annotations

import re
import sys
import urllib.parse
from collections import defaultdict
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

COLOR1 = "#e5a5a5"
COLOR2 = "#a7c4e5"
CIRCOS_COLORS = {"translocation": "#000000", "duplication": "#00bb00",
                 "deletion": "#ff0000", "inversion": "#0000ff"}
SQUISHED_INTRON_SIZE = 200

# --------------------------------------------------------------------------
# option surface (draw_fusions.R:7-33); (name, type, default, mandatory)

PARAMETERS = [
    ("fusions", "file", "fusions.tsv", True),
    ("annotation", "file", "annotation.gtf", True),
    ("output", "string", "output.pdf", True),
    ("alignments", "file", "Aligned.sortedByCoord.out.bam", False),
    ("cytobands", "file", "cytobands.tsv", False),
    ("minConfidenceForCircosPlot", "string", "medium", False),
    ("proteinDomains", "file", "protein_domains.gff3", False),
    ("sampleName", "string", "", False),
    ("squishIntrons", "bool", True, False),
    ("printExonLabels", "bool", True, False),
    ("render3dEffect", "bool", True, False),
    ("plotPanels", "string", "fusion,circos,domains,readcounts", False),
    ("pdfWidth", "numeric", 11.692, False),
    ("pdfHeight", "numeric", 8.267, False),
    ("color1", "string", COLOR1, False),
    ("color2", "string", COLOR2, False),
    ("mergeDomainsOverlappingBy", "numeric", 0.9, False),
    ("optimizeDomainColors", "bool", False, False),
    ("fontSize", "numeric", 1.0, False),
    ("fontFamily", "string", "Helvetica", False),
    ("showIntergenicVicinity", "string", "0", False),
    ("transcriptSelection", "string", "provided", False),
    ("fixedScale", "numeric", 0.0, False),
    ("coverageRange", "string", "0", False),
]


class OptionError(ValueError):
    pass


def parse_options(argv: List[str]) -> dict:
    """draw_fusions.R:35-122 — parse + validate the full option surface."""
    spec = {name: (kind, default, mandatory)
            for name, kind, default, mandatory in PARAMETERS}
    options = {name: ("" if kind == "file" else default)
               for name, (kind, default, _m) in spec.items()}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise OptionError(f"Unknown parameter: {arg}")
        name, value = arg[2:].split("=", 1)
        if name not in spec:
            raise OptionError(f"Unknown parameter: {arg}")
        kind = spec[name][0]
        if kind == "bool":
            if value not in ("TRUE", "T", "FALSE", "F"):
                raise OptionError(f"Invalid argument to --{name}")
            options[name] = value in ("TRUE", "T")
        elif kind == "numeric":
            try:
                options[name] = float(value)
            except ValueError:
                raise OptionError(f"Invalid argument to --{name}")
        else:  # string / file
            options[name] = value
    for name, (kind, _default, mandatory) in spec.items():
        if mandatory and not options[name]:
            raise OptionError(f"Missing mandatory argument: --{name}")

    if options["minConfidenceForCircosPlot"] not in ("none", "low", "medium",
                                                     "high"):
        raise OptionError("Invalid argument to --minConfidenceForCircosPlot")

    vicinity = str(options["showIntergenicVicinity"]).split(",")
    if len(vicinity) not in (1, 4):
        raise OptionError("Invalid argument to --showIntergenicVicinity")
    parsed_vicinity = []
    for item in vicinity:
        if item == "closestGene":
            parsed_vicinity.append("exon")
        elif item == "closestProteinCodingGene":
            parsed_vicinity.append("CDS")
        else:
            try:
                value = float(item)
            except ValueError:
                raise OptionError("Invalid argument to --showIntergenicVicinity")
            if value < 0:
                raise OptionError("Invalid argument to --showIntergenicVicinity")
            parsed_vicinity.append(value)
    if len(parsed_vicinity) == 1:
        parsed_vicinity = parsed_vicinity * 4
    options["showIntergenicVicinity"] = parsed_vicinity
    if options["squishIntrons"]:
        if any(not isinstance(v, float) or v > 0 for v in parsed_vicinity):
            raise OptionError("--squishIntrons must be disabled, when "
                              "--showIntergenicVicinity is > 0")

    if options["transcriptSelection"] not in ("coverage", "provided",
                                              "canonical"):
        raise OptionError("Invalid argument to --transcriptSelection")
    if options["fixedScale"] < 0:
        raise OptionError("Invalid argument to --fixedScale")

    try:
        coverage_range = [float(x)
                          for x in str(options["coverageRange"]).split(",")]
    except ValueError:
        raise OptionError("Invalid argument to --coverageRange")
    if len(coverage_range) not in (1, 2) or any(x < 0 for x in coverage_range):
        raise OptionError("Invalid argument to --coverageRange")
    options["coverageRange"] = coverage_range

    valid_panels = {"fusion", "circos", "domains", "readcounts"}
    panels = str(options["plotPanels"]).split(",")
    invalid = [p for p in panels if p not in valid_panels]
    if invalid:
        raise OptionError("Invalid argument to --plotPanels: "
                          + ",".join(invalid))
    options["plotPanels"] = panels
    return options


# --------------------------------------------------------------------------
# input parsing


def remove_chr(contig: str) -> str:
    return re.sub(r"^chr", "", re.sub(r"^chrM$", "MT", contig))


@dataclass
class FusionRow:
    gene1: str
    gene2: str
    strand1: str
    strand2: str
    contig1: str
    contig2: str
    display_contig1: str
    display_contig2: str
    breakpoint1: int
    breakpoint2: int
    site1: str
    site2: str
    type: str
    direction1: str
    direction2: str
    split_reads1: Optional[int]
    split_reads2: Optional[int]
    split_reads: Optional[int]
    discordant_mates: int
    confidence: str
    reading_frame: str
    gene_id1: str
    gene_id2: str
    transcript_id1: str
    transcript_id2: str
    fusion_transcript: str


def read_fusions(path: str) -> List[FusionRow]:
    """draw_fusions.R:163-206 — Arriba and STAR-Fusion formats."""
    with open(path) as handle:
        lines = [line.rstrip("\n") for line in handle if line.strip()]
    if not lines:
        return []
    header = lines[0].split("\t")
    rows = [line.split("\t") for line in lines[1:]]
    col = {name: i for i, name in enumerate(header)}

    def get(fields, name, default="."):
        return fields[col[name]] if name in col else default

    fusions = []
    if header[0] in ("#gene1", "gene1"):  # Arriba output
        for fields in rows:
            contig1, bp1 = get(fields, "breakpoint1").rsplit(":", 1)
            contig2, bp2 = get(fields, "breakpoint2").rsplit(":", 1)
            type_match = re.search(
                r"translocation|duplication|deletion|inversion",
                get(fields, "type"))
            fusions.append(FusionRow(
                gene1=fields[0], gene2=get(fields, "gene2"),
                strand1=get(fields, "strand1(gene/fusion)"),
                strand2=get(fields, "strand2(gene/fusion)"),
                contig1=remove_chr(contig1), contig2=remove_chr(contig2),
                display_contig1=contig1, display_contig2=contig2,
                breakpoint1=int(bp1), breakpoint2=int(bp2),
                site1=get(fields, "site1"), site2=get(fields, "site2"),
                type=type_match.group(0) if type_match else get(fields, "type"),
                direction1=get(fields, "direction1",
                               "downstream" if get(fields, "site1") else "."),
                direction2=get(fields, "direction2", "."),
                split_reads1=int(get(fields, "split_reads1", "0")),
                split_reads2=int(get(fields, "split_reads2", "0")),
                split_reads=None,
                discordant_mates=int(get(fields, "discordant_mates", "0")),
                confidence=get(fields, "confidence"),
                reading_frame=get(fields, "reading_frame"),
                gene_id1=get(fields, "gene_id1"),
                gene_id2=get(fields, "gene_id2"),
                transcript_id1=get(fields, "transcript_id1"),
                transcript_id2=get(fields, "transcript_id2"),
                fusion_transcript=re.sub(r"[()^$]", "",
                                         get(fields, "fusion_transcript")),
            ))
            # directions are not in the TSV: derive them from type/breakpoints
            # the way the reference's own output defines them
            f = fusions[-1]
            if f.direction1 == "." or f.direction2 == ".":
                d1, d2 = _derive_directions(f)
                fusions[-1] = replace(f, direction1=d1, direction2=d2)
    elif header[0] in ("#FusionName", "FusionName"):  # STAR-Fusion
        for fields in rows:
            left = get(fields, "LeftBreakpoint")
            right = get(fields, "RightBreakpoint")
            lc, lp, lstrand = left.rsplit(":", 2)
            rc, rp, rstrand = right.rsplit(":", 2)
            direction1 = "downstream" if lstrand == "+" else "upstream"
            direction2 = "upstream" if rstrand == "+" else "downstream"
            contig1, contig2 = remove_chr(lc), remove_chr(rc)
            if contig1 != contig2:
                sv_type = "translocation"
            elif direction1 == direction2:
                sv_type = "inversion"
            elif (direction1 == "downstream") == (int(lp) < int(rp)):
                sv_type = "deletion"
            else:
                sv_type = "duplication"
            cds = get(fields, "FUSION_CDS")
            if cds != ".":
                cds = re.sub(r"^([a-z]*)", lambda m: m.group(1) + "|",
                             cds).upper()
            prot = get(fields, "PROT_FUSION_TYPE")
            reading_frame = {"INFRAME": "in-frame",
                             "FRAMESHIFT": "out-of-frame"}.get(prot, ".")
            fusions.append(FusionRow(
                gene1=re.sub(r"\^.*", "", get(fields, "LeftGene")),
                gene2=re.sub(r"\^.*", "", get(fields, "RightGene")),
                strand1=f"{lstrand}/{lstrand}", strand2=f"{rstrand}/{rstrand}",
                contig1=contig1, contig2=contig2,
                display_contig1=lc, display_contig2=rc,
                breakpoint1=int(lp), breakpoint2=int(rp),
                site1="exon", site2="exon", type=sv_type,
                direction1=direction1, direction2=direction2,
                split_reads1=None, split_reads2=None,
                split_reads=int(get(fields, "JunctionReadCount", "0")),
                discordant_mates=int(get(fields, "SpanningFragCount", "0")),
                confidence="high", reading_frame=reading_frame,
                gene_id1=re.sub(r".*\^", "", get(fields, "LeftGene")),
                gene_id2=re.sub(r".*\^", "", get(fields, "RightGene")),
                transcript_id1=get(fields, "CDS_LEFT_ID"),
                transcript_id2=get(fields, "CDS_RIGHT_ID"),
                fusion_transcript=cds,
            ))
    else:
        raise OptionError("Unrecognized fusion file format")
    return fusions


def _derive_directions(f: FusionRow) -> Tuple[str, str]:
    """Reconstruct breakpoint orientations from the reported strands and
    event type (output_fusions.cpp get_fusion_type inverse)."""
    strand1 = f.strand1.split("/")[-1]
    strand2 = f.strand2.split("/")[-1]
    if strand1 in "+-" and strand2 in "+-":
        d1 = "downstream" if strand1 == "+" else "upstream"
        d2 = "upstream" if strand2 == "+" else "downstream"
        return d1, d2
    if f.contig1 == f.contig2 and f.type == "duplication":
        return "upstream", "downstream"
    return "downstream", "upstream"


@dataclass
class ExonRow:
    contig: str
    type: str  # exon | CDS | intergenic | dummy
    start: int
    end: int
    strand: str
    attributes: str
    gene_id: str
    gene_name: str
    transcript: str
    exon_number: str
    left: float = 0.0
    right: float = 0.0


def read_exons(path: str, print_exon_labels: bool) -> List[ExonRow]:
    """draw_fusions.R:223-243."""
    from ..io.compressed import iter_lines
    exons: List[ExonRow] = []
    for line in iter_lines(path):
        if not line or line[0] == "#":
            continue
        parts = line.split("\t")
        if len(parts) < 9 or parts[2] not in ("exon", "CDS"):
            continue
        attributes = parts[8]
        gene_id = _gtf_attribute(attributes, "gene_id")
        gene_name = _gtf_attribute(attributes, "gene_name") or gene_id
        exons.append(ExonRow(
            contig=remove_chr(parts[0]), type=parts[2],
            start=int(parts[3]), end=int(parts[4]), strand=parts[6],
            attributes=attributes, gene_id=gene_id, gene_name=gene_name,
            transcript=_gtf_attribute(attributes, "transcript_id"),
            exon_number=(_gtf_attribute(attributes, "exon_number")
                         if print_exon_labels else "")))
    return exons


def _gtf_attribute(attributes: str, name: str) -> str:
    match = re.search(name + r'[ =]"?([^;"]+)', attributes)
    return match.group(1) if match else ""


@dataclass
class DomainRow:
    contig: str
    start: int
    end: int
    strand: str
    color: str
    name: str
    domain_id: str


def read_protein_domains(path: str) -> List[DomainRow]:
    """draw_fusions.R:246-257."""
    from ..io.compressed import iter_lines
    domains = []
    for line in iter_lines(path):
        if not line or line[0] == "#":
            continue
        parts = line.split("\t")
        if len(parts) < 9:
            continue
        attributes = parts[8]
        domains.append(DomainRow(
            contig=remove_chr(parts[0]), start=int(parts[3]),
            end=int(parts[4]), strand=parts[6],
            color=_gtf_attribute(attributes, "color") or "#b0b0d8",
            name=urllib.parse.unquote(_gtf_attribute(attributes, "Name")),
            domain_id=_gtf_attribute(attributes, "protein_domain_id")))
    return domains


def read_cytobands(path: str):
    """Sorted cytobands: contig -> [(start, end, name, giemsa)]."""
    from ..io.compressed import iter_lines
    bands = defaultdict(list)
    for line in iter_lines(path):
        if not line or line.startswith("#") or line.startswith("contig"):
            continue
        parts = line.split("\t")
        if len(parts) >= 5:
            bands[remove_chr(parts[0])].append(
                (int(parts[1]), int(parts[2]), parts[3], parts[4]))
    for contig in bands:
        bands[contig].sort()
    return dict(bands)


# --------------------------------------------------------------------------
# transcript selection (draw_fusions.R:814-899)

_APPRIS_RANKS = [
    ("appris_principal_1", 12), ("appris_principal_2", 11),
    ("appris_principal_3", 10), ("appris_principal_4", 9),
    ("appris_principal_5", 8), ("appris_principal", 7),
    ("appris_candidate_longest", 6), ("appris_candidate", 5),
    ("appris_alternative_1", 4), ("appris_alternative_2", 3),
    ("appris_alternative", 2), ("CCDS", 1),
]


def _appris_rank(attributes: str) -> int:
    for keyword, rank in _APPRIS_RANKS:
        if keyword in attributes:
            return rank
    return 0


def find_exons(exons: List[ExonRow], contig: str, gene_id: str,
               direction: str, breakpoint: int, coverage,
               transcript_id: str, transcript_selection: str,
               warn=lambda msg: print(f"WARNING: {msg}", file=sys.stderr)
               ) -> List[ExonRow]:
    """Pick the transcript to draw (draw_fusions.R:814-899)."""
    if transcript_selection == "provided" and transcript_id not in (".", ""):
        candidate = [e for e in exons if e.transcript == transcript_id]
        if candidate:
            return list(candidate)
        warn(f"Unknown transcript given in fusions file ({transcript_id}), "
             "selecting a different one")

    if transcript_selection == "canonical":
        candidate = [e for e in exons
                     if e.gene_id == gene_id and e.contig == contig]
    else:
        # transcripts that use the breakpoint as a splice site
        transcripts = {e.transcript for e in exons
                       if e.gene_id == gene_id and e.contig == contig
                       and e.type == "exon"
                       and ((direction == "downstream"
                             and abs(e.end - breakpoint) <= 2)
                            or (direction == "upstream"
                                and abs(e.start - breakpoint) <= 2))}
        candidate = [e for e in exons if e.transcript in transcripts]
        if not candidate:
            candidate = [e for e in exons
                         if e.gene_id == gene_id and e.contig == contig]
        if coverage is not None and candidate:
            candidate = _pick_by_coverage(candidate, coverage)
        # prefer transcripts encompassing the breakpoint
        by_transcript = defaultdict(list)
        for e in candidate:
            by_transcript[e.transcript].append(e)
        if len(by_transcript) > 1:
            encompassing = {t for t, te in by_transcript.items()
                            if min(e.start for e in te) <= breakpoint
                            <= max(e.end for e in te)}
            if encompassing:
                candidate = [e for e in candidate
                             if e.transcript in encompassing]

    def unique_transcripts(rows):
        return list(dict.fromkeys(e.transcript for e in rows))

    if len(unique_transcripts(candidate)) > 1:  # consensus transcript
        best = max(_appris_rank(e.attributes) for e in candidate)
        keep = {e.transcript for e in candidate
                if _appris_rank(e.attributes) == best}
        candidate = [e for e in candidate if e.transcript in keep]
    if len(unique_transcripts(candidate)) > 1:  # longest coding sequence
        cds_length = defaultdict(int)
        for e in candidate:
            if e.type == "CDS":
                cds_length[e.transcript] += e.end - e.start
        best = max(cds_length.get(t, 0) for t in unique_transcripts(candidate))
        candidate = [e for e in candidate if cds_length.get(e.transcript, 0) == best]
    if len(unique_transcripts(candidate)) > 1:  # longest overall
        exon_length = defaultdict(int)
        for e in candidate:
            exon_length[e.transcript] += e.end - e.start
        best = max(exon_length[t] for t in unique_transcripts(candidate))
        candidate = [e for e in candidate if exon_length[e.transcript] == best]
    if candidate:
        first = unique_transcripts(candidate)[0]
        seen = set()
        result = []
        for e in candidate:
            # R's unique() compares whole rows — keep the label too
            key = (e.type, e.start, e.end, e.transcript, e.exon_number)
            if e.transcript == first and key not in seen:
                seen.add(key)
                result.append(e)
        return result
    return []


def _pick_by_coverage(candidate: List[ExonRow], coverage) -> List[ExonRow]:
    """Highest-coverage transcript with the reference's shorter-transcript
    bias (draw_fusions.R:840-865). coverage = (start, numpy array)."""
    cov_start, cov = coverage
    cov_end = cov_start + len(cov)
    by_transcript = defaultdict(list)
    for e in candidate:
        by_transcript[e.transcript].append(e)
    highest, best_transcript, best_length = -1.0, None, 0
    for transcript, te in by_transcript.items():
        length = 0
        total = 0.0
        for e in te:
            start = max(e.start, cov_start)
            end = min(e.end, cov_end - 1)
            length += max(0, end - start + 1)
            if end >= start:
                total += float(cov[start - cov_start:end - cov_start + 1].sum())
        if best_transcript is None:
            substantial = 0.0
        else:
            lo, hi = sorted((length, best_length))
            substantial = (1 - (lo / hi if hi else 1)) / 10
        if ((length > best_length and total * (1 - substantial) > highest)
                or (length <= best_length and total > highest * (1 - substantial))):
            highest, best_transcript, best_length = total, transcript, length
    if highest > 0:
        return by_transcript[best_transcript]
    return candidate


def find_closest_gene(exons: List[ExonRow], contig: str, breakpoint: int,
                      predicate) -> Tuple[int, int]:
    """draw_fusions.R:902-922 — (start, end) of the gene closest to the
    breakpoint among exons satisfying predicate."""
    near = [e for e in exons if e.contig == contig and predicate(e)]
    gene_ids = {e.gene_id for e in near}
    closest = [e for e in exons if e.contig == contig and e.gene_id in gene_ids]
    if len(gene_ids) > 1:
        def distance(gid):
            return min(min(abs(e.start - breakpoint), abs(e.end - breakpoint))
                       for e in closest if e.gene_id == gid)
        best = min(sorted(gene_ids), key=distance)
        closest = [e for e in closest if e.gene_id == best]
    if not closest:
        return max(1, breakpoint - 1000), breakpoint + 1000
    return min(e.start for e in closest), max(e.end for e in closest)


# --------------------------------------------------------------------------
# coverage from alignments (GenomicAlignments::coverage equivalent)


def compute_coverage(alignments_path: str, contig: str, region_start: int,
                     region_end: int):
    """Cigar-aware per-base coverage over [region_start, region_end]
    (1-based); returns (start, numpy float array) or None."""
    import numpy as np

    from ..io.bam import open_alignment_file
    header, records = open_alignment_file(alignments_path)
    names = {remove_chr(name): tid
             for tid, name in enumerate(header.target_names)}
    tid = names.get(remove_chr(contig))
    if tid is None:
        return None
    length = max(1, region_end - region_start + 1)
    cov = np.zeros(length, np.float64)
    consumes_ref = {0, 2, 7, 8}  # M D = X (N excluded like GAlignments)
    for record in records:
        if record.tid != tid or (record.flag & 4):
            continue
        pos = record.pos + 1  # 1-based
        if pos > region_end:
            continue
        for word in record.cigar:  # packed htslib words: length<<4 | op
            op = int(word) & 0xF
            op_length = int(word) >> 4
            if op in consumes_ref:
                lo = max(pos, region_start)
                hi = min(pos + op_length - 1, region_end)
                if hi >= lo:
                    cov[lo - region_start:hi - region_start + 1] += 1
                pos += op_length
            elif op == 3:  # N
                pos += op_length
    return region_start, cov


# --------------------------------------------------------------------------
# interval helpers (GenomicRanges reduce/intersect equivalents)


def _reduce_intervals(intervals):
    """Merge overlapping/adjacent [start, end] (1-based, inclusive)."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _intersect_intervals(a, b):
    result = []
    for start1, end1 in _reduce_intervals(a):
        for start2, end2 in _reduce_intervals(b):
            lo, hi = max(start1, start2), min(end1, end2)
            if lo <= hi:
                result.append((lo, hi))
    return _reduce_intervals(result)


# --------------------------------------------------------------------------
# colors


def _change_brightness(color: str, delta: int) -> str:
    from matplotlib.colors import to_rgb
    r, g, b = (int(round(c * 255)) for c in to_rgb(color))
    clip = lambda x: min(255, max(0, x + delta))  # noqa: E731
    return f"#{clip(r):02x}{clip(g):02x}{clip(b):02x}"


def get_dark_color(color: str) -> str:
    return _change_brightness(color, -100)


def get_bright_color(color: str) -> str:
    return _change_brightness(color, +190)


# --------------------------------------------------------------------------
# exon coordinate transforms (draw_fusions.R:1087-1135)


def squish_introns(exons: List[ExonRow], breakpoint: int) -> float:
    """Squish every intron to a fixed width, adjusting the breakpoint too.
    Mutates exon.left/right in place; returns the mapped breakpoint."""
    cumulative = 0
    previous_end = -SQUISHED_INTRON_SIZE
    mapped_breakpoint = float(breakpoint)
    breakpoint_mapped = False
    for exon in exons:
        if (not breakpoint_mapped and breakpoint > previous_end + 1
                and breakpoint < exon.left):
            mapped_breakpoint = ((breakpoint - previous_end)
                                 / (exon.left - previous_end)
                                 * SQUISHED_INTRON_SIZE
                                 + previous_end - cumulative)
            breakpoint_mapped = True
        if exon.left > previous_end:
            cumulative += exon.left - previous_end - SQUISHED_INTRON_SIZE
            previous_end = exon.right
        if (not breakpoint_mapped and exon.left <= breakpoint
                <= exon.right + 1):
            mapped_breakpoint = breakpoint - cumulative
            breakpoint_mapped = True
        exon.left -= cumulative
        exon.right -= cumulative
    return mapped_breakpoint


def shift_to_origin(exons: List[ExonRow], breakpoint: int) -> float:
    """--squishIntrons=FALSE: introns to scale, gene starts at x=0."""
    origin = min(e.left for e in exons)
    for exon in exons:
        exon.left -= origin
        exon.right -= origin
    return float(breakpoint - origin)


# --------------------------------------------------------------------------
# panel renderers


def draw_strand(ax, left, right, y, color, strand, font_size):
    """draw_fusions.R drawStrand: orientation arrows along the gene line."""
    if strand not in ("+", "-"):
        return
    ax.plot([left + 0.001, right - 0.001], [y, y], color=color, linewidth=2,
            zorder=2, solid_capstyle="butt")
    if right - left > 0.01:
        x = left + 0.005
        marker = ">" if strand == "+" else "<"
        while x <= right - 0.005:
            ax.plot([x], [y], marker=marker, markersize=2.4 * font_size,
                    color=color, zorder=3, linestyle="none")
            x += 0.01


def draw_exon(ax, left, right, y, color, title, exon_type, font_size,
              render_3d):
    """draw_fusions.R drawExon: CDS double bars, exon box + label."""
    from matplotlib.patches import Rectangle
    height = 0.03
    dark = get_dark_color(color)
    if exon_type == "CDS":
        for y0, y1 in ((y + height / 2 - 0.001, y + height),
                       (y - height, y - height / 2 + 0.001)):
            ax.add_patch(Rectangle((left, y0), right - left, y1 - y0,
                                   facecolor=color, edgecolor="none",
                                   zorder=4))
        ax.plot([left, left, right, right],
                [y + height / 2, y + height, y + height, y + height / 2],
                color=dark, linewidth=0.7, zorder=5)
        ax.plot([left, left, right, right],
                [y - height / 2, y - height, y - height, y - height / 2],
                color=dark, linewidth=0.7, zorder=5)
        if render_3d:
            ax.add_patch(Rectangle((left, y - height), right - left,
                                   height / 2, facecolor="black", alpha=0.12,
                                   edgecolor="none", zorder=5))
    elif exon_type == "exon":
        ax.add_patch(Rectangle((left, y - height / 2), right - left, height,
                               facecolor=color, edgecolor=dark, linewidth=0.7,
                               zorder=3))
        if render_3d:
            ax.add_patch(Rectangle((left, y), right - left, height / 2,
                                   facecolor="white", alpha=0.35,
                                   edgecolor="none", zorder=4))
        if title:
            ax.text((left + right) / 2, y, title, ha="center", va="center",
                    fontsize=6.5 * 0.9 * font_size, zorder=6)


def draw_coverage(ax, left, right, y, coverage, start, end, color):
    """draw_fusions.R drawCoverage: normalized coverage as a filled band."""
    import numpy as np
    if coverage is None:
        return
    cov_start, cov = coverage
    lo = max(int(start), cov_start)
    hi = min(int(end), cov_start + len(cov) - 1)
    if hi < lo:
        return
    data = cov[lo - cov_start:hi - cov_start + 1]
    max_resolution = 5000
    points = int(max(2, min(len(data), (right - left) * max_resolution)))
    if len(data) > points:
        edges = np.linspace(0, len(data), points + 1).astype(int)
        data = np.array([data[a:b].mean() if b > a else 0.0
                         for a, b in zip(edges[:-1], edges[1:])])
    x = np.linspace(left, right, len(data))
    ax.fill_between(np.concatenate([[left], x, [right]]),
                    np.concatenate([[y], y + data * 0.1, [y]]),
                    y, color=color, linewidth=0, zorder=2)


def draw_ideogram(ax, adjust, left, right, y, cytobands, contig, breakpoint,
                  font_size, render_3d, warn):
    """draw_fusions.R drawIdeogram: banded chromosome with curly brace."""
    from matplotlib.patches import Polygon, Rectangle

    band_colors = {"gneg": "#ffffff", "acen": "#ec4f4f", "stalk": "#0000ff"}
    bands = cytobands.get(contig, [])
    if not bands:
        warn(f"Ideogram of contig {contig} cannot be drawn, because no "
             "Giemsa staining information is available.")
        return None
    genome_max = max(end for contig_bands in cytobands.values()
                     for _s, end, _n, _g in contig_bands)
    ideogram_width, ideogram_height = 0.4, 0.04

    def stain_color(giemsa):
        if giemsa.startswith("gpos"):
            try:
                value = int(giemsa[4:])
            except ValueError:
                value = 100
            level = round(255 * (100 - value) / 100)
            return f"#{level:02x}{level:02x}{level:02x}"
        return band_colors.get(giemsa, "#ffffff")

    scaled = [(s / genome_max * ideogram_width, e / genome_max * ideogram_width,
               name, giemsa) for s, e, name, giemsa in bands]
    offset = left if adjust == "left" else right - max(e for _s, e, _n, _g in scaled)
    scaled = [(s + offset, e + offset, name, giemsa)
              for s, e, name, giemsa in scaled]

    # curly brace from the gene region to the breakpoint band position
    extent = max(end for _s, end, _n, _g in bands) - min(s for s, _e, _n, _g in bands)
    tip = (min(s for s, _e, _n, _g in scaled)
           + (max(e for _s, e, _n, _g in scaled) - min(s for s, _e, _n, _g in scaled))
           / max(extent, 1) * breakpoint)
    import numpy as np
    smoothness = 20
    brace_x = np.cumsum(np.exp(-np.linspace(-2.5, 2.5, smoothness) ** 2))
    brace_x = brace_x / brace_x[-1]
    brace_y = np.linspace(y - 0.05 + 0.03, y - 0.05, smoothness)
    ax.plot(left + (tip - left) + brace_x * (left - tip), brace_y,
            color="black", linewidth=0.8)
    ax.plot(tip + brace_x * (right - tip), brace_y, color="black",
            linewidth=0.8)

    ax.text((max(e for _s, e, _n, _g in scaled)
             + min(s for s, _e, _n, _g in scaled)) / 2, y + 0.07,
            f"chromosome {contig}", fontweight="bold",
            fontsize=8 * font_size, ha="center", va="bottom")
    band_name = next((name for s, e, name, _g in bands
                      if s <= breakpoint <= e), "")
    ax.text(tip, y + 0.03, band_name, fontsize=8 * font_size, ha="center",
            va="bottom")

    centromere_sides = []
    for i, (s, e, name, giemsa) in enumerate(scaled):
        color = stain_color(giemsa)
        if giemsa == "acen":
            if not centromere_sides:
                ax.add_patch(Polygon([(s, y - ideogram_height / 2), (e, y),
                                      (s, y + ideogram_height / 2)],
                                     facecolor=color, edgecolor="black",
                                     linewidth=0.4))
            else:
                ax.add_patch(Polygon([(e, y - ideogram_height / 2), (s, y),
                                      (e, y + ideogram_height / 2)],
                                     facecolor=color, edgecolor="black",
                                     linewidth=0.4))
            centromere_sides.append(i)
        else:
            ax.add_patch(Rectangle((s, y - ideogram_height / 2), e - s,
                                   ideogram_height, facecolor=color,
                                   edgecolor="black", linewidth=0.4))
    if render_3d:
        first = scaled[0][0]
        last = scaled[-1][1]
        ax.add_patch(Rectangle((first, y), last - first, ideogram_height / 2,
                               facecolor="white", alpha=0.35,
                               edgecolor="none"))
    # breakpoint tick on the ideogram
    ax.plot([tip], [y], marker="v", color="red", markersize=3.2 * font_size,
            zorder=6)
    return tip


def draw_circos(ax, legend_ax, fusion: FusionRow, fusions: List[FusionRow],
                cytobands, min_confidence: str, font_size, warn):
    """draw_fusions.R drawCircos: ideogram ring, gene labels, typed chords."""
    import numpy as np
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path as MplPath

    for contig in (fusion.contig1, fusion.contig2):
        if contig not in cytobands:
            warn("Circos plot cannot be drawn, because no Giemsa staining "
                 f"information is available for contig {contig}.")
            ax.axis("off")
            legend_ax.axis("off")
            return False

    contig_lengths = {contig: max(end for _s, end, _n, _g in bands)
                      for contig, bands in cytobands.items()}
    total = sum(contig_lengths.values())
    gap = 0.015 * 2 * np.pi
    usable = 2 * np.pi - gap * len(contig_lengths)
    start_angle = {}
    angle = np.pi / 2

    def stain_color(giemsa):
        if giemsa.startswith("gpos"):
            try:
                value = int(giemsa[4:])
            except ValueError:
                value = 100
            level = round(255 * (100 - value) / 100) / 255
            return (level, level, level)
        return {"gneg": "#ffffff", "acen": "#ec4f4f",
                "stalk": "#0000ff"}.get(giemsa, "#f0f0f0")

    def pos_to_angle(contig, position):
        return start_angle[contig] - position / total * usable

    for contig, length in contig_lengths.items():
        start_angle[contig] = angle
        span = length / total * usable
        for band_start, band_end, _name, giemsa in cytobands[contig]:
            t0 = angle - band_start / total * usable
            t1 = angle - band_end / total * usable
            theta = np.linspace(t0, t1, 8)
            ax.plot(np.cos(theta), np.sin(theta), color=stain_color(giemsa),
                    linewidth=5, solid_capstyle="butt", zorder=2)
        theta = np.linspace(angle, angle - span, 40)
        ax.plot(1.035 * np.cos(theta), 1.035 * np.sin(theta), color="#444444",
                linewidth=0.7, zorder=1)
        ax.plot(0.965 * np.cos(theta), 0.965 * np.sin(theta), color="#444444",
                linewidth=0.7, zorder=1)
        mid = angle - span / 2
        ax.text(1.14 * np.cos(mid), 1.14 * np.sin(mid), contig, ha="center",
                va="center", fontsize=5.5 * 0.85 * font_size)
        angle -= span + gap

    def chord(f, color, zorder):
        a1 = pos_to_angle(f.contig1, f.breakpoint1)
        a2 = pos_to_angle(f.contig2, f.breakpoint2)
        p1 = (0.96 * np.cos(a1), 0.96 * np.sin(a1))
        p2 = (0.96 * np.cos(a2), 0.96 * np.sin(a2))
        path = MplPath([p1, (0, 0), p2],
                       [MplPath.MOVETO, MplPath.CURVE3, MplPath.CURVE3])
        ax.add_patch(PathPatch(path, fill=False, edgecolor=color,
                               linewidth=1.6, zorder=zorder))

    confidence_rank = {"low": 0, "medium": 1, "high": 2}
    ordered = [f for f in fusions if f is not fusion] + [fusion]
    for f in ordered:
        if f.contig1 not in cytobands or f.contig2 not in cytobands:
            continue
        if f is fusion:
            chord(f, CIRCOS_COLORS.get(f.type, "#000000"), 5)
        elif (min_confidence != "none"
              and confidence_rank.get(f.confidence, 0)
              >= confidence_rank.get(min_confidence, 1)):
            chord(f, get_bright_color(CIRCOS_COLORS.get(f.type, "#000000")), 3)

    # labels of the fused genes
    for contig, breakpoint, site, gene, display in (
            (fusion.contig1, fusion.breakpoint1, fusion.site1, fusion.gene1,
             fusion.display_contig1),
            (fusion.contig2, fusion.breakpoint2, fusion.site2, fusion.gene2,
             fusion.display_contig2)):
        label = (f"{display}:{breakpoint}" if site == "intergenic" else gene)
        a = pos_to_angle(contig, breakpoint)
        ax.annotate(label, xy=(1.05 * np.cos(a), 1.05 * np.sin(a)),
                    xytext=(1.42 * np.cos(a), 1.42 * np.sin(a)),
                    fontsize=6.5 * font_size, ha="center", va="center",
                    arrowprops=dict(arrowstyle="-", linewidth=0.5))

    ax.set_xlim(-1.6, 1.6)
    ax.set_ylim(-1.6, 1.6)
    ax.set_aspect("equal")
    ax.axis("off")

    legend_ax.axis("off")
    for i, (sv_type, color) in enumerate(CIRCOS_COLORS.items()):
        column, row = i % 2, i // 2
        legend_ax.plot([0.05 + column * 0.5, 0.13 + column * 0.5],
                       [0.8 - row * 0.45] * 2,
                       color=get_bright_color(color), linewidth=3)
        legend_ax.text(0.15 + column * 0.5, 0.8 - row * 0.45, sv_type,
                       fontsize=6.5 * font_size, va="center")
    legend_ax.set_xlim(0, 1)
    legend_ax.set_ylim(0, 1)
    return True


def draw_protein_domains(ax, fusion: FusionRow, exons1: List[ExonRow],
                         exons2: List[ExonRow], domains: List[DomainRow],
                         color1: str, color2: str, merge_overlapping_by: float,
                         optimize_colors: bool, font_size: float,
                         render_3d: bool) -> dict:
    """draw_fusions.R drawProteinDomains — returns a report dict with the
    drawn domain names or the abort message."""
    from matplotlib.patches import Rectangle

    exons_y, exon_height = 0.5, 0.2
    gene_names_y = exons_y - exon_height / 2 - 0.05
    ax.set_xlim(-0.1, 1.1)
    ax.set_ylim(0, 1)
    ax.axis("off")

    def message(text):
        ax.text(0.5, 0.5, text, ha="center", va="center",
                fontsize=7 * font_size)
        return {"domains1": [], "domains2": [], "message": text}

    coding1 = [e for e in exons1
               if e.type == "CDS" and fusion.site1 != "intergenic"]
    coding2 = [e for e in exons2
               if e.type == "CDS" and fusion.site2 != "intergenic"]

    def cut(coding, breakpoint, direction):
        result = []
        for e in coding:
            if direction == "upstream":
                if e.end < breakpoint:
                    continue
                result.append((max(e.start, breakpoint), e.end, e.strand))
            else:
                if e.start > breakpoint:
                    continue
                result.append((e.start, min(e.end, breakpoint), e.strand))
        return result

    coding1 = cut(coding1, fusion.breakpoint1, fusion.direction1)
    coding2 = cut(coding2, fusion.breakpoint2, fusion.direction2)

    if (not any(e.type == "CDS" for e in exons1)
            and not any(e.type == "CDS" for e in exons2)):
        return message("Genes are not protein-coding.")
    coding_length1 = sum(e - s + 1 for s, e, _ in coding1)
    coding_length2 = sum(e - s + 1 for s, e, _ in coding2)
    if coding_length1 + coding_length2 == 0:
        return message("No coding regions retained in fusion transcript.")
    if ((coding_length1 == 0 or fusion.strand1.endswith("."))
            and (coding_length2 == 0 or fusion.strand2.endswith("."))):
        return message("Failed to determine retained protein domains due to "
                       "lack of strand information.")
    antisense1 = fusion.strand1.split("/")[0] != fusion.strand1.split("/")[-1]
    antisense2 = fusion.strand2.split("/")[0] != fusion.strand2.split("/")[-1]
    if ((coding_length1 == 0 or antisense1)
            and (coding_length2 == 0 or antisense2)):
        return message("No coding regions due to antisense transcription.")

    # overlapping domains, grouped by domain id, trimmed to coding exons
    exon_intervals1 = [(s, e) for s, e, _ in coding1]
    exon_intervals2 = [(s, e) for s, e, _ in coding2]
    both = _reduce_intervals(exon_intervals1 + exon_intervals2)
    contigs = {fusion.contig1, fusion.contig2}
    overlapping_ids = []
    for domain in domains:
        if domain.contig not in contigs:
            continue
        if any(domain.start <= e and domain.end >= s for s, e in both):
            if domain.domain_id not in overlapping_ids:
                overlapping_ids.append(domain.domain_id)

    def trim(exon_intervals):
        rows = []
        for domain_id in overlapping_ids:
            group = [d for d in domains if d.domain_id == domain_id]
            pieces = _intersect_intervals(
                [(d.start, d.end) for d in group], exon_intervals)
            for start, end in pieces:
                rows.append({"start": start, "end": end,
                             "name": group[0].name, "id": domain_id,
                             "color": group[0].color})
        return rows

    retained1 = trim(exon_intervals1)
    retained2 = trim(exon_intervals2)

    def remove_introns(coding, retained):
        if not coding:
            return []
        cumulative, previous_end = 0, 0
        ordered = sorted(coding)
        for start, end, _strand in ordered:
            if start > previous_end:
                cumulative += start - previous_end
            for domain in retained:
                if start <= domain["start"] <= end:
                    domain["start"] -= cumulative
                if start <= domain["end"] <= end:
                    domain["end"] -= cumulative
            previous_end = end
        # merge adjacent pieces of the same domain
        merged = []
        for domain_id in dict.fromkeys(d["id"] for d in retained):
            group = [d for d in retained if d["id"] == domain_id]
            for start, end in _reduce_intervals(
                    [(d["start"], d["end"]) for d in group]):
                merged.append({"start": start, "end": end,
                               "name": group[0]["name"], "id": domain_id,
                               "color": group[0]["color"]})
        return merged

    retained1 = remove_introns(coding1, retained1)
    retained2 = remove_introns(coding2, retained2)
    if not retained1 and not retained2:
        return message("No protein domains retained in fusion.")

    def merge_similar(rows):
        merged = []
        for domain in sorted(rows, key=lambda d: d["end"] - d["start"],
                             reverse=True):
            if not any((abs(kept["start"] - domain["start"])
                        + abs(kept["end"] - domain["end"]))
                       / (domain["end"] - domain["start"] + 1)
                       <= 1 - merge_overlapping_by for kept in merged):
                merged.append(domain)
        return merged

    retained1 = merge_similar(retained1)
    retained2 = merge_similar(retained2)

    if optimize_colors:
        import colorsys
        unique = list(dict.fromkeys(d["id"] for d in retained1 + retained2))
        palette = {}
        for i, domain_id in enumerate(unique):
            r, g, b = colorsys.hsv_to_rgb(i / max(1, len(unique)), 1, 1)
            r, g, b = (0.3 + c * 0.7 for c in (r, g, b))  # pastel
            palette[domain_id] = (
                f"#{round(r*255):02x}{round(g*255):02x}{round(b*255):02x}")
        for domain in retained1 + retained2:
            domain["color"] = palette[domain["id"]]

    # reverse when on the minus strand
    if any(strand == "-" for _s, _e, strand in coding1):
        for domain in retained1:
            domain["start"], domain["end"] = (coding_length1 - domain["end"],
                                              coding_length1 - domain["start"])
    if any(strand == "-" for _s, _e, strand in coding2):
        for domain in retained2:
            domain["start"], domain["end"] = (coding_length2 - domain["end"],
                                              coding_length2 - domain["start"])

    total = coding_length1 + coding_length2
    for domain in retained1 + retained2:
        domain["start"] /= total
        domain["end"] /= total
    length1 = coding_length1 / total
    length2 = coding_length2 / total

    # coding regions of the fusion
    ax.add_patch(Rectangle((0, exons_y - exon_height / 2), length1,
                           exon_height, facecolor=color1, edgecolor="none"))
    ax.add_patch(Rectangle((length1, exons_y - exon_height / 2), length2,
                           exon_height, facecolor=color2, edgecolor="none"))

    # exon boundaries as dotted lines
    lengths = ([ (e - s + 1) / total
                 for s, e, _str in sorted(coding1)]
               + [(e - s + 1) / total for s, e, _str in sorted(coding2)])
    boundary = 0.0
    for piece in lengths[:-1]:
        boundary += piece
        ax.plot([boundary, boundary],
                [exons_y - exon_height, exons_y + exon_height],
                color="white", linestyle=":", linewidth=0.8)

    def nest(rows):
        """Containment nesting + partial-overlap stacking
        (draw_fusions.R nestDomains)."""
        rows = sorted(rows, key=lambda d: d["end"] - d["start"], reverse=True)
        for i, domain in enumerate(rows):
            domain["parent"] = -1
            domain["index"] = i
        for i, domain in enumerate(rows):
            for other in rows:
                if (other is not domain
                        and other["start"] >= domain["start"]
                        and other["end"] <= domain["end"]):
                    other["parent"] = i
        events = []
        for domain in rows:
            events.append((domain["start"], 1))
            events.append((domain["end"], -1))
        depth = most = 0
        for _pos, step in sorted(events):
            depth += step
            most = max(most, depth)
        padding = 1 / max(1, most) * 0.4

        def adjust(parent, y, height):
            children = [d for d in rows if d["parent"] == parent]
            for domain in children:
                overlapping = [d for d in children
                               if (domain["start"] <= d["start"] <= domain["end"]
                                   or domain["start"] <= d["end"] <= domain["end"])]
                count = max(1, len(overlapping))
                domain["height"] = (height / count
                                    - padding * (count - 1) / count)
                position = next(k for k, d in enumerate(overlapping)
                                if d is domain)
                domain["y"] = y + position * (domain["height"] + padding)
                adjust(domain["index"], domain["y"] + padding,
                       domain["height"] - 2 * padding)

        adjust(-1, 0.0, 1.0)
        return sorted(rows, key=lambda d: d.get("height", 0), reverse=True)

    retained1 = nest(retained1)
    retained2 = nest(retained2)
    for domain in retained1 + retained2:
        domain["y"] = (exons_y - exon_height / 2 + 0.025
                       + (exon_height - 2 * 0.025) * domain.get("y", 0))
        domain["height"] = domain.get("height", 1) * (exon_height - 2 * 0.025)

    def domain_rect(left, bottom, right, top, color):
        ax.add_patch(Rectangle((left, bottom), right - left, top - bottom,
                               facecolor=color, edgecolor=get_dark_color(color),
                               linewidth=0.6))
        if render_3d:
            ax.add_patch(Rectangle((left, (bottom + top) / 2), right - left,
                                   (top - bottom) / 2, facecolor="white",
                                   alpha=0.4, edgecolor="none"))

    for domain in retained1:
        domain_rect(domain["start"], domain["y"], domain["end"],
                    domain["y"] + domain["height"], domain["color"])
    for domain in retained2:
        domain_rect(length1 + domain["start"], domain["y"],
                    length1 + domain["end"], domain["y"] + domain["height"],
                    domain["color"])

    if coding_length1 > 0:
        ax.text(length1 / 2, gene_names_y, fusion.gene1, fontweight="bold",
                fontsize=7 * font_size, ha="center", va="top")
    if coding_length2 > 0:
        ax.text(length1 + length2 / 2, gene_names_y, fusion.gene2,
                fontweight="bold", fontsize=7 * font_size, ha="center",
                va="top")

    def count_unique(rows):
        unique = 0
        previous = None
        for domain in rows:
            if domain["id"] != previous:
                unique += 1
            previous = domain["id"]
        return unique

    retained1.sort(key=lambda d: d["start"])
    retained2.sort(key=lambda d: -d["end"])
    unique1 = count_unique(retained1)
    unique2 = count_unique(retained2)

    title_y = exons_y + exon_height / 2 + (unique1 + 2) * 0.05
    ax.text(0.5, title_y + 0.01, "RETAINED PROTEIN DOMAINS",
            fontweight="bold", fontsize=7 * font_size, ha="center",
            va="bottom")
    frame = fusion.reading_frame
    frame_text = (f"{frame} fusion" if frame in ("in-frame", "out-of-frame")
                  else ("stop codon before fusion junction"
                        if frame == "stop-codon" else "reading frame unclear"))
    ax.text(0.5, title_y, frame_text, fontsize=7 * font_size, ha="center",
            va="top")

    def draw_labels(rows, above):
        # rows carry page-global coordinates (gene2 pre-shifted by length1)
        if not rows:
            return
        label_y = (exons_y + exon_height / 2 + count_unique(rows) * 0.05
                   if above
                   else exons_y - exon_height / 2
                   - (count_unique(rows) + 1) * 0.05)
        previous_connector = -1.0 if above else 100.0
        previous_label = -1.0 if above else 100.0
        for i, domain in enumerate(rows):
            if above:
                connector = min(domain["start"] + 0.01,
                                (domain["start"] + domain["end"]) / 2)
                if (connector - previous_connector < 0.01
                        and domain["end"] > previous_connector + 0.01):
                    connector = previous_connector + 0.01
                label_x = max(connector, previous_label) + 0.02
            else:
                connector = max(domain["end"] - 0.01,
                                (domain["start"] + domain["end"]) / 2)
                if (previous_connector - connector < 0.01
                        and domain["start"] < previous_connector - 0.01):
                    connector = previous_connector - 0.01
                label_x = min(connector, previous_label) - 0.02
            adjacent_same = (i + 1 < len(rows)
                             and rows[i + 1]["id"] == domain["id"])
            dark = get_dark_color(domain["color"])
            if not adjacent_same:
                ax.text(label_x, label_y, domain["name"],
                        fontsize=6.5 * font_size, color=dark,
                        ha="left" if above else "right", va="center")
            anchor_y = (domain["y"] + domain["height"]) if above else domain["y"]
            start_x = label_x - 0.005 if above else label_x + 0.005
            ax.plot([start_x, connector, connector],
                    [label_y, label_y, anchor_y], color=dark, linewidth=0.6)
            if not adjacent_same:
                label_y += -0.05 if above else 0.05
            previous_connector = connector
            previous_label = label_x

    draw_labels(retained1, True)
    for domain in retained2:  # shift gene2-local coordinates onto the page
        domain["start"] += length1
        domain["end"] += length1
    draw_labels(retained2, False)

    return {"domains1": [d["name"] for d in retained1],
            "domains2": [d["name"] for d in retained2], "message": ""}


# --------------------------------------------------------------------------
# main renderer


def _signif1(value: float) -> float:
    """R signif(x, 1): round to one significant digit."""
    import math
    if value <= 0:
        return 0.0
    magnitude = 10.0 ** math.floor(math.log10(value))
    return round(value / magnitude) * magnitude


def _measured_text(ax, fig, x, y, text, color, ha, font_size):
    """Draw text and return its width in data coordinates (for the
    two-color fusion-transcript line, draw_fusions.R:1317-1334)."""
    if not text:
        return 0.0
    artist = ax.text(x, y, text, color=color, ha=ha, va="center",
                     fontsize=7 * font_size, family="monospace")
    try:
        renderer = fig.canvas.get_renderer()
        bbox = artist.get_window_extent(renderer=renderer)
        inverse = ax.transData.inverted()
        (x0, _y0), (x1, _y1) = inverse.transform([(bbox.x0, bbox.y0),
                                                  (bbox.x1, bbox.y1)])
        return abs(x1 - x0)
    except Exception:
        return 0.004 * len(text) * font_size


def draw_fusions(fusions_file: str, annotation_file: str, output_file: str,
                 alignments_file: str = "", cytobands_file: str = "",
                 protein_domains_file: str = "", sample_name: str = "",
                 squish_introns_option: bool = True,
                 print_exon_labels: bool = True, render_3d: bool = True,
                 plot_panels: Optional[List[str]] = None,
                 pdf_width: float = 11.692, pdf_height: float = 8.267,
                 color1: str = COLOR1, color2: str = COLOR2,
                 merge_domains_overlapping_by: float = 0.9,
                 optimize_domain_colors: bool = False, font_size: float = 1.0,
                 font_family: str = "Helvetica",
                 show_intergenic_vicinity: Optional[list] = None,
                 transcript_selection: str = "provided",
                 fixed_scale: float = 0.0,
                 coverage_range: Optional[List[float]] = None,
                 min_confidence_for_circos_plot: str = "medium"
                 ) -> List[dict]:
    """Render one PDF page per fusion; returns the per-page render report."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    def warn(message):
        print(f"WARNING: {message}", file=sys.stderr)

    plot_panels = list(plot_panels
                       or ["fusion", "circos", "domains", "readcounts"])
    show_vicinity_option = show_intergenic_vicinity or [0.0] * 4
    coverage_range = coverage_range or [0.0]
    if font_family and font_family not in ("Helvetica", "Times", "Courier"):
        matplotlib.rcParams["font.family"] = font_family
    dark1, dark2 = get_dark_color(color1), get_dark_color(color2)

    fusions = read_fusions(fusions_file)
    cytobands = read_cytobands(cytobands_file) if cytobands_file else {}
    if not cytobands_file:
        warn("Missing parameter '--cytobands'. No ideograms and circos "
             "plots will be drawn.")
    if not cytobands:
        plot_panels = [p for p in plot_panels if p != "circos"]
    exons = read_exons(annotation_file, print_exon_labels)
    domains = (read_protein_domains(protein_domains_file)
               if protein_domains_file else [])
    if not protein_domains_file:
        plot_panels = [p for p in plot_panels if p != "domains"]

    report: List[dict] = []
    with PdfPages(output_file) as pdf:
        if not fusions:
            fig = plt.figure(figsize=(pdf_width, pdf_height))
            fig.text(0.5, 0.5, "empty input file", ha="center", va="center")
            warn("empty input file")
            pdf.savefig(fig)
            plt.close(fig)
            return report

        # dummy annotation for intergenic breakpoints (draw_fusions.R:260-281)
        for i, fusion in enumerate(fusions):
            for side in (1, 2):
                if getattr(fusion, f"site{side}") != "intergenic":
                    continue
                contig = getattr(fusion, f"contig{side}")
                breakpoint = getattr(fusion, f"breakpoint{side}")
                gene_id = f"{contig}:{breakpoint}"
                exons.append(ExonRow(
                    contig=contig, type="intergenic",
                    start=max(breakpoint - 1000, 1), end=breakpoint + 1000,
                    strand=".", attributes="",
                    gene_id=gene_id,
                    gene_name=getattr(fusion, f"gene{side}"),
                    transcript=gene_id, exon_number="intergenic"))
                fusions[i] = replace(fusion, **{f"gene_id{side}": gene_id})
                fusion = fusions[i]

        for fusion in fusions:
            page = _draw_one_fusion(
                plt, pdf, fusion, fusions, exons, domains, cytobands,
                alignments_file, sample_name, squish_introns_option,
                render_3d, plot_panels, pdf_width, pdf_height, color1, color2,
                dark1, dark2, merge_domains_overlapping_by,
                optimize_domain_colors, font_size, show_vicinity_option,
                transcript_selection, fixed_scale, coverage_range,
                min_confidence_for_circos_plot, warn)
            report.append(page)
    return report


def _draw_one_fusion(plt, pdf, fusion, fusions, exons, domains, cytobands,
                     alignments_file, sample_name, squish_introns_option,
                     render_3d, plot_panels, pdf_width, pdf_height, color1,
                     color2, dark1, dark2, merge_domains_overlapping_by,
                     optimize_domain_colors, font_size, show_vicinity_option,
                     transcript_selection, fixed_scale, coverage_range,
                     min_confidence_for_circos, warn):
    import copy

    page = {"gene1": fusion.gene1, "gene2": fusion.gene2, "panels": [],
            "breakpoint_labels": [], "scale_label": "", "transcripts": [],
            "domain_report": None, "messages": []}

    # intergenic vicinity ranges (draw_fusions.R:925-955)
    show_vicinity = [0.0] * 4
    if fusion.site1 == "intergenic":
        for k, (side, comparator) in enumerate(
                ((0, "left"), (1, "right"))):
            option = show_vicinity_option[k]
            if isinstance(option, float):
                show_vicinity[k] = option
            elif comparator == "left":
                start, _end = find_closest_gene(
                    exons, fusion.contig1, fusion.breakpoint1,
                    lambda e: e.end < fusion.breakpoint1 and e.type == option)
                show_vicinity[k] = fusion.breakpoint1 - start
            else:
                _start, end = find_closest_gene(
                    exons, fusion.contig1, fusion.breakpoint1,
                    lambda e: e.start > fusion.breakpoint1 and e.type == option)
                show_vicinity[k] = end - fusion.breakpoint1
    if fusion.site2 == "intergenic":
        for k, comparator in ((2, "left"), (3, "right")):
            option = show_vicinity_option[k]
            if isinstance(option, float):
                show_vicinity[k] = option
            elif comparator == "left":
                start, _end = find_closest_gene(
                    exons, fusion.contig2, fusion.breakpoint2,
                    lambda e: e.end < fusion.breakpoint2 and e.type == option)
                show_vicinity[k] = fusion.breakpoint2 - start
            else:
                _start, end = find_closest_gene(
                    exons, fusion.contig2, fusion.breakpoint2,
                    lambda e: e.start > fusion.breakpoint2 and e.type == option)
                show_vicinity[k] = end - fusion.breakpoint2

    # coverage (draw_fusions.R:958-988)
    coverage1 = coverage2 = None
    coverage_region1 = coverage_region2 = None
    if alignments_file:
        def coverage_region(gene_id, contig, breakpoint, left, right):
            start, end = find_closest_gene(exons, contig, breakpoint,
                                           lambda e: e.gene_id == gene_id)
            return (int(min(start, breakpoint - left)),
                    int(max(end, breakpoint + right)))

        coverage_region1 = coverage_region(
            fusion.gene_id1, fusion.contig1, fusion.breakpoint1,
            show_vicinity[0], show_vicinity[1])
        coverage_region2 = coverage_region(
            fusion.gene_id2, fusion.contig2, fusion.breakpoint2,
            show_vicinity[2], show_vicinity[3])
        coverage1 = compute_coverage(alignments_file, fusion.contig1,
                                     *coverage_region1)
        coverage2 = compute_coverage(alignments_file, fusion.contig2,
                                     *coverage_region2)

    # pick transcripts (draw_fusions.R:991-1009)
    exons1 = find_exons(exons, fusion.contig1, fusion.gene_id1,
                        fusion.direction1, fusion.breakpoint1, coverage1,
                        fusion.transcript_id1, transcript_selection, warn)
    exons2 = find_exons(exons, fusion.contig2, fusion.gene_id2,
                        fusion.direction2, fusion.breakpoint2, coverage2,
                        fusion.transcript_id2, transcript_selection, warn)
    for which, gene, selected in (("1", fusion.gene1, exons1),
                                  ("2", fusion.gene2, exons2)):
        if not selected:
            fig = plt.figure(figsize=(pdf_width, pdf_height))
            fig.text(0.5, 0.5, f"exon coordinates of {gene} not found",
                     ha="center", va="center")
            warn(f"exon coordinates of {gene} not found")
            pdf.savefig(fig)
            plt.close(fig)
            page["messages"].append(f"exon coordinates of {gene} not found")
            return page
    exons1 = [copy.copy(e) for e in exons1]
    exons2 = [copy.copy(e) for e in exons2]

    # intergenic vicinity: pull in neighboring genes (draw_fusions.R:1011-1030)
    if sum(show_vicinity) > 0:
        def widen(selected, contig, breakpoint, left, right, direction,
                  transcript_id, coverage):
            gene_ids = {e.gene_id for e in exons
                        if e.contig == contig and e.exon_number != "intergenic"
                        and (breakpoint - left <= e.end <= breakpoint + right
                             or breakpoint - left <= e.start
                             <= breakpoint + right)}
            for gene_id in sorted(gene_ids):
                selected.extend(copy.copy(e) for e in find_exons(
                    exons, contig, gene_id, direction, breakpoint, coverage,
                    transcript_id, transcript_selection, warn))
            return [e for e in selected
                    if (breakpoint - left <= e.start and e.end
                        <= breakpoint + right)
                    or e.exon_number == "intergenic"]

        if fusion.site1 == "intergenic":
            exons1 = widen(exons1, fusion.contig1, fusion.breakpoint1,
                           show_vicinity[0], show_vicinity[1],
                           fusion.direction1, fusion.transcript_id1, coverage1)
        if fusion.site2 == "intergenic":
            exons2 = widen(exons2, fusion.contig2, fusion.breakpoint2,
                           show_vicinity[2], show_vicinity[3],
                           fusion.direction2, fusion.transcript_id2, coverage2)

    # coverage normalization (draw_fusions.R:1033-1049)
    import numpy as np
    coverage_normalization1 = coverage_normalization2 = 1
    if alignments_file:
        def normalization(coverage, region, selected):
            if coverage is None:
                return 1
            cov_start, cov = coverage
            if squish_introns_option:
                peak = 0.0
                for e in selected:
                    lo = max(e.start, cov_start)
                    hi = min(e.end, cov_start + len(cov) - 1)
                    if hi >= lo:
                        peak = max(peak, float(
                            cov[lo - cov_start:hi - cov_start + 1].max()))
                return max(1, peak)
            return max(1, round(float(np.quantile(cov, 0.9999))))

        coverage_normalization1 = (
            normalization(coverage1, coverage_region1, exons1)
            if coverage_range[0] == 0 else coverage_range[0])
        coverage_normalization2 = (
            normalization(coverage2, coverage_region2, exons2)
            if coverage_range[-1] == 0 else coverage_range[-1])
        if len(coverage_range) == 1 and coverage_range[0] == 0:
            harmonized = max(coverage_normalization1, coverage_normalization2)
            coverage_normalization1 = coverage_normalization2 = harmonized
        if coverage1 is not None:
            coverage1 = (coverage1[0], np.minimum(
                coverage1[1] / coverage_normalization1, 1.0))
        if coverage2 is not None:
            coverage2 = (coverage2[0], np.minimum(
                coverage2[1] / coverage_normalization2, 1.0))

    # exon order: coding regions drawn last (draw_fusions.R:1052-1053)
    exons1.sort(key=lambda e: (e.start, e.type == "CDS"))
    exons2.sort(key=lambda e: (e.start, e.type == "CDS"))

    # dummy exons when the breakpoint lies outside the transcript
    breakpoint1, breakpoint2 = fusion.breakpoint1, fusion.breakpoint2

    def add_dummy(selected, breakpoint):
        if breakpoint < min(e.start for e in selected):
            position = max(1, breakpoint - 1000)
            selected.insert(0, replace(selected[0], type="dummy",
                                       start=position, end=position,
                                       exon_number=""))
        elif breakpoint > max(e.end for e in selected):
            selected.append(replace(selected[0], type="dummy",
                                    start=breakpoint + 1000,
                                    end=breakpoint + 1000, exon_number=""))

    add_dummy(exons1, breakpoint1)
    add_dummy(exons2, breakpoint2)
    for e in exons1 + exons2:
        e.left, e.right = float(e.start), float(e.end)

    # squish or align-left (draw_fusions.R:1087-1118)
    if squish_introns_option:
        mapped_breakpoint1 = squish_introns(exons1, breakpoint1)
        mapped_breakpoint2 = squish_introns(exons2, breakpoint2)
    else:
        mapped_breakpoint1 = shift_to_origin(exons1, breakpoint1)
        mapped_breakpoint2 = shift_to_origin(exons2, breakpoint2)

    # scale to the page (draw_fusions.R:1120-1135)
    scaling_factor = (max(e.right for e in exons1)
                      + max(e.right for e in exons2))
    if fixed_scale > 0:
        if fixed_scale >= scaling_factor:
            scaling_factor = fixed_scale
        else:
            warn("fallback to automatic scaling, because value for "
                 "--fixedScale is too small to fit transcripts on canvas "
                 f"(increase it to {scaling_factor} to avoid this)")
    for e in exons1 + exons2:
        e.left /= scaling_factor
        e.right /= scaling_factor
    mapped_breakpoint1 /= scaling_factor
    mapped_breakpoint2 /= scaling_factor

    gene2_offset = 1 + 0.05 - max(e.right for e in exons2)
    anchor1 = (mapped_breakpoint1 if fusion.direction1 == "downstream"
               else max(e.right for e in exons1) - mapped_breakpoint1)
    fusion_offset1 = (max(e.right for e in exons1) + gene2_offset) / 2 - anchor1
    fusion_offset2 = fusion_offset1 + anchor1

    # page layout (draw_fusions.R:1143-1160)
    top_row = "fusion" in plot_panels
    bottom_row = any(p in plot_panels for p in ("circos", "domains",
                                                "readcounts"))
    widths = [1.1 if "circos" in plot_panels else 0.01,
              1.2 if "domains" in plot_panels else 0.01,
              0.7 if "readcounts" in plot_panels else 0.01]
    heights = [1.55 if top_row else 0.3,
               1.2 if bottom_row else 0.01,
               0.25 if "circos" in plot_panels else 0.01]
    total_w, total_h = sum(widths), sum(heights)
    fig = plt.figure(figsize=(pdf_width, pdf_height))

    def panel_axes(row0, row1, col0, col1):
        x0 = sum(widths[:col0]) / total_w
        width = sum(widths[col0:col1]) / total_w
        y0 = sum(heights[row1:]) / total_h
        height = sum(heights[row0:row1]) / total_h
        ax = fig.add_axes([x0, y0, width, height])
        ax.axis("off")
        return ax

    fusion_ax = panel_axes(0, 1, 0, 3)
    fusion_ax.set_xlim(-0.12, 1.12)
    fusion_ax.set_ylim((0.4, 1.1) if bottom_row else (0.2, 1.3))

    y_sample = 1.04 if top_row else 0.5
    y_ideograms = 0.94 if alignments_file else 0.84
    y_breakpoint_labels = 0.86 if alignments_file else 0.76
    y_coverage = 0.72
    y_exons = 0.67
    y_gene_names = 0.58
    y_fusion = 0.5
    y_transcript = 0.45
    y_scale = 0.407
    y_trajectory_bp = y_breakpoint_labels - 0.035
    y_trajectory_exon_top = y_exons + 0.03
    y_trajectory_exon_bottom = y_exons - 0.055
    y_trajectory_fusion = y_fusion + 0.03

    if sample_name:
        fusion_ax.text(0.5, y_sample, sample_name, fontweight="bold",
                       fontsize=9 * 1.5 * font_size, ha="center", va="bottom")

    max_right1 = max(e.right for e in exons1)
    max_right2 = max(e.right for e in exons2)

    if "fusion" in plot_panels:
        page["panels"].append("fusion")
        if cytobands:
            draw_ideogram(fusion_ax, "left", min(e.left for e in exons1),
                          max_right1, y_ideograms, cytobands, fusion.contig1,
                          fusion.breakpoint1, font_size, render_3d, warn)
            draw_ideogram(fusion_ax, "right", gene2_offset,
                          gene2_offset + max_right2, y_ideograms, cytobands,
                          fusion.contig2, fusion.breakpoint2, font_size,
                          render_3d, warn)

        # gene & transcript names
        if fusion.gene1 != ".":
            fusion_ax.text(max_right1 / 2, y_gene_names, fusion.gene1,
                           fontweight="bold", fontsize=8 * font_size,
                           ha="center", va="bottom")
        if fusion.site1 != "intergenic":
            fusion_ax.text(max_right1 / 2, y_gene_names - 0.01,
                           exons1[0].transcript, fontsize=7 * font_size,
                           ha="center", va="top")
            page["transcripts"].append(exons1[0].transcript)
        if fusion.gene2 != ".":
            fusion_ax.text(gene2_offset + max_right2 / 2, y_gene_names,
                           fusion.gene2, fontweight="bold",
                           fontsize=8 * font_size, ha="center", va="bottom")
        if fusion.site2 != "intergenic":
            fusion_ax.text(gene2_offset + max_right2 / 2, y_gene_names - 0.01,
                           exons2[0].transcript, fontsize=7 * font_size,
                           ha="center", va="top")
            page["transcripts"].append(exons2[0].transcript)

        # neighboring genes of intergenic breakpoints get their own labels
        for selected, site, offset in ((exons1, fusion.site1, 0.0),
                                       (exons2, fusion.site2, gene2_offset)):
            if site != "intergenic":
                continue
            for gene_name in dict.fromkeys(e.gene_name for e in selected):
                of_gene = [e for e in selected
                           if e.gene_name == gene_name and e.type != "dummy"]
                if any(e.type == "exon" for e in of_gene):
                    fusion_ax.text(
                        offset + (min(e.left for e in of_gene)
                                  + max(e.right for e in of_gene)) / 2,
                        y_exons - 0.04, gene_name, fontsize=7 * font_size,
                        ha="center", va="top")

        # breakpoint labels
        label1 = (f"breakpoint1\n{fusion.display_contig1}:"
                  f"{fusion.breakpoint1}")
        label2 = (f"breakpoint2\n{fusion.display_contig2}:"
                  f"{fusion.breakpoint2}")
        fusion_ax.text(mapped_breakpoint1 + 0.01, y_breakpoint_labels - 0.03,
                       label1, ha="right", va="bottom",
                       fontsize=7 * font_size)
        fusion_ax.text(gene2_offset + mapped_breakpoint2 - 0.01,
                       y_breakpoint_labels - 0.03, label2, ha="left",
                       va="bottom", fontsize=7 * font_size)
        page["breakpoint_labels"] = [label1.replace("\n", " "),
                                     label2.replace("\n", " ")]

        # coverage tracks + axes (draw_fusions.R:1218-1258)
        if alignments_file:
            page["panels"].append("coverage")
            fusion_ax.plot([-0.02, -0.01, -0.01, -0.02],
                           [y_coverage, y_coverage, y_coverage + 0.1,
                            y_coverage + 0.1], color="black", linewidth=0.8)
            fusion_ax.text(-0.025, y_coverage, "0", ha="right", va="center",
                           fontsize=7 * font_size)
            fusion_ax.text(-0.025, y_coverage + 0.1,
                           str(int(coverage_normalization1)), ha="right",
                           va="center", fontsize=7 * font_size)
            fusion_ax.text(-0.05, y_coverage + 0.08, "Coverage", rotation=90,
                           ha="right", va="center", fontsize=7 * font_size)
            if len(coverage_range) == 2:
                axis_x = gene2_offset + max_right2
                fusion_ax.plot([axis_x + 0.02, axis_x + 0.01, axis_x + 0.01,
                                axis_x + 0.02],
                               [y_coverage, y_coverage, y_coverage + 0.1,
                                y_coverage + 0.1], color="black",
                               linewidth=0.8)
                fusion_ax.text(axis_x + 0.025, y_coverage, "0", ha="left",
                               va="center", fontsize=7 * font_size)
                fusion_ax.text(axis_x + 0.025, y_coverage + 0.1,
                               str(int(coverage_normalization2)), ha="left",
                               va="center", fontsize=7 * font_size)
            from matplotlib.patches import Rectangle
            fusion_ax.add_patch(Rectangle(
                (min(e.left for e in exons1), y_coverage),
                max_right1 - min(e.left for e in exons1), 0.1,
                facecolor="#eeeeee", edgecolor="none", zorder=1))
            fusion_ax.add_patch(Rectangle(
                (gene2_offset + min(e.left for e in exons2), y_coverage),
                max_right2 - min(e.left for e in exons2), 0.1,
                facecolor="#eeeeee", edgecolor="none", zorder=1))
            if squish_introns_option:
                for e in exons1:
                    if e.type != "CDS":
                        draw_coverage(fusion_ax, e.left, e.right, y_coverage,
                                      coverage1, e.start, e.end, color1)
                for e in exons2:
                    if e.type != "CDS":
                        draw_coverage(fusion_ax, gene2_offset + e.left,
                                      gene2_offset + e.right, y_coverage,
                                      coverage2, e.start, e.end, color2)
            else:
                draw_coverage(fusion_ax, min(e.left for e in exons1),
                              max_right1, y_coverage, coverage1,
                              min(e.start for e in exons1),
                              max(e.end for e in exons1), color1)
                draw_coverage(fusion_ax,
                              gene2_offset + min(e.left for e in exons2),
                              gene2_offset + max_right2, y_coverage,
                              coverage2, min(e.start for e in exons2),
                              max(e.end for e in exons2), color2)

        # gene diagrams (draw_fusions.R:1260-1272)
        fusion_ax.plot([min(e.left for e in exons1), max_right1],
                       [y_exons, y_exons], color=dark1, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons1):
            of_gene = [e for e in exons1 if e.gene_name == gene_name]
            draw_strand(fusion_ax, min(e.left for e in of_gene),
                        max(e.right for e in of_gene), y_exons, dark1,
                        of_gene[0].strand, font_size)
        for e in exons1:
            draw_exon(fusion_ax, e.left, e.right, y_exons, color1,
                      e.exon_number, e.type, font_size, render_3d)
        fusion_ax.plot([gene2_offset, gene2_offset + max_right2],
                       [y_exons, y_exons], color=dark2, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons2):
            of_gene = [e for e in exons2 if e.gene_name == gene_name]
            draw_strand(fusion_ax, gene2_offset + min(e.left for e in of_gene),
                        gene2_offset + max(e.right for e in of_gene), y_exons,
                        dark2, of_gene[0].strand, font_size)
        for e in exons2:
            draw_exon(fusion_ax, gene2_offset + e.left,
                      gene2_offset + e.right, y_exons, color2, e.exon_number,
                      e.type, font_size, render_3d)

        _draw_fused_genes(fusion_ax, fusion, exons1, exons2,
                          mapped_breakpoint1, mapped_breakpoint2,
                          gene2_offset, fusion_offset1, fusion_offset2,
                          color1, color2, dark1, dark2, font_size, render_3d,
                          y_fusion, y_trajectory_bp, y_trajectory_exon_top,
                          y_trajectory_exon_bottom, y_trajectory_fusion)

        # fusion transcript sequence (draw_fusions.R:1317-1334)
        if fusion.fusion_transcript != ".":
            transcript = fusion.fusion_transcript
            part1 = re.sub(r"\|.*", "", transcript)[-30:]
            part2 = re.sub(r".*\|", "", transcript)[:30]
            match = re.match(r".*\|([^|]*)\|.*", transcript)
            non_template = match.group(1) if match else ""
            half = len(non_template) // 2
            ntb1, ntb2 = non_template[:half], non_template[half:]
            width1 = _measured_text(fusion_ax, fig, fusion_offset2,
                                    y_transcript, ntb1, "black", "right",
                                    font_size)
            _measured_text(fusion_ax, fig, fusion_offset2 - width1,
                           y_transcript, part1, dark1, "right", font_size)
            width2 = _measured_text(fusion_ax, fig, fusion_offset2,
                                    y_transcript, ntb2, "black", "left",
                                    font_size)
            _measured_text(fusion_ax, fig, fusion_offset2 + width2,
                           y_transcript, part2, dark2, "left", font_size)

        # scale bar (draw_fusions.R:1337-1356)
        real_scale = max(max(e.end - e.start for e in exons1),
                         max(e.end - e.start for e in exons2))
        map_scale = max(max(e.right - e.left for e in exons1),
                        max(e.right - e.left for e in exons2))
        if map_scale > 0 and real_scale > 0:
            desired = 0.2
            real_scale = desired / map_scale * real_scale
            map_scale = desired
            real_fit = _signif1(real_scale)
            map_fit = real_fit / real_scale * map_scale
            fusion_ax.plot([1 - map_fit, 1], [y_scale, y_scale],
                           color="black", linewidth=0.8)
            for x in (1 - map_fit, 1):
                fusion_ax.plot([x, x], [y_scale - 0.007, y_scale + 0.007],
                               color="black", linewidth=0.8)
            import math
            thousands = max(0, min(3, int(math.floor(
                math.log10(max(real_fit, 1)) / 3))))
            units = ["bp", "kbp", "Mbp", "Gbp"]
            scale_label = (f"{real_fit / max(1, 1000 ** thousands):g} "
                           f"{units[thousands]}")
            fusion_ax.text(1 - map_fit / 2, y_scale + 0.005, scale_label,
                           ha="center", va="bottom", fontsize=7 * font_size)
            page["scale_label"] = scale_label
            if squish_introns_option:
                fusion_ax.text(1 - map_fit / 2, y_scale - 0.005,
                               "introns not to scale", ha="center", va="top",
                               fontsize=7 * font_size, style="italic")

    # circos panel
    if "circos" in plot_panels:
        circos_ax = panel_axes(1, 2, 0, 1)
        legend_ax = panel_axes(2, 3, 0, 1)
        if draw_circos(circos_ax, legend_ax, fusion, fusions, cytobands,
                       min_confidence_for_circos, font_size, warn):
            page["panels"].append("circos")

    # protein domain panel
    if "domains" in plot_panels:
        domains_ax = panel_axes(1, 3, 1, 2)
        page["domain_report"] = draw_protein_domains(
            domains_ax, fusion, exons1, exons2, domains, color1, color2,
            merge_domains_overlapping_by, optimize_domain_colors, font_size,
            render_3d)
        page["panels"].append("domains")

    # read count panel (draw_fusions.R:1382-1399)
    if "readcounts" in plot_panels:
        counts_ax = panel_axes(1, 3, 2, 3)
        counts_ax.set_xlim(0, 1)
        counts_ax.set_ylim(0, 1)
        counts_ax.text(0, 0.575, "SUPPORTING READ COUNT", fontweight="bold",
                       fontsize=7 * font_size, ha="left", va="bottom")
        if fusion.split_reads is not None:  # STAR-Fusion: combined counts
            text = (f"Split reads = {fusion.split_reads}\n"
                    f"Discordant mates = {fusion.discordant_mates}")
        else:
            text = (f"Split reads at breakpoint1 = {fusion.split_reads1}\n"
                    f"Split reads at breakpoint2 = {fusion.split_reads2}\n"
                    f"Discordant mates = {fusion.discordant_mates}")
        counts_ax.text(0, 0.525, text, fontsize=7 * font_size, ha="left",
                       va="top")
        page["panels"].append("readcounts")

    pdf.savefig(fig)
    plt.close(fig)
    return page



def _draw_fused_genes(ax, fusion, exons1, exons2, breakpoint1, breakpoint2,
                      gene2_offset, fusion_offset1, fusion_offset2, color1,
                      color2, dark1, dark2, font_size, render_3d, y_fusion,
                      y_trajectory_bp, y_trajectory_exon_top,
                      y_trajectory_exon_bottom, y_trajectory_fusion):
    """The fused-transcript diagram + red dashed trajectories
    (draw_fusions.R:1274-1315)."""
    max_right1 = max(e.right for e in exons1)
    max_right2 = max(e.right for e in exons2)

    def flip(strand):
        return {"+": "-", "-": "+"}.get(strand, strand)

    def trajectories(x_outer, x_breakpoint, x_fusion_outer, x_fusion_bp):
        ax.plot([x_outer, x_outer, x_fusion_outer],
                [y_trajectory_exon_top, y_trajectory_exon_bottom,
                 y_trajectory_fusion], color="red", linestyle="--",
                linewidth=0.8)
        ax.plot([x_breakpoint, x_breakpoint, x_fusion_bp],
                [y_trajectory_bp, y_trajectory_exon_bottom,
                 y_trajectory_fusion], color="red", linestyle="--",
                linewidth=0.8)

    # gene1 of the fusion
    if fusion.direction1 == "downstream":
        ax.plot([fusion_offset1, fusion_offset1 + breakpoint1],
                [y_fusion, y_fusion], color=dark1, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons1):
            of_gene = [e for e in exons1 if e.gene_name == gene_name]
            if min(e.start for e in of_gene) <= fusion.breakpoint1:
                draw_strand(ax, fusion_offset1 + min(e.left for e in of_gene),
                            fusion_offset1 + min(breakpoint1,
                                                 max(e.right for e in of_gene)),
                            y_fusion, dark1, of_gene[0].strand, font_size)
        for e in exons1:
            if e.start <= fusion.breakpoint1:
                draw_exon(ax, fusion_offset1 + e.left,
                          fusion_offset1 + min(breakpoint1, e.right),
                          y_fusion, color1, e.exon_number, e.type, font_size,
                          render_3d)
        trajectories(0.0, breakpoint1, fusion_offset1,
                     fusion_offset1 + breakpoint1)
    else:  # upstream
        ax.plot([fusion_offset1, fusion_offset2], [y_fusion, y_fusion],
                color=dark1, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons1):
            of_gene = [e for e in exons1 if e.gene_name == gene_name]
            if max(e.end + 1 for e in of_gene) >= fusion.breakpoint1:
                draw_strand(ax, fusion_offset2 - max(e.right for e in of_gene)
                            + breakpoint1,
                            min(fusion_offset2,
                                fusion_offset2 - min(e.left for e in of_gene)
                                + breakpoint1),
                            y_fusion, dark1, flip(of_gene[0].strand),
                            font_size)
        for e in exons1:
            if e.end + 1 >= fusion.breakpoint1:
                draw_exon(ax, fusion_offset1 + max_right1 - e.right,
                          min(fusion_offset2,
                              fusion_offset1 + max_right1 - e.left),
                          y_fusion, color1, e.exon_number, e.type, font_size,
                          render_3d)
        trajectories(max_right1, breakpoint1, fusion_offset1,
                     fusion_offset1 + max_right1 - breakpoint1)

    # gene2 of the fusion
    if fusion.direction2 == "downstream":
        ax.plot([fusion_offset2, fusion_offset2 + breakpoint2],
                [y_fusion, y_fusion], color=dark2, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons2):
            of_gene = [e for e in exons2 if e.gene_name == gene_name]
            if min(e.start for e in of_gene) <= fusion.breakpoint2:
                draw_strand(ax, max(fusion_offset2, fusion_offset2
                                    + breakpoint2
                                    - max(e.right for e in of_gene)),
                            fusion_offset2 + breakpoint2
                            - min(e.left for e in of_gene),
                            y_fusion, dark2, flip(of_gene[0].strand),
                            font_size)
        for e in exons2:
            if e.start <= fusion.breakpoint2:
                draw_exon(ax, max(fusion_offset2,
                                  fusion_offset2 + breakpoint2 - e.right),
                          fusion_offset2 + breakpoint2 - e.left, y_fusion,
                          color2, e.exon_number, e.type, font_size, render_3d)
        trajectories(gene2_offset, gene2_offset + breakpoint2,
                     fusion_offset2 + breakpoint2, fusion_offset2)
    else:  # upstream
        ax.plot([fusion_offset2,
                 fusion_offset2 + max_right2 - breakpoint2],
                [y_fusion, y_fusion], color=dark2, linewidth=1)
        for gene_name in dict.fromkeys(e.gene_name for e in exons2):
            of_gene = [e for e in exons2 if e.gene_name == gene_name]
            if max(e.end + 1 for e in of_gene) >= fusion.breakpoint2:
                draw_strand(ax, max(fusion_offset2, fusion_offset2
                                    + min(e.left for e in of_gene)
                                    - breakpoint2),
                            fusion_offset2 + max(e.right for e in of_gene)
                            - breakpoint2,
                            y_fusion, dark2, of_gene[0].strand, font_size)
        for e in exons2:
            if e.end + 1 >= fusion.breakpoint2:
                draw_exon(ax, max(fusion_offset2,
                                  fusion_offset2 + e.left - breakpoint2),
                          fusion_offset2 + e.right - breakpoint2, y_fusion,
                          color2, e.exon_number, e.type, font_size, render_3d)
        trajectories(gene2_offset + max_right2, gene2_offset + breakpoint2,
                     fusion_offset2 + max_right2 - breakpoint2,
                     fusion_offset2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or any(arg.startswith("--help") for arg in argv):
        usage = "Usage: draw_fusions"
        for name, kind, default, mandatory in PARAMETERS:
            default_text = ("TRUE" if default is True else
                            "FALSE" if default is False else str(default))
            piece = f"--{name}={default_text}"
            usage += " " + (piece if mandatory else f"[{piece}]")
        print(usage, file=sys.stderr)
        return 1 if not argv else 0
    try:
        options = parse_options(argv)
    except OptionError as error:
        print(str(error), file=sys.stderr)
        return 1
    for path_option in ("fusions", "annotation", "alignments", "cytobands",
                        "proteinDomains"):
        value = options[path_option]
        if value:
            try:
                open(value, "rb").close()
            except OSError:
                print(f"Cannot read file: {value}", file=sys.stderr)
                return 1
    draw_fusions(
        options["fusions"], options["annotation"], options["output"],
        alignments_file=options["alignments"],
        cytobands_file=options["cytobands"],
        protein_domains_file=options["proteinDomains"],
        sample_name=options["sampleName"],
        squish_introns_option=options["squishIntrons"],
        print_exon_labels=options["printExonLabels"],
        render_3d=options["render3dEffect"],
        plot_panels=options["plotPanels"],
        pdf_width=options["pdfWidth"], pdf_height=options["pdfHeight"],
        color1=options["color1"], color2=options["color2"],
        merge_domains_overlapping_by=options["mergeDomainsOverlappingBy"],
        optimize_domain_colors=options["optimizeDomainColors"],
        font_size=options["fontSize"], font_family=options["fontFamily"],
        show_intergenic_vicinity=options["showIntergenicVicinity"],
        transcript_selection=options["transcriptSelection"],
        fixed_scale=options["fixedScale"],
        coverage_range=options["coverageRange"],
        min_confidence_for_circos_plot=options["minConfidenceForCircosPlot"])
    print("Done", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
