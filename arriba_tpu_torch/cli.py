"""Command-line interface, flag-compatible with the reference binary.

Reference parity: source/options.cpp:270-485 (parse_arguments) — the same
single-letter getopt flags, validation rules, and mandatory-argument checks,
so existing Arriba invocations (e.g. run_arriba.sh) work unchanged.
"""

from __future__ import annotations

import getopt
import os
import sys
from typing import List

from .config import Options
from .constants import (STRANDEDNESS_AUTO, STRANDEDNESS_NO,
                        STRANDEDNESS_REVERSE, STRANDEDNESS_YES)
from .io.gtf import parse_gtf_features

VALID_ARGUMENTS = "c:x:d:g:G:o:O:t:p:a:b:k:s:i:v:f:E:S:m:L:H:D:R:A:M:K:V:F:U:Q:e:T:C:l:z:Z:@:uXIh"

USAGE = """Arriba-TPU: TPU-native gene fusion detection (capability-compatible with Arriba)

Usage: arriba_tpu -x rna.bam -g annotation.gtf -a assembly.fa -o fusions.tsv \\
                  [-b blacklist.tsv] [-k known_fusions.tsv] [-t tags.tsv] \\
                  [-p protein_domains.gff3] [-d structural_variants.tsv] \\
                  [-O fusions.discarded.tsv] [OPTIONS]

Mandatory:
  -x FILE      main alignment file (SAM/BAM/CRAM, sorted or unsorted, file
               or pipe); chimeric reads as supplementary alignments
               (--chimOutType WithinBAM) unless -c is given
  -g FILE      gene annotation in GTF format (gzip accepted)
  -a FILE      assembly in FASTA format (gzip accepted)
  -o FILE      output file for predicted fusions (fusions.tsv)
  -b FILE      blacklist of recurrent artifacts/benign transcripts
               (omit only together with '-f blacklist')

Input options:
  -c FILE      separate chimeric alignments file (old STAR
               'Chimeric.out.sam' mode; deprecated upstream)
  -d FILE      WGS structural-variant calls (4-column TSV or VCF) used by
               the genomic-support confidence logic
  -k FILE      known/recurrent fusions: relaxed evidence thresholds
  -t FILE      tag file: matching fusions are labeled in the 'tags' column
  -p FILE      protein domain annotation (GFF3) for the
               retained_protein_domains column
  -G STRING    GTF feature/attribute aliases (default: gene_name=gene_name|
               gene_id gene_id=gene_id transcript_id=transcript_id
               feature_exon=exon feature_CDS=CDS)
  -i CONTIGS   interesting contigs (space-separated, '*' wildcards;
               default: 1 2 ... X Y AC_* NC_*)
  -v CONTIGS   viral contigs (default: AC_* NC_*)
  -s STRAND    strandedness: auto/yes/no/reverse (default: auto)
  -u           reads are already duplicate-marked (BAM_FDUP); disable the
               internal coordinate-based duplicate marking
  -@ N         worker threads: shards the native extraction scan and the
               parallel cascade stages by read-name hash (output is
               byte-identical at any thread count; default: 1)

Output options:
  -O FILE      discarded fusions output (fusions.discarded.tsv)
  -I           fill gaps in assembled fusion transcripts from the assembly
               (uppercase = supported by reads, lowercase = filled)
  -X           also fill the fusion_transcript/peptide_sequence/
               read_identifiers columns of the discarded-fusions file
               (left empty by default to reduce runtime and file size)

Filtering & scoring options:
  -f FILTERS   disable the given filters (space-separated registry names)
  -E FLOAT     e-value cutoff for filter relative_support (default: 0.3)
  -S N         min supporting reads for filter min_support (default: 2)
  -m FLOAT     max fraction of mis-mapping supporting reads before filter
               mismappers discards an event (default: 0.8)
  -L FLOAT     max gene-identity fraction before filter homologs
               (default: 0.3)
  -H N         homopolymer length for filter homopolymer (default: 6)
  -D DIST      max distance between a breakpoint and a -d genomic call to
               count as genomic support (default: 100000)
  -R N         min distance from the gene boundary for read-through
               events (filter marginal_read_through; default: 10000)
  -A N         min anchor length for filter short_anchor (default: 23)
  -M N         min spliced breakpoints for the many_spliced recovery
               (default: 4)
  -K FLOAT     max recurrent k-mer content for filter low_entropy
               (default: 0.6)
  -V FLOAT     max mismatch p-value for filter mismatches (default: 0.01)
  -F N         fragment length for single-end data (default: 200)
  -U N         subsample events with more supporting reads than this
               (default: 300)
  -Q FLOAT     expression quantile above which a gene counts as highly
               expressed (filter in_vitro; default: 0.998)
  -e FLOAT     max exonic fraction for intragenic events (filter
               intragenic_exonic; default: 0.33)
  -T N         report viral integration only for the top N most expressed
               viral contigs (default: 5)
  -C FLOAT     min transcribed fraction of a viral contig (filter
               low_coverage_viral_contigs; default: 0.05)
  -l N         max internal-tandem-duplication length (default: 100)
  -z FLOAT     min ITD supporting-read allele fraction (default: 0.07)
  -Z N         min ITD supporting reads (default: 10)

  -h           print this help and exit

Every flag matches the reference arriba binary's semantics; outputs are
byte-identical on the same inputs (see PARITY.md).
"""


def crash(condition: bool, message: str) -> None:
    if condition:
        print(f"ERROR: {message}", file=sys.stderr)
        sys.exit(1)


def _check_readable(path: str) -> None:
    crash(not os.access(path, os.R_OK), f"file not found/readable: {path}")


def _parse_int(value: str, flag: str, minimum: int = None, maximum: int = None) -> int:
    try:
        result = int(value)
    except ValueError:
        crash(True, f"invalid argument to -{flag}")
    crash(minimum is not None and result < minimum, f"invalid argument to -{flag}")
    crash(maximum is not None and result > maximum, f"invalid argument to -{flag}")
    return result


def _parse_float(value: str, flag: str, minimum: float = None,
                 maximum: float = None) -> float:
    try:
        result = float(value)
    except ValueError:
        crash(True, f"invalid argument to -{flag}")
    crash(minimum is not None and result < minimum, f"invalid argument to -{flag}")
    crash(maximum is not None and result > maximum, f"invalid argument to -{flag}")
    return result


def parse_arguments(argv: List[str]) -> Options:
    options = Options()

    crash(len(argv) > 0 and (not argv[0] or argv[0][0] != "-"),
          "cannot interpret the first argument: " + (argv[0] if argv else ""))

    try:
        opts, extra = getopt.getopt(argv, VALID_ARGUMENTS)
    except getopt.GetoptError as error:
        crash(True, str(error))

    seen = set()
    for flag, value in opts:
        flag = flag[1]
        crash(flag in seen, f"option -{flag} specified too often")
        seen.add(flag)

        if flag == "c":
            options.chimeric_bam_file = value
            _check_readable(value)
            if value.endswith(".junction"):
                print("WARNING: it seems you passed the chimeric junction file "
                      "('Chimeric.out.junction') to the parameter -c, but this "
                      "parameter takes the chimeric alignments file "
                      "('Chimeric.out.sam') as input", file=sys.stderr)
        elif flag == "x":
            options.rna_bam_file = value
            _check_readable(value)
        elif flag == "d":
            options.genomic_breakpoints_file = value
            _check_readable(value)
        elif flag == "g":
            options.gene_annotation_file = value
            _check_readable(value)
        elif flag == "G":
            options.gtf_features = value
            try:
                parse_gtf_features(value)
            except Exception:
                crash(True, f"malformed GTF features: {value}")
        elif flag == "o":
            options.output_file = value
            parent = os.path.dirname(value) or "."
            crash(not os.path.isdir(parent),
                  f"parent directory of output file '{value}' does not exist")
        elif flag == "O":
            options.discarded_output_file = value
            parent = os.path.dirname(value) or "."
            crash(not os.path.isdir(parent),
                  f"parent directory of output file '{value}' does not exist")
        elif flag == "t":
            options.tags_file = value
            _check_readable(value)
        elif flag == "p":
            options.protein_domains_file = value
            _check_readable(value)
        elif flag == "a":
            options.assembly_file = value
            _check_readable(value)
        elif flag == "b":
            options.blacklist_file = value
            _check_readable(value)
        elif flag == "k":
            options.known_fusions_file = value
            _check_readable(value)
        elif flag == "s":
            strandedness = {"auto": STRANDEDNESS_AUTO, "yes": STRANDEDNESS_YES,
                            "no": STRANDEDNESS_NO, "reverse": STRANDEDNESS_REVERSE}
            crash(value not in strandedness, f"invalid type of strandedness: {value}")
            options.strandedness = strandedness[value]
        elif flag == "i":
            options.interesting_contigs = value.replace(",", " ")
        elif flag == "v":
            options.viral_contigs = value.replace(",", " ")
        elif flag == "f":
            for disabled_filter in value.replace(",", " ").split():
                crash(disabled_filter not in options.filters,
                      f"invalid argument to option -f: {disabled_filter}")
                options.filters[disabled_filter] = False
        elif flag == "E":
            options.evalue_cutoff = _parse_float(value, flag, 0)
        elif flag == "S":
            options.min_support = _parse_int(value, flag, 0)
        elif flag == "m":
            options.max_mismapper_fraction = _parse_float(value, flag, 0, 1)
        elif flag == "L":
            options.max_homolog_identity = _parse_float(value, flag, 0, 1)
        elif flag == "H":
            options.homopolymer_length = _parse_int(value, flag, 2)
        elif flag == "D":
            options.max_genomic_breakpoint_distance = _parse_int(value, flag, 0)
        elif flag == "R":
            options.min_read_through_distance = _parse_int(value, flag, 0)
        elif flag == "A":
            options.min_anchor_length = _parse_int(value, flag, 0)
        elif flag == "M":
            options.min_spliced_events = _parse_int(value, flag, 0)
        elif flag == "K":
            options.max_kmer_content = _parse_float(value, flag, 0, 1)
        elif flag == "V":
            options.mismatch_pvalue_cutoff = _parse_float(value, flag, 0, 1)
        elif flag == "F":
            options.fragment_length = _parse_int(value, flag, 1)
        elif flag == "U":
            options.subsampling_threshold = _parse_int(value, flag, 1, 32767)
        elif flag == "Q":
            options.high_expression_quantile = _parse_float(value, flag, 0, 1)
        elif flag == "e":
            options.exonic_fraction = _parse_float(value, flag, 0, 1)
        elif flag == "T":
            options.top_viral_contigs = _parse_int(value, flag, 1)
        elif flag == "C":
            options.viral_contig_min_covered_fraction = _parse_float(value, flag, 0, 1)
        elif flag == "l":
            options.max_itd_length = _parse_int(value, flag, 1)
        elif flag == "z":
            options.min_itd_allele_fraction = _parse_float(value, flag, 0, 1)
        elif flag == "Z":
            options.min_itd_support = _parse_int(value, flag, 1)
        elif flag == "@":
            options.threads = _parse_int(value, flag, 1)
        elif flag == "u":
            options.external_duplicate_marking = True
        elif flag == "X":
            options.print_extra_info_for_discarded_fusions = True
        elif flag == "I":
            options.fill_sequence_gaps = True
        elif flag == "h":
            print(USAGE)
            sys.exit(0)

    if not argv:
        print(USAGE)
        crash(True, "no arguments given")
    crash(not options.rna_bam_file, "missing mandatory option -x")
    crash(not options.gene_annotation_file, "missing mandatory option -g")
    crash(not options.output_file, "missing mandatory option -o")
    crash(not options.assembly_file, "missing mandatory option -a")
    crash(options.filters["blacklist"] and not options.blacklist_file,
          "filter 'blacklist' enabled, but missing option -b "
          "(use '-f blacklist' if you want to disable the blacklist)")

    return options


def main(argv: List[str] = None) -> int:
    import resource
    import time

    from . import pipeline, trace

    # one root span a call while the stage log is on (trace.py)
    with trace.sample(pipeline._STAGE_TIMES):
        log = pipeline.log
        start_time = time.time()
        log("Launching Arriba-TPU")
        options = parse_arguments(sys.argv[1:] if argv is None else argv)
        try:
            pipeline.run(options)
        except RuntimeError as error:
            # crash() semantics of the reference (common.hpp:330)
            print(f"ERROR: {error}", file=sys.stderr)
            return 1
        log("Freeing resources")
        elapsed = time.time() - start_time
        usage = resource.getrusage(resource.RUSAGE_SELF)
        cpu = usage.ru_utime + usage.ru_stime
        peak_gb = usage.ru_maxrss / (1024.0 * 1024)

        def hhmmss(seconds: float) -> str:
            seconds = int(seconds)
            return (f"{seconds // 3600}:{seconds % 3600 // 60:02}:"
                    f"{seconds % 60:02}")

        log(f"Done (elapsed time={hhmmss(elapsed)}, CPU time={hhmmss(cpu)}, "
            f"peak memory={peak_gb:.3g}gb)")
        return 0
