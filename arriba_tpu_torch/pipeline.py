"""The pipeline orchestrator: load inputs, run the cascade, write outputs.

Reference parity: source/arriba.cpp:79-631 (main). Stages run in the exact
reference order with the same ordering constraints (multimappers before
e-value, e-value after merge_adjacent, blacklist after select_best,
homologs/mismappers near the end, genomic_support undoing heuristics,
isoforms last). Stage logs print `[time] Stage (metric=value)` like the
reference.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import trace
from .annotation.index import IntervalIndex, combine_annotations
from .annotation.queries import annotate_alignments, compute_exonic_lengths
from .annotation.tables import Annotation
from .config import Options
from .constants import (FORWARD, MATE1, SPLIT_READ,
                        STRANDEDNESS_AUTO, STRANDEDNESS_NO,
                        STRANDEDNESS_REVERSE, STRANDEDNESS_YES, SUPPLEMENTARY)
from .contigs import ContigRegistry
from .filters import read_level
from .filters.blacklist import filter_blacklisted_ranges, recover_known_fusions
from .filters.event_level import (filter_both_intronic, filter_end_to_end_fusions,
                                  filter_intragenic_both_exonic,
                                  filter_marginal_read_through, filter_min_support,
                                  filter_no_coverage, filter_non_coding_neighbors,
                                  filter_relative_support, filter_short_anchor,
                                  estimate_expected_fusions, merge_adjacent_fusions,
                                  recover_internal_tandem_duplication,
                                  recover_isoforms, recover_many_spliced,
                                  select_most_supported_breakpoints)
from .filters.genomic_support import (assign_confidence, filter_no_genomic_support,
                                      mark_genomic_support, recover_genomic_support)
from .filters.homologs import filter_homologs
from .filters.in_vitro import filter_in_vitro, recover_both_spliced
from .filters.mismappers import filter_mismappers, make_kmer_index
from .filters.multimappers import filter_multimappers
from .fusion import Fusions
from .fusions_finder import find_fusions
from .ingest.chimeric import (assign_strands_from_strandedness,
                              read_chimeric_alignments)
from .ingest.stats import (Coverage, detect_strandedness,
                           estimate_fragment_length)
from .io.fasta import load_assembly
from .io.gtf import read_annotation_gtf
from .model import ChimericAlignments, mark_multimappers, sort_chimeric_alignments
from .output.protein import ProteinDomains, load_protein_domains
from .output.tags import Tags, load_tags
from .output.writer import write_fusions_to_file

KMER_LENGTH = 8  # arriba.cpp:549


def _time_string() -> str:
    return time.strftime("[%Y-%m-%dT%H:%M:%S]")


# the stage log and the tracer's switch (trace.py; cli.main reads it)
_STAGE_TIMES = os.environ.get("ARRIBA_TPU_TORCH_STAGE_TIMES", "") not in ("", "0")


def log(message: str, end: str = "\n") -> None:
    if _STAGE_TIMES:
        # each line opens a stage span and closes the one before it
        since = trace.stage(message)
        if since is not None:
            print(f"[stage +{since:7.3f}s]", file=sys.stderr, flush=True)
        print(f"[stage] {message}", file=sys.stderr, flush=True)
    print(f"{_time_string()} {message}", end=end, flush=True)


@dataclass
class PipelineState:
    """Everything main() holds in locals, for tests and downstream tools."""

    options: Options
    contigs: ContigRegistry = field(default_factory=ContigRegistry)
    assembly: dict = field(default_factory=dict)
    annotation: Optional[Annotation] = None
    gene_index: Optional[IntervalIndex] = None
    exon_index: Optional[IntervalIndex] = None
    chimeric_alignments: ChimericAlignments = field(default_factory=dict)
    fusions: Fusions = field(default_factory=dict)
    coverage: Coverage = field(default_factory=Coverage)
    mapped_reads: int = 0
    mapped_viral_reads_by_contig: List[int] = field(default_factory=list)
    viral_contigs: List[bool] = field(default_factory=list)
    interesting_contigs: List[bool] = field(default_factory=list)
    max_mate_gap: int = 0
    read_length_mean: float = 0.0
    tags: Tags = field(default_factory=dict)
    protein_domains: Optional[ProteinDomains] = None


def run(options: Options) -> PipelineState:
    """arriba.cpp:79-612 — the full pipeline."""
    from .device import check
    check()  # a requested device that is missing fails before any work
    state = PipelineState(options=options)
    enabled = options.filters

    # load assembly (arriba.cpp:91-98)
    if not enabled["uninteresting_contigs"]:
        options.interesting_contigs = "*"
    log(f"Loading assembly from '{options.assembly_file}' ")
    state.assembly = load_assembly(options.assembly_file, state.contigs,
                                   options.interesting_contigs)

    # load GTF (arriba.cpp:100-107)
    log(f"Loading annotation from '{options.gene_annotation_file}' ")
    state.annotation = read_annotation_gtf(options.gene_annotation_file,
                                           options.gtf_features, state.contigs,
                                           state.assembly)
    annotation = state.annotation
    genes = annotation.genes
    exons = annotation.exons

    state.exon_index = IntervalIndex(exons.contig, exons.start, exons.end,
                                     len(state.contigs))
    state.gene_index = IntervalIndex(genes.contig, genes.start, genes.end,
                                     len(state.contigs))

    # load chimeric alignments (arriba.cpp:117-130)
    ca = state.chimeric_alignments
    if options.chimeric_bam_file:
        log(f"Reading chimeric alignments from '{options.chimeric_bam_file}' ", end="")
        total, mapped = read_chimeric_alignments(
            options.chimeric_bam_file, state.assembly, ca, state.contigs,
            options.interesting_contigs, options.viral_contigs, genes,
            state.gene_index, state.coverage, state.mapped_viral_reads_by_contig,
            True, False, options.external_duplicate_marking, options.max_itd_length,
            options.threads)
        state.mapped_reads += mapped
        print(f"(total={total})")
    log(f"Reading chimeric alignments from '{options.rna_bam_file}' ", end="")
    total, mapped = read_chimeric_alignments(
        options.rna_bam_file, state.assembly, ca, state.contigs,
        options.interesting_contigs, options.viral_contigs, genes,
        state.gene_index, state.coverage, state.mapped_viral_reads_by_contig,
        bool(options.chimeric_bam_file), True, options.external_duplicate_marking,
        options.max_itd_length, options.threads, retain_native=True)
    state.mapped_reads += mapped
    retained = not isinstance(total, int)
    if retained:
        # native retained mode: the fragments live in the extraction store
        # (sorted, multimappers marked); `ca` is a lazy name->Fragment view
        state.chimeric_alignments = ca = total
        total = len(ca)
    print(f"(total={total})")

    if not retained:
        # restore ordered-map iteration order
        state.chimeric_alignments = ca = sort_chimeric_alignments(ca)

    # contig lookup tables (arriba.cpp:132-139)
    state.viral_contigs = state.contigs.interesting_mask(options.viral_contigs)
    state.interesting_contigs = state.contigs.interesting_mask(options.interesting_contigs)

    log("Marking multi-mapping alignments ", end="")
    if retained:
        print(f"(marked={ca.multimapper_count})")
    else:
        print(f"(marked={mark_multimappers(ca)})")

    # BAM files may add contigs unknown to the GTF; the indices already cover
    # all contigs because they were built with len(contigs) after registration
    if state.exon_index.n_contigs < len(state.contigs):
        state.exon_index = IntervalIndex(exons.contig, exons.start, exons.end,
                                         len(state.contigs))
        state.gene_index = IntervalIndex(genes.contig, genes.start, genes.end,
                                         len(state.contigs))

    if retained:
        # bind the annotation engine + gene index for the native chain
        from .annotation.native_annotate import (bind_annotation_engine,
                                                 bind_gene_index)
        bind_annotation_engine(ca.native, state.exon_index, exons, genes)
        bind_gene_index(ca.native, state.gene_index, genes)

    # strandedness (arriba.cpp:146-160)
    strandedness = options.strandedness
    if strandedness == STRANDEDNESS_AUTO:
        log("Detecting strandedness ", end="")
        if retained:
            strandedness = ca.native.detect_strandedness_native()
        else:
            strandedness = detect_strandedness(ca, genes, exons,
                                               state.gene_index,
                                               state.exon_index)
        print({STRANDEDNESS_YES: "(yes)", STRANDEDNESS_REVERSE: "(reverse)"}
              .get(strandedness, "(no)"))
    if strandedness != STRANDEDNESS_NO:
        log("Assigning strands to alignments ")
        if retained:
            ca.native.assign_strands_native(int(strandedness))
        else:
            assign_strands_from_strandedness(ca, strandedness)

    log("Annotating alignments ")
    # exonic lengths (arriba.cpp:166-184)
    compute_exonic_lengths(genes, exons, state.exon_index)

    # annotate with exons (arriba.cpp:186-188); bulk native path when built
    from .annotation.native_annotate import annotate_all_native
    if retained:
        pass  # the native chain annotates in place below
    elif not annotate_all_native(ca, exons, genes, state.exon_index):
        for mates in ca.values():
            annotate_alignments(mates, exons, genes, state.exon_index)

    if retained:
        # native annotation chain: exon annotation + gene fallback + dummy
        # ranges (phase 1), then append the dummies to the Python gene table,
        # re-index/re-bind, and re-annotate + disambiguate (phase 2)
        from .annotation.native_annotate import (bind_annotation_engine,
                                                 bind_gene_index)
        dummy_contig_b, dummy_start_b, dummy_end_b = \
            ca.native.annotate_store_phase1(options.threads)
        if len(dummy_contig_b) > 0:
            genes.append_dummies(np.frombuffer(dummy_contig_b, np.int64),
                                 np.frombuffer(dummy_start_b, np.int64),
                                 np.frombuffer(dummy_end_b, np.int64))
        state.gene_index = IntervalIndex(genes.contig, genes.start, genes.end,
                                         len(state.contigs))
        gene_index = state.gene_index
        bind_annotation_engine(ca.native, state.exon_index, exons, genes)
        bind_gene_index(ca.native, gene_index, genes)
        ca.native.annotate_store_phase2()
        return _run_cascades(state, options, enabled, ca, annotation, genes,
                             exons, gene_index)

    # fall back to gene-level annotation (arriba.cpp:190-205); under device
    # offload, a batched emptiness triage (ops/annotation.py) skips the
    # host range_query for every mate with no gene within the 2 bp slack
    from .device import offload_enabled
    gene_triage = None
    pending = [mate for mates in ca.values() for mate in mates
               if len(mate.genes) == 0]
    if pending and offload_enabled():
        from .ops.annotation import interval_overlap_triage
        hits = interval_overlap_triage(
            [(mate.contig, mate.start, mate.end) for mate in pending],
            genes.contig, genes.start, genes.end, len(state.contigs))
        gene_triage = {id(mate): bool(hit)
                       for mate, hit in zip(pending, hits)}
    for mates in ca.values():
        for mate in mates:
            if len(mate.genes) == 0:
                if gene_triage is not None and not gene_triage[id(mate)]:
                    continue  # device-triaged: the range query is empty
                mate.genes = state.gene_index.range_query(mate.contig, mate.start,
                                                          mate.end)
        if len(mates) == 3:
            combined = combine_annotations(mates[SPLIT_READ].genes, mates[MATE1].genes)
            if len(mates[MATE1].genes) == 0 or len(combined) < len(mates[MATE1].genes):
                mates[MATE1].genes = combined
            if len(mates[SPLIT_READ].genes) == 0 or len(combined) < len(mates[SPLIT_READ].genes):
                mates[SPLIT_READ].genes = combined

    # dummy genes for intergenic alignments (arriba.cpp:207-260)
    unmapped_alignments: List[tuple] = []
    for mates in ca.values():
        if len(mates) == 3:
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            if len(split.genes) == 0:
                pos = split.start if split.strand == FORWARD else split.end
                unmapped_alignments.append((split.contig, pos))
            if len(supp.genes) == 0:
                pos = supp.end if supp.strand == FORWARD else supp.start
                unmapped_alignments.append((supp.contig, pos))
        else:
            for mate in mates:
                if len(mate.genes) == 0:
                    pos = mate.end if mate.strand == FORWARD else mate.start
                    unmapped_alignments.append((mate.contig, pos))
    if unmapped_alignments:
        unmapped_alignments.sort()  # (contig, position): annotation_record_t order
        first_contig, first_pos = unmapped_alignments[0]
        record_contig, record_start, record_end = first_contig, first_pos, first_pos

        def next_known_gene_boundary(contig: int, position: int) -> Optional[int]:
            bounds = state.gene_index.boundaries[contig] \
                if contig < state.gene_index.n_contigs else np.empty(0)
            idx = int(np.searchsorted(bounds, position, side="left"))
            return int(bounds[idx]) if idx < len(bounds) else None

        next_known_gene = next_known_gene_boundary(first_contig, first_pos)
        i = 1
        while True:
            at_end = i >= len(unmapped_alignments)
            if not at_end:
                contig, pos = unmapped_alignments[i]
            if (at_end or record_end + 10000 < pos
                    or (next_known_gene is not None and next_known_gene <= pos)
                    or contig != record_contig):
                genes.append_dummy(record_contig, record_start, record_end)
                if at_end:
                    break
                record_contig, record_start = contig, pos
                next_known_gene = next_known_gene_boundary(contig, pos)
            record_end = unmapped_alignments[i][1]
            i += 1

    # re-index genes incl. dummies, re-annotate unmapped (arriba.cpp:262-284)
    state.gene_index = IntervalIndex(genes.contig, genes.start, genes.end,
                                     len(state.contigs))
    gene_index = state.gene_index
    for mates in ca.values():
        if len(mates) == 3:
            split, supp = mates[SPLIT_READ], mates[SUPPLEMENTARY]
            if len(mates[MATE1].genes) == 0 or len(split.genes) == 0:
                breakpoint = split.start if split.strand == FORWARD else split.end
                split.genes = gene_index.point_query(split.contig, breakpoint)
                mates[MATE1].genes = split.genes
            if len(supp.genes) == 0:
                breakpoint = supp.end if supp.strand == FORWARD else supp.start
                supp.genes = gene_index.point_query(supp.contig, breakpoint)
        else:
            for mate in mates:
                if len(mate.genes) == 0:
                    breakpoint = mate.end if mate.strand == FORWARD else mate.start
                    mate.genes = gene_index.point_query(mate.contig, breakpoint)

    # disambiguate multiple dummy genes (arriba.cpp:286-319)
    for mates in ca.values():
        for mate in mates:
            if len(mate.genes) > 1 and genes.is_dummy[int(mate.genes[0])]:
                breakpoint = mate.start if mate.strand == FORWARD else mate.end
                encompassing = int(mates[MATE1].genes[0])
                for dummy_gene in mate.genes:
                    dummy_gene = int(dummy_gene)
                    if genes.start[dummy_gene] <= breakpoint <= genes.end[dummy_gene]:
                        encompassing = dummy_gene
                mate.genes = np.array([encompassing], np.int64)
        if len(mates) == 3:
            split = mates[SPLIT_READ]
            m1 = mates[MATE1]
            if (int(m1.genes[0]) != int(split.genes[0])
                    and genes.is_dummy[int(m1.genes[0])]
                    and genes.is_dummy[int(split.genes[0])]):
                breakpoint = split.start if split.strand == FORWARD else split.end
                encompassing = int(m1.genes[0])
                for dummy_gene in list(m1.genes) + list(split.genes):
                    dummy_gene = int(dummy_gene)
                    if genes.start[dummy_gene] <= breakpoint <= genes.end[dummy_gene]:
                        encompassing = dummy_gene
                m1.genes = np.array([encompassing], np.int64)
                split.genes = np.array([encompassing], np.int64)

    # gene ids are row indices already (arriba.cpp:321-325)
    return _run_cascades(state, options, enabled, ca, annotation, genes,
                         exons, gene_index)


def _run_cascades(state, options, enabled, ca, annotation, genes, exons,
                  gene_index):
    """Read-level cascade through output (arriba.cpp:327-612); shared by
    the retained-native and materialized paths."""
    # --- read-level cascade (arriba.cpp:327-409) -----------------------------
    # one facade: native (single bulk marshal, C++ stages) or Python per stage
    from .filters.native_cascade import ReadLevelCascade
    cascade = ReadLevelCascade(ca, state, options, genes, exons, state.exon_index)

    if enabled["duplicates"]:
        log("Filtering duplicates ", end="")
        print(f"(remaining={cascade.filter_duplicates()})")

    if enabled["uninteresting_contigs"]:
        log(f"Filtering mates which do not map to interesting contigs "
            f"({options.interesting_contigs}) ", end="")
        print(f"(remaining={cascade.filter_uninteresting_contigs()})")

    if enabled["viral_contigs"]:
        log(f"Filtering mates which only map to viral contigs ({options.viral_contigs}) ",
            end="")
        print(f"(remaining={cascade.filter_viral_contigs()})")

    if enabled["top_expressed_viral_contigs"]:
        log(f"Filtering viral contigs with expression lower than the top "
            f"{options.top_viral_contigs} ", end="")
        print(f"(remaining={cascade.filter_top_expressed_viral_contigs()})")

    if enabled["low_coverage_viral_contigs"]:
        log(f"Filtering viral contigs with less than "
            f"{options.viral_contig_min_covered_fraction * 100}% coverage ", end="")
        print(f"(remaining={cascade.filter_low_coverage_viral_contigs()})")

    log("Estimating fragment length ", end="")
    ok, mate_gap_mean, mate_gap_stddev, read_length_mean = \
        cascade.estimate_fragment_length()
    if ok:
        print(f"(mate gap mean={mate_gap_mean:g}, mate gap stddev={mate_gap_stddev:g}, "
              f"read length mean={read_length_mean:g})")
        state.max_mate_gap = max(0, int(mate_gap_mean + 3 * mate_gap_stddev))
        state.read_length_mean = read_length_mean
    else:
        print("(failed)")
        state.max_mate_gap = options.fragment_length
        state.read_length_mean = options.fragment_length

    if enabled["read_through"]:
        log(f"Filtering read-through fragments with a distance "
            f"<={options.min_read_through_distance}bp ", end="")
        print(f"(remaining={cascade.filter_proximal_read_through()})")

    if enabled["inconsistently_clipped"]:
        log("Filtering inconsistently clipped mates ", end="")
        print(f"(remaining={cascade.filter_inconsistently_clipped_mates()})")

    if enabled["homopolymer"]:
        log(f"Filtering breakpoints adjacent to homopolymers "
            f">={options.homopolymer_length}nt ", end="")
        print(f"(remaining={cascade.filter_homopolymer()})")

    if enabled["small_insert_size"]:
        log("Filtering fragments with small insert size ", end="")
        print(f"(remaining={cascade.filter_small_insert_size()})")

    if enabled["long_gap"]:
        log("Filtering alignments with long gaps ", end="")
        print(f"(remaining={cascade.filter_long_gap()})")

    if enabled["same_gene"]:
        log("Filtering fragments with both mates in the same gene ", end="")
        print(f"(remaining={cascade.filter_same_gene()})")

    if enabled["hairpin"]:
        log("Filtering fusions arising from hairpin structures ", end="")
        print(f"(remaining={cascade.filter_hairpin()})")

    if enabled["mismatches"]:
        log(f"Filtering reads with a mismatch p-value "
            f"<={options.mismatch_pvalue_cutoff} ", end="")
        print(f"(remaining={cascade.filter_mismatches()})")

    if enabled["low_entropy"]:
        log(f"Filtering reads with low entropy (k-mer content "
            f">={options.max_kmer_content * 100}%) ", end="")
        print(f"(remaining={cascade.filter_low_entropy()})")

    # --- candidate generation + event-level cascade (arriba.cpp:411-585) -----
    log("Finding fusions and counting supporting reads ", end="")
    fusions = state.fusions
    print(f"(total={cascade.find_fusions(fusions)})")

    # the event cascade runs natively over the columnar fusion table while it
    # can; the table materializes into Python Fusion objects before the first
    # stage without a native twin (see filters/native_cascade.EventCascade)
    from .filters.native_cascade import EventCascade
    events = EventCascade(cascade, fusions, state, options, annotation)

    if options.genomic_breakpoints_file:
        log(f"Marking fusions with support from whole-genome sequencing in "
            f"'{options.genomic_breakpoints_file}' ", end="")
        print(f"(marked={events.mark_genomic_support()})")

    if enabled["merge_adjacent"]:
        log("Merging adjacent fusion breakpoints ", end="")
        print(f"(remaining={events.merge_adjacent()})")

    if enabled["multimappers"]:
        log("Filtering multi-mapping fusions by alignment score and read support ",
            end="")
        print(f"(remaining={events.multimappers()})")

    log("Estimating expected number of fusions by random chance (e-value) ")
    events.estimate_expected_fusions()

    if enabled["non_coding_neighbors"]:
        log("Filtering fusions with both breakpoints in adjacent non-coding/"
            "intergenic regions ", end="")
        print(f"(remaining={events.non_coding_neighbors()})")

    if enabled["intragenic_exonic"]:
        log("Filtering intragenic fusions with both breakpoints in exonic regions ",
            end="")
        print(f"(remaining={events.intragenic_exonic()})")

    if enabled["min_support"]:
        log(f"Filtering fusions with <{options.min_support} supporting reads ", end="")
        print(f"(remaining={events.min_support()})")

    if enabled["relative_support"]:
        log(f"Filtering fusions with an e-value >={options.evalue_cutoff:g} ", end="")
        print(f"(remaining={events.relative_support()})")

    if enabled["internal_tandem_duplication"]:
        log(f"Searching for internal tandem duplications <={options.max_itd_length}bp "
            f"with >={options.min_itd_support} supporting reads and "
            f">={options.min_itd_allele_fraction * 100:g}% allele fraction ", end="")
        print(f"(remaining={events.recover_internal_tandem_duplication()})")

    if enabled["intronic"]:
        log("Filtering fusions with both breakpoints in intronic/intergenic regions ",
            end="")
        print(f"(remaining={events.both_intronic()})")

    if options.known_fusions_file and enabled["known_fusions"]:
        log(f"Searching for known fusions in '{options.known_fusions_file}' ", end="")
        print(f"(remaining={events.known_fusions()})")

    if enabled["in_vitro"]:
        log(f"Filtering in vitro-generated fusions between genes with an expression "
            f"above the {options.high_expression_quantile * 100:g}% quantile ", end="")
        print(f"(remaining={events.in_vitro()})")

    if enabled["spliced"]:
        log("Searching for fusions with spliced split reads ", end="")
        print(f"(remaining={events.recover_both_spliced()})")

    if enabled["select_best"]:
        log("Selecting best breakpoints from genes with multiple breakpoints ", end="")
        print(f"(remaining={events.select_best()})")

    if enabled["marginal_read_through"]:
        log("Filtering read-through fusions with breakpoints near the gene boundary ",
            end="")
        print(f"(remaining={events.marginal_read_through()})")

    if enabled["many_spliced"]:
        log(f"Searching for fusions with >={options.min_spliced_events} spliced events ",
            end="")
        print(f"(remaining={events.recover_many_spliced()})")

    if options.genomic_breakpoints_file and enabled["no_genomic_support"]:
        log("Assigning confidence scores to events ")
        events.assign_confidence()
        log("Filtering low-confidence events with no support from WGS ", end="")
        print(f"(remaining={events.no_genomic_support()})")

    if enabled["blacklist"] and options.blacklist_file:
        log(f"Filtering blacklisted fusions in '{options.blacklist_file}' ", end="")
        print(f"(remaining={events.blacklist()})")

    if enabled["short_anchor"]:
        log(f"Filtering fusions with anchors <={options.min_anchor_length}nt ", end="")
        print(f"(remaining={events.short_anchor()})")

    if enabled["end_to_end"]:
        log("Filtering end-to-end fusions with low support ", end="")
        print(f"(remaining={events.end_to_end()})")

    if enabled["no_coverage"]:
        log("Filtering fusions with no coverage around the breakpoints ", end="")
        print(f"(remaining={events.no_coverage()})")

    if enabled["homologs"] or enabled["mismappers"]:
        log("Indexing gene sequences ")
        events.make_kmer_index(
            int(state.max_mate_gap + 2 * state.read_length_mean), KMER_LENGTH)

    if enabled["homologs"]:
        log(f"Filtering genes with >={options.max_homolog_identity * 100:g}% identity ",
            end="")
        print(f"(remaining={events.homologs()})")

    if enabled["mismappers"]:
        log(f"Re-aligning chimeric reads to filter fusions with "
            f">={options.max_mismapper_fraction * 100:g}% mis-mappers ", end="")
        print(f"(remaining={events.mismappers()})")

    if options.genomic_breakpoints_file and enabled["genomic_support"]:
        log("Searching for fusions with support from WGS ", end="")
        print(f"(remaining={events.recover_genomic_support()})")

    if (options.genomic_breakpoints_file and enabled["genomic_support"]) \
            or enabled["many_spliced"]:
        if enabled["select_best"]:
            log("Selecting best breakpoints from genes with multiple breakpoints ",
                end="")
            print(f"(remaining={events.select_best()})")

    if enabled["isoforms"]:
        log("Searching for additional isoforms ", end="")
        print(f"(remaining={events.recover_isoforms()})")

    log("Assigning confidence scores to events ")
    events.assign_confidence()
    events.finish()

    if options.tags_file:
        log(f"Loading tags from '{options.tags_file}'")
        state.tags = load_tags(options.tags_file, state.contigs,
                               annotation.gene_names, genes)

    if options.protein_domains_file:
        log(f"Loading protein domains from '{options.protein_domains_file}'")
        state.protein_domains = load_protein_domains(options.protein_domains_file,
                                                     state.contigs, annotation,
                                                     len(state.contigs))

    log(f"Writing fusions to file '{options.output_file}' ")
    write_fusions_to_file(fusions, options.output_file, ca, state.coverage,
                          state.assembly, annotation, gene_index, state.exon_index,
                          state.contigs.original, state.tags, state.protein_domains,
                          state.max_mate_gap, options.max_itd_length, True,
                          options.fill_sequence_gaps, False,
                          threads=options.threads)

    if options.discarded_output_file:
        log(f"Writing discarded fusions to file '{options.discarded_output_file}'")
        with trace.span("writer.discarded"):
            if not events.write_discarded(options.discarded_output_file):
                write_fusions_to_file(
                    fusions, options.discarded_output_file, ca,
                    state.coverage, state.assembly, annotation, gene_index,
                    state.exon_index, state.contigs.original, state.tags,
                    state.protein_domains, state.max_mate_gap,
                    options.max_itd_length,
                    options.print_extra_info_for_discarded_fusions,
                    options.fill_sequence_gaps, True,
                    threads=options.threads)

    return state
