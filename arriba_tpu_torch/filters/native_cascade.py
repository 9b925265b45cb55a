"""Native dispatch for the read-level filter cascade (#1-14).

One marshal of the (annotated) fragments feeds native/cascade.cpp, which
runs the whole cascade and the mate-gap collection in C++; the pipeline
keeps its stage-by-stage logging by reading the per-stage `remaining=`
counters from here. The Python implementations in read_level.py remain the
parity reference, and run when there is no engine (_native_build.engine).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..constants import (FILTER_DUPLICATES, FILTER_HAIRPIN,
                         FILTER_HOMOPOLYMER, FILTER_INCONSISTENTLY_CLIPPED,
                         FILTER_LONG_GAP, FILTER_LOW_COVERAGE_VIRAL_CONTIGS,
                         FILTER_LOW_ENTROPY, FILTER_MISMATCHES,
                         FILTER_READ_THROUGH, FILTER_SAME_GENE,
                         FILTER_SMALL_INSERT_SIZE,
                         FILTER_TOP_EXPRESSED_VIRAL_CONTIGS,
                         FILTER_UNINTERESTING_CONTIGS, FILTER_VIRAL_CONTIGS,
                         FORWARD)
from ..constants import (FILTER_BLACKLIST, FILTER_END_TO_END,
                         FILTER_INTERNAL_TANDEM_DUPLICATION, FILTER_INTRONIC,
                         FILTER_INTRAGENIC_EXONIC, FILTER_IN_VITRO,
                         FILTER_ISOFORMS, FILTER_MARGINAL_READ_THROUGH,
                         FILTER_MERGE_ADJACENT, FILTER_MIN_SUPPORT,
                         FILTER_MULTIMAPPERS, FILTER_NON_CODING_NEIGHBORS,
                         FILTER_NO_COVERAGE, FILTER_NO_GENOMIC_SUPPORT,
                         FILTER_RELATIVE_SUPPORT, FILTER_SELECT_BEST,
                         FILTER_SHORT_ANCHOR, FILTER_HOMOLOGS,
                         FILTER_MISMAPPERS)
from .. import trace
from .._native_build import engine
from ..ingest.stats import fragment_length_stats
from . import read_level

_STAGES = ("duplicates", "uninteresting_contigs", "viral_contigs",
           "top_expressed_viral_contigs", "low_coverage_viral_contigs",
           "read_through", "inconsistently_clipped", "homopolymer",
           "small_insert_size", "long_gap", "same_gene", "hairpin",
           "mismatches", "low_entropy")
_STAGE_FILTER_IDS = (FILTER_DUPLICATES, FILTER_UNINTERESTING_CONTIGS,
                     FILTER_VIRAL_CONTIGS, FILTER_TOP_EXPRESSED_VIRAL_CONTIGS,
                     FILTER_LOW_COVERAGE_VIRAL_CONTIGS, FILTER_READ_THROUGH,
                     FILTER_INCONSISTENTLY_CLIPPED, FILTER_HOMOPOLYMER,
                     FILTER_SMALL_INSERT_SIZE, FILTER_LONG_GAP,
                     FILTER_SAME_GENE, FILTER_HAIRPIN, FILTER_MISMATCHES,
                     FILTER_LOW_ENTROPY)


class ReadLevelCascade:
    """Facade the pipeline drives stage-by-stage. When the native engine is
    available, the first stage accessor runs stages 1-5 + gap collection in
    one call (under the pipeline's first read-level stage line), and
    estimate_fragment_length() triggers stages 6-14; each accessor then just
    returns the precomputed counter. Otherwise every method delegates to the
    Python implementation."""

    def __init__(self, chimeric_alignments, state, options, genes, exons,
                 exon_index) -> None:
        self.ca = chimeric_alignments
        self.state = state
        self.options = options
        self.genes = genes
        self.exons = exons
        self.exon_index = exon_index
        self._engine = engine()
        self._begun = False
        self._counts = {}
        self._gaps: Optional[np.ndarray] = None
        self._fragments = None

    @property
    def _native(self):
        """The native engine, once stages 1-5 have run on it (at the first
        access); None for the Python implementations."""
        if not self._begun:
            self._begun = True
            if self._engine is not None:
                try:
                    self._begin()
                except Exception:
                    # fall back cleanly to the Python implementations
                    self._engine = None
        return self._engine

    # -- native driver ------------------------------------------------------

    def _enabled_mask(self) -> int:
        mask = 0
        for bit, name in enumerate(_STAGES):
            if self.options.filters[name]:
                mask |= 1 << bit
        return mask

    def _context_args(self):
        """The per-run context (contig masks, gene tables, assembly,
        coverage, params) shared by cascade_begin and
        cascade_begin_retained."""
        state = self.state
        options = self.options
        genes = self.genes
        n_contigs = len(state.interesting_contigs)
        interesting = bytes(bytearray(
            1 if state.interesting_contigs[i] else 0 for i in range(n_contigs)))
        viral = bytes(bytearray(
            1 if state.viral_contigs[i] else 0 for i in range(n_contigs)))
        mapped_viral = np.zeros(n_contigs, np.int64)
        for i, count in enumerate(state.mapped_viral_reads_by_contig[:n_contigs]):
            mapped_viral[i] = count
        assembly_list = [state.assembly.get(i) for i in range(n_contigs)]
        coverage_list = []
        for i in range(n_contigs):
            planes = state.coverage.coverage
            coverage_list.append(planes[i] if i < len(planes) and len(planes[i])
                                 else None)
        params = (1 if options.external_duplicate_marking else 0,
                  int(options.top_viral_contigs),
                  float(options.viral_contig_min_covered_fraction),
                  int(options.min_read_through_distance),
                  int(options.homopolymer_length),
                  self._enabled_mask())
        genes_start_b = np.ascontiguousarray(genes.start, np.int64).tobytes()
        genes_end_b = np.ascontiguousarray(genes.end, np.int64).tobytes()
        genes_dummy_b = np.ascontiguousarray(genes.is_dummy, np.uint8).tobytes()
        return (interesting, viral, mapped_viral.tobytes(), genes_start_b,
                genes_end_b, genes_dummy_b, assembly_list, coverage_list,
                params)

    def _begin(self) -> None:
        ca = self.ca
        state = self.state
        genes = self.genes

        # the annotation engine was bound before dummy genes were created;
        # re-bind so native splice tests cover every gene row (the cascade's
        # homopolymer filter and find_fusions index genes by row id)
        from ..annotation.native_annotate import bind_annotation_engine
        bind_annotation_engine(self._engine, self.exon_index, self.exons, genes)

        if getattr(ca, "is_lazy_native", False):
            # retained mode: the fragments already live in the native
            # extraction store — bind context only, no marshal
            with trace.span("read_cascade.begin"):
                counts_b, gaps_b, read_length_sum, read_length_count = \
                    self._engine.cascade_begin_retained(
                        *self._context_args(), _STAGE_FILTER_IDS)
            counts = np.frombuffer(counts_b, np.int64)
            for bit, name in enumerate(_STAGES[:5]):
                self._counts[name] = int(counts[bit])
            self._gaps = np.frombuffer(gaps_b or b"", np.int64)
            self._read_length_sum = read_length_sum
            self._read_length_count = read_length_count
            self._fragments = None
            return

        fragments = list(ca.values())
        self._fragments = fragments
        n_mates = sum(len(mates) for mates in fragments)

        frag_flags = np.zeros(len(fragments), np.int64)
        frag_filter = np.zeros(len(fragments), np.int64)
        for f, mates in enumerate(fragments):
            frag_flags[f] = ((1 if mates.single_end else 0)
                             | (2 if mates.duplicate else 0)
                             | (4 if mates.multimapper else 0))
            frag_filter[f] = mates.filter

        # sequences + post-dummy gene sets always marshal fresh; the
        # geometry/CIGAR/predicted-strand columns are identical to the ones
        # the annotation stage marshalled moments ago, so reuse them
        seq_offsets = np.zeros(n_mates + 1, np.int64)
        genes_offsets = np.zeros(n_mates + 1, np.int64)
        seq_parts = []
        gene_parts = []
        row = 0
        for mates in fragments:
            for mate in mates:
                seq_offsets[row + 1] = seq_offsets[row] + len(mate.sequence)
                genes_offsets[row + 1] = genes_offsets[row] + len(mate.genes)
                seq_parts.append(mate.sequence)
                gene_parts.append(np.ascontiguousarray(mate.genes, np.int64).tobytes())
                row += 1

        from ..annotation.native_annotate import consume_marshal_cache
        cache = consume_marshal_cache(fragments)
        if cache is not None:
            frag_offsets_b = cache["frag_offsets"]
            contig_b, start_b, end_b = cache["contig"], cache["start"], cache["end"]
            strand_b = cache["strand"]
            pred_strand_b, pred_ambig_b = cache["pred_strand"], cache["pred_ambig"]
            exonic_b = cache["exonic"]
            cigar_offsets_b, cigar_words_b = (cache["cigar_offsets"],
                                              cache["cigar_words"])
        else:
            frag_offsets = np.zeros(len(fragments) + 1, np.int64)
            contig = np.zeros(n_mates, np.int64)
            start = np.zeros(n_mates, np.int64)
            end = np.zeros(n_mates, np.int64)
            strand = np.zeros(n_mates, np.int64)
            pred_strand = np.zeros(n_mates, np.int64)
            pred_ambig = np.zeros(n_mates, np.int64)
            exonic = np.zeros(n_mates, np.int64)
            cigar_offsets = np.zeros(n_mates + 1, np.int64)
            cigar_parts = []
            row = 0
            for f, mates in enumerate(fragments):
                frag_offsets[f + 1] = frag_offsets[f] + len(mates)
                for mate in mates:
                    contig[row] = mate.contig
                    start[row] = mate.start
                    end[row] = mate.end
                    strand[row] = 1 if mate.strand == FORWARD else 0
                    pred_strand[row] = 1 if mate.predicted_strand == FORWARD else 0
                    pred_ambig[row] = 1 if mate.predicted_strand_ambiguous else 0
                    exonic[row] = 1 if mate.exonic else 0
                    cigar_offsets[row + 1] = cigar_offsets[row] + len(mate.cigar)
                    cigar_parts.append(mate.cigar.astype(np.uint32, copy=False).tobytes())
                    row += 1
            frag_offsets_b = frag_offsets.tobytes()
            contig_b, start_b, end_b = (contig.tobytes(), start.tobytes(),
                                        end.tobytes())
            strand_b = strand.tobytes()
            pred_strand_b, pred_ambig_b = pred_strand.tobytes(), pred_ambig.tobytes()
            exonic_b = exonic.tobytes()
            cigar_offsets_b = cigar_offsets.tobytes()
            cigar_words_b = b"".join(cigar_parts)

        options = self.options
        n_contigs = len(state.interesting_contigs)
        interesting = bytes(bytearray(
            1 if state.interesting_contigs[i] else 0 for i in range(n_contigs)))
        viral = bytes(bytearray(
            1 if state.viral_contigs[i] else 0 for i in range(n_contigs)))
        mapped_viral = np.zeros(n_contigs, np.int64)
        for i, count in enumerate(state.mapped_viral_reads_by_contig[:n_contigs]):
            mapped_viral[i] = count
        assembly_list = [state.assembly.get(i) for i in range(n_contigs)]
        coverage_list = []
        for i in range(n_contigs):
            planes = state.coverage.coverage
            coverage_list.append(planes[i] if i < len(planes) and len(planes[i])
                                 else None)

        params = (1 if options.external_duplicate_marking else 0,
                  int(options.top_viral_contigs),
                  float(options.viral_contig_min_covered_fraction),
                  int(options.min_read_through_distance),
                  int(options.homopolymer_length),
                  self._enabled_mask())

        with trace.span("read_cascade.begin"):
            counts_b, gaps_b, read_length_sum, read_length_count = \
                self._engine.cascade_begin(
                    frag_offsets_b, contig_b, start_b,
                    end_b, strand_b, pred_strand_b,
                    pred_ambig_b, exonic_b, cigar_offsets_b,
                    cigar_words_b, seq_offsets.tobytes(),
                    "".join(seq_parts).encode("latin-1"),
                    genes_offsets.tobytes(),
                    b"".join(gene_parts), frag_flags.tobytes(),
                    frag_filter.tobytes(), interesting, viral,
                    mapped_viral.tobytes(),
                    np.ascontiguousarray(genes.start, np.int64).tobytes(),
                    np.ascontiguousarray(genes.end, np.int64).tobytes(),
                    np.ascontiguousarray(genes.is_dummy, np.uint8).tobytes(),
                    assembly_list, coverage_list, params, _STAGE_FILTER_IDS)

        counts = np.frombuffer(counts_b, np.int64)
        for bit, name in enumerate(_STAGES[:5]):
            self._counts[name] = int(counts[bit])
        self._gaps = np.frombuffer(gaps_b or b"", np.int64)
        self._read_length_sum = read_length_sum
        self._read_length_count = read_length_count

    def _finish(self) -> None:
        state = self.state
        options = self.options
        genome_size = sum(
            len(state.assembly[c]) for c in range(len(state.interesting_contigs))
            if state.interesting_contigs[c] and c in state.assembly)
        from ..device import offload_enabled
        hybrid_device = (offload_enabled()
                         and self.options.filters["low_entropy"])
        with trace.span("read_cascade.finish"):
            counts_b, filters_b = self._native.cascade_finish(
                int(state.max_mate_gap), 0.01,
                float(options.mismatch_pvalue_cutoff), int(genome_size),
                float(options.max_kmer_content), 3,
                int(options.max_itd_length), 1 if hybrid_device else 0)
        counts = np.frombuffer(counts_b, np.int64)
        for bit, name in enumerate(_STAGES[5:]):
            self._counts[name] = int(counts[bit])
        if hybrid_device:
            self._counts["low_entropy"] = self._device_low_entropy()
        if self._fragments is not None:
            filters = np.frombuffer(filters_b, np.int64).tolist()
            for mates, filter_id in zip(self._fragments, filters):
                mates.filter = filter_id

    @trace.spanned("k2.offload")
    def _device_low_entropy(self) -> int:
        """Hybrid stage 13: the native engine exports the exact rows its
        scan would visit; the batched recurrence decides them on the device
        (ops/readfilters.low_entropy_batch_chunked, K2 on CUDA); verdicts
        apply back into the native store. A device error raises."""
        from ..ops.readfilters import low_entropy_batch_chunked
        from .mismappers import KMER_BASE_LUT

        options = self.options
        rows_b, offsets_b, seq_blob, windows_b = \
            self._native.cascade_low_entropy_rows(3, int(options.max_itd_length))
        frag_rows = np.frombuffer(rows_b or b"", np.int64)
        if len(frag_rows) == 0:
            return self._native.cascade_set_filters(b"", 13)
        seq_offsets = np.frombuffer(offsets_b, np.int64)
        windows = np.frombuffer(windows_b, np.int32).reshape(-1, 4)
        lengths = np.diff(seq_offsets).astype(np.int32)
        n = len(frag_rows)
        L = int(lengths.max())
        codes = np.full((n, L), 3, np.uint8)
        all_codes = KMER_BASE_LUT[np.frombuffer(seq_blob, np.uint8)]
        # row-major boolean assignment == concatenated-sequence order
        cols = np.arange(L, dtype=np.int32)[None, :]
        codes[cols < lengths[:, None]] = all_codes
        flags = low_entropy_batch_chunked(
            codes, lengths,
            np.ascontiguousarray(windows[:, 0]),
            np.ascontiguousarray(windows[:, 1]),
            np.ascontiguousarray(windows[:, 2]),
            np.ascontiguousarray(windows[:, 3]),
            float(options.max_kmer_content))
        hit_rows = np.ascontiguousarray(frag_rows[np.asarray(flags, bool)])
        return self._native.cascade_set_filters(hit_rows.tobytes(), 13)

    # -- stage accessors (pipeline call order) ------------------------------

    def filter_duplicates(self):
        if self._native:
            return self._counts["duplicates"]
        return read_level.filter_duplicates(
            self.ca, self.options.external_duplicate_marking)

    def filter_uninteresting_contigs(self):
        if self._native:
            return self._counts["uninteresting_contigs"]
        return read_level.filter_uninteresting_contigs(
            self.ca, self.state.interesting_contigs)

    def filter_viral_contigs(self):
        if self._native:
            return self._counts["viral_contigs"]
        return read_level.filter_viral_contigs(self.ca, self.state.viral_contigs)

    def filter_top_expressed_viral_contigs(self):
        if self._native:
            return self._counts["top_expressed_viral_contigs"]
        return read_level.filter_top_expressed_viral_contigs(
            self.ca, self.options.top_viral_contigs, self.state.viral_contigs,
            self.state.interesting_contigs,
            self.state.mapped_viral_reads_by_contig, self.state.assembly,
            self.genes)

    def filter_low_coverage_viral_contigs(self):
        if self._native:
            return self._counts["low_coverage_viral_contigs"]
        return read_level.filter_low_coverage_viral_contigs(
            self.ca, self.state.coverage, self.state.viral_contigs,
            self.options.viral_contig_min_covered_fraction, 100)

    def estimate_fragment_length(self):
        if self._native:
            result = fragment_length_stats(self._gaps, self._read_length_sum,
                                           self._read_length_count)
            self._finish()  # stages 6-14 (hairpin does not need max_mate_gap)
            return result
        from ..ingest.stats import estimate_fragment_length
        return estimate_fragment_length(self.ca, self.genes, self.exons,
                                        self.exon_index)

    def filter_proximal_read_through(self):
        if self._native:
            return self._counts["read_through"]
        return read_level.filter_proximal_read_through(
            self.ca, self.genes, self.options.min_read_through_distance)

    def filter_inconsistently_clipped_mates(self):
        if self._native:
            return self._counts["inconsistently_clipped"]
        return read_level.filter_inconsistently_clipped_mates(self.ca)

    def filter_homopolymer(self):
        if self._native:
            return self._counts["homopolymer"]
        return read_level.filter_homopolymer(
            self.ca, self.options.homopolymer_length, self.genes, self.exons,
            self.exon_index)

    def filter_small_insert_size(self):
        if self._native:
            return self._counts["small_insert_size"]
        return read_level.filter_small_insert_size(self.ca, 5)

    def filter_long_gap(self):
        if self._native:
            return self._counts["long_gap"]
        return read_level.filter_long_gap(self.ca)

    def filter_same_gene(self):
        if self._native:
            return self._counts["same_gene"]
        return read_level.filter_same_gene(self.ca)

    def filter_hairpin(self):
        if self._native:
            return self._counts["hairpin"]
        return read_level.filter_hairpin(self.ca, self.state.max_mate_gap)

    def filter_mismatches(self):
        if self._native:
            return self._counts["mismatches"]
        return read_level.filter_mismatches(
            self.ca, self.state.assembly, self.state.interesting_contigs,
            self.state.viral_contigs, 0.01, self.options.mismatch_pvalue_cutoff)

    def filter_low_entropy(self):
        if self._native:
            return self._counts["low_entropy"]
        return read_level.filter_low_entropy(self.ca, 3,
                                             self.options.max_kmer_content,
                                             self.options.max_itd_length)

    # -- candidate generation (fusions.cpp:203-473) -------------------------

    def find_fusions(self, fusions):
        from ..fusions_finder import find_fusions
        if not self._native:
            return find_fusions(self.ca, fusions, self.genes, self.exons,
                                self.exon_index, self.state.max_mate_gap,
                                self.options.subsampling_threshold)
        import sys
        swapped_b, subsampled, remaining = self._native.find_fusions_native(
            int(self.state.max_mate_gap),
            int(self.options.subsampling_threshold), 1)
        # pass-2 canonicalization: MATE1 = lower coordinate (mirrors the
        # in-place swap the Python implementation performs); in retained mode
        # the native store swapped its own mates and the lazy export already
        # reflects it
        if self._fragments is not None:
            for index in np.frombuffer(swapped_b or b"", np.int64).tolist():
                mates = self._fragments[index]
                mates[0], mates[1] = mates[1], mates[0]
        if subsampled:
            print(f"WARNING: some fusions were subsampled, because they have "
                  f"more than {self.options.subsampling_threshold} supporting "
                  f"reads", file=sys.stderr)
        return remaining

    def materialize_fusions(self, fusions, passing_only: bool = False,
                            release: bool = True) -> None:
        """One-time materialization of the native fusion table into Python
        Fusion objects (event_export), syncing per-fragment filter ids that
        event stages may have updated. Releases both native stores unless the
        native discarded-fusions writer still needs them (release=False);
        passing_only skips Fusion objects for filtered rows when the
        discarded file is written natively (or not at all)."""
        from ..fusion import Fusion

        (columns_b, evalue_b, confidence_b, closest_b, offsets_b, items_b,
         frag_filters_b) = self._native.event_export(passing_only)
        if release:
            if getattr(self.ca, "is_lazy_native", False):
                # the lazy view resolves per-fragment state from the native
                # stores — capture it before they go away
                self.ca.ensure_materialized()
            self._native.event_release()
        columns = np.frombuffer(columns_b or b"", np.int64).reshape(-1, 17)
        n = len(columns)
        evalues = np.frombuffer(evalue_b or b"", np.float32).tolist()
        confidences = np.frombuffer(confidence_b or b"", np.int64).tolist()
        closest = np.frombuffer(closest_b or b"", np.int64).reshape(-1, 2).tolist()
        offsets = np.frombuffer(offsets_b or b"", np.int64).tolist()
        # the item stream stays a numpy view: only kept rows' slices are
        # converted (the full stream is O(total read references) — seconds
        # of tolist() on deep samples; see also event_export passing_only)
        items = np.frombuffer(items_b or b"", np.int64)
        names = list(self.ca.keys())

        if self._fragments is not None:
            for mates, filter_id in zip(
                    self._fragments,
                    np.frombuffer(frag_filters_b or b"", np.int64).tolist()):
                mates.filter = filter_id

        off1 = offsets[:n + 1]
        off2 = offsets[n + 1:2 * (n + 1)]
        off3 = offsets[2 * (n + 1):]
        if passing_only:
            keep = np.nonzero(columns[:, 8] == 0)[0].tolist()
            rows = [(int(i), columns[i].tolist()) for i in keep]
        else:
            rows = list(enumerate(columns.tolist()))
        new_fusion = Fusion.__new__
        for i, row in rows:
            (gene1, gene2, contig1, contig2, breakpoint1, breakpoint2,
             direction1, direction2, filter_id, split_reads1, split_reads2,
             discordant_mates, anchor_start1, anchor_start2, flags, _r1,
             _r2) = row
            direction1 = bool(direction1)
            direction2 = bool(direction2)
            fusion = new_fusion(Fusion)
            fusion.__dict__ = {
                "transcript_start_ambiguous": bool(flags & 64),
                "split_reads1": split_reads1,
                "transcript_start": bool(flags & 32),
                "split_reads2": split_reads2,
                "spliced1": bool(flags & 128),
                "spliced2": bool(flags & 256),
                "exonic1": bool(flags & 1),
                "exonic2": bool(flags & 2),
                "predicted_strand1": bool(flags & 4),
                "predicted_strand2": bool(flags & 8),
                "direction1": direction1,
                "direction2": direction2,
                "confidence": confidences[i],
                "filter": filter_id,
                "predicted_strands_ambiguous": bool(flags & 16),
                "discordant_mates": discordant_mates,
                "contig1": contig1,
                "contig2": contig2,
                "evalue": evalues[i],
                "breakpoint1": breakpoint1,
                "breakpoint2": breakpoint2,
                "anchor_start1": anchor_start1,
                "anchor_start2": anchor_start2,
                "closest_genomic_breakpoint1": closest[i][0],
                "closest_genomic_breakpoint2": closest[i][1],
                "gene1": gene1,
                "gene2": gene2,
                "split_read1_list": [names[j] for j in items[off1[i]:off1[i + 1]]],
                "split_read2_list": [names[j] for j in items[off2[i]:off2[i + 1]]],
                "discordant_mate_list": [names[j] for j in items[off3[i]:off3[i + 1]]],
                # the same lists as native-store rows, so the writer can
                # feed the native pileup/supporting-read calls directly
                "support_rows": (items[off1[i]:off1[i + 1]],
                                 items[off2[i]:off2[i + 1]],
                                 items[off3[i]:off3[i + 1]]),
            }
            fusions[(gene1, gene2, contig1, contig2, breakpoint1, breakpoint2,
                     direction1, direction2)] = fusion


# ---------------------------------------------------------------------------
# event-level cascade facade (arriba.cpp:415-612 stage order)

# order must match event.h's FilterName enum
def _event_filter_order():
    return (FILTER_DUPLICATES, FILTER_HAIRPIN, FILTER_INCONSISTENTLY_CLIPPED,
            FILTER_MISMATCHES, FILTER_MERGE_ADJACENT, FILTER_MULTIMAPPERS,
            FILTER_RELATIVE_SUPPORT, FILTER_NON_CODING_NEIGHBORS,
            FILTER_INTRAGENIC_EXONIC, FILTER_MIN_SUPPORT,
            FILTER_INTERNAL_TANDEM_DUPLICATION, FILTER_INTRONIC,
            FILTER_IN_VITRO, FILTER_SELECT_BEST, FILTER_MARGINAL_READ_THROUGH,
            FILTER_NO_GENOMIC_SUPPORT, FILTER_BLACKLIST, FILTER_SHORT_ANCHOR,
            FILTER_END_TO_END, FILTER_NO_COVERAGE, FILTER_HOMOLOGS,
            FILTER_MISMAPPERS, FILTER_ISOFORMS, FILTER_HOMOPOLYMER,
            FILTER_UNINTERESTING_CONTIGS)


class EventCascade:
    """Drives the event-level cascade stage by stage. While the native fusion
    table is live, stages run in C++ over the columnar store (native/event.cpp,
    mirroring arriba.cpp:415-612); the table materializes into Python Fusion
    objects immediately before the first stage without a native twin, and the
    Python implementations take over from there. ARRIBA_TPU_TORCH_NO_NATIVE_EVENT=1
    forces immediate materialization (all stages in Python)."""

    def __init__(self, read_cascade: "ReadLevelCascade", fusions, state,
                 options, annotation) -> None:
        self.rc = read_cascade
        self.ca = read_cascade.ca
        self.fusions = fusions
        self.state = state
        self.options = options
        self.annotation = annotation
        self.genes = read_cascade.genes
        self.exons = read_cascade.exons
        self.exon_index = read_cascade.exon_index
        self._kmer_indices = None
        self._native = read_cascade._native
        self._live = self._native is not None
        if (self._live
                and os.environ.get("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT") == "1"):
            self.materialize()
        elif self._live:
            self._bind()

    # -- native plumbing ----------------------------------------------------

    def _cluster_ids(self) -> np.ndarray:
        """Multimapper cluster ids: adjacent fragments (sorted-name order)
        with equal HI-stripped names share an id (read_chimeric_alignments
        .cpp:792-802 key adjacency)."""
        if getattr(self.ca, "is_lazy_native", False):
            return np.frombuffer(self._native.extract_cluster_ids(), np.int64)
        from ..model import strip_hi_tag_from_read_name
        ids = np.empty(len(self.ca), np.int64)
        previous = None
        current = -1
        for i, name in enumerate(self.ca.keys()):
            stripped = strip_hi_tag_from_read_name(name)
            if stripped != previous:
                current += 1
                previous = stripped
            ids[i] = current
        return ids

    def _bind(self) -> None:
        genes = self.genes
        coverage = self.state.coverage
        n_contigs = len(self.state.interesting_contigs)

        def int64_bytes(values):
            return np.ascontiguousarray(values, np.int64).tobytes()

        gene_index = self.state.gene_index
        starts = []
        ends = []
        for contig in range(n_contigs):
            if (contig < len(coverage.fragment_starts)
                    and len(coverage.fragment_starts[contig])):
                starts.append(coverage.fragment_starts[contig].view(np.uint8))
                ends.append(coverage.fragment_ends[contig].view(np.uint8))
            else:
                starts.append(None)
                ends.append(None)
        self._native.event_bind(
            int64_bytes(genes.is_protein_coding),
            int64_bytes(genes.exonic_length),
            self._cluster_ids().tobytes(),
            [int64_bytes(b) for b in gene_index.boundaries],
            [int64_bytes(o) for o in gene_index.offsets],
            [int64_bytes(i) for i in gene_index.items],
            starts, ends,
            int64_bytes(np.array(_event_filter_order(), np.int64)))

    def materialize(self) -> None:
        if not self._live:
            return
        self._live = False
        with trace.span("events.materialize"):
            self.rc.materialize_fusions(self.fusions)
        trace.count("events.materialized", len(self.fusions))

    def _dispatch(self, native_name: str, native_args: tuple, python_fn,
                  python_args: tuple):
        if self._live:
            return getattr(self._native, native_name)(*native_args)
        return python_fn(*python_args)

    # -- sharded mid-cascade statistics (parallel/stats.py) -------------------

    def _sharded_statistics(self):
        """(CascadeStats, (dense expression counts, threshold)) of the
        sharded reduction when ARRIBA_TPU_TORCH_SHARDED_STATS asks for it,
        else None; computed once. =<n> reduces over n row shards on the
        offload device (parallel/stats.py), =<n>procs across n
        torch.distributed ranks (parallel/multihost.py: NCCL with one card
        per rank, gloo on the CPU), which also merges the candidate cluster
        tables and checks the merged table against the host fusion table.
        Integer-exact either way, so the output stays byte-identical for
        every layout. A failure raises: there is no fallback to the host
        pass."""
        from ..device import sharded_stats
        layout = sharded_stats()
        if layout is None:
            return None
        cached = getattr(self, "_sharded_stats_cache", None)
        if cached is not None:
            return cached
        from ..filters.in_vitro import expression_gene_incidence
        from ..output.stdmap_order import fusion_map_order
        self.materialize()
        # the partner dedup is sensitive to the reference's map iteration
        # order (see event_level.estimate_expected_fusions): feed the
        # sharded reduction the same emulated order
        fusion_list = list(self.fusions.values())
        order = fusion_map_order(list(self.fusions.keys()))
        fusion_list = [fusion_list[i] for i in order]
        incidence = expression_gene_incidence(self.ca)
        n, procs = layout
        if procs:
            from ..parallel.multihost import run_multiprocess_stats
            stats, expression, n_clusters = run_multiprocess_stats(
                fusion_list, self.genes, incidence,
                self.options.high_expression_quantile, n)
            # the merged candidate clusters must reproduce the host fusion
            # table: one cluster per fusion with >= 1 supporting read
            expected = sum(1 for f in fusion_list
                           if f.split_read1_list or f.split_read2_list
                           or f.discordant_mate_list)
            if n_clusters != expected:
                raise RuntimeError(
                    f"sharded candidate merge diverged from the host fusion "
                    f"table: {n_clusters} clusters != {expected}")
        else:
            from ..parallel.dp import make_mesh
            from ..parallel.stats import compute_stats_sharded
            stats, expression = compute_stats_sharded(
                fusion_list, self.genes, incidence,
                self.options.high_expression_quantile, make_mesh(n))
        self._sharded_stats_cache = (stats, expression)
        return self._sharded_stats_cache

    # -- stages (pipeline call order) ----------------------------------------

    def mark_genomic_support(self) -> int:
        from .genomic_support import mark_genomic_support
        options = self.options
        self.materialize()
        return mark_genomic_support(self.fusions,
                                    options.genomic_breakpoints_file,
                                    self.state.contigs, self.genes,
                                    options.max_genomic_breakpoint_distance,
                                    options.max_itd_length)

    def merge_adjacent(self) -> int:
        from .event_level import merge_adjacent_fusions
        return self._dispatch(
            "ev_merge_adjacent", (5, int(self.options.max_itd_length)),
            merge_adjacent_fusions,
            (self.fusions, 5, self.options.max_itd_length))

    def multimappers(self) -> int:
        from .multimappers import filter_multimappers
        return self._dispatch(
            "ev_multimappers", (),
            filter_multimappers,
            (self.ca, self.fusions, self.state.assembly, self.genes,
             self.exons, self.exon_index))

    @trace.spanned("events.evalue")
    def estimate_expected_fusions(self) -> None:
        from .event_level import estimate_expected_fusions
        sharded = self._sharded_statistics()
        if sharded is not None:
            return estimate_expected_fusions(
                self.fusions, self.state.mapped_reads, self.genes,
                self.exons, self.exon_index, stats=sharded[0])
        return self._dispatch(
            "ev_estimate_expected", (int(self.state.mapped_reads),),
            estimate_expected_fusions,
            (self.fusions, self.state.mapped_reads, self.genes, self.exons,
             self.exon_index))

    def non_coding_neighbors(self) -> int:
        from .event_level import filter_non_coding_neighbors
        return self._dispatch(
            "ev_non_coding_neighbors", (),
            filter_non_coding_neighbors, (self.fusions, self.genes))

    def intragenic_exonic(self) -> int:
        from .event_level import filter_intragenic_both_exonic
        return self._dispatch(
            "ev_intragenic_exonic", (float(self.options.exonic_fraction),),
            filter_intragenic_both_exonic,
            (self.fusions, self.genes, self.exons, self.exon_index,
             self.options.exonic_fraction))

    def min_support(self) -> int:
        from .event_level import filter_min_support
        return self._dispatch(
            "ev_min_support", (int(self.options.min_support),),
            filter_min_support,
            (self.fusions, self.genes, self.options.min_support))

    def relative_support(self) -> int:
        from .event_level import filter_relative_support
        return self._dispatch(
            "ev_relative_support", (float(self.options.evalue_cutoff),),
            filter_relative_support,
            (self.fusions, self.genes, self.options.evalue_cutoff))

    def recover_internal_tandem_duplication(self) -> int:
        from .event_level import recover_internal_tandem_duplication
        options = self.options
        return self._dispatch(
            "ev_recover_itd",
            (int(options.max_itd_length), int(options.min_itd_support),
             float(options.min_itd_allele_fraction),
             int(options.subsampling_threshold)),
            recover_internal_tandem_duplication,
            (self.fusions, self.ca, self.state.coverage, self.genes,
             self.exons, self.exon_index, options.max_itd_length,
             options.min_itd_support, options.min_itd_allele_fraction,
             options.subsampling_threshold))

    def both_intronic(self) -> int:
        from .event_level import filter_both_intronic
        viral = bytes(bytearray(1 if v else 0 for v in self.state.viral_contigs))
        return self._dispatch(
            "ev_both_intronic", (viral,),
            filter_both_intronic,
            (self.fusions, self.ca, self.state.viral_contigs))

    def _parse_item_pairs(self, path: str, allow_keyword2: bool):
        """Parse a blacklist/known-fusions file into the native stages'
        columnar item-pair encoding (7 int64 per item, 14 per pair); the
        gene-name resolution and malformed-line warnings stay in
        blacklist.py's parser."""
        from .blacklist import _iter_item_pair_lines, parse_blacklist_item
        rows = []
        for range1, range2 in _iter_item_pair_lines(path):
            item1 = parse_blacklist_item(range1, self.state.contigs,
                                         self.annotation.gene_names,
                                         self.genes, False)
            if item1 is None and not allow_keyword2:
                # known-fusions parses both before deciding (warnings fire)
                parse_blacklist_item(range2, self.state.contigs,
                                     self.annotation.gene_names, self.genes,
                                     False)
                continue
            if item1 is None:
                continue
            item2 = parse_blacklist_item(range2, self.state.contigs,
                                         self.annotation.gene_names,
                                         self.genes, allow_keyword2)
            if item2 is None:
                continue
            for item in (item1, item2):
                rows.append((item.type, int(item.strand_defined),
                             int(item.strand), item.contig, item.start,
                             item.end, item.gene))
        return np.asarray(rows, np.int64).tobytes()

    def known_fusions(self) -> int:
        from .blacklist import recover_known_fusions
        if self._live:
            items = self._parse_item_pairs(self.options.known_fusions_file,
                                           allow_keyword2=False)
            return self._native.ev_known_fusions(
                items, int(self.state.max_mate_gap))
        self.materialize()
        return recover_known_fusions(
            self.fusions, self.options.known_fusions_file, self.state.contigs,
            self.annotation.gene_names, self.genes, self.state.coverage,
            self.state.max_mate_gap)

    def in_vitro(self) -> int:
        from .in_vitro import filter_in_vitro
        sharded = self._sharded_statistics()
        if sharded is not None:
            return filter_in_vitro(
                self.fusions, self.ca, self.options.high_expression_quantile,
                self.state.gene_index, self.state.coverage,
                expression=sharded[1])
        return self._dispatch(
            "ev_in_vitro", (float(self.options.high_expression_quantile),),
            filter_in_vitro,
            (self.fusions, self.ca, self.options.high_expression_quantile,
             self.state.gene_index, self.state.coverage))

    def recover_both_spliced(self) -> int:
        from .in_vitro import recover_both_spliced
        sharded = self._sharded_statistics()
        if sharded is not None:
            return recover_both_spliced(
                self.fusions, self.ca, self.genes, self.exons,
                self.exon_index, self.state.coverage, 200,
                self.options.high_expression_quantile, 1000, 1000,
                expression=sharded[1])
        return self._dispatch(
            "ev_recover_both_spliced",
            (200, float(self.options.high_expression_quantile), 1000, 1000),
            recover_both_spliced,
            (self.fusions, self.ca, self.genes, self.exons, self.exon_index,
             self.state.coverage, 200, self.options.high_expression_quantile,
             1000, 1000))

    def select_best(self) -> int:
        from .event_level import select_most_supported_breakpoints
        return self._dispatch(
            "ev_select_best", (),
            select_most_supported_breakpoints, (self.fusions,))

    def marginal_read_through(self) -> int:
        from .event_level import filter_marginal_read_through
        return self._dispatch(
            "ev_marginal_read_through", (),
            filter_marginal_read_through,
            (self.fusions, self.genes, self.state.coverage))

    def recover_many_spliced(self) -> int:
        from .event_level import recover_many_spliced
        return self._dispatch(
            "ev_recover_many_spliced", (int(self.options.min_spliced_events),),
            recover_many_spliced,
            (self.fusions, self.genes, self.options.min_spliced_events))

    def assign_confidence(self) -> None:
        from .genomic_support import assign_confidence
        return self._dispatch(
            "ev_assign_confidence", (),
            assign_confidence,
            (self.fusions, self.state.coverage, self.genes))

    def no_genomic_support(self) -> int:
        from .genomic_support import filter_no_genomic_support
        viral = bytes(bytearray(1 if v else 0 for v in self.state.viral_contigs))
        return self._dispatch(
            "ev_no_genomic_support", (viral,),
            filter_no_genomic_support,
            (self.fusions, self.state.viral_contigs))

    def blacklist(self) -> int:
        from .blacklist import filter_blacklisted_ranges
        if self._live:
            items = self._parse_item_pairs(self.options.blacklist_file,
                                           allow_keyword2=True)
            return self._native.ev_blacklist(
                items, float(self.options.evalue_cutoff),
                int(self.state.max_mate_gap))
        self.materialize()
        return filter_blacklisted_ranges(
            self.fusions, self.options.blacklist_file, self.state.contigs,
            self.annotation.gene_names, self.genes,
            self.options.evalue_cutoff, self.state.max_mate_gap)

    def short_anchor(self) -> int:
        from .event_level import filter_short_anchor
        return self._dispatch(
            "ev_short_anchor", (int(self.options.min_anchor_length),),
            filter_short_anchor,
            (self.fusions, self.options.min_anchor_length))

    def end_to_end(self) -> int:
        from .event_level import filter_end_to_end_fusions
        viral = bytes(bytearray(1 if v else 0 for v in self.state.viral_contigs))
        return self._dispatch(
            "ev_end_to_end", (viral,),
            filter_end_to_end_fusions,
            (self.fusions, self.genes, self.exons, self.exon_index,
             self.state.viral_contigs))

    def no_coverage(self) -> int:
        from .event_level import filter_no_coverage
        return self._dispatch(
            "ev_no_coverage", (),
            filter_no_coverage,
            (self.fusions, self.state.coverage, self.genes, self.exons,
             self.exon_index))

    @trace.spanned("events.kmer_index")
    def make_kmer_index(self, padding: int, kmer_length: int) -> None:
        from .mismappers import indexed_bases, make_kmer_index
        if self._live:
            self._native.ev_make_kmer_index(int(padding),
                                            int(self.options.threads))
            return
        self.materialize()
        self._kmer_indices = make_kmer_index(self.fusions, self.state.assembly,
                                             self.genes, padding, kmer_length)
        if trace.active():
            trace.count("events.kmer_index_bases",
                        indexed_bases(self._kmer_indices, self.state.assembly,
                                      self.genes))
            # (contig, 8-mer) keys of the Python table: 0 where the native
            # realignment engine holds the positions
            trace.count("events.kmer_table_kmers",
                        sum(len(index)
                            for index in self._kmer_indices.values()))

    @trace.spanned("events.homologs")
    def homologs(self) -> int:
        from .homologs import filter_homologs
        return self._dispatch(
            "ev_homologs", (float(self.options.max_homolog_identity),
                            int(self.options.threads)),
            filter_homologs,
            (self.fusions, self._kmer_indices or {}, 8, self.state.assembly,
             self.genes, self.options.max_homolog_identity))

    def mismappers(self) -> int:
        from .mismappers import filter_mismappers
        return self._dispatch(
            "ev_mismappers",
            (float(self.options.max_mismapper_fraction),
             int(self.state.max_mate_gap), int(self.options.threads)),
            filter_mismappers,
            (self.fusions, self.ca, self._kmer_indices or {}, 8,
             self.state.assembly, self.genes, self.exons, self.exon_index,
             self.options.max_mismapper_fraction, self.state.max_mate_gap))

    def recover_genomic_support(self) -> int:
        from .genomic_support import recover_genomic_support
        return self._dispatch(
            "ev_recover_genomic_support", (),
            recover_genomic_support, (self.fusions,))

    def recover_isoforms(self) -> int:
        from .event_level import recover_isoforms
        return self._dispatch(
            "ev_recover_isoforms", (),
            recover_isoforms, (self.fusions,))

    def finish(self) -> None:
        """Materialize (if still native) so the output writer sees Python
        Fusion objects; always called before writing. When the discarded
        file can be serialized natively (default options: no -X, no tags,
        no protein domains), only passing fusions materialize and the native
        stores stay alive until write_discarded()."""
        self._native_writer = False
        if not self._live:
            return
        self._native_writer = (
            bool(self.options.discarded_output_file)
            and not self.options.print_extra_info_for_discarded_fusions
            and not self.options.tags_file
            and not self.options.protein_domains_file)
        passing_only = (self._native_writer
                        or not self.options.discarded_output_file)
        self._live = False
        # keep the native stores alive while a lazy chimeric-alignment view
        # still resolves fragments from them (the writer reads per-read
        # filters and sequences after this point); release() frees them
        lazy_ca = getattr(self.ca, "is_lazy_native", False)
        self.rc.materialize_fusions(
            self.fusions, passing_only=passing_only,
            release=not self._native_writer and not lazy_ca)

    def write_discarded(self, path: str) -> bool:
        """Serialize the discarded-fusions file natively from the still-live
        fusion table (output_fusions.cpp:820-1060 discarded rows). Returns
        False when finish() fell back to full materialization."""
        if not getattr(self, "_native_writer", False):
            return False
        from ..constants import FILTER_NAMES
        from ..output.writer import HEADER
        genes = self.genes
        self._native.ev_write_discarded(
            path, HEADER.encode(),
            [n.encode() for n in self.state.contigs.original],
            [n.encode() for n in genes.name],
            [n.encode() for n in genes.gene_id],
            [n.encode() for n in FILTER_NAMES],
            int(self.options.max_itd_length))
        self._native_writer = False
        if not getattr(self.ca, "is_lazy_native", False):
            self._native.event_release()
        return True

    def release(self) -> None:
        """Free the native stores once the writers are done. A lazy chimeric
        view materializes everything first so post-pipeline introspection
        still sees the final per-fragment state."""
        if self._native is None:
            return
        if getattr(self.ca, "is_lazy_native", False):
            self.ca.ensure_materialized()
        self._native.event_release()
        self._native.extract_release()
