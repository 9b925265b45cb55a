"""Native bulk path for the "Annotating alignments" stage.

Flattens all fragments into columnar arrays, annotates them in one
`_native.annotate_bulk` call (exact port of annotation.cpp:379-555 — see
native/annotate.cpp), and writes the gene sets / strand resolutions back.
The Python implementation in `queries.annotate_alignments` remains the
parity reference, and runs when there is no engine (_native_build.engine).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .._native_build import engine
from ..constants import FORWARD
from ..model import Fragment
from .index import IntervalIndex
from .tables import ExonTable, GeneTable


def bind_annotation_engine(native, exon_index: IntervalIndex,
                           exons: ExonTable, genes: GeneTable) -> None:
    """(Re-)register the exon interval index and exon/gene tables with the
    native annotation engine. Must be re-run after the gene table grows
    (dummy-gene creation) so native splice tests see every gene row."""

    def int64_bytes(values) -> bytes:
        return np.ascontiguousarray(values, np.int64).tobytes()

    native.annotate_bind(
        exon_index.n_contigs,
        [int64_bytes(b) for b in exon_index.boundaries],
        [int64_bytes(o) for o in exon_index.offsets],
        [int64_bytes(i) for i in exon_index.items],
        int64_bytes(exons.gene), int64_bytes(exons.start),
        int64_bytes(exons.end), int64_bytes(exons.prev_exon),
        int64_bytes(exons.next_exon), int64_bytes(exons.coding_region_start),
        int64_bytes(exons.coding_region_end),
        int64_bytes(genes.contig), int64_bytes(genes.strand))


def bind_gene_index(native, gene_index: IntervalIndex,
                    genes: GeneTable) -> None:
    """Register the gene interval index + gene tables for the retained-store
    annotation chain (gene-level fallback, dummy genes, strandedness).
    Must follow every bind_annotation_engine call (which resets the engine)."""

    def int64_bytes(values) -> bytes:
        return np.ascontiguousarray(values, np.int64).tobytes()

    native.gene_index_bind(
        [int64_bytes(b) for b in gene_index.boundaries],
        [int64_bytes(o) for o in gene_index.offsets],
        [int64_bytes(i) for i in gene_index.items],
        int64_bytes(genes.start), int64_bytes(genes.end),
        np.ascontiguousarray(genes.is_dummy, np.uint8).tobytes())


# marshal reuse: the read-level cascade runs on the same fragments right
# after annotation (only gene sets change in between), so the geometry/CIGAR
# columns marshalled here are stashed for native_cascade to consume
_marshal_cache = None


def consume_marshal_cache(fragments):
    """Return the cached annotation marshal if it matches `fragments`
    element-for-element; single use.

    Reuse is only sound while no stage between annotation and the cascade
    mutates mate geometry (contig/start/end/strand/CIGAR) — gene sets may
    change. Element identity is checked exactly; geometry is verified on a
    deterministic sample of fragments so a future pipeline edit that
    violates the invariant fails loudly here instead of silently diverging."""
    global _marshal_cache
    cache = _marshal_cache
    _marshal_cache = None
    if cache is None:
        return None
    cached_fragments = cache["fragments"]
    if len(cached_fragments) != len(fragments):
        return None
    if any(a is not b for a, b in zip(cached_fragments, fragments)):
        return None

    n = len(fragments)
    if n:
        frag_offsets = np.frombuffer(cache["frag_offsets"], np.int64)
        contig = np.frombuffer(cache["contig"], np.int64)
        start = np.frombuffer(cache["start"], np.int64)
        end = np.frombuffer(cache["end"], np.int64)
        strand = np.frombuffer(cache["strand"], np.int64)
        cigar_offsets = np.frombuffer(cache["cigar_offsets"], np.int64)
        cigar_words = np.frombuffer(cache["cigar_words"], np.uint32)
        sample = {0, n - 1, n // 2} | set(range(0, n, max(1, n // 64)))
        for f in sample:
            row = int(frag_offsets[f])
            for mate in fragments[f]:
                if (int(contig[row]) != mate.contig
                        or int(start[row]) != mate.start
                        or int(end[row]) != mate.end
                        or int(strand[row]) != (1 if mate.strand == FORWARD else 0)
                        or not np.array_equal(
                            cigar_words[int(cigar_offsets[row]):
                                        int(cigar_offsets[row + 1])],
                            mate.cigar.astype(np.uint32, copy=False))):
                    raise AssertionError(
                        "annotation marshal cache is stale: fragment geometry "
                        "changed between annotate and cascade_begin (fragment "
                        f"{f}); a pipeline stage violated the reuse invariant")
                row += 1
    return cache


def annotate_all_native(chimeric_alignments: Dict[str, Fragment],
                        exons: ExonTable, genes: GeneTable,
                        exon_index: IntervalIndex) -> bool:
    """Annotate every fragment via the native engine; returns False (leaving
    all fragments untouched) when the native module is unavailable."""
    native = engine()
    if native is None:
        return False

    bind_annotation_engine(native, exon_index, exons, genes)

    fragments = list(chimeric_alignments.values())
    n_mates = sum(len(mates) for mates in fragments)
    frag_offsets = np.zeros(len(fragments) + 1, np.int64)
    contig = np.zeros(n_mates, np.int64)
    start = np.zeros(n_mates, np.int64)
    end = np.zeros(n_mates, np.int64)
    strand = np.zeros(n_mates, np.int64)
    pred_strand = np.zeros(n_mates, np.int64)
    pred_ambig = np.zeros(n_mates, np.int64)
    cigar_offsets = np.zeros(n_mates + 1, np.int64)
    cigars = []
    row = 0
    for f, mates in enumerate(fragments):
        frag_offsets[f + 1] = frag_offsets[f] + len(mates)
        for mate in mates:
            contig[row] = mate.contig
            start[row] = mate.start
            end[row] = mate.end
            strand[row] = mate.strand
            pred_strand[row] = mate.predicted_strand
            pred_ambig[row] = mate.predicted_strand_ambiguous
            cigar_offsets[row + 1] = cigar_offsets[row] + len(mate.cigar)
            cigars.append(mate.cigar)
            row += 1
    cigar_words = (np.concatenate(cigars).astype(np.uint32) if cigars
                   else np.empty(0, np.uint32))

    (genes_offsets_b, genes_items_b, pred_strand_b, pred_ambig_b,
     exonic_b) = native.annotate_bulk(
        frag_offsets.tobytes(), contig.tobytes(), start.tobytes(),
        end.tobytes(), strand.tobytes(), pred_strand.tobytes(),
        pred_ambig.tobytes(), cigar_offsets.tobytes(), cigar_words.tobytes())

    genes_offsets = np.frombuffer(genes_offsets_b, np.int64)
    # writable backing store: fragments keep (read-mostly) views into it
    genes_items = np.frombuffer(bytearray(genes_items_b), np.int64)
    out_pred_strand = np.frombuffer(pred_strand_b, np.int64)
    out_pred_ambig = np.frombuffer(pred_ambig_b, np.int64)
    out_exonic = np.frombuffer(exonic_b, np.int64)

    row = 0
    for mates in fragments:
        for mate in mates:
            mate.genes = genes_items[genes_offsets[row]:genes_offsets[row + 1]]
            mate.exonic = bool(out_exonic[row])
            mate.predicted_strand = bool(out_pred_strand[row])
            mate.predicted_strand_ambiguous = bool(out_pred_ambig[row])
            row += 1

    global _marshal_cache
    _marshal_cache = {
        "fragments": fragments,
        "frag_offsets": frag_offsets.tobytes(),
        "contig": contig.tobytes(),
        "start": start.tobytes(),
        "end": end.tobytes(),
        "strand": strand.tobytes(),
        "pred_strand": pred_strand_b or b"",
        "pred_ambig": pred_ambig_b or b"",
        "exonic": exonic_b or b"",
        "cigar_offsets": cigar_offsets.tobytes(),
        "cigar_words": cigar_words.tobytes(),
    }
    return True
