"""Sharded mid-cascade global statistics.

The e-value model and the in-vitro artifact filter consume *global*
statistics of the candidate table and of per-read gene expression
(filter_relative_support.cpp:20-83, filter_in_vitro.cpp:48-83). In the
reference these are single-threaded host passes; here the candidate table
is split into row shards (``parallel/dp.Mesh``), per-shard partial sums are
reduced with psum, and the small dedup'd tables (fusion-partner edges) are
gathered from every shard and reduced identically on every rank. Every
reduced quantity is an integer, so the result is bit-identical for any
shard count and layout, and the host multiply chain that consumes it
produces a byte-identical fusions.tsv.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..filters.event_level import CascadeStats

COUNTERS = ("spliced_bp", "exonic_bp", "intronic_bp", "mixed_bp",
            "intragenic_dup", "intragenic_inv", "spliced_same",
            "spliced_diff")
COLUMNS = ("valid", "none", "gene1", "gene2", "bp1", "bp2", "contig1",
           "contig2", "dir1", "dir2", "split", "sup", "spliced1", "spliced2",
           "exonic1", "exonic2", "dummy1", "dummy2", "index")


def _pad_rows(array: np.ndarray, n_rows: int, fill) -> np.ndarray:
    if array.shape[0] == n_rows:
        return array
    widths = [(0, n_rows - array.shape[0])]
    return np.pad(array, widths, constant_values=fill)


def _dense_count(index, mask, n_genes: int) -> torch.Tensor:
    """int32 [n_genes]: how often each gene occurs in index where mask; the
    masked-out entries go to one extra slot that is sliced off."""
    slot = torch.where(mask, index, n_genes).to(torch.int64)
    dense = torch.zeros(n_genes + 1, dtype=torch.int32, device=index.device)
    dense.index_add_(0, slot, torch.ones_like(slot, dtype=torch.int32))
    return dense[:n_genes]


def _lexsort(keys) -> torch.Tensor:
    """jnp.lexsort: the order that sorts by the LAST key first. Stable
    argsort passes from the first key (least significant) to the last."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _shard_partials(n_genes: int, cols, gene_hits, hits_valid):
    """One shard's part: counter partials, dense gene indicators, its
    entries of the partner stream, and its expression bincount."""
    valid = cols["valid"]
    none = cols["none"] & valid
    gene1, gene2 = cols["gene1"], cols["gene2"]
    bp1, bp2 = cols["bp1"], cols["bp2"]
    contig1, contig2 = cols["contig1"], cols["contig2"]
    dir1, dir2 = cols["dir1"], cols["dir2"]
    split, sup = cols["split"], cols["sup"]
    spliced1, spliced2 = cols["spliced1"], cols["spliced2"]
    exonic1, exonic2 = cols["exonic1"], cols["exonic2"]
    dummy1, dummy2 = cols["dummy1"], cols["dummy2"]
    index = cols["index"]

    def count(mask):
        return (mask & valid).sum()

    read_through = ((contig1 == contig2) & (bp2 - bp1 < 400000)
                    & ~dir1 & dir2)
    # breakpoint-location distribution (filter_relative_support.cpp:44-66)
    located = (none & ((contig1 != contig2) | (bp2 - bp1 > 500000))
               & (sup >= 2) & (split > 0) & ~dummy1 & ~dummy2)
    any_spliced = spliced1 | spliced2
    # intragenic duplication / inversion ratio
    intragenic = none & (gene1 == gene2) & (split >= 2)
    # intragenic : intergenic spliced ratio
    both_spliced = spliced1 & spliced2
    counters = {
        "spliced_bp": count(located & any_spliced),
        "exonic_bp": count(located & ~any_spliced & exonic1 & exonic2),
        "intronic_bp": count(located & ~any_spliced & ~exonic1 & ~exonic2),
        "mixed_bp": count(located & ~any_spliced & (exonic1 != exonic2)),
        "intragenic_dup": count(intragenic & dir1 & ~dir2),
        "intragenic_inv": count(intragenic & (dir1 == dir2)),
        "spliced_same": count(both_spliced & (gene1 == gene2)),
        "spliced_diff": count(both_spliced & (gene1 != gene2)),
    }

    # genes involved in fusions / read-through: dense indicators
    with_fusion = valid & ~dummy1 & ~dummy2 & (split > 0)
    rt = with_fusion & read_through

    def gene_indicator(mask):
        return (_dense_count(gene1, mask, n_genes)
                + _dense_count(gene2, mask, n_genes))

    # fusion partners per gene: the interleaved key2/key1 stream of
    # filter_relative_support.cpp:20-41. Each row i contributes entries 2i
    # (key=gene2, partner=gene1) and 2i+1 (key=gene1, partner=gene2).
    eligible = none & (gene1 != gene2)
    stream = (torch.cat([gene2, gene1]), torch.cat([gene1, gene2]),
              torch.cat([bp1, bp1]), torch.cat([bp2, bp2]),
              torch.cat([2 * index, 2 * index + 1]),
              torch.cat([eligible, eligible]))
    expression = _dense_count(gene_hits, hits_valid, n_genes)
    return (counters, gene_indicator(with_fusion), gene_indicator(rt), stream,
            expression)


def _stats_step(mesh, n_genes: int, cols, gene_hits, hits_valid) -> dict:
    """The shard parts, the collectives, then the replicated partner
    dedup; every output is the same on every rank."""
    from .dp import per_shard

    names = list(cols)
    parts = per_shard(
        mesh, lambda hits, hv, *c: _shard_partials(
            n_genes, dict(zip(names, c)), hits, hv),
        gene_hits, hits_valid, *(cols[name] for name in names))
    out = {name: mesh.psum([part[0][name] for part in parts])
           for name in COUNTERS}
    out["genes_with_fusions"] = (
        mesh.psum([part[1] for part in parts]) > 0).sum()
    out["genes_with_read_through"] = (
        mesh.psum([part[2] for part in parts]) > 0).sum()
    kg, pt, b1, b2, stream_index, entry_valid = (
        mesh.all_gather([part[3][i] for part in parts]) for i in range(6))

    # dedup by (key, bp1, bp2) keeps the smallest interleaved index: the
    # reference's first-insertion-wins map semantics. Sort invalid last,
    # then (kg, b1, b2, stream_index) ascending.
    order = _lexsort((stream_index, b2, b1, kg,
                      (~entry_valid).to(torch.int8)))
    kg, pt, b1, b2 = kg[order], pt[order], b1[order], b2[order]
    entry_valid = entry_valid[order]
    no = torch.zeros(1, dtype=torch.bool, device=kg.device)
    same_key = torch.cat([no, (kg[1:] == kg[:-1]) & (b1[1:] == b1[:-1])
                          & (b2[1:] == b2[:-1]) & entry_valid[1:]
                          & entry_valid[:-1]])
    kept = entry_valid & ~same_key

    # dedup (kg, pt) edges among the kept entries
    order2 = _lexsort((pt, kg, (~kept).to(torch.int8)))
    kg2, pt2, kept2 = kg[order2], pt[order2], kept[order2]
    same_edge = torch.cat([no, (kg2[1:] == kg2[:-1]) & (pt2[1:] == pt2[:-1])
                           & kept2[1:] & kept2[:-1]])
    edge = kept2 & ~same_edge

    out_degree = _dense_count(kg2, edge, n_genes)
    keep_edge = edge & (out_degree[kg2.clamp(max=n_genes - 1).long()]
                        >= out_degree[pt2.clamp(max=n_genes - 1).long()])
    out["partner_count"] = _dense_count(kg2, keep_edge, n_genes)

    # per-gene chimeric-read expression counts (filter_in_vitro.cpp:48-62)
    out["expression"] = mesh.psum([part[4] for part in parts])
    return out


def expression_quantile_threshold(dense_counts: np.ndarray,
                                  quantile: float) -> int:
    """filter_in_vitro.cpp:63-83 from a dense per-gene count vector: sort
    genes with >=1 read by (count, gene id) ascending; threshold = count at
    floor(quantile * n). Shard-count independent because the dense vector
    is a psum."""
    nonzero = np.nonzero(dense_counts)[0]
    if len(nonzero) == 0:
        return 0
    counts = dense_counts[nonzero]
    order = np.lexsort((nonzero, counts))
    index = int(np.floor(quantile * len(nonzero)))
    if index >= len(nonzero):
        index = len(nonzero) - 1
    return int(counts[order[index]])


def candidate_cluster_inputs(fusion_list, n_dp: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One clustering candidate row per supporting read of the fusion
    table: the raw stream fusions.cpp:203-366 aggregates. Returns
    (key_columns int32 [8, N], kind int32 [N], valid bool [N]) padded to a
    multiple of 8 * n_dp. Merging these rows over the mesh must reproduce
    the host fusion table's per-kind support counts exactly."""
    keys = np.array([(f.gene1, f.gene2, f.contig1, f.contig2,
                      f.breakpoint1, f.breakpoint2, int(f.direction1),
                      int(f.direction2)) for f in fusion_list],
                    np.int64).reshape(-1, 8)
    counts = np.array([(len(f.split_read1_list), len(f.split_read2_list),
                        len(f.discordant_mate_list)) for f in fusion_list],
                      np.int64).reshape(-1, 3)
    # per fusion: its split_read1 rows, then split_read2, then discordant
    per_kind = counts.ravel()
    n_cand = int(per_kind.sum())
    N = -(-max(n_cand, 1) // (8 * n_dp)) * 8 * n_dp
    cols = np.zeros((8, N), np.int32)
    kind = np.zeros(N, np.int32)
    cols[:, :n_cand] = np.repeat(np.repeat(keys, 3, axis=0), per_kind,
                                 axis=0).T
    kind[:n_cand] = np.repeat(np.tile(np.arange(3, dtype=np.int32),
                                      len(counts)), per_kind)
    valid = np.arange(N) < n_cand
    return cols, kind, valid


def build_stats_host_inputs(fusion_list, genes, gene_hits: np.ndarray,
                            n_dp: int) -> Dict[str, np.ndarray]:
    """Marshal the fusion table and read-gene incidence into the padded
    numpy arrays the sharded step consumes (row count a multiple of n_dp).
    Shared by the single-process path (compute_stats_sharded) and the
    multi-process workers (parallel/multihost.py), which get these arrays
    in a file."""
    from ..filters.event_level import extract_fusion_columns

    host = extract_fusion_columns(fusion_list, genes)
    n_fusions = len(fusion_list)
    n_rows = max(n_dp, -(-max(n_fusions, 1) // n_dp) * n_dp)

    cols = {
        "valid": _pad_rows(np.ones(n_fusions, bool), n_rows, False),
        "none": _pad_rows(host["none"], n_rows, False) if n_fusions
        else np.zeros(n_rows, bool),
        "index": np.arange(n_rows, dtype=np.int32),
    }
    for name in ("gene1", "gene2", "bp1", "bp2", "contig1", "contig2",
                 "split", "sup"):
        cols[name] = _pad_rows(
            np.asarray(host[name] if n_fusions else np.zeros(0, np.int64),
                       np.int32), n_rows, 0)
    for name in ("dir1", "dir2", "spliced1", "spliced2", "exonic1",
                 "exonic2", "dummy1", "dummy2"):
        cols[name] = _pad_rows(
            np.asarray(host[name] if n_fusions else np.zeros(0, bool), bool),
            n_rows, False)

    n_hits = len(gene_hits)
    n_hit_rows = max(n_dp, -(-max(n_hits, 1) // n_dp) * n_dp)
    inputs = {f"col_{k}": v for k, v in cols.items()}
    inputs["hits"] = _pad_rows(np.asarray(gene_hits, np.int32), n_hit_rows, 0)
    inputs["hits_valid"] = _pad_rows(np.ones(n_hits, bool), n_hit_rows, False)
    inputs["n_genes"] = np.int64(len(genes.start))
    return inputs


def run_stats_step(mesh, inputs: Dict[str, np.ndarray]) -> dict:
    """The stats step over ``mesh`` on pre-marshalled host inputs (each
    process puts its own rows on its device); returns host values."""
    cols = {name: mesh.put(inputs[f"col_{name}"]) for name in COLUMNS}
    out = _stats_step(mesh, int(inputs["n_genes"]), cols,
                      mesh.put(inputs["hits"]), mesh.put(inputs["hits_valid"]))
    return {key: value.cpu().numpy() for key, value in out.items()}


def stats_from_outputs(out, high_expression_quantile: float
                       ) -> Tuple[CascadeStats, Tuple[np.ndarray, int]]:
    """Convert the step's outputs into (CascadeStats, expression pair)."""
    stats = CascadeStats(
        partner_count=np.asarray(out["partner_count"], np.int64),
        spliced_breakpoints=int(out["spliced_bp"]),
        exonic_breakpoints=int(out["exonic_bp"]),
        intronic_breakpoints=int(out["intronic_bp"]),
        exonic_intronic_breakpoints=int(out["mixed_bp"]),
        intragenic_duplications=int(out["intragenic_dup"]),
        intragenic_inversions=int(out["intragenic_inv"]),
        spliced_same_gene=int(out["spliced_same"]),
        spliced_different_genes=int(out["spliced_diff"]),
        genes_with_fusions=int(out["genes_with_fusions"]),
        genes_with_read_through=int(out["genes_with_read_through"]),
    )
    dense = np.asarray(out["expression"], np.int64)
    threshold = expression_quantile_threshold(dense,
                                              high_expression_quantile)
    return stats, (dense, threshold)


def compute_stats_sharded(fusion_list, genes, gene_hits: np.ndarray,
                          high_expression_quantile: float, mesh
                          ) -> Tuple[CascadeStats, Tuple[np.ndarray, int]]:
    """Run the sharded reduction over ``mesh`` and return
    (CascadeStats, (dense expression counts, high-expression threshold)).

    Bit-identical to the host passes (event_level.compute_cascade_stats,
    in_vitro.find_top_expressed_genes) for every shard count: every reduced
    quantity is an integer combined with associative integer reductions."""
    inputs = build_stats_host_inputs(fusion_list, genes, gene_hits,
                                     mesh.size)
    return stats_from_outputs(run_stats_step(mesh, inputs),
                              high_expression_quantile)
