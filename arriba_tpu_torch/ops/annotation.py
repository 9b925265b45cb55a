"""Device-side annotation index queries.

The host IntervalIndex (annotation/index.py) stores, per contig, sorted
region boundaries plus CSR feature sets — the layout torch.searchsorted
consumes. These functions are the device formulation of the reference's
get_annotation_by_coordinate point query (annotation.t.hpp:55-68): one
searchsorted per query batch, then fixed-width gathers of the CSR sets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import trace


def point_query_spans(boundaries: torch.Tensor, offsets: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q] positions -> (csr_start [Q], csr_len [Q]) of the feature set of
    the region containing each position (empty set past the last
    boundary)."""
    idx = torch.searchsorted(boundaries, positions)
    in_range = idx < boundaries.shape[0]
    idx_clipped = idx.clamp(max=max(boundaries.shape[0] - 1, 0))
    starts = torch.where(in_range, offsets[idx_clipped], 0)
    ends = torch.where(in_range, offsets[idx_clipped + 1], 0)
    return starts, ends - starts


def gather_sets(items: torch.Tensor, csr_start: torch.Tensor,
                csr_len: torch.Tensor, max_items: int) -> torch.Tensor:
    """CSR sets as a fixed-width [Q, max_items] matrix padded with -1 (sets
    longer than max_items are truncated)."""
    lanes = torch.arange(max_items, device=items.device)[None, :]
    valid = lanes < csr_len[:, None]
    indices = torch.where(valid, csr_start[:, None] + lanes, 0)
    return torch.where(valid, items[indices], -1)


def point_query_batch(boundaries, offsets, items, positions,
                      max_items: int) -> torch.Tensor:
    """Fused point query: [Q] positions -> [Q, max_items] feature rows
    (-1 padded)."""
    starts, lengths = point_query_spans(boundaries, offsets, positions)
    return gather_sets(items, starts, lengths, max_items)


def interval_overlap_triage(queries, feature_contig, feature_start,
                            feature_end, n_contigs: int, slack: int = 2,
                            device=None):
    """bool[len(queries)] per (contig, start, end) query: could any feature
    lie within `slack` bp of the interval? A sound emptiness prefilter for
    IntervalIndex.range_query (annotation.t.hpp:70-99): every feature that
    query can return overlaps [start-slack, end+slack], so a False here
    means the host query is guaranteed EMPTY and can be skipped. Batched
    over the whole mate set via the sorted-global-coordinate ranges of the
    blacklist triage (ops/blacklist.py)."""
    from .blacklist import build_range_index, contig_offsets, query_intervals

    if not queries:
        return np.zeros(0, bool)
    if device is None:
        from ..device import torch_device
        device = torch_device()
    q_contig = np.asarray([q[0] for q in queries], np.int64)
    q_lo = np.maximum(np.asarray([q[1] for q in queries], np.int64)
                      - slack, 0)
    q_hi = np.asarray([q[2] for q in queries], np.int64) + slack
    feature_contig = np.asarray(feature_contig, np.int64)
    feature_start = np.asarray(feature_start, np.int64)
    feature_end = np.asarray(feature_end, np.int64)

    lengths = np.zeros(n_contigs, np.int64)
    for contig, hi in ((feature_contig, feature_end), (q_contig, q_hi)):
        if len(contig):
            np.maximum.at(lengths, contig, hi + 8)
    offsets = contig_offsets(lengths)
    starts, prefix_max_end = build_range_index(
        feature_contig, feature_start, feature_end, offsets, device)
    base = offsets[q_contig]
    hits = query_intervals(starts, prefix_max_end,
                           trace.upload(q_lo + base, device),
                           trace.upload(q_hi + base, device))
    return hits.cpu().numpy()
