"""Device-side blacklist range triage.

The host blacklist (filters/blacklist.py, parity with
filter_blacklisted_ranges.cpp:17-300) evaluates rich per-item semantics
(keywords, gene matches, 5'/3' awareness) over a 100 kb genome-bin hash.
The device analog replaces the bin hash with sorted interval arrays and
answers the hot containment question — "does this breakpoint fall inside
any blacklisted range?" — for whole batches at once:

  contigs are laid out end-to-end in an int64 global coordinate space;
  ranges sorted by global start with a running
  prefix-max of global ends make point containment a single searchsorted
  per query.

A triage prefilter: breakpoints that hit no range skip the host's per-item
matching entirely; hits are re-checked on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace


def contig_offsets(contig_lengths) -> np.ndarray:
    """Global-coordinate offset per contig (exclusive prefix sum), int64."""
    lengths = np.asarray(contig_lengths, np.int64)
    offsets = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    return offsets


def build_range_index(contig, start, end, offsets: np.ndarray, device=None):
    """(sorted global starts, running prefix-max of global ends), int64
    tensors on the device."""
    contig = np.asarray(contig, np.int64)
    start = np.asarray(start, np.int64) + offsets[contig]
    end = np.asarray(end, np.int64) + offsets[contig]
    order = np.argsort(start, kind="stable")
    prefix_max_end = np.maximum.accumulate(end[order]) if len(order) else end
    return (trace.upload(start[order], device),
            trace.upload(prefix_max_end, device))


def query_intervals(sorted_starts, prefix_max_end, query_lo, query_hi):
    """bool [N]: does each global-coordinate interval [lo, hi] overlap any
    range? Overlap iff some range with start <= hi has end >= lo: one
    binary search for the ranges starting at or before hi, then the
    running maximum of their ends."""
    if sorted_starts.numel() == 0:
        return torch.zeros(query_hi.shape, dtype=torch.bool,
                           device=query_hi.device)
    idx = torch.searchsorted(sorted_starts, query_hi, right=True)
    best_end = torch.where(idx > 0, prefix_max_end[(idx - 1).clamp(min=0)],
                           0)
    return (idx > 0) & (best_end >= query_lo)


def query_points(sorted_starts, prefix_max_end, query_global):
    """bool [N]: does each global-coordinate point fall inside any range?
    Ranges never span contig boundaries, so the global layout cannot create
    cross-contig false positives as long as queries use the same offsets."""
    return query_intervals(sorted_starts, prefix_max_end, query_global,
                           query_global)
