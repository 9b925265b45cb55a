"""Fusion-candidate clustering as a sort plus a segment-reduce, in PyTorch.

The counting core of find_fusions (fusions.cpp:203-366): every chimeric
fragment contributes one breakpoint-pair candidate per (gene1, gene2)
combination; candidates with identical (gene1, gene2, contig1, contig2,
breakpoint1, breakpoint2, direction1, direction2) keys aggregate into one
fusion with per-kind support counts. The host implementation uses a hash
map; here the same aggregation is a fixed-shape sort + segment-reduce:

  1. pack the key into six int32 words (sentinel 0x7FFFFFFF for empty
     slots, so the order is the JAX package's int32 order),
  2. stable argsort passes from the least to the most significant word,
  3. run boundaries and segment ids via cumsum,
  4. per-kind support via index_add_.

Shapes are static: N candidate slots in, N cluster slots out (empty slots
at the end). These are plain torch ops on the tensors' device.
"""

from __future__ import annotations

import torch

SUPPORT_KINDS = 3  # split_reads1, split_reads2, discordant_mates
SENTINEL = 0x7FFFFFFF


def pack_keys(gene1, gene2, contig1, contig2, breakpoint1, breakpoint2,
              direction1, direction2):
    """Pack the 8-tuple fusion key into 6 int32 words, most significant
    first: (gene1, gene2, contig-pair, breakpoint1, breakpoint2,
    direction-pair)."""
    def word(x):
        return torch.as_tensor(x).to(torch.int32)

    contig_pair = (word(contig1) << 16) | word(contig2)
    direction_pair = (word(direction1) << 1) | word(direction2)
    return (word(gene1), word(gene2), contig_pair, word(breakpoint1),
            word(breakpoint2), direction_pair)


def _aggregate(words, rows, valid):
    """Sort the slots by key (empty slots carry the sentinel and sort last)
    and sum the int32 [N, K] rows of equal keys."""
    n = words[0].shape[0]
    words = [torch.where(valid, word, SENTINEL) for word in words]
    for word_index in range(len(words) - 1, -1, -1):
        order = torch.argsort(words[word_index], stable=True)
        words = [word[order] for word in words]
        rows = rows[order]
    valid = words[-1] != SENTINEL
    for word in words[:-1]:
        valid = valid | (word != SENTINEL)

    changed = torch.zeros(n - 1, dtype=torch.bool, device=valid.device)
    for word in words:
        changed = changed | (word[1:] != word[:-1])
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=valid.device),
                       changed]) & valid
    segment = torch.cumsum(first.to(torch.int32), 0) - 1
    segment = torch.where(valid, segment, n - 1)  # park empty slots last

    rows = rows * valid[:, None].to(rows.dtype)
    support = torch.zeros((n, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
    support.index_add_(0, segment.long(), rows)

    # cluster keys: the first slot of each run; the other slots scatter into
    # one extra slot that is sliced off
    slot = torch.where(first, segment, n).long()
    out_words = tuple(
        torch.full((n + 1,), SENTINEL, dtype=torch.int32,
                   device=word.device).scatter_(0, slot, word)[:n]
        for word in words)
    n_clusters = first.to(torch.int32).sum()
    cluster_valid = torch.arange(n, device=valid.device) < n_clusters
    return {"words": out_words, "support": support,
            "cluster_valid": cluster_valid, "n_clusters": n_clusters}


def cluster_candidates(words, kind, valid):
    """Aggregate candidates with equal keys.

    words: tuple of int32 [N] key words, most significant first; kind:
    int32 [N] in [0, SUPPORT_KINDS), the support counter the candidate
    feeds (other values count for none); valid: bool [N], the slots in use.

    Returns, per output slot (sorted by key, empty slots at the end):
    words (tuple of int32 [N]), support (int32 [N, SUPPORT_KINDS]),
    cluster_valid (bool [N]) and n_clusters (int32 scalar)."""
    kinds = torch.arange(SUPPORT_KINDS, dtype=torch.int32, device=kind.device)
    one_hot = (kind.to(torch.int32)[:, None] == kinds).to(torch.int32)
    return _aggregate(words, one_hot, valid)


def merge_cluster_tables(words, support, valid):
    """Merge already-aggregated cluster tables (e.g. gathered from shards):
    rows with equal keys sum their support vectors."""
    return _aggregate(words, support, valid)
