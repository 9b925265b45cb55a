"""Batched device implementations of the per-read filter math, in PyTorch.

The embarrassingly-parallel-over-reads stages of the cascade (SURVEY §2.7):
mismatch counting + binomial test (filter_mismatches.cpp), recurrent k-mer
content (filter_low_entropy.cpp:60-100) and homopolymer runs
(filter_homopolymer.cpp:38-52), as fixed-shape masked tensor ops over a
ReadBatch. The low-entropy scan runs the hand-written CUDA kernel K2
(kernels/csrc/low_entropy.cu) for CUDA tensors and its plain PyTorch version
(_low_entropy_core_plain) for CPU tensors.

The host implementations in filters/read_level.py are the semantic oracle;
tests/test_torch_ops.py holds these ops against the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import trace
from .encode import PAD_CODE

KMER_LENGTH = 3          # filter_low_entropy k (arriba.cpp:408)
N_KMERS = 4 ** KMER_LENGTH


def count_mismatches_batch(bases: torch.Tensor, ref: torch.Tensor,
                           match_mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized core of count_mismatches (filter_mismatches.cpp:12-53):
    (mismatches, alignment_length) int32 per read over the M/=/X positions,
    excluding PAD/N read or reference codes."""
    valid = match_mask & (bases != PAD_CODE) & (ref != PAD_CODE)
    mismatches = (valid & (bases != ref)).sum(dim=1, dtype=torch.int32)
    alignment_length = valid.sum(dim=1, dtype=torch.int32)
    return mismatches, alignment_length


def binomial_pvalue(mismatches: torch.Tensor, alignment_length: torch.Tensor,
                    mismatch_probability: float) -> torch.Tensor:
    """Point binomial probability C(n,k) p^k (1-p)^(n-k) in float32, the
    reference's test statistic (filter_mismatches.cpp:66-79), via
    log-gamma."""
    n = alignment_length.to(torch.float32)
    k = mismatches.to(torch.float32)
    p = torch.tensor(mismatch_probability, dtype=torch.float32,
                     device=n.device)
    log_choose = (torch.lgamma(n + 1) - torch.lgamma(k + 1)
                  - torch.lgamma(n - k + 1))
    log_p = log_choose + k * torch.log(p) + (n - k) * torch.log1p(-p)
    return torch.exp(log_p)


def mismatch_filter_batch(bases, ref, match_mask, extra_mismatches,
                          mismatch_probability: float,
                          pvalue_cutoff: float) -> torch.Tensor:
    """Per-read discard mask for the mismatches filter's binomial branch."""
    mismatches, alignment_length = count_mismatches_batch(bases, ref,
                                                          match_mask)
    pvalue = binomial_pvalue(mismatches + extra_mismatches, alignment_length,
                             mismatch_probability)
    return pvalue < pvalue_cutoff


def low_entropy_thresholds(segment_length, kmer_content: float) -> np.ndarray:
    """The reference's threshold arithmetic (filter_low_entropy.cpp:67-69),
    bit-exact on the host: float32 product and quotient, +0.5 in double and
    truncation, computed as floor(q) + (frac(q) >= 0.5). Inverted windows
    (negative length) get a threshold that never trips."""
    seg = np.asarray(segment_length)
    q = (seg.astype(np.float32) * np.float32(kmer_content)) \
        / np.float32(KMER_LENGTH)
    base = np.floor(q)
    t = (base + (q - base >= np.float32(0.5))).astype(np.int32)
    return np.where(seg < 0, np.int32(1) << 30, t).astype(np.int32)


def _thresholds(length, a1s, a1e, a2s, a2e, kmer_content: float):
    host = [np.asarray(x.cpu() if torch.is_tensor(x) else x)
            for x in (length, a1s, a1e, a2s, a2e)]
    return (low_entropy_thresholds(host[0], kmer_content),
            low_entropy_thresholds(host[2] - host[1], kmer_content),
            low_entropy_thresholds(host[4] - host[3], kmer_content))


def low_entropy_batch(bases, length, aligned_start1, aligned_end1,
                      aligned_start2, aligned_end2,
                      kmer_content: float) -> torch.Tensor:
    """bool [N]: the low-entropy verdict of each row of a code matrix (on
    its tensor's device), with the thresholds computed on the host."""
    device = bases.device
    th = _thresholds(length, aligned_start1, aligned_end1, aligned_start2,
                     aligned_end2, kmer_content)
    return _low_entropy_core(
        bases, *(x.to(device) if torch.is_tensor(x)
                 else trace.upload(np.asarray(x), device) for x in (
                     length, aligned_start1, aligned_end1, aligned_start2,
                     aligned_end2)),
        *(trace.upload(t, device) for t in th))


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """[N, L] codes -> [N, ceil(L/4)] uint8, four 2-bit codes per byte, low
    bits first; codes > 3 (PAD/N) clamp to 3, exactly what the k-mer
    recurrence does with them."""
    L = codes.shape[1]
    L4 = (L + 3) // 4 * 4
    cp = np.empty((codes.shape[0], L4), np.uint8)
    np.minimum(codes, 3, out=cp[:, :L])
    cp[:, L:] = 3
    return (cp[:, 0::4] | (cp[:, 1::4] << 2) | (cp[:, 2::4] << 4)
            | (cp[:, 3::4] << 6))


def low_entropy_batch_chunked(codes, lengths, a1s, a1e, a2s, a2e,
                              kmer_content: float, chunk_rows: int = 131072,
                              device=None) -> np.ndarray:
    """Host numpy in, numpy bool out: the low-entropy scan dispatched in
    fixed-size row chunks (the last zero-padded; padded rows have length 0
    and never flag), each shipped to the device 2-bit packed."""
    if device is None:
        from ..device import torch_device
        device = torch_device()
    n = len(lengths)
    if n == 0:
        return np.zeros(0, bool)
    if int(np.max(lengths)) > codes.shape[1]:
        raise ValueError("a row is longer than the code matrix")
    if n <= chunk_rows:
        chunk_rows = n  # small batches keep their natural shape
    out = np.zeros(n, bool)
    for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        if hi - lo == chunk_rows:
            c, ln = codes[lo:hi], lengths[lo:hi]
            w = (a1s[lo:hi], a1e[lo:hi], a2s[lo:hi], a2e[lo:hi])
        else:
            pad = chunk_rows - (hi - lo)
            c = np.concatenate(
                [codes[lo:hi],
                 np.full((pad, codes.shape[1]), 3, codes.dtype)])
            ln = np.concatenate([lengths[lo:hi],
                                 np.zeros(pad, lengths.dtype)])
            w = tuple(np.concatenate([arr[lo:hi], np.zeros(pad, arr.dtype)])
                      for arr in (a1s, a1e, a2s, a2e))
        th = _thresholds(ln, *w, kmer_content)
        meta = np.stack([np.asarray(x, np.int32) for x in (ln, *w, *th)],
                        axis=1)
        flags = _low_entropy_core_packed(
            trace.upload(pack_codes(c), device), c.shape[1],
            trace.upload(meta, device))
        out[lo:hi] = flags.cpu().numpy()[:hi - lo]
    return out


def _unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    quarters = torch.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], dim=2)
    return quarters.reshape(packed.shape[0], -1)[:, :L]


def _low_entropy_core_packed(packed: torch.Tensor, L: int,
                             meta: torch.Tensor) -> torch.Tensor:
    """The scan over a packed code matrix. meta is int32 [N, 8] = (length,
    a1s, a1e, a2s, a2e, th_all, th_a1, th_a2) with length <= L. CUDA
    tensors launch K2; CPU tensors run the plain version."""
    if L > 4 * packed.shape[1]:
        raise ValueError("L exceeds the packed row")
    if packed.is_cuda:
        from .. import kernels
        return kernels.low_entropy(packed.contiguous(),
                                   meta.to(torch.int32).contiguous())
    return _low_entropy_core_plain(_unpack_codes(packed, L),
                                   *meta.unbind(dim=1))


def _low_entropy_core(bases, length, aligned_start1, aligned_end1,
                      aligned_start2, aligned_end2, th_all, th_a1,
                      th_a2) -> torch.Tensor:
    """bool [N] over an unpacked code matrix: CUDA tensors are packed on the
    device and go to K2; CPU tensors run the plain version."""
    if bases.is_cuda:
        n, L = bases.shape
        L4 = (L + 3) // 4 * 4
        cp = torch.full((n, L4), 3, dtype=torch.uint8, device=bases.device)
        cp[:, :L] = bases.clamp(max=3).to(torch.uint8)
        packed = (cp[:, 0::4] | (cp[:, 1::4] << 2) | (cp[:, 2::4] << 4)
                  | (cp[:, 3::4] << 6))
        meta = torch.stack([x.to(torch.int32) for x in (
            length, aligned_start1, aligned_end1, aligned_start2,
            aligned_end2, th_all, th_a1, th_a2)], dim=1)
        return _low_entropy_core_packed(packed, L, meta)
    return _low_entropy_core_plain(bases, length, aligned_start1,
                                   aligned_end1, aligned_start2, aligned_end2,
                                   th_all, th_a1, th_a2)


def _low_entropy_core_plain(bases, length, aligned_start1, aligned_end1,
                            aligned_start2, aligned_end2, th_all, th_a1,
                            th_a2) -> torch.Tensor:
    """The plain PyTorch version of K2: filter_low_entropy.cpp:60-100 per
    read, sequential over positions and vectorized over rows.

    For K = 3 the reference's greedy non-overlapping selection has a key
    property: position p is selected iff it is eligible (p < length - 3)
    and the SAME 3-mer was selected neither at p-1 nor at p-2, so the scan
    carries two selection bits per row. The early-exit check of the
    reference is monotone in the counters, so it is evaluated on the final
    counters, restricted to 3-mers counted at least once."""
    n, L = bases.shape
    device = bases.device
    codes = bases.clamp(max=3).to(torch.int64)
    kv = ((codes << 4) | (torch.roll(codes, -1, dims=1) << 2)
          | torch.roll(codes, -2, dims=1))
    length = length.to(torch.int64)
    bounds = [x.to(torch.int64) for x in (aligned_start1, aligned_end1,
                                          aligned_start2, aligned_end2)]
    counts = torch.zeros(3, n, N_KMERS, dtype=torch.int32, device=device)
    sel1 = torch.zeros(n, dtype=torch.bool, device=device)
    sel2 = torch.zeros_like(sel1)
    kv1 = torch.zeros(n, dtype=torch.int64, device=device)
    kv2 = torch.zeros_like(kv1)
    n_pos = min(L, max(0, int(length.max()) - KMER_LENGTH)) if n else 0
    for p in range(n_pos):
        v = kv[:, p]
        sel = ((p < length - KMER_LENGTH) & ~(sel1 & (v == kv1))
               & ~(sel2 & (v == kv2)))
        in_a1 = sel & (p + 1 >= bounds[0]) & (p < bounds[1])
        in_a2 = sel & (p + 1 >= bounds[2]) & (p < bounds[3])
        for plane, mask in enumerate((sel, in_a1, in_a2)):
            counts[plane].scatter_add_(1, v[:, None],
                                       mask[:, None].to(torch.int32))
        sel2, kv2, sel1, kv1 = sel1, kv1, sel, v
    c_all, c_a1, c_a2 = counts
    crossed = (c_all >= 1) & ((c_all >= th_all[:, None])
                              | (c_a1 >= th_a1[:, None])
                              | (c_a2 >= th_a2[:, None]))
    return crossed.any(dim=1) & (length >= KMER_LENGTH)


def homopolymer_run_batch(windows: torch.Tensor) -> torch.Tensor:
    """Longest run of identical non-PAD codes per row ([N, W] -> int32 [N]).
    The host builds the two breakpoint-adjacent windows with a PAD separator
    (filter_homopolymer.cpp:22-40 concatenates them with ' ')."""
    same = (windows[:, 1:] == windows[:, :-1]) & (windows[:, 1:] != PAD_CODE)
    run = torch.ones(windows.shape[0], dtype=torch.int32,
                     device=windows.device)
    best = run.clone()
    for i in range(windows.shape[1] - 1):
        run = torch.where(same[:, i], run + 1, 1)
        best = torch.maximum(best, run)
    return best


def read_filter_step(bases, ref, match_mask, length, aligned_start,
                     aligned_end, extra_mismatches,
                     mismatch_probability: float = 0.01,
                     pvalue_cutoff: float = 0.01,
                     kmer_content: float = 0.6) -> dict:
    """The fused per-read step: every read-level filter statistic of a
    ReadBatch in one call. Unlike the JAX step, whose low-entropy thresholds
    are float32 math inside the traced graph, the thresholds come from the
    host (bit-exact, as in low_entropy_batch)."""
    mismatches, alignment_length = count_mismatches_batch(bases, ref,
                                                          match_mask)
    pvalue = binomial_pvalue(mismatches + extra_mismatches, alignment_length,
                             mismatch_probability)
    low_entropy_discard = low_entropy_batch(bases, length, aligned_start,
                                            aligned_end, aligned_start,
                                            aligned_end, kmer_content)
    return {
        "mismatches": mismatches,
        "alignment_length": alignment_length,
        "pvalue": pvalue,
        "mismatch_discard": pvalue < pvalue_cutoff,
        "low_entropy_discard": low_entropy_discard,
    }
