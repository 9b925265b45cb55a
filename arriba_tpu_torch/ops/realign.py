"""Batched realignment screening for filter_mismappers, in PyTorch.

The reference re-aligns each clipped segment / discordant mate against the
partner gene with a recursive 8-mer-seeded seed-and-extend aligner
(filter_mismappers.cpp:86-230). The device path splits the candidate
(read, window) pairs into a tri-state verdict before that recursion:

0. `resident_pairs` copies the distinct gene windows and reads of a call
   to the device once; a (read, window) pair is then two ids, and the two
   steps below read the bytes there.
1. `screen_pairs` / `screen_resident` -> `kmer_bitmap_screen`, a *sound
   REJECT*: align() can only accept a read if at least one 8-mer of the
   read occurs in the padded gene window (the seed lookup at
   filter_mismappers.cpp:97-99). CUDA tensors run the hand-written kernel
   K5 (kernels/csrc/kmer_bitmap_screen.cu: each window's 8-mers set in a
   bitmap once, over the slices `screen_schedule` cuts, then its pairs'
   read 8-mers tested against it), CPU tensors `kmer_bitmap_screen_plain`.
   `shared_kmer_mask`, the per-row sorted screen of the JAX package (a
   sort plus a batched searchsorted), stays for the realign step below.
2. `accept_pairs` / `accept_resident` -> `accept_wavefront_indexed` (rows
   that read the resident tables by offset; `accept_wavefront` takes dense
   rows), an *exact single-seed ACCEPT*:
   every single-seed align() path (seed 8-mer, left extension with <= 1
   mismatch, right extension at +1/-1 with the 4-consecutive-mismatch
   break, the outer-loop seed bound and the k-mer-index range) evaluated
   per (read, window) row. CUDA tensors run the hand-written kernel K1
   (kernels/csrc/accept_wavefront.cu, which looks the read's eligible
   8-mers up in the window and walks only the diagonals they name, or
   every diagonal of a row whose min_score an unseeded walk can reach);
   CPU tensors run
   `accept_wavefront_plain`, a step-for-step twin of the JAX package's
   wavefront. A device ACCEPT is sound (align() necessarily accepts);
   splice/deletion recursion chains stay host-only, so a device reject
   decides nothing.
   `mxu_shared_kmer_mask` gives the same verdict through a one-hot
   product with a fused any(dot == 8): the hand-written kernel K4 on the
   int8 tensor cores (kernels/csrc/mxu_kmer_screen.cu) for CUDA tensors,
   `mxu_shared_kmer_mask_plain` on the CPU. No CLI path uses it.
3. `realign_step`, the data-parallel path's fused prefilter and scoring
   step: the 8-mer screen plus `smith_waterman_scores`, the best local
   alignment score per row. CUDA tensors run the hand-written kernel K3
   (kernels/csrc/smith_waterman.cu), or K3w (smith_waterman_wide.cu) for
   reads past 512 positions, scores past 16 bits or bytes above 4; CPU
   tensors run
   `smith_waterman_scores_plain`, the twin of the JAX package's wavefront.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import trace
from ..kernels import KB_SLICE
from ..seq import COMPLEMENT_LUT as _COMPLEMENT_LUT
from .encode import PAD_CODE

SEED_KMER_LENGTH = 8  # arriba.cpp:549


def _packed_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[N, L] 2-bit-packable codes -> int32 [N, L] k-mer values (positions
    whose k-mer would run off the end or cover PAD yield -1)."""
    values = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    any_pad = torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        shifted = torch.roll(codes, -j, dims=1)
        values = (values << 2) | shifted.clamp(max=3).to(torch.int32)
        any_pad = any_pad | (shifted == PAD_CODE)
    L = codes.shape[1]
    in_range = torch.arange(L, device=codes.device)[None, :] <= L - k
    return torch.where(in_range & ~any_pad, values, -1)


def shared_kmer_mask(reads: torch.Tensor, windows: torch.Tensor,
                     k: int = SEED_KMER_LENGTH) -> torch.Tensor:
    """bool [N]: does any k-mer of read n occur in window n? Sort the window
    k-mer values per row, then search the read k-mers in them."""
    read_kmers = _packed_kmers(reads, k).contiguous()
    window_kmers = torch.sort(_packed_kmers(windows, k), dim=1).values
    idx = torch.searchsorted(window_kmers, read_kmers)
    idx = idx.clamp(max=window_kmers.shape[1] - 1)
    found = torch.gather(window_kmers, 1, idx) == read_kmers
    return (found & (read_kmers >= 0)).any(dim=1)


def mxu_shared_kmer_mask_plain(reads: torch.Tensor, windows: torch.Tensor,
                               k: int = SEED_KMER_LENGTH,
                               w_chunk: int = 512) -> torch.Tensor:
    """The plain PyTorch version of K4, and the JAX package's
    mxu_shared_kmer_mask step for step: each k-mer one-hot per base in 4k
    lanes (a byte above 3, PAD included, one-hots to zeros, so a k-mer
    covering one cannot reach k), a batched product against the window's
    k-mers in w_chunk tiles, any(dot == k). The dots are integers of at
    most 4k: int32 on the CPU, float32 (exact for them) on the card, where
    PyTorch has no integer batched product. bool [N]."""
    n, L = reads.shape
    W = windows.shape[1]
    device = reads.device
    R, WK = L - k + 1, W - k + 1
    verdict = torch.zeros(n, dtype=torch.bool, device=device)
    if R <= 0 or WK <= 0 or n == 0:
        return verdict
    dtype = torch.float32 if reads.is_cuda else torch.int32
    bases = torch.arange(4, device=device)

    def onehot(codes, n_pos):
        stacked = torch.stack([codes[:, j:j + n_pos] for j in range(k)], -1)
        return (stacked[..., None] == bases).to(dtype).reshape(
            codes.shape[0], n_pos, 4 * k)

    read_oh = onehot(reads, R)                                # [N, R, 4k]
    n_chunks = -(-WK // w_chunk)
    pad = torch.full((n, n_chunks * w_chunk + k - 1 - W), PAD_CODE,
                     dtype=windows.dtype, device=device)
    win_pad = torch.cat([windows, pad], dim=1)
    for lo in range(0, n_chunks * w_chunk, w_chunk):
        win_oh = onehot(win_pad[:, lo:lo + w_chunk + k - 1], w_chunk)
        dots = torch.bmm(read_oh, win_oh.transpose(1, 2))     # [N, R, Wc]
        verdict |= (dots == k).flatten(1).any(dim=1)
    return verdict


def mxu_shared_kmer_mask(reads: torch.Tensor, windows: torch.Tensor,
                         k: int = SEED_KMER_LENGTH,
                         w_chunk: int = 512) -> torch.Tensor:
    """bool [N]: does any k-mer of read n occur in window n, as the one-hot
    product decides it (mxu_shared_kmer_mask_plain)? CUDA tensors run the
    hand-written kernel K4 (kernels/csrc/mxu_kmer_screen.cu, int8 tensor
    cores: its k = 8 kernel, or its any-k kernel for any other k from 1 on;
    w_chunk, a tiling of the plain version, does not change the verdict);
    CPU tensors the plain version. No CLI path calls it, as in the JAX
    package (whose bench does)."""
    if reads.is_cuda:
        from .. import kernels
        return kernels.mxu_kmer_screen(reads.contiguous(),
                                       windows.contiguous(), k)
    return mxu_shared_kmer_mask_plain(reads, windows, k, w_chunk)


def smith_waterman_scores_plain(reads, windows, match: int = 1,
                                mismatch: int = -1,
                                gap: int = -1) -> torch.Tensor:
    """The plain PyTorch version of K3: int32 [N], the best local alignment
    score of each (read, window) row (match / mismatch substitution,
    linear gap, floor 0, h = 0 wherever either byte is PAD_CODE). A step-
    for-step twin of the JAX package's anti-diagonal wavefront: L + W - 1
    steps over [N, L], carrying the two previous diagonals."""
    n, L = reads.shape
    W = windows.shape[1]
    device = reads.device
    # reversed and padded windows: diagonal d reads wrev[:, W-1-d+L : ...+L]
    wrev = torch.flip(windows, dims=[1])
    pad = torch.full((n, L), PAD_CODE, dtype=windows.dtype, device=device)
    wrev = torch.cat([pad, wrev, pad], dim=1)
    read_valid = reads != PAD_CODE
    zero_col = torch.zeros((n, 1), dtype=torch.int32, device=device)
    h_prev = torch.zeros((n, L), dtype=torch.int32, device=device)
    h_prev2 = h_prev
    best = torch.zeros(n, dtype=torch.int32, device=device)
    match_t, mismatch_t = (torch.tensor(x, dtype=torch.int32, device=device)
                           for x in (match, mismatch))
    for d in range(L + W - 1):
        window_diag = wrev[:, W - 1 - d + L:W - 1 - d + 2 * L]  # windows[d-i]
        substitution = torch.where(reads == window_diag, match_t, mismatch_t)
        valid = read_valid & (window_diag != PAD_CODE)
        # the previous diagonals shifted one read position for the i-1 terms
        h_prev_shift = torch.cat([zero_col, h_prev[:, :-1]], dim=1)
        h_prev2_shift = torch.cat([zero_col, h_prev2[:, :-1]], dim=1)
        h = torch.maximum((h_prev2_shift + substitution).clamp(min=0),
                          torch.maximum(h_prev_shift + gap, h_prev + gap))
        h = torch.where(valid, h, 0)
        best = torch.maximum(best, h.amax(dim=1))
        h_prev2, h_prev = h_prev, h
    return best


def smith_waterman_scores(reads, windows, match: int = 1, mismatch: int = -1,
                          gap: int = -1) -> torch.Tensor:
    """int32 [N] best local alignment scores: for CUDA tensors K3, or K3w
    where K3 cannot carry the shapes, scores or bytes (kernels.sw_route);
    the plain version for CPU tensors. PAD is byte 4; any other byte is
    compared whole, as the JAX op does."""
    if reads.is_cuda:
        from .. import kernels
        return kernels.smith_waterman(reads.contiguous(),
                                      windows.contiguous(), match, mismatch,
                                      gap)
    return smith_waterman_scores_plain(reads, windows, match, mismatch, gap)


def realign_step(reads, windows, length,
                 min_score_fraction: float = 0.8) -> dict:
    """The fused prefilter and scoring step for a batch of (read, window)
    rows: per-row seed hits, SW scores, and whether the row can possibly be
    accepted by the reference aligner (seed present AND local score >=
    min_align_fraction * read length, in float32 as the JAX step has it)."""
    seeds = shared_kmer_mask(reads, windows)
    scores = smith_waterman_scores(reads, windows)
    fraction = torch.tensor(min_score_fraction, dtype=torch.float32,
                            device=length.device)
    min_score = (fraction * length.to(torch.float32) + 0.5).to(torch.int32)
    return {"seed_hit": seeds, "sw_score": scores,
            "can_align": seeds & (scores >= min_score)}


# ---------------------------------------------------------------------------
# host-facing batching for the mismappers prefilter (filters/mismappers.py)

# The screen codes bytes as the native kmer_to_int does
# (filter_mismappers.cpp:33-45, _kmer_codes_bytes): T=0, G=1, C=2,
# everything else (incl. A and N) = 3 — so device read k-mers are a superset
# of the native seed lookups and window k-mers a superset of the native
# index (which drops N-start positions): the screen can only err permissive.
# The reverse complement is coded after the CHARACTER is complemented (N
# stays N and keeps code 3; a bare `code ^ 3` would wrongly send N -> code
# 0): K5 codes the raw reverse complement row that K1 reads.


def _device(device):
    if device is None:
        from ..device import torch_device
        return torch_device()
    return device


# ---------------------------------------------------------------------------
# the resident tables: each distinct gene window and read on the device once
#
# The windows of a call are gene windows, views into the assembly's contigs
# (filters/mismappers.collect_screen_tasks), and many reads share each one.
# resident_pairs copies every distinct window (named by the caller's window
# id, or keyed by its view's address and length) once into one byte table
# and every distinct read sequence once into a read table; a (read, window)
# pair is then two ids, a row of K1 a few integers. K5, the 8-mer bitmap
# screen, and K1's indexed entry read the bytes there.

_WINDOW_ALIGN = 16   # each window starts on a 16-byte boundary of the table


@dataclasses.dataclass
class ResidentPairs:
    """(read, window) pairs with their distinct windows and reads on one
    device. Each window sits in ``table`` (uint8) at ``win_offset`` for
    ``win_len`` bytes, from a 16-byte boundary, followed by _PAD_WIN up to
    the next and kernels.AW_TABLE_SLACK bytes past the last. Read r is rows
    2 r (forward) and 2 r + 1 (reverse complement) of ``accept_reads``
    (raw bytes, _PAD_READ past the read), which K1 reads as they are and K5
    codes as _kmer_codes_bytes does. ``uploaded`` counts the bytes
    copied to the device: the windows, the reads, and the rows' integers
    that screen_resident and accept_resident add."""
    device: torch.device
    pair_read: np.ndarray      # int64 [pairs]
    pair_window: np.ndarray    # int64 [pairs]
    read_len: np.ndarray       # int64 [reads]
    win_offset: np.ndarray     # int64 [windows]
    win_len: np.ndarray        # int64 [windows]
    table: torch.Tensor
    accept_reads: torch.Tensor
    uploaded: dict


def _row_width(longest: int, least: int) -> int:
    return -(-max(least, longest) // 64) * 64


def _view_ids(window_views) -> np.ndarray:
    """int64 [n]: an id a window view, in order of first sight, the same
    for views of one buffer at one address with one length and stride."""
    ids: dict = {}
    return np.fromiter(
        (ids.setdefault((w.__array_interface__["data"][0], len(w),
                         w.strides), len(ids))
         for w in map(np.asarray, window_views)), np.int64,
        len(window_views))


@trace.spanned("screen.resident_pairs")
def resident_pairs(read_seqs, window_views, device=None,
                   window_ids=None) -> ResidentPairs:
    """Copy the distinct windows and reads of (read_seqs[i],
    window_views[i]) pairs to the device once (ResidentPairs). read_seqs:
    list of str; window_views: list of uint8 numpy arrays, views into the
    assembly; window_ids: an int a pair, equal for pairs of one window
    (collect_screen_tasks gives them), else views of one buffer at one
    address, length and stride share a window (_view_ids)."""
    from .. import kernels

    device = _device(device)
    read_ids: dict = {}
    pair_read = np.fromiter((read_ids.setdefault(seq, len(read_ids))
                             for seq in read_seqs), np.int64, len(read_seqs))
    ids = _view_ids(window_views) if window_ids is None else np.asarray(
        window_ids, np.int64)
    _, first, pair_window = np.unique(ids, return_index=True,
                                      return_inverse=True)
    pair_window = pair_window.reshape(-1).astype(np.int64)
    windows = [np.asarray(window_views[i], np.uint8) for i in first]

    win_len = np.fromiter(map(len, windows), np.int64, len(windows))
    span = -(-win_len // _WINDOW_ALIGN) * _WINDOW_ALIGN
    win_offset = np.cumsum(span) - span
    host = np.full(int(span.sum()) + kernels.AW_TABLE_SLACK, _PAD_WIN,
                   np.uint8)
    for window, offset, length in zip(windows, win_offset, win_len):
        host[offset:offset + length] = window

    seqs = list(read_ids)
    read_len = np.fromiter(map(len, seqs), np.int64, len(seqs))
    width = _row_width(int(read_len.max(initial=0)), 16)
    # each read and its reversal as a row of width bytes, 0 (_PAD_READ) past
    # the read
    pad = chr(_PAD_READ)
    fwd, back = (np.frombuffer("".join(
        (seq if forward else seq[::-1]).ljust(width, pad) for seq in seqs)
        .encode("latin-1"), np.uint8).reshape(len(seqs), width)
        for forward in (True, False))
    accept = np.empty((2 * len(seqs), width), np.uint8)
    accept[0::2] = fwd
    accept[1::2] = _COMPLEMENT_LUT[back]
    return ResidentPairs(
        device, pair_read, pair_window, read_len, win_offset, win_len,
        trace.upload(host, device), trace.upload(accept, device),
        {"windows": host.nbytes, "reads": accept.nbytes, "rows": 0})


# K5's rows a block tests against one window's bitmap (screen_tasks): of
# 32, 64, 128 and 256 the fastest on the main path's own launch and on the
# main case on an H100 (32 wins where one window's rows are all a launch
# has; PERF.md)
KB_TASK_ROWS = 64


def screen_tasks(row_window: np.ndarray, rows_per_task: int = KB_TASK_ROWS):
    """Order the rows by window and cut each window's rows into tasks of at
    most rows_per_task: (order, int32 [tasks, 3] = (window, first row, end
    row) of the rows in that order)."""
    order = np.argsort(row_window, kind="stable")
    ordered = row_window[order]
    starts = np.flatnonzero(np.r_[True, ordered[1:] != ordered[:-1]]) if len(
        ordered) else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], len(ordered)].astype(np.int64)
    pieces = -(-(ends - starts) // rows_per_task)
    run = np.repeat(np.arange(len(starts)), pieces)
    begin = starts[run] + rows_per_task * (
        np.arange(len(run)) - np.repeat(np.cumsum(pieces) - pieces, pieces))
    end = np.minimum(begin + rows_per_task, ends[run])
    tasks = np.stack([ordered[begin], begin, end], 1).astype(np.int32)
    return order, tasks.reshape(-1, 3)


def _task_rows(tasks: torch.Tensor, n: int) -> torch.Tensor:
    """int64 [n]: each row's window as the tasks name it, -1 for a row no
    task names."""
    t = tasks.long()
    counts = (t[:, 2].clamp(max=n) - t[:, 1].clamp(min=0)).clamp(min=0)
    first = torch.repeat_interleave(t[:, 1].clamp(min=0), counts)
    step = torch.arange(int(counts.sum()), device=tasks.device) - \
        torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    row_window = torch.full((n,), -1, dtype=torch.int64, device=tasks.device)
    row_window[first + step] = torch.repeat_interleave(t[:, 0], counts)
    return row_window


def kmer_bitmap_screen_plain(reads, table, offsets, lengths, row_read,
                             tasks) -> torch.Tensor:
    """The plain PyTorch version of K5: bool [N], does an 8-mer of read
    row_read[r] in either orientation (its raw rows 2 r and 2 r + 1 of
    reads, _PAD_READ past the read; an 8-mer covering it counts not) occur
    in the window the tasks give row r (its bytes
    table[offsets[w]:][:lengths[w]])? Both are coded as _kmer_codes_bytes
    codes them; the window 8-mers as sorted (window, 8-mer) keys, the read 8-mers
    searched in them, 4,096 rows at a time."""
    n = row_read.shape[0]
    device = reads.device
    verdict = torch.zeros(n, dtype=torch.bool, device=device)
    row_window = _task_rows(tasks, n)
    used = torch.unique(row_window[row_window >= 0])
    if n == 0 or len(used) == 0:
        return verdict
    k = SEED_KMER_LENGTH
    n_pos = (lengths.long()[used] - (k - 1)).clamp(min=0)
    start = torch.repeat_interleave(offsets[used], n_pos) + (
        torch.arange(int(n_pos.sum()), device=device)
        - torch.repeat_interleave(torch.cumsum(n_pos, 0) - n_pos, n_pos))
    kmer = torch.zeros_like(start)
    for t in range(k):
        kmer = kmer * 4 + _kmer_codes_bytes(table[start + t].long())
    keys = torch.unique(torch.repeat_interleave(used, n_pos) * 4 ** k + kmer)
    for a in range(0, n, 4096):
        rows = torch.arange(a, min(a + 4096, n), device=device)
        read = row_read[rows].long()
        raw = torch.stack([reads[2 * read], reads[2 * read + 1]], 1)
        codes = torch.where(raw == _PAD_READ, PAD_CODE,
                            _kmer_codes_bytes(raw.long())).to(torch.uint8)
        kmers = _packed_kmers(codes.flatten(0, 1), k).reshape(
            len(rows), -1).long()
        query = row_window[rows, None] * 4 ** k + kmers
        at = torch.searchsorted(keys, query).clamp(max=len(keys) - 1)
        hit = (keys[at] == query) & (kmers >= 0) & (
            row_window[rows, None] >= 0)
        verdict[rows] = hit.any(dim=1)
    return verdict


def kmer_bitmap_screen(reads, table, offsets, lengths, row_read, tasks,
                       schedule=None):
    """bool [N]: K5 for CUDA tensors (its build pass over the windows'
    slices that schedule gives, then its test pass; without a schedule,
    screen_schedule makes one from tasks and lengths, which waits for the
    card), the plain version for CPU tensors (see kmer_bitmap_screen_plain),
    which needs no schedule."""
    if reads.is_cuda:
        from .. import kernels
        if schedule is None:
            schedule = screen_schedule(tasks.cpu().numpy(),
                                       lengths.cpu().numpy(),
                                       device=tasks.device)
        return kernels.kmer_bitmap_screen(reads, table, offsets, lengths,
                                          row_read, tasks, schedule)
    return kmer_bitmap_screen_plain(reads, table, offsets, lengths,
                                    row_read, tasks)


@dataclasses.dataclass
class ScreenSchedule:
    """Where K5's build pass sets each window's bitmap once (screen_schedule):
    the windows its tasks name, ranked, each cut into slices."""
    rank_window: torch.Tensor  # int32 [used]: the window id of each rank
    task_rank: torch.Tensor    # int32 [tasks]: each task's window's rank
    slices: torch.Tensor       # int32 [slices, 2]: (rank, first position)
    slice_len: int             # positions a slice

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in (self.rank_window, self.task_rank, self.slices))


def screen_schedule(tasks: np.ndarray, lengths: np.ndarray,
                    slice_len: int = KB_SLICE,
                    device=None) -> ScreenSchedule:
    """K5's schedule for tasks int32 [K, 3] over windows of lengths, in
    numpy: the distinct window ids the tasks name that lie in [0, len(
    lengths)), in increasing order, ranked 0, 1, ... (task_rank -1 for a
    task whose id lies outside), and each ranked window's positions [0,
    lengths - 7) cut into slices of slice_len from 0 (none for a window too
    short for an 8-mer); the tensors on device."""
    window = np.asarray(tasks, np.int64).reshape(-1, 3)[:, 0]
    valid = (window >= 0) & (window < len(lengths))
    rank_window, rank = np.unique(window[valid], return_inverse=True)
    task_rank = np.full(len(window), -1, np.int32)
    task_rank[valid] = rank.reshape(-1)
    n_pos = np.maximum(np.asarray(lengths, np.int64)[rank_window] - 7, 0)
    count = -(-n_pos // slice_len)
    slice_rank = np.repeat(np.arange(len(rank_window)), count)
    first = slice_len * (np.arange(len(slice_rank))
                         - np.repeat(np.cumsum(count) - count, count))
    slices = np.stack([slice_rank, first], 1).astype(np.int32)
    return ScreenSchedule(*(trace.upload(x, _device(device)) for x in (
        rank_window.astype(np.int32), task_rank, slices.reshape(-1, 2))),
        slice_len)


def screen_inputs(resident: ResidentPairs, pairs: np.ndarray,
                  rows_per_task: int = KB_TASK_ROWS,
                  slice_len: int = KB_SLICE):
    """K5's inputs for the pairs of resident named by index: (order, (reads,
    table, offsets, lengths, row_read, tasks), schedule), the rows being the
    pairs in that order (sorted by window, screen_tasks, rows_per_task a
    task), the windows the tasks name cut into slices of slice_len positions
    (screen_schedule) and the tensors on the resident tables' device."""
    device = resident.device
    order, tasks = screen_tasks(resident.pair_window[pairs], rows_per_task)
    lengths = resident.win_len.astype(np.int32)
    host = (resident.win_offset, lengths,
            resident.pair_read[pairs[order]].astype(np.int32), tasks)
    schedule = screen_schedule(tasks, lengths, slice_len, device)
    resident.uploaded["rows"] += (sum(x.nbytes for x in host)
                                  + schedule.nbytes())
    offsets, lengths, row_read, tasks = (trace.upload(x, device)
                                         for x in host)
    return order, (resident.accept_reads, resident.table, offsets, lengths,
                   row_read, tasks), schedule


def screen_launches(resident: ResidentPairs, batch_rows: int = 1 << 20):
    """K5's launches over every pair of resident, batch_rows pairs each,
    the pairs sorted by window: (the pairs in the launch's row order,
    kmer_bitmap_screen's arguments, its schedule) a launch."""
    order = np.argsort(resident.pair_window, kind="stable")
    for a in range(0, len(order), batch_rows):
        pairs = order[a:a + batch_rows]
        within, args, schedule = screen_inputs(resident, pairs)
        yield pairs[within], args, schedule


@trace.spanned("screen.k5")
def screen_resident(resident: ResidentPairs,
                    batch_rows: int = 1 << 20) -> np.ndarray:
    """[n] bool per pair of resident: the read shares an 8-mer with its
    window in either orientation, K5 over the resident tables
    (kmer_bitmap_screen), batch_rows pairs a launch (screen_launches)."""
    result = np.zeros(len(resident.pair_read), bool)
    for pairs, args, schedule in screen_launches(resident, batch_rows):
        result[pairs] = kmer_bitmap_screen(
            *args, schedule=schedule).cpu().numpy()
    return result


def screen_pairs(read_seqs, window_views, window_chunk: int = 8192,
                 batch_rows: int = 1 << 20, device=None) -> np.ndarray:
    """[n] bool per (read, window) pair: the pair shares an 8-mer in either
    read orientation (a sound prefilter for the reference aligner — a pair
    without a shared seed can never be accepted by align()).

    Only the seed criterion is used: a plain -1-gap local alignment score is
    NOT a sound upper bound on the reference's accept score, because align()
    grants free gaps at splice sites / on its single-deletion recursion and
    double credit when re-covering skipped leading bases
    (filter_mismappers.cpp:117-170).

    read_seqs: list of str (the sequences align_both_strands would try);
    window_views: list of uint8 numpy views into the assembly (the padded
    gene windows). The distinct windows and reads go to the device once
    (resident_pairs) and each pair is tested against its whole window
    (screen_resident), batch_rows pairs a launch. window_chunk is ignored:
    the JAX package cuts long windows into chunks of window_chunk bytes
    overlapping by 7, so that every 8-mer of a window lies whole in one
    chunk, and the verdict is the same for any window_chunk."""
    if len(read_seqs) == 0:
        return np.zeros(0, bool)
    return screen_resident(resident_pairs(read_seqs, window_views, device),
                           batch_rows=batch_rows)


# ---------------------------------------------------------------------------
# exact device ACCEPT: align()'s single-seed (no-recursion) paths
#
# align() (filter_mismappers.cpp:86-187) accepts a read iff SOME search path
# reaches min_score. Its paths decompose into single-seed paths (seed 8-mer,
# left extension with <= 1 mismatch, right extension at +1/-1 with a break
# after 4 consecutive mismatches, free leading skips at the top level) and
# recursion-chained paths (re-seeding after a splice-site boundary or one
# deletion). The accept wavefront evaluates EVERY single-seed path exactly,
# so `accept=True` is sound; `accept=False` decides nothing — the pair falls
# back to the host recursion. Bytes are compared raw (the reference compares
# characters, filter_mismappers.cpp:117,160), k-mers in the T=0/G=1/C=2/
# other=3 code of kmer_to_int (filter_mismappers.cpp:33-45).

_PAD_READ = 0     # never a sequence byte
_PAD_WIN = 1
_NEG = -(2 ** 20)


def _kmer_codes_bytes(raw: torch.Tensor) -> torch.Tensor:
    """Raw sequence bytes -> kmer_to_int base codes (T0 G1 C2 other 3)."""
    return torch.where(raw == ord("T"), 0,
                       torch.where(raw == ord("G"), 1,
                                   torch.where(raw == ord("C"), 2, 3)))


def accept_wavefront_plain(reads, windows, read_len, win_len, min_score,
                           seed_lo, seed_hi) -> torch.Tensor:
    """The plain PyTorch version of K1: bool [N] per (read, window) row, a
    step-for-step twin of the JAX package's _accept_wavefront_kernel.

    Every diagonal is evaluated by an anti-diagonal wavefront with per-cell
    carries (cell (i, j) at step d = i + j, predecessor (i-1, j-1) two
    steps back, one lane up):
      a     consecutive byte-matches ending here
      b     byte-matches scanning left until the 2nd mismatch (the left
            extension value of a seed starting at i+1)
      q     consecutive code-matches (8-mer streak detector)
      bsave b at the cell before the current code streak began
      sok   streak-start eligibility (outer-loop p bound, window k-mer
            range, window start char != 'N') latched at streak start
      cons  consecutive byte-mismatches of the active right-extension walk
      sc    best active walk score (max over fired seeds on this diagonal)
    A seed fires when q == 8 & sok with candidate 8 + bsave; accept when a
    candidate is >= min_score at fire time or an active walk reaches
    min_score on a byte-match. Steps past the last valid cell, and steps
    after every row has accepted, cannot change the verdict and are
    skipped."""
    N, L = reads.shape
    W = windows.shape[1]
    device = reads.device
    if N == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    read_len = read_len.to(torch.int32)
    win_len = win_len.to(torch.int32)
    min_score = min_score.to(torch.int32)
    wrev = torch.flip(windows, dims=[1])
    pad = torch.full((N, L), _PAD_WIN, dtype=windows.dtype, device=device)
    wrev = torch.cat([pad, wrev, pad], dim=1)

    read_b = reads.to(torch.int32)
    kc_r = _kmer_codes_bytes(read_b)
    lane = torch.arange(L, dtype=torch.int32, device=device)[None, :]
    r_valid = lane < read_len[:, None]
    p_eligible = ((lane + 8 < read_len[:, None])
                  & (2 * lane <= (read_len + 16 - min_score)[:, None]))
    ms = min_score[:, None]
    wl = win_len[:, None]
    slo = seed_lo.to(torch.int32)[:, None].clamp(min=0)
    shi = seed_hi.to(torch.int32)[:, None]

    def shift(p, fill):
        col = torch.full((N, 1), fill, dtype=p.dtype, device=device)
        return torch.cat([col, p[:, :-1]], dim=1)

    zeros = torch.zeros((N, L), dtype=torch.int32, device=device)
    falses = torch.zeros((N, L), dtype=torch.bool, device=device)
    negs = torch.full((N, L), _NEG, dtype=torch.int32, device=device)
    empty = (zeros, zeros, zeros, zeros, falses, zeros, negs)
    prev, prev2 = empty, empty
    accept = torch.zeros(N, dtype=torch.bool, device=device)
    last_cell = (int(read_len.clamp(0, L).max()) - 1
                 + int(win_len.clamp(max=W).max()) - 1)
    for d in range(min(L + W - 1, last_cell + 1)):
        if d % 256 == 255 and bool(accept.all()):
            break
        a_p, b_p, q_p, bs_p, sok_p, cons_p, sc_p = prev2
        window_diag = wrev[:, W - 1 - d + L:W - 1 - d + 2 * L].to(torch.int32)
        j = d - lane
        v = r_valid & (j >= 0) & (j < wl)
        m = (read_b == window_diag) & v
        cm = (kc_r == _kmer_codes_bytes(window_diag)) & v

        # diagonal predecessor (i-1, j-1): two steps back, one lane up
        a_in = shift(a_p, 0)
        b_in = shift(b_p, 0)
        q_in = shift(q_p, 0)
        bs_in = shift(bs_p, 0)
        sok_in = shift(sok_p, False)
        cons_in = shift(cons_p, 0)
        sc_in = shift(sc_p, _NEG)

        a = torch.where(m, a_in + 1, 0)
        b = torch.where(v, torch.where(m, b_in + 1, a_in), 0)
        q = torch.where(cm, q_in + 1, 0)
        starts = cm & (q_in == 0)
        elig = (p_eligible & (j >= slo) & (j <= shi) & (j <= wl - 10)
                & (window_diag != ord("N")))
        sok = torch.where(cm, torch.where(starts, elig, sok_in), False)
        bsave = torch.where(cm, torch.where(starts, b_in, bs_in), 0)

        fired = (q == 8) & sok
        candidate = 8 + bsave

        cons = torch.where(v, torch.where(m, 0, cons_in + 1), 0)
        sc_step = torch.where(m, sc_in + 1, sc_in - 1)
        sc_step = torch.where(v & (torch.where(m, 0, cons) < 4), sc_step,
                              _NEG)
        accept = (accept | (m & (sc_step >= ms)).any(dim=1)
                  | (fired & (candidate >= ms)).any(dim=1))
        sc = torch.maximum(sc_step, torch.where(fired, candidate, _NEG))
        prev2, prev = prev, (a, b, q, bsave, sok, cons, sc)
    return accept


def accept_wavefront(reads, windows, params) -> torch.Tensor:
    """bool [N]: K1 for CUDA tensors, the plain version for CPU tensors.
    params is int32 [N, 5] = (read_len, win_len, min_score, seed_lo,
    seed_hi)."""
    if reads.is_cuda:
        from .. import kernels
        return kernels.accept_wavefront(reads.contiguous(),
                                        windows.contiguous(),
                                        params.to(torch.int32).contiguous())
    return accept_wavefront_plain(reads, windows, *params.unbind(dim=1))


def accept_rows(read_len: np.ndarray, win_len: np.ndarray,
                min_scores: np.ndarray, L: int, window_chunk: int = 8192):
    """K1's rows of pairs (read_len, win_len, min_score), as the JAX
    package's accept_pairs cuts them: each window into chunks of
    window_chunk bytes at a stride of window_chunk - 2 L, chunk 0 seeding
    in [0, stride + L - 1], a later chunk in [L, L + stride - 1] and only if
    it holds at least L + 10 bytes; the chunks end with the first that
    reaches the window's end. Each chunk gives a forward row, then a
    reverse complement row. Returns (pair, orientation 0 / 1, the chunk's
    offset in its window, params int32 [rows, 5] = (read_len, win_len,
    min_score, seed_lo, seed_hi)), without a loop a row."""
    stride = window_chunk - 2 * L
    if stride <= 0:
        raise ValueError(f"window_chunk {window_chunk} leaves no stride for "
                         f"reads {L} wide")
    read_len, win_len, min_scores = (np.asarray(x, np.int64) for x in (
        read_len, win_len, min_scores))
    # the first chunk that reaches the window's end, and whether it holds
    # the L + 10 bytes a chunk past the first needs
    last = np.maximum(0, -(-(win_len - window_chunk) // stride))
    chunks = np.where(last == 0, 1, last + (win_len - last * stride >= L + 10))
    pair = np.repeat(np.arange(len(win_len)), chunks)
    c = np.arange(len(pair)) - np.repeat(np.cumsum(chunks) - chunks, chunks)
    offset = c * stride
    params = np.stack([
        read_len[pair],
        np.clip(win_len[pair] - offset, 0, window_chunk),
        min_scores[pair],
        np.where(c == 0, 0, L),
        np.full(len(pair), stride + L - 1)], 1).astype(np.int32)
    return (np.repeat(pair, 2), np.tile([0, 1], len(pair)),
            np.repeat(offset, 2), np.repeat(params, 2, axis=0))


def accept_wavefront_indexed_plain(reads, table, offsets, params, W: int,
                                   batch_rows: int = 512) -> torch.Tensor:
    """The plain version of K1's indexed entry: bool [N], each row's read
    (read_len bytes of reads, flattened, from offsets[:, 0]; _PAD_READ past
    them) and window (win_len bytes of table from offsets[:, 1]; _PAD_WIN
    past them, W wide) through accept_wavefront_plain, batch_rows rows at
    a time."""
    n = offsets.shape[0]
    device = offsets.device
    flat = reads.reshape(-1)
    L = reads.shape[1]
    verdict = torch.zeros(n, dtype=torch.bool, device=device)
    lanes_r = torch.arange(L, device=device)
    lanes_w = torch.arange(W, device=device)
    for a in range(0, n, batch_rows):
        off = offsets[a:a + batch_rows].long()
        p = params[a:a + batch_rows]
        r = flat[(off[:, :1] + lanes_r).clamp(0, flat.numel() - 1)]
        r = torch.where(lanes_r < p[:, :1], r, _PAD_READ)
        w = table[(off[:, 1:] + lanes_w).clamp(0, table.numel() - 1)]
        w = torch.where(lanes_w < p[:, 1:2], w, _PAD_WIN)
        verdict[a:a + batch_rows] = accept_wavefront_plain(
            r, w, *p.unbind(dim=1))
    return verdict


def accept_wavefront_indexed(reads, table, offsets, params,
                             W: int) -> torch.Tensor:
    """bool [N]: K1's indexed entry for CUDA tensors, the plain version for
    CPU tensors. reads uint8 [R, L] a read table, table uint8 [T] a window
    table, offsets int64 [N, 2] = (read offset into reads, window offset
    into table), params int32 [N, 5] as accept_wavefront's, win_len <= W."""
    if reads.is_cuda:
        from .. import kernels
        return kernels.accept_wavefront_indexed(reads, table, offsets,
                                                params, W)
    return accept_wavefront_indexed_plain(reads, table, offsets, params, W)


def resident_accept_rows(resident: ResidentPairs, pairs: np.ndarray,
                         min_scores, window_chunk: int = 8192):
    """K1's rows of the pairs of resident named by index (accept_rows, at
    the width L of the JAX package's accept_pairs over these pairs):
    (row_pair, offsets int64 [rows, 2] = (read offset into
    resident.accept_reads, window offset into resident.table), params int32
    [rows, 5]), each row's read and window spans inside their tables."""
    read = resident.pair_read[pairs]
    window = resident.pair_window[pairs]
    read_len = resident.read_len[read]
    L = _row_width(int(read_len.max(initial=0)), 16)
    row_pair, orient, chunk, params = accept_rows(
        read_len, resident.win_len[window], min_scores, L, window_chunk)
    width = resident.accept_reads.shape[1]
    offsets = np.stack([(2 * read[row_pair] + orient) * width,
                        resident.win_offset[window[row_pair]] + chunk], 1)
    return row_pair, offsets, params


def accept_launches(resident: ResidentPairs, pairs: np.ndarray, min_scores,
                    window_chunk: int = 8192, batch_rows: int = 1 << 20):
    """K1's launches over the rows of the pairs of resident named by index
    (resident_accept_rows), batch_rows rows each: (each row's index into
    pairs, on the device; accept_wavefront_indexed's arguments) a
    launch."""
    row_pair, offsets, params = resident_accept_rows(
        resident, pairs, min_scores, window_chunk)
    for a in range(0, len(row_pair), batch_rows):
        b = slice(a, a + batch_rows)
        host = (offsets[b], params[b], row_pair[b].astype(np.int32))
        resident.uploaded["rows"] += sum(x.nbytes for x in host)
        off_d, params_d, pair_d = (trace.upload(x, resident.device)
                                   for x in host)
        yield pair_d, (resident.accept_reads, resident.table, off_d,
                       params_d, window_chunk)


@trace.spanned("screen.accept")
def accept_resident(resident: ResidentPairs, pairs, min_scores,
                    window_chunk: int = 8192,
                    batch_rows: int = 1 << 20) -> np.ndarray:
    """[n] bool per pair of resident named by index in pairs: a
    single-seed align() path in EITHER read orientation reaches min_scores
    (sound accept — see accept_wavefront_plain). K1's rows index the
    resident tables (accept_wavefront_indexed), batch_rows rows a launch
    (accept_launches); the rows' verdicts fold onto their pairs on the
    device (a scatter-max) and come to the host once."""
    pairs = np.asarray(pairs, np.int64)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    verdict = torch.zeros(len(pairs), dtype=torch.int32,
                          device=resident.device)
    for row_pair, args in accept_launches(resident, pairs, min_scores,
                                          window_chunk, batch_rows):
        hits = accept_wavefront_indexed(*args)
        verdict.scatter_reduce_(0, row_pair.long(), hits.to(torch.int32),
                                "amax")
    return verdict.cpu().numpy() != 0


def accept_pairs(read_seqs, window_views, min_scores,
                 window_chunk: int = 8192, batch_rows: int = 1 << 20,
                 device=None) -> np.ndarray:
    """[n] bool per (read, window) pair: a single-seed align() path in
    EITHER read orientation reaches min_score (sound accept — see
    accept_wavefront_plain). read_seqs: list of str; window_views: list of
    uint8 views into the assembly (exactly the [gene_start, gene_end]
    windows align() searches); min_scores: list of int (the reference's
    min_align_fraction arithmetic, computed by the caller).

    The distinct windows and reads go to the device once (resident_pairs);
    windows split into chunks of window_chunk bytes that overlap by 2 L,
    each chunk restricting seeds to its own stride (seed_lo, seed_hi), and
    each chunk's rows read the resident bytes by offset (accept_resident),
    batch_rows rows a launch."""
    n = len(read_seqs)
    if n == 0:
        return np.zeros(0, bool)
    return accept_resident(resident_pairs(read_seqs, window_views, device),
                           np.arange(n), min_scores, window_chunk,
                           batch_rows)
