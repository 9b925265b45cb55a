"""Batched realignment screening for filter_mismappers, in PyTorch.

The reference re-aligns each clipped segment / discordant mate against the
partner gene with a recursive 8-mer-seeded seed-and-extend aligner
(filter_mismappers.cpp:86-230). The device path splits the candidate
(read, window) pairs into a tri-state verdict before that recursion:

1. `screen_pairs` -> `shared_kmer_mask`, a *sound REJECT*: align() can only
   accept a read if at least one 8-mer of the read occurs in the padded
   gene window (the seed lookup at filter_mismappers.cpp:97-99). Plain
   PyTorch: a per-row sort plus a batched searchsorted.
2. `accept_pairs` -> `accept_wavefront`, an *exact single-seed ACCEPT*:
   every single-seed align() path (seed 8-mer, left extension with <= 1
   mismatch, right extension at +1/-1 with the 4-consecutive-mismatch
   break, the outer-loop seed bound and the k-mer-index range) evaluated
   per (read, window) row. CUDA tensors run the hand-written kernel K1
   (kernels/csrc/accept_wavefront.cu, which looks the read's eligible
   8-mers up in the window and walks only the diagonals they name); CPU
   tensors run
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
   (kernels/csrc/smith_waterman.cu); CPU tensors run
   `smith_waterman_scores_plain`, the twin of the JAX package's wavefront.
"""

from __future__ import annotations

import numpy as np
import torch

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
    cores; k = 8 only, and w_chunk, a tiling of the plain version, does not
    change the verdict); CPU tensors the plain version. No CLI path calls
    it, as in the JAX package (whose bench does)."""
    if reads.is_cuda:
        if k != SEED_KMER_LENGTH:
            raise ValueError(f"K4 screens {SEED_KMER_LENGTH}-mers, not "
                             f"{k}-mers")
        from .. import kernels
        return kernels.mxu_kmer_screen(reads.contiguous(),
                                       windows.contiguous())
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
    """int32 [N] best local alignment scores: K3 for CUDA tensors, the
    plain version for CPU tensors. reads and windows hold codes 0-4 (PAD
    4), as ops/encode.py builds them; K3 refuses a larger byte."""
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

# native kmer semantics (filter_mismappers.cpp:33-45): T=0, G=1, C=2,
# everything else (incl. A and N) = 3 — so device read k-mers are a superset
# of the native seed lookups and window k-mers a superset of the native
# index (which drops N-start positions): the screen can only err permissive.
_SCREEN_LUT = np.full(256, 3, np.uint8)
_SCREEN_LUT[ord("T")] = 0
_SCREEN_LUT[ord("G")] = 1
_SCREEN_LUT[ord("C")] = 2

# codes of the reverse complement must match _SCREEN_LUT applied to
# reverse_complement_str(seq): complement the CHARACTER first (N stays N and
# keeps code 3; a bare `code ^ 3` would wrongly send N -> code 0).
_SCREEN_RC_LUT = _SCREEN_LUT[_COMPLEMENT_LUT]


def _batches(rows, batch_rows: int):
    """Group a row stream into lists of batch_rows (the last may be short)."""
    batch = []
    for row in rows:
        batch.append(row)
        if len(batch) == batch_rows:
            yield batch
            batch = []
    if batch:
        yield batch


def _device(device):
    if device is None:
        from ..device import torch_device
        return torch_device()
    return device


def screen_pairs(read_seqs, window_views, window_chunk: int = 8192,
                 batch_rows: int = 4096, device=None) -> np.ndarray:
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
    gene windows). Long windows are split into chunks overlapping by k-1 so
    rows stay fixed-shape; rows stream to the device batch_rows at a time.
    """
    n = len(read_seqs)
    if n == 0:
        return np.zeros(0, bool)
    device = _device(device)
    k = SEED_KMER_LENGTH
    max_read = max(len(seq) for seq in read_seqs)
    L = -(-max(k, max_read) // 64) * 64

    def rows():
        for i, (seq, window) in enumerate(zip(read_seqs, window_views)):
            raw = np.frombuffer(seq.encode("latin-1"), np.uint8)
            fwd = np.full(L, PAD_CODE, np.uint8)
            fwd[:len(raw)] = _SCREEN_LUT[raw]
            rc = np.full(L, PAD_CODE, np.uint8)
            rc[:len(raw)] = _SCREEN_RC_LUT[raw[::-1]]
            for start in range(0, max(1, len(window)), window_chunk - (k - 1)):
                chunk = window[start:start + window_chunk]
                if len(chunk) < k and start > 0:
                    break
                padded = np.full(window_chunk, PAD_CODE, np.uint8)
                padded[:len(chunk)] = _SCREEN_LUT[chunk]
                yield i, fwd, padded
                yield i, rc, padded
                if start + window_chunk >= len(window):
                    break

    result = np.zeros(n, bool)
    for index, batch in enumerate(_batches(rows(), batch_rows)):
        pairs = np.fromiter((row[0] for row in batch), np.int64, len(batch))
        reads = [row[1] for row in batch]
        windows = [row[2] for row in batch]
        # pad the trailing batch to a fixed shape (PAD rows screen to False)
        if len(batch) < batch_rows and index > 0:
            pad = batch_rows - len(batch)
            reads += [np.full(L, PAD_CODE, np.uint8)] * pad
            windows += [np.full(window_chunk, PAD_CODE, np.uint8)] * pad
        hits = shared_kmer_mask(torch.from_numpy(np.stack(reads)).to(device),
                                torch.from_numpy(np.stack(windows)).to(device))
        np.logical_or.at(result, pairs, hits.cpu().numpy()[:len(batch)])
    return result


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


def accept_pairs(read_seqs, window_views, min_scores,
                 window_chunk: int = 8192, batch_rows: int = 512,
                 device=None) -> np.ndarray:
    """[n] bool per (read, window) pair: a single-seed align() path in
    EITHER read orientation reaches min_score (sound accept — see
    accept_wavefront_plain). read_seqs: list of str; window_views: list of
    uint8 views into the assembly (exactly the [gene_start, gene_end]
    windows align() searches); min_scores: list of int (the reference's
    min_align_fraction arithmetic, computed by the caller).

    Windows split into chunks of window_chunk bytes that overlap by 2 L,
    each chunk restricting seeds to its own stride (seed_lo, seed_hi);
    rows stream to the device batch_rows at a time."""
    n = len(read_seqs)
    if n == 0:
        return np.zeros(0, bool)
    device = _device(device)
    from ..seq import reverse_complement_str

    max_read = max(len(seq) for seq in read_seqs)
    if (torch.device(device).type == "cuda"
            and min(min_scores) <= _NEG + max_read):
        # K1 walks only the diagonals a seed names; without a fired seed a
        # walk scores at most _NEG + read_len, so a min_score that low could
        # accept on a diagonal K1 never walks
        raise ValueError(f"accept_pairs takes min_scores > {_NEG} + the "
                         f"read length on a CUDA device")
    L = -(-max(16, max_read) // 64) * 64
    stride = window_chunk - 2 * L
    assert stride > 0

    def rows():
        for i, (seq, window) in enumerate(zip(read_seqs, window_views)):
            raw = np.frombuffer(seq.encode("latin-1"), np.uint8)
            fwd = np.full(L, _PAD_READ, np.uint8)
            fwd[:len(raw)] = raw
            rc_raw = np.frombuffer(
                reverse_complement_str(seq).encode("latin-1"), np.uint8)
            rc = np.full(L, _PAD_READ, np.uint8)
            rc[:len(rc_raw)] = rc_raw
            ms = int(min_scores[i])
            c = 0
            while True:
                offset = c * stride
                chunk = window[offset:offset + window_chunk]
                lo = 0 if c == 0 else L
                hi = lo + stride - 1 if c > 0 else stride + L - 1
                if lo > len(chunk) - 10 and c > 0:
                    break
                padded = np.full(window_chunk, _PAD_WIN, np.uint8)
                padded[:len(chunk)] = chunk
                meta = (len(raw), len(chunk), ms, lo, hi)
                yield i, fwd, padded, meta
                yield i, rc, padded, meta
                c += 1
                if offset + window_chunk >= len(window):
                    break

    result = np.zeros(n, bool)
    for index, batch in enumerate(_batches(rows(), batch_rows)):
        pairs = np.fromiter((row[0] for row in batch), np.int64, len(batch))
        reads = [row[1] for row in batch]
        windows = [row[2] for row in batch]
        # read_len <= L and win_len <= window_chunk by construction, and
        # min_score checked above: what K1 requires of a row holds without a
        # check on the card
        params = np.zeros((len(batch), 5), np.int32)
        params[:, 2] = 2 ** 20   # padded rows: unreachable min_score
        params[:len(batch)] = [row[3] for row in batch]
        if len(batch) < batch_rows and index > 0:
            pad = batch_rows - len(batch)
            reads += [np.full(L, _PAD_READ, np.uint8)] * pad
            windows += [np.full(window_chunk, _PAD_WIN, np.uint8)] * pad
            padded_params = np.zeros((batch_rows, 5), np.int32)
            padded_params[:, 2] = 2 ** 20
            padded_params[:len(batch)] = params
            params = padded_params
        hits = accept_wavefront(
            torch.from_numpy(np.stack(reads)).to(device),
            torch.from_numpy(np.stack(windows)).to(device),
            torch.from_numpy(params).to(device))
        np.logical_or.at(result, pairs, hits.cpu().numpy()[:len(batch)])
    return result
