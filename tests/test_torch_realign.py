"""The port's realignment screen and single-seed accept
(arriba_tpu_torch/ops/realign.py, plain PyTorch on the CPU) against the JAX
package's: the 8-mer screen, the accept wavefront (XLA twin and the Pallas
kernel in interpret mode) and the host batching around both, on the inputs
of tests/test_device_ops.py. Verdicts must be identical."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from arriba_tpu.ops import realign as jax_realign  # noqa: E402
from arriba_tpu.seq import reverse_complement_str  # noqa: E402
from arriba_tpu_torch.ops import realign  # noqa: E402
from arriba_tpu_torch.ops.encode import PAD_CODE  # noqa: E402

BASES = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")


def _screen_rows_random():
    """tests/test_device_ops.py:245-259."""
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, size=(6, 64), dtype=np.uint8)
    windows = rng.integers(0, 4, size=(6, 128), dtype=np.uint8)
    windows[0, 20:28] = reads[0, 5:13]
    return reads, windows


def _screen_rows_padded():
    """tests/test_device_ops.py:262-286: planted seeds, PAD tails, a fully
    padded read."""
    rng = np.random.default_rng(9)
    n, L, W = 12, 96, 1200
    reads = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    windows = rng.integers(0, 4, size=(n, W), dtype=np.uint8)
    windows[0, 40:48] = reads[0, 11:19]
    windows[1, 600:608] = reads[1, 0:8]
    windows[2, W - 8:] = reads[2, L - 8:]
    reads[3, 50:] = PAD_CODE
    windows[4, 100:] = PAD_CODE
    windows[4, 20:28] = reads[4, 2:10]
    reads[5] = PAD_CODE
    return reads, windows


@pytest.mark.parametrize("make_rows", [_screen_rows_random,
                                       _screen_rows_padded])
def test_shared_kmer_mask_matches_jax_and_bruteforce(make_rows):
    reads, windows = make_rows()
    got = realign.shared_kmer_mask(torch.from_numpy(reads),
                                   torch.from_numpy(windows)).numpy()
    want = np.asarray(jax_realign.shared_kmer_mask(jnp.asarray(reads),
                                                   jnp.asarray(windows)))
    np.testing.assert_array_equal(got, want)
    for row in range(len(reads)):
        read_kmers = {tuple(reads[row, i:i + 8])
                      for i in range(reads.shape[1] - 7)
                      if PAD_CODE not in reads[row, i:i + 8]}
        window_kmers = {tuple(windows[row, i:i + 8])
                        for i in range(windows.shape[1] - 7)
                        if PAD_CODE not in windows[row, i:i + 8]}
        assert got[row] == bool(read_kmers & window_kmers), row
    assert got[0] and not got.all()


def _screen_rows_above_4():
    """The padded rows with bytes 5-255 scattered through reads and
    windows, one inside row 0's planted seed: the one-hot screen reads such
    a byte as no base, the sorted screen as code 3."""
    reads, windows = _screen_rows_padded()
    rng = np.random.default_rng(21)
    for x in (reads, windows):
        spots = rng.random(x.shape) < 0.03
        x[spots] = rng.integers(5, 256, int(spots.sum()))
    reads[0, 14] = windows[0, 43] = 9
    return reads, windows


def _screen_rows_narrow():
    """Reads of 20 bytes (13 k-mers, less than one 16-k-mer tile) against
    windows of 12 (5 k-mers, less than one 8-k-mer tile); the read's last
    8-mer planted at every other window's end."""
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 4, size=(9, 20), dtype=np.uint8)
    windows = rng.integers(0, 4, size=(9, 12), dtype=np.uint8)
    windows[::2, 4:] = reads[::2, 12:]
    return reads, windows


@pytest.mark.parametrize("make_rows,w_chunk", [
    (_screen_rows_random, 512), (_screen_rows_padded, 512),
    (_screen_rows_padded, 64), (_screen_rows_above_4, 512),
    (_screen_rows_narrow, 512)])
def test_mxu_shared_kmer_mask_matches_jax_and_sorted_screen(make_rows,
                                                            w_chunk):
    """The one-hot product screen (plain PyTorch on the CPU) gives the JAX
    op's verdicts exactly, and the sorted screen's wherever every byte is a
    code 0-4; a k-mer covering a byte above 3 never matches."""
    reads, windows = make_rows()
    r, w = torch.from_numpy(reads), torch.from_numpy(windows)
    got = realign.mxu_shared_kmer_mask(r, w, w_chunk=w_chunk).numpy()
    want = np.asarray(jax_realign.mxu_shared_kmer_mask(
        jnp.asarray(reads), jnp.asarray(windows), w_chunk=w_chunk))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)
    if max(reads.max(), windows.max()) <= PAD_CODE:
        np.testing.assert_array_equal(
            got, realign.shared_kmer_mask(r, w).numpy())
    for row in range(len(reads)):
        read_kmers = {tuple(reads[row, i:i + 8])
                      for i in range(reads.shape[1] - 7)}
        window_kmers = {tuple(windows[row, i:i + 8])
                        for i in range(windows.shape[1] - 7)}
        shared = {kmer for kmer in read_kmers & window_kmers
                  if max(kmer) <= 3}
        assert got[row] == bool(shared), f"row {row}"


def test_accept_wavefront_plain_matches_xla_and_pallas():
    """tests/test_device_ops.py:853-887: embedded copies, random rejects,
    short windows and per-row bounds; the plain version against the XLA
    twin and the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(17)
    N, L, W = 16, 128, 512
    reads = rng.integers(65, 85, (N, L)).astype(np.uint8)
    wins = rng.integers(65, 85, (N, W)).astype(np.uint8)
    for i in range(0, N, 2):
        p = int(rng.integers(0, W - 100))
        reads[i, :100] = wins[i, p:p + 100]
        reads[i, rng.integers(0, 100, 2)] = rng.integers(65, 85, 2)
    columns = (np.full(N, 100, np.int32), rng.integers(200, W + 1, N)
               .astype(np.int32), np.full(N, 80, np.int32),
               np.zeros(N, np.int32))
    columns += (columns[1].copy(),)
    params = np.stack(columns, axis=1)
    pallas_params = np.zeros((N, 128), np.int32)
    pallas_params[:, :5] = params

    got = realign.accept_wavefront(torch.from_numpy(reads),
                                   torch.from_numpy(wins),
                                   torch.from_numpy(params)).numpy()
    xla = np.asarray(jax_realign._accept_wavefront_kernel(
        jnp.asarray(reads), jnp.asarray(wins),
        *(jnp.asarray(c) for c in columns)))
    pallas = np.asarray(jax_realign._accept_wavefront_pallas(
        jnp.asarray(reads), jnp.asarray(wins), jnp.asarray(pallas_params),
        block_n=16, interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert 0 < got.sum() < N


def _pairs_recursion_mix():
    """tests/test_device_ops.py:689-738: random reads, exact and mutated
    embedded copies and reverse complements, windows up to 9000 bp (the
    8192-byte chunking path), a few 'N's."""
    rng = np.random.default_rng(777)
    reads, windows, min_scores = [], [], []
    for t in range(48):
        L = int(rng.integers(20, 151))
        W = int(rng.integers(300, 9000))
        win = rng.choice(BASES, W).copy()
        if t % 6 == 0:
            win[rng.integers(0, W, 4)] = ord("N")
        kind = t % 4
        p = int(rng.integers(0, W - L))
        if kind == 0:
            read = rng.choice(BASES, L)
        elif kind == 1:
            read = win[p:p + L].copy()
        elif kind == 2:
            read = win[p:p + L].copy()
            for j in rng.integers(0, L, 3):
                read[j] = rng.choice(BASES)
        else:
            read = np.frombuffer(reverse_complement_str(
                win[p:p + L].tobytes().decode()).encode(), np.uint8)
        reads.append(read.tobytes().decode())
        windows.append(win)
        min_scores.append(int(0.8 * L + 0.5))
    return reads, windows, min_scores


def _pairs_bounds():
    """tests/test_device_ops.py:757-816: copies at the window's end and
    start, a match in the read's tail, four consecutive mismatches."""
    rng = np.random.default_rng(31)
    cases = []
    win = rng.choice(BASES, 400).copy()
    cases.append((win[360:].tobytes().decode(), win))
    win2 = rng.choice(BASES, 400).copy()
    cases.append((win2[:40].tobytes().decode(), win2))
    win3 = rng.choice(BASES, 600).copy()
    cases.append((rng.choice(BASES, 90).tobytes().decode()
                  + win3[100:160].tobytes().decode(), win3))
    win4 = rng.choice(BASES, 500).copy()
    arr = win4[50:170].copy()
    arr[40:44] = (arr[40:44] + 1) % 4
    cases.append((arr.tobytes().decode(), win4))
    reads = [seq for seq, _ in cases]
    return reads, [w for _, w in cases], [int(0.8 * len(s) + 0.5)
                                          for s in reads]


def _pairs_screen_mix():
    """tests/test_device_ops.py:617-672 and :819-828: substrings, reverse
    complements, mutated and random reads against one 3000 bp window with
    'N's, and short reads straddling the screen's chunk boundaries of a
    5000 bp window."""
    rng = np.random.default_rng(1234)

    def random_seq(n, with_n=False):
        seq = rng.choice(BASES, n).copy()
        if with_n:
            seq[rng.integers(0, n, max(1, n // 20))] = ord("N")
        return seq

    window = random_seq(3000, with_n=True)
    text = window.tobytes().decode()
    reads = []
    for i in range(40):
        start = int(rng.integers(0, len(window) - 60))
        kind = i % 5
        if kind == 0:
            seq = text[start:start + 50]
        elif kind == 1:
            seq = reverse_complement_str(text[start:start + 50])
        elif kind == 2:
            arr = window[start:start + 50].copy()
            for j in rng.integers(0, 50, 6):
                arr[j] = rng.choice(BASES)
            seq = arr.tobytes().decode()
        else:
            seq = random_seq(50, with_n=kind == 4).tobytes().decode()
        reads.append(seq)
    windows = [window] * len(reads)
    long_window = np.random.default_rng(9).choice(BASES, 5000)
    for anchor in (2041, 2044, 2047, 4082, 4089):
        reads.append(long_window[anchor:anchor + 12].tobytes().decode())
        windows.append(long_window)
    return reads, windows, [int(0.8 * len(s) + 0.5) for s in reads]


@pytest.mark.parametrize("make_pairs,all_seeded", [
    (_pairs_recursion_mix, False), (_pairs_bounds, True),
    (_pairs_screen_mix, False)])
def test_screen_pairs_matches_jax(make_pairs, all_seeded):
    reads, windows, _ = make_pairs()
    got = realign.screen_pairs(reads, windows, device=CPU)
    want = jax_realign.screen_pairs(reads, windows)
    np.testing.assert_array_equal(got, want)
    assert bool(got.all()) == all_seeded and got.any()


@pytest.mark.parametrize("make_pairs", [_pairs_recursion_mix, _pairs_bounds])
def test_accept_pairs_matches_jax(make_pairs):
    reads, windows, min_scores = make_pairs()
    got = realign.accept_pairs(reads, windows, min_scores, device=CPU)
    want = jax_realign.accept_pairs(reads, windows, min_scores)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_accept_pairs_streams_several_batches():
    """More rows than one batch: the trailing batch is padded to the fixed
    shape and every pair keeps its own verdict."""
    reads, windows, min_scores = _pairs_bounds()
    got = realign.accept_pairs(reads * 3, windows * 3, min_scores * 3,
                               batch_rows=5, device=CPU)
    want = jax_realign.accept_pairs(reads * 3, windows * 3, min_scores * 3,
                                    batch_rows=5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(got[:len(reads)], 3))


def test_accept_pairs_refuses_a_negative_min_score():
    """K1 walks only the diagonals a seed names, which is exact only while
    min_score is above what an unseeded walk can score (read_len - 2^20):
    on a CUDA device accept_pairs refuses a lower one before it builds a
    row. The plain version walks every diagonal, so on the CPU any
    min_score answers as the JAX package does."""
    reads, windows, min_scores = _pairs_bounds()
    low = [-(2 ** 20)] + list(min_scores[1:])
    with pytest.raises(ValueError, match="on a CUDA device"):
        realign.accept_pairs(reads, windows, low,
                             device=torch.device("cuda"))
    for first in (-1, -(2 ** 20) + 1):
        scores = [first] + list(min_scores[1:])
        got = realign.accept_pairs(reads, windows, scores, device=CPU)
        want = jax_realign.accept_pairs(reads, windows, scores)
        np.testing.assert_array_equal(got, want)
        assert got[0]


def _plain_dp_scores(reads, windows):
    """The textbook Smith-Waterman recurrence, one cell at a time (+1 / -1,
    linear gap -1, floor 0, PAD cells 0)."""
    scores = []
    for read, window in zip(reads, windows):
        h = np.zeros((len(read) + 1, len(window) + 1), np.int64)
        for i, a in enumerate(read, 1):
            for j, b in enumerate(window, 1):
                if a == PAD_CODE or b == PAD_CODE:
                    continue
                h[i, j] = max(h[i - 1, j - 1] + (1 if a == b else -1),
                              h[i - 1, j] - 1, h[i, j - 1] - 1, 0)
        scores.append(int(h.max()))
    return np.asarray(scores, np.int32)


def _sw_rows(seed, n, L, W):
    """Random rows, exact and mutated read copies, copies with a gap, PAD
    tails on both sides, an all-PAD read and an all-PAD window."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (n, L)).astype(np.uint8)
    windows = rng.integers(0, 4, (n, W)).astype(np.uint8)
    for row in range(n):
        kind = row % 5
        length = int(rng.integers(1, min(L, W) + 1))
        at = int(rng.integers(0, W - length + 1))
        copy = windows[row, at:at + length].copy()
        if kind == 1:
            copy[rng.integers(0, length, 3)] = rng.integers(0, 4, 3)
        elif kind == 2 and length > 8:
            cut = int(rng.integers(1, length - 4))
            copy = np.concatenate([copy[:cut], copy[cut + 2:]])
        if kind < 3:
            reads[row, :len(copy)] = copy
        if kind == 3:
            reads[row, int(rng.integers(0, L)):] = PAD_CODE
            windows[row, int(rng.integers(0, W)):] = PAD_CODE
    reads[n - 1] = PAD_CODE
    windows[n - 2] = PAD_CODE
    return reads, windows


@pytest.mark.parametrize("seed,n,L,W", [(3, 10, 24, 40), (8, 10, 37, 21)])
def test_smith_waterman_plain_matches_jax_pallas_and_dp(seed, n, L, W):
    """The plain version against the JAX package's jnp wavefront, its
    Pallas kernel in interpret mode (as tests/test_device_ops.py runs it)
    and the textbook recurrence, exactly."""
    reads, windows = _sw_rows(seed, n, L, W)
    got = realign.smith_waterman_scores(torch.from_numpy(reads),
                                        torch.from_numpy(windows)).numpy()
    want = np.asarray(jax_realign.smith_waterman_scores(
        jnp.asarray(reads), jnp.asarray(windows)))
    pallas = np.asarray(jax_realign.smith_waterman_scores_pallas(
        jnp.asarray(reads), jnp.asarray(windows), block_n=n, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _plain_dp_scores(reads, windows))
    assert got.dtype == np.int32 and got.min() == 0 and got.max() > 8


def test_smith_waterman_plain_scoring_parameters():
    reads, windows = _sw_rows(5, 12, 30, 50)
    for match, mismatch, gap in ((2, -3, -2), (1, 0, -1)):
        got = realign.smith_waterman_scores_plain(
            torch.from_numpy(reads), torch.from_numpy(windows), match,
            mismatch, gap).numpy()
        want = np.asarray(jax_realign.smith_waterman_scores(
            jnp.asarray(reads), jnp.asarray(windows), match, mismatch, gap))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fraction", [0.8, 0.35])
def test_realign_step_matches_jax(fraction):
    reads, windows = _sw_rows(11, 16, 64, 96)
    length = (reads != PAD_CODE).sum(axis=1).astype(np.int32)
    got = realign.realign_step(torch.from_numpy(reads),
                               torch.from_numpy(windows),
                               torch.from_numpy(length),
                               min_score_fraction=fraction)
    want = jax_realign.realign_step(jnp.asarray(reads), jnp.asarray(windows),
                                    jnp.asarray(length),
                                    min_score_fraction=fraction)
    for key in ("seed_hit", "sw_score", "can_align"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["can_align"].any() and not got["can_align"].all()


@pytest.mark.parametrize("make_rows", [
    _screen_rows_random, _screen_rows_padded, _screen_rows_above_4,
    _screen_rows_narrow])
def test_mxu_work_counts_kmer_pairs_to_the_first_hit(make_rows):
    """chip_smoke.py's K4 bound counts each row's read k-mers against its
    window k-mers up to the first one shared over codes 0-3 (all of them
    for a row with none), 32 multiply-adds a pair: brute force here."""
    from chip_smoke import mxu_work

    reads, windows = make_rows()
    work = mxu_work(torch.from_numpy(reads), torch.from_numpy(windows))
    R, WK = reads.shape[1] - 7, windows.shape[1] - 7
    pairs = 0
    for row in range(len(reads)):
        read_kmers = {tuple(reads[row, i:i + 8]) for i in range(R)}
        first = next((j for j in range(WK)
                      if max(windows[row, j:j + 8]) <= 3
                      and tuple(windows[row, j:j + 8]) in read_kmers), None)
        pairs += R * (WK if first is None else first + 1)
        assert bool(work["verdict"][row]) == (first is not None), row
    assert work["macs"] == 32 * pairs
    assert work["macs"] < work["full_macs"] == len(reads) * R * WK * 32
