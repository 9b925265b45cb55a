"""The port on the card: the CUDA kernels (K1-K5) against their plain
PyTorch versions, the other offloaded ops and whole CLI runs against the
CPU and host paths, and the kernel wrappers' argument checks. The tests
that need a CUDA device are marked ``cuda`` and skip without one;
``python3 chip_smoke.py`` runs the kernel comparison at the main path's
shapes."""

import numpy as np
import pytest
import torch

from arriba_tpu_torch import kernels
from arriba_tpu_torch.ops import readfilters, realign


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# W = 1000: rows that are no multiple of 16 bytes
@pytest.mark.cuda
@pytest.mark.parametrize("N,W", [(64, 1024), (512, 8192), (64, 1000)])
def test_accept_wavefront_kernel_matches_plain(cuda, N, W):
    from chip_smoke import accept_inputs

    reads, windows, params = (torch.from_numpy(x).to(cuda)
                              for x in accept_inputs(N=N, W=W))
    before = kernels.launch_counts["accept_wavefront"]
    got = realign.accept_wavefront(reads, windows, params)
    want = realign.accept_wavefront_plain(reads, windows,
                                          *params.unbind(dim=1))
    assert kernels.launch_counts["accept_wavefront"] == before + 1
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < N


# the adversarial rows at the main path's shape, and a block of 64
# low-complexity rows (a poly-A read against a window of A8 G4 repeats, a
# rejecting row where every diagonal is a candidate)
@pytest.mark.cuda
def test_accept_wavefront_kernel_adversarial_rows(cuda):
    import numpy as np

    from chip_smoke import ACCEPT_KINDS, accept_adversarial_inputs

    reads, windows, params = accept_adversarial_inputs(N=4 * len(ACCEPT_KINDS))
    kinds = len(ACCEPT_KINDS)
    block = accept_adversarial_inputs(N=kinds * 64)
    reads, windows, params = (
        torch.from_numpy(np.concatenate([x, y[2::kinds]])).to(cuda)
        for x, y in zip((reads, windows, params), block))
    got = realign.accept_wavefront(reads, windows, params)
    want = realign.accept_wavefront_plain(reads, windows,
                                          *params.unbind(dim=1))
    assert torch.equal(got, want)
    expected = [ACCEPT_KINDS[row % kinds][1]
                for row in range(4 * kinds)] + [False] * 64
    assert want.cpu().tolist() == expected


@pytest.mark.cuda
def test_low_entropy_kernel_matches_plain(cuda):
    import numpy as np

    from chip_smoke import low_entropy_inputs

    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs(n=8192)
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = torch.from_numpy(np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1)
                            .astype(np.int32)).to(cuda)
    packed = torch.from_numpy(readfilters.pack_codes(codes)).to(cuda)
    before = kernels.launch_counts["low_entropy"]
    got = readfilters._low_entropy_core_packed(packed, codes.shape[1], meta)
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, codes.shape[1]),
        *meta.unbind(dim=1))
    assert kernels.launch_counts["low_entropy"] == before + 1
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < len(codes)


# (L, W): tensorize's width against the dry run's windows, L not a
# multiple of 32 with W < L, a long read past a stripe of 8, a stripe of 1
@pytest.mark.cuda
@pytest.mark.parametrize("L,W", [(256, 256), (150, 100), (300, 1000),
                                 (20, 64)])
def test_smith_waterman_kernel_matches_plain(cuda, L, W):
    from chip_smoke import smith_waterman_inputs

    from arriba_tpu_torch.ops.encode import PAD_CODE

    reads, windows = (torch.from_numpy(x).to(cuda) for x in
                      smith_waterman_inputs(n=512, L=L, W=W))
    reads[5] = PAD_CODE                 # a row of pad only
    windows[6] = PAD_CODE
    before = kernels.launch_counts["smith_waterman"]
    got = realign.smith_waterman_scores(reads, windows)
    want = realign.smith_waterman_scores_plain(reads, windows)
    assert kernels.launch_counts["smith_waterman"] == before + 1
    assert torch.equal(got, want)
    longest = int((reads != PAD_CODE).sum(dim=1).max())
    assert int(want[5]) == int(want[6]) == 0
    assert min(L, W) // 2 < int(want.max()) <= longest
    for params in ((2, -3, -2), (1, 0, -1)):
        assert torch.equal(realign.smith_waterman_scores(reads, windows,
                                                         *params),
                           realign.smith_waterman_scores_plain(
                               reads, windows, *params))


# odd batches (the last warp pairs its row with an all-PAD dummy), a
# one-row batch, and a stripe of 4 against windows not a multiple of 4 wide
# (the byte loads)
@pytest.mark.cuda
@pytest.mark.parametrize("N,L,W", [(1, 256, 256), (511, 256, 256),
                                   (33, 37, 300), (17, 100, 97)])
def test_smith_waterman_kernel_odd_batches(cuda, N, L, W):
    from chip_smoke import smith_waterman_inputs

    # row 0 of smith_waterman_inputs is an empty read: start at row 1
    reads, windows = (torch.from_numpy(x[1:]).to(cuda) for x in
                      smith_waterman_inputs(n=N + 1, L=L, W=W))
    for params in ((1, -1, -1), (2, -3, -2)):
        got = realign.smith_waterman_scores(reads, windows, *params)
        want = realign.smith_waterman_scores_plain(reads, windows, *params)
        assert torch.equal(got, want)
    assert int(want.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("L,W,params,route", [
    (513, 256, (1, -1, -1), "smith_waterman_wide16"),
    (512, 256, (16, -1, -1), "smith_waterman_wide"),
    (256, 256, (1, -200, -1), "smith_waterman_wide")])
def test_smith_waterman_kernel_refuses_past_its_guard(cuda, L, W, params,
                                                      route):
    """Shapes and scores past K3's 16-bit guard route to K3w, decided
    before any launch (its 16-bit pairs where only the length stops K3),
    and K3w gives the plain version's scores."""
    from chip_smoke import smith_waterman_inputs

    reads, windows = (torch.from_numpy(x).to(cuda) for x in
                      smith_waterman_inputs(n=64, L=L, W=W))
    before = dict(kernels.launch_counts)
    assert kernels.sw_route(reads, windows, *params) == route
    assert kernels.launch_counts == before
    got = realign.smith_waterman_scores(reads, windows, *params)
    assert kernels.launch_counts == dict(before, **{route: before[route] + 1})
    assert torch.equal(got, realign.smith_waterman_scores_plain(
        reads, windows, *params))


# a byte above code 4 in a read or a window: K3 reads code bit 2 as PAD and
# ships window codes in 3 bits, so such a batch routes to K3w, which
# compares whole bytes as the plain version does
@pytest.mark.cuda
@pytest.mark.parametrize("where,value", [("reads", 5), ("windows", 16)])
def test_smith_waterman_kernel_refuses_bytes_above_code_4(cuda, where,
                                                          value):
    reads = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    windows = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    (reads if where == "reads" else windows)[2, 7] = value
    reads[3, 10:20] = windows[3, 30:40] = value
    before = dict(kernels.launch_counts)
    assert kernels.sw_route(reads, windows) == "smith_waterman_wide"
    assert kernels.launch_counts == before
    got = realign.smith_waterman_scores(reads, windows)
    assert kernels.launch_counts == dict(
        before, smith_waterman_wide=before["smith_waterman_wide"] + 1)
    assert torch.equal(got, realign.smith_waterman_scores_plain(reads,
                                                                windows))


# rows of lanes x 3,069 + 100 codes: more tiles than the long-row kernel's
# 10-bit fields hold, so that its lanes flush them
LE_FLUSH_CODES = kernels.LE_LONG_LANES * 3069 + 100


# rows past the packed counters' 3,072 codes (the long-row kernel: one tile
# at 3,100 and 4,000 codes, and rows whose lanes flush), the packed
# counters' widest rows, and a batch of rows too short to scan
@pytest.mark.cuda
@pytest.mark.parametrize("L,short", [(3100, False), (3072, False),
                                     (150, True), (4000, False),
                                     (LE_FLUSH_CODES, False)])
def test_low_entropy_kernel_routes(cuda, L, short):
    import numpy as np

    from chip_smoke import low_entropy_inputs

    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs(n=1000, L=L)
    if short:
        lengths = lengths % 4
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = torch.from_numpy(np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1)
                            .astype(np.int32)).to(cuda)
    packed = torch.from_numpy(readfilters.pack_codes(codes)).to(cuda)
    route = "low_entropy_long" if L > 3072 else "low_entropy"
    assert kernels.le_route(packed.shape[1]) == route
    before = dict(kernels.launch_counts)
    got = readfilters._low_entropy_core_packed(packed, L, meta)
    assert kernels.launch_counts == dict(before, **{route: before[route] + 1})
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta.unbind(dim=1))
    assert torch.equal(got, want)
    assert (int(want.sum()) == 0) if short else (0 < int(want.sum()) < 1000)
    if route == "low_entropy_long":
        # the packed entry point refuses rows it cannot count, so no launch
        # counted as "low_entropy" runs the long-row kernel
        from arriba_tpu_torch.kernels import build

        launch, _ = build.load("low_entropy")
        out = torch.empty(1000, dtype=torch.uint8, device=cuda)
        assert launch(packed.data_ptr(), meta.data_ptr(), out.data_ptr(),
                      *packed.shape,
                      torch.cuda.current_stream().cuda_stream) != 0


# the long-row kernel on batches of fewer reads than a block holds (four
# groups of 32 lanes), and one more: a homopolymer, a dinucleotide repeat
# and random reads, equal to the plain version
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 5])
def test_low_entropy_long_kernel_few_rows(cuda, n):
    import numpy as np

    from chip_smoke import low_entropy_inputs

    L = 4000
    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs(seed=n, n=n, L=L)
    codes[0] = 2
    lengths[0] = L
    if n > 1:
        codes[1] = np.tile([0, 3], L // 2)
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = torch.from_numpy(np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1)
                            .astype(np.int32)).to(cuda)
    packed = torch.from_numpy(readfilters.pack_codes(codes)).to(cuda)
    before = kernels.launch_counts["low_entropy_long"]
    got = readfilters._low_entropy_core_packed(packed, L, meta)
    assert kernels.launch_counts["low_entropy_long"] == before + 1
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta.unbind(dim=1))
    assert torch.equal(got, want)
    assert bool(want[0])


# the K2 kernel a packed row width launches: the packed counters up to
# 3,072 codes (768 bytes), the three-counter kernel past them
@pytest.mark.parametrize("row_bytes,route", [
    (1, "low_entropy"), (38, "low_entropy"), (768, "low_entropy"),
    (769, "low_entropy_long"), (1000, "low_entropy_long")])
def test_low_entropy_route(row_bytes, route):
    assert kernels.le_route(row_bytes) == route
    assert route in kernels.launch_counts


# K4 on chip_smoke.py's phase-2 cases, (a)-(c) on the first rows of the
# bench shape: the bench rows (early exits), no hit anywhere (the full
# product), PAD tails and bytes above 4, and 333 x 45 x 1,001 (the mixed
# rows: test_mxu_kmer_screen_kernel_takes_rows_in_turn)
@pytest.mark.cuda
@pytest.mark.parametrize("case,N", [("bench", 64), ("no_hit", 16),
                                    ("pad", 64), ("odd", 333)])
def test_mxu_kmer_screen_kernel_matches_plain(cuda, case, N):
    from chip_smoke import mxu_inputs, mxu_work

    reads, windows = (torch.from_numpy(x[:N].copy()).to(cuda)
                      for x in mxu_inputs(case))
    before = kernels.launch_counts["mxu_kmer_screen"]
    got = realign.mxu_shared_kmer_mask(reads, windows)
    want = realign.mxu_shared_kmer_mask_plain(reads, windows)
    assert kernels.launch_counts["mxu_kmer_screen"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(want, mxu_work(reads, windows)["verdict"])
    if case == "no_hit":
        assert not bool(want.any())
    elif case == "pad":
        assert want.cpu().tolist() == [row % 4 == 0 for row in range(N)]
    elif case == "bench":
        # ~18 chance hits are expected in a row of 145 x 8,001 k-mer pairs
        assert bool(want.all())
    else:
        assert 0 < int(want.sum()) < N


# odd N and one row; reads of 293 and 256 k-mers (two slabs of 160)
# against windows of several stages, and a read of two slabs against the
# bench's window (seeds in the second slab); rows narrower than one tile;
# reads or windows too short for an 8-mer, once with more rows than K4's
# blocks have threads (each thread zeroes rows in turn); bytes 0-5
@pytest.mark.cuda
@pytest.mark.parametrize("N,L,W", [(1, 152, 8008), (17, 300, 5000),
                                   (31, 263, 2100), (65, 20, 12),
                                   (9, 7, 100), (9, 100, 7),
                                   (24, 300, 8008), (70000, 7, 100)])
def test_mxu_kmer_screen_kernel_shapes(cuda, N, L, W):
    gen = torch.Generator().manual_seed(N * 7 + L)
    reads = torch.randint(0, 6, (N, L), dtype=torch.uint8, generator=gen)
    windows = torch.randint(0, 6, (N, W), dtype=torch.uint8, generator=gen)
    if min(L, W) >= 8:
        seed = torch.randint(0, 4, (N, 8), dtype=torch.uint8, generator=gen)
        reads[::2, L - 8:] = seed[::2]
        windows[::2, W // 3:W // 3 + 8] = seed[::2]
    reads, windows = reads.to(cuda), windows.to(cuda)
    got = realign.mxu_shared_kmer_mask(reads, windows)
    want = realign.mxu_shared_kmer_mask_plain(reads, windows)
    assert torch.equal(got, want)
    if min(L, W) >= 8:
        assert bool(want[::2].all())
    else:
        assert not bool(want.any())


# more rows than K4 launches blocks (at most 16 blocks of 128 threads an
# SM), so each block takes rows in turn and a row that a hit decides early
# sits next to rows that run to the window's end; reads of one and of two
# slabs of 160 k-mers; every launch's verdicts checked, out filled with 2
# before each so that a row left unwritten shows
@pytest.mark.cuda
@pytest.mark.parametrize("L", [152, 300])
def test_mxu_kmer_screen_kernel_takes_rows_in_turn(cuda, L):
    from chip_smoke import mxu_inputs, mxu_work

    reads, windows = (torch.from_numpy(x).to(cuda)
                      for x in mxu_inputs("mixed", L=L))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert len(reads) > 16 * sms
    want = realign.mxu_shared_kmer_mask_plain(reads, windows)
    assert torch.equal(want, mxu_work(reads, windows)["verdict"])
    assert 0 < int(want.sum()) < len(reads)
    out = torch.empty(len(reads), dtype=torch.uint8, device=cuda)
    for _ in range(5):
        out.fill_(2)
        kernels.launch_mxu_kmer_screen(reads, windows, out)
        assert torch.equal(out, want.to(torch.uint8))


@pytest.mark.cuda
def test_mxu_kmer_screen_kernel_refusals(cuda):
    """K4's wrapper refuses a wrong dtype, device, layout or row count
    before launch, and launches nothing for no rows; k != 8 routes to the
    any-k kernel (decided before launch) and k < 1, which the JAX op
    cannot take either, is refused."""
    reads = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    windows = torch.zeros(4, 256, dtype=torch.uint8, device=cuda)
    out = torch.zeros(4, dtype=torch.uint8, device=cuda)
    before = dict(kernels.launch_counts)
    for args, match in (
            ((reads.int(), windows, out), "uint8"),
            ((reads, windows.long(), out), "uint8"),
            ((reads, windows, out.bool()), "uint8"),
            ((reads, windows.cpu(), out), "CUDA tensor"),
            ((reads[:, ::2], windows, out), "contiguous"),
            ((reads, windows[:3], out), "same rows"),
            ((reads, windows, out[:3]), "same rows")):
        with pytest.raises(ValueError, match=match):
            kernels.launch_mxu_kmer_screen(*args)
    with pytest.raises(ValueError, match="1 <= k"):
        realign.mxu_shared_kmer_mask(reads, windows, k=0)
    assert kernels.launch_counts == before
    assert realign.mxu_shared_kmer_mask(reads[:0], windows[:0]).shape == (0,)
    assert kernels.launch_counts == before
    assert kernels.mxu_route(7) == "mxu_kmer_screen_any_k"
    assert kernels.launch_counts == before
    reads[1, 3:10] = windows[1, 50:57] = torch.tensor([0, 1, 2, 3, 3, 2, 1])
    got = realign.mxu_shared_kmer_mask(reads, windows, k=7)
    assert kernels.launch_counts == dict(
        before, mxu_kmer_screen_any_k=before["mxu_kmer_screen_any_k"] + 1)
    assert torch.equal(got, realign.mxu_shared_kmer_mask_plain(reads,
                                                               windows, 7))


WIDE16, WIDE = "smith_waterman_wide16", "smith_waterman_wide"


def _launch_width(route, reads, windows, params):
    """One launch of K3w's width route on the batch: int32 [N] scores"""
    out = torch.full((reads.shape[0],), -1, dtype=torch.int32,
                     device=reads.device)
    getattr(kernels, f"launch_{route}")(
        reads, windows, out, kernels.sw_wide_carry(reads, windows, route),
        *params)
    return out


# K3w at reduced counts of chip_smoke.SWW_CASES' shapes: reads of 640
# (the 600 bp ReadBatch width), 513 (one past K3) and 1,024 (two tiles) at
# 4,096 rows and fewer, 5,000 (ten tiles), bytes 5-255, h past 2^13, match
# - gap outside a byte, a positive gap; row counts that are no multiple of
# a block's 4 rows (32-bit) or 8 (16-bit). A batch routed to the 16-bit
# pairs is also scored by the 32-bit lanes: both widths equal the plain
# version.
@pytest.mark.cuda
@pytest.mark.parametrize("N,L,W,params,above_4,route", [
    (513, 640, 256, (1, -1, -1), False, WIDE16),
    (4096, 640, 256, (1, -1, -1), False, WIDE16),
    (4096, 513, 256, (1, -1, -1), False, WIDE16),
    (4093, 513, 300, (1, -1, -1), False, WIDE16),
    (64, 1024, 2048, (1, -1, -1), False, WIDE16),
    (3, 5000, 300, (1, -1, -1), True, WIDE),
    (333, 256, 256, (1, -1, -1), True, WIDE),
    (4097, 640, 256, (1, -1, -1), True, WIDE),
    (8, 4608, 4608, (2, -3, -5), False, WIDE),
    (257, 256, 256, (1, -1, -200), False, WIDE),
    (31, 600, 90, (3, -2, 2), False, WIDE16),
])
def test_smith_waterman_wide_kernel_matches_plain(cuda, N, L, W, params,
                                                  above_4, route):
    from chip_smoke import smith_waterman_inputs

    reads, windows = (torch.from_numpy(x).to(cuda) for x in
                      smith_waterman_inputs(n=N, L=L, W=W, above_4=above_4))
    assert kernels.sw_route(reads, windows, *params) == route
    before = dict(kernels.launch_counts)
    got = realign.smith_waterman_scores(reads, windows, *params)
    assert kernels.launch_counts == dict(before, **{route: before[route] + 1})
    want = realign.smith_waterman_scores_plain(reads, windows, *params)
    assert torch.equal(got, want)
    if route == WIDE16:
        assert torch.equal(_launch_width(WIDE, reads, windows, params), want)
    assert int(want.max()) > 8
    if params == (2, -3, -5):
        assert int(want.max()) >= 1 << 13


# each row trimmed to its own extents on the card: reads and windows
# ending in PAD at every length from 0 up, PADs inside reads and windows
# (kept), empty rows, pairs of rows of different lengths, in both widths
@pytest.mark.cuda
@pytest.mark.parametrize("N,L,W", [(1100, 1100, 160), (515, 513, 96)])
def test_smith_waterman_wide_kernel_trims_each_row(cuda, N, L, W):
    import numpy as np

    from chip_smoke import smith_waterman_inputs

    from arriba_tpu_torch.ops.encode import PAD_CODE

    reads, windows = smith_waterman_inputs(seed=29, n=N, L=L, W=W)
    rng = np.random.default_rng(N)
    rows = np.arange(N)
    extent = rows % (L + 1)                     # reads of every length
    reads[:] = rng.integers(0, 4, reads.shape)
    reads[np.arange(L)[None, :] >= extent[:, None]] = PAD_CODE
    windows[np.arange(W)[None, :] >= (rows * 7 % (W + 1))[:, None]] = \
        PAD_CODE
    inside = rows[(rows % 3 == 1) & (extent > 2)]
    reads[inside, extent[inside] // 2] = PAD_CODE
    copies = rows[rows % 2 == 0]
    span = np.minimum(extent[copies], W // 2)
    for row, n_copy in zip(copies, span):
        reads[row, :n_copy] = windows[row, :n_copy]
    reads, windows = (torch.from_numpy(x).to(cuda) for x in (reads, windows))
    want = realign.smith_waterman_scores_plain(reads, windows)
    empty = torch.from_numpy(extent == 0).to(cuda)
    assert int(want.max()) > 8 and int(want[empty].max()) == 0
    for route in (WIDE16, WIDE):
        assert torch.equal(_launch_width(route, reads, windows, (1, -1, -1)),
                           want)


# the any-k kernel at chip_smoke's k on the bench rows (first 64) and case
# (d), on the no-hit rows (the full product), on k-mers that straddle its
# stages' chunk boundaries (chip_smoke's 'straddle' rows; at k = 80 two
# parts a stage), at k = 40 and 80 (more k-steps than its B images hold)
# and on 4,096 mixed rows (each block takes rows in turn)
@pytest.mark.cuda
@pytest.mark.parametrize("case,N,k", [
    ("bench", 64, 1), ("bench", 64, 4), ("bench", 64, 12), ("bench", 64, 16),
    ("bench", 64, 31), ("odd", 333, 1), ("odd", 333, 4), ("odd", 333, 12),
    ("odd", 333, 16), ("odd", 333, 31), ("no_hit", 16, 12),
    ("no_hit", 512, 16), ("no_hit", 512, 31), ("straddle", 64, 12),
    ("straddle", 64, 31), ("straddle", 64, 80),
    ("pad", 64, 16), ("bench", 16, 40), ("bench", 16, 80),
    ("mixed", 4096, 12)])
def test_mxu_kmer_screen_any_k_matches_plain(cuda, case, N, k):
    from chip_smoke import mxu_inputs

    chunk = kernels.mxu_any_chunk(k) if case == "straddle" else None
    reads, windows = (torch.from_numpy(x[:N].copy()).to(cuda)
                      for x in mxu_inputs(case, k=k, chunk=chunk))
    before = dict(kernels.launch_counts)
    got = realign.mxu_shared_kmer_mask(reads, windows, k)
    assert kernels.launch_counts == dict(
        before, mxu_kmer_screen_any_k=before["mxu_kmer_screen_any_k"] + 1)
    want = realign.mxu_shared_kmer_mask_plain(reads, windows, k)
    assert torch.equal(got, want)
    if case == "no_hit":
        assert not bool(want.any())
    elif case == "straddle":
        assert want.tolist() == [row % 2 == 0 for row in range(N)]
    elif case in ("odd", "mixed", "pad") and k >= 8:
        # at k < 8 chance hits decide every odd row
        assert 0 < int(want.sum()) < N
    out = torch.empty(N, dtype=torch.uint8, device=cuda)
    for _ in range(3):
        out.fill_(2)
        kernels.launch_mxu_kmer_screen(reads, windows, out, k)
        assert torch.equal(out, want.to(torch.uint8))


# the chunk the built library reports, at chip_smoke's k and where the
# layout changes: the values the header's layout gives on the CPU
# (test_torch_kernel_math.test_mxu_any_k_layout)
@pytest.mark.cuda
def test_mxu_any_chunk_from_the_library(cuda):
    assert [kernels.mxu_any_chunk(k) for k in (1, 12, 16, 31, 40, 72, 80)] \
        == [2048, 1920, 1920, 1728, 512, 2048, 128]


# k past 2,048: one tile a group, the largest dot tested against k
@pytest.mark.cuda
def test_mxu_kmer_screen_any_k_one_tile_groups(cuda):
    from chip_smoke import mxu_inputs

    reads, windows = (torch.from_numpy(x).to(cuda) for x in
                      mxu_inputs("mixed", N=16, L=2100, W=2120, k=2049))
    got = realign.mxu_shared_kmer_mask(reads, windows, 2049)
    want = realign.mxu_shared_kmer_mask_plain(reads, windows, 2049)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < 16


# K1 on rows whose min_score an unseeded walk can reach, next to rows that
# take the seed lookup, at chip_smoke's shape and at the main shape's width
@pytest.mark.cuda
@pytest.mark.parametrize("N,W", [(512, 2048), (64, 8192)])
def test_accept_wavefront_kernel_every_diagonal(cuda, N, W):
    from chip_smoke import accept_low_min_score_inputs

    reads, windows, params = (torch.from_numpy(x).to(cuda) for x in
                              accept_low_min_score_inputs(N=N, W=W))
    walks_all = kernels.accept_walks_all(params, reads.shape[1])
    assert 0 < int(walks_all.sum()) < N
    got = realign.accept_wavefront(reads, windows, params)
    want = realign.accept_wavefront_plain(reads, windows,
                                          *params.unbind(dim=1))
    assert torch.equal(got, want)
    assert 0 < int(want[walks_all].sum()) < int(walks_all.sum())


# more rows than a grid dimension holds (65,535): rows on y and z
@pytest.mark.cuda
def test_accept_wavefront_kernel_many_rows(cuda):
    from chip_smoke import accept_many_rows_inputs

    reads, windows, params = (torch.from_numpy(x).to(cuda) for x in
                              accept_many_rows_inputs())
    before = kernels.launch_counts["accept_wavefront"]
    got = realign.accept_wavefront(reads, windows, params)
    assert kernels.launch_counts["accept_wavefront"] == before + 1
    want = realign.accept_wavefront_plain(reads, windows,
                                          *params.unbind(dim=1))
    assert torch.equal(got, want)
    assert 0 < int(want[65535:].sum()) < 70000 - 65535


# the data-parallel realign step on 600 bp reads (a ReadBatch 640 wide, so
# K3w), at 1 and 4 shards on the card, against the CPU
@pytest.mark.cuda
def test_sharded_realign_step_on_600bp_reads(cuda):
    from chip_smoke import realign_600bp

    result = realign_600bp(256, cpu=True)
    # one launch a shard of K3w's 16-bit pairs: 1 + 4, and none of K3 or
    # of the 32-bit lanes
    assert result["launches"]["smith_waterman_wide16"] == 5
    assert result["launches"]["smith_waterman_wide"] == 0
    assert result["launches"]["smith_waterman"] == 0


def test_smith_waterman_wrapper_checks_its_guard_before_launch(monkeypatch):
    """Shapes and scores past K3's 16-bit guard: K3's own launcher still
    refuses them before launch, and smith_waterman routes them to K3w
    (sw_route, from shapes, scores and bytes) before its one launch, K3w's
    16-bit pairs where only the length stops K3 and its 32-bit lanes
    otherwise; the 16-bit launcher refuses scores past 16 bits (a
    CUDA-free check: the tensor checks are stubbed and the launches
    recorded)."""
    launched = []
    monkeypatch.setattr(kernels, "_require", lambda *args: None)
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, *args: launched.append(name))
    out = torch.zeros(2, dtype=torch.int32)
    for L, W, params, route in (
            (513, 64, (1, -1, -1), "smith_waterman_wide16"),
            (512, 64, (16, -1, -1), "smith_waterman_wide"),
            (64, 64, (1, -1, -200), "smith_waterman_wide")):
        reads = torch.zeros(2, L, dtype=torch.uint8)
        windows = torch.zeros(2, W, dtype=torch.uint8)
        with pytest.raises(ValueError):
            kernels.launch_smith_waterman(reads, windows, out, *params)
        assert launched == []
        if route == "smith_waterman_wide":
            with pytest.raises(ValueError):
                kernels.launch_smith_waterman_wide16(
                    reads, windows, out,
                    kernels.sw_wide_carry(reads, windows,
                                          "smith_waterman_wide16"), *params)
            assert launched == []
        assert kernels.sw_route(reads, windows, *params) == route
        kernels.smith_waterman(reads, windows, *params)
        assert launched == [route]
        launched.clear()
    kernels.launch_smith_waterman(torch.zeros(2, 256, dtype=torch.uint8),
                                  torch.zeros(2, 256, dtype=torch.uint8),
                                  out)
    assert launched == ["smith_waterman"]


@pytest.mark.parametrize("where,value,ok", [
    ("reads", 4, True), ("windows", 4, True), ("reads", 5, False),
    ("windows", 7, False), ("reads", 16, False), ("windows", 255, False),
])
def test_smith_waterman_codes_guard(where, value, ok):
    """K3 takes codes 0-4: sw_codes_guard passes those and refuses any
    larger byte, and sw_route sends a batch holding one to K3w instead,
    without a launch (a CUDA-free check on CPU tensors: smith_waterman then
    reaches the chosen kernel's tensor checks, which refuse CPU tensors)."""
    reads = torch.randint(0, 5, (3, 40), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(value))
    windows = torch.randint(0, 5, (3, 70), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(7))
    (reads if where == "reads" else windows)[1, 13] = value
    before = dict(kernels.launch_counts)
    if ok:
        kernels.sw_codes_guard(reads, windows)
    else:
        with pytest.raises(ValueError, match="codes 0-4"):
            kernels.sw_codes_guard(reads, windows)
    assert kernels.sw_route(reads, windows) == (
        "smith_waterman" if ok else "smith_waterman_wide")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernels.smith_waterman(reads, windows)
    kernels.sw_codes_guard(reads[:0], windows[:0])  # empty inputs pass
    assert kernels.launch_counts == before


_AW_ARGS = (torch.zeros(2, 8, dtype=torch.uint8),
            torch.ones(2, 16, dtype=torch.uint8),
            torch.zeros(2, 5, dtype=torch.int32))
_LE_ARGS = (torch.zeros(2, 4, dtype=torch.uint8),
            torch.zeros(2, 8, dtype=torch.int32))
_SW_ARGS = (torch.zeros(2, 8, dtype=torch.uint8),
            torch.zeros(2, 16, dtype=torch.uint8))
_MK_ARGS = (torch.zeros(2, 20, dtype=torch.uint8),
            torch.zeros(2, 64, dtype=torch.uint8))
_SWW_ARGS = (torch.zeros(2, 600, dtype=torch.uint8),
             torch.zeros(2, 16, dtype=torch.uint8))
_KB_ARGS = (torch.zeros(4, 16, dtype=torch.uint8),
            torch.zeros(64, dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.tensor([[0, 0, 3]], dtype=torch.int32))
_KB_SCHEDULE = realign.screen_schedule(np.array([[0, 0, 3]]),
                                       np.array([16]), device="cpu")
_AWI_ARGS = (torch.zeros(2, 64, dtype=torch.uint8),
             torch.zeros(64, dtype=torch.uint8),
             torch.zeros(3, 2, dtype=torch.int64),
             torch.zeros(3, 5, dtype=torch.int32))


@pytest.mark.parametrize("name,args", [
    ("accept_wavefront", _AW_ARGS),
    ("launch_accept_wavefront",
     _AW_ARGS + (torch.zeros(2, dtype=torch.int32),)),
    ("low_entropy", _LE_ARGS),
    ("launch_low_entropy", _LE_ARGS + (torch.zeros(2, dtype=torch.uint8),)),
    ("smith_waterman", _SW_ARGS),
    ("launch_smith_waterman",
     _SW_ARGS + (torch.zeros(2, dtype=torch.int32),)),
    ("mxu_kmer_screen", _MK_ARGS),
    ("launch_mxu_kmer_screen",
     _MK_ARGS + (torch.zeros(2, dtype=torch.uint8),)),
    ("smith_waterman", _SWW_ARGS),
    ("launch_smith_waterman_wide",
     _SWW_ARGS + (torch.zeros(2, dtype=torch.int32),
                  torch.zeros(2, 16, dtype=torch.int32))),
    ("launch_smith_waterman_wide16",
     _SWW_ARGS + (torch.zeros(2, dtype=torch.int32),
                  torch.zeros(1, 16, dtype=torch.int32))),
    ("mxu_kmer_screen", _MK_ARGS + (12,)),
    ("launch_mxu_kmer_screen",
     _MK_ARGS + (torch.zeros(2, dtype=torch.uint8), 3)),
    ("kmer_bitmap_screen", _KB_ARGS + (_KB_SCHEDULE,)),
    ("launch_kmer_bitmap_screen",
     _KB_ARGS + (torch.zeros(3, dtype=torch.uint8), _KB_SCHEDULE)),
    ("accept_wavefront_indexed", _AWI_ARGS + (8192,)),
    ("launch_accept_wavefront_indexed",
     _AWI_ARGS + (torch.zeros(3, dtype=torch.int32), 8192)),
])
def test_kernel_wrappers_refuse_cpu_tensors(name, args):
    """A wrapper launches its kernel or raises: CPU tensors never reach it
    (the ops take their plain versions for those) and are refused."""
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(kernels, name)(*args)
    assert kernels.launch_counts == before


# the resident cases (chip_smoke.resident_case), small where the plain
# versions would take long
def _resident_cuda_cases():
    from chip_smoke import (resident_chunk_edges, resident_main,
                            resident_reads_n, resident_shared,
                            resident_short, resident_tail)

    return {"main": lambda: resident_main(contig_len=400_000, n_windows=16,
                                          win_lo=2_000, win_hi=30_000,
                                          n_pairs=2048),
            "tail": resident_tail, "short": resident_short,
            "reads_n": resident_reads_n,
            "chunk_edges": resident_chunk_edges,
            "shared": lambda: resident_shared(n_pairs=3000)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "tail", "short", "reads_n",
                                  "chunk_edges", "shared"])
def test_kmer_bitmap_screen_kernel_matches_plain(cuda, case):
    """K5's two passes on the resident tables (packed by resident_pairs,
    and the contig itself as the window table), in tasks of 64 rows at the
    default slice length and of 256 rows at 48 positions a slice, against
    its plain version, one count a call."""
    import numpy as np

    from chip_smoke import resident_layouts

    made = _resident_cuda_cases()[case]()
    for layout, resident in resident_layouts(made, cuda).items():
        for rows_per_task, slice_len in ((64, realign.KB_SLICE), (256, 48)):
            order, args, schedule = realign.screen_inputs(
                resident, np.arange(len(resident.pair_read)),
                rows_per_task=rows_per_task, slice_len=slice_len)
            before = kernels.launch_counts["kmer_bitmap_screen"]
            got = realign.kmer_bitmap_screen(*args, schedule=schedule)
            assert kernels.launch_counts["kmer_bitmap_screen"] == before + 1
            assert torch.equal(got, realign.kmer_bitmap_screen_plain(
                *args)), (layout, slice_len)
            if case == "tail":
                verdict = np.zeros(len(order), bool)
                verdict[order] = got.cpu().numpy()
                assert not verdict[0::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slice_plus_7", "slice_plus_8",
                                  "two_slices_plus_6", "unnamed_window",
                                  "one_row_tasks", "short_reads",
                                  "long_reads"])
def test_kmer_bitmap_screen_kernel_edges(cuda, case):
    """K5 on the edges of its schedule (chip_smoke.kb_edge_case: windows at
    a slice's edges with 8-mers planted across them, a window no task
    names, tasks of one row, reads of 0-8 bytes, reads past 256 bytes)
    against its plain version, with the schedule given and made by
    realign.kmer_bitmap_screen, one count a call each."""
    import numpy as np

    from chip_smoke import kb_edge_case

    (contig, spans, reads, _), left_out, rows_per_task = kb_edge_case(case)
    resident = realign.resident_pairs(
        reads, [contig[a:a + n] for a, n in spans], cuda)
    pairs = np.flatnonzero(resident.pair_window != (
        -1 if left_out is None else left_out))
    _, args, schedule = realign.screen_inputs(resident, pairs,
                                              rows_per_task=rows_per_task)
    want = realign.kmer_bitmap_screen_plain(*args)
    for given in (schedule, None):
        before = kernels.launch_counts["kmer_bitmap_screen"]
        got = realign.kmer_bitmap_screen(*args, schedule=given)
        assert kernels.launch_counts["kmer_bitmap_screen"] == before + 1
        assert torch.equal(got, want), given is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "short", "reads_n",
                                  "chunk_edges", "shared"])
def test_accept_wavefront_indexed_kernel_matches_plain(cuda, case):
    """K1's indexed entry on the rows of a case's first 256 pairs, over
    both layouts, against its plain version; no "tail" row accepts."""
    import numpy as np

    from chip_smoke import resident_layouts

    made = _resident_cuda_cases()[case]()
    n = min(len(made[2]), 256)
    for layout, resident in resident_layouts(made, cuda).items():
        _, offsets, params = realign.resident_accept_rows(
            resident, np.arange(n), np.asarray(made[3][:n]))
        o, p = (torch.from_numpy(x).to(cuda) for x in (offsets, params))
        before = kernels.launch_counts["accept_wavefront_indexed"]
        got = realign.accept_wavefront_indexed(resident.accept_reads,
                                               resident.table, o, p, 8192)
        assert kernels.launch_counts["accept_wavefront_indexed"] == before + 1
        want = realign.accept_wavefront_indexed_plain(
            resident.accept_reads, resident.table, o, p, 8192)
        assert torch.equal(got, want), layout
        if case == "tail":
            assert not bool(want.any())


@pytest.mark.cuda
def test_screen_and_accept_pairs_on_the_card_match_the_cpu(cuda):
    """screen_pairs and accept_pairs on the card (K5, K1's indexed entry,
    the verdicts folded on the card) give the CPU's answers."""
    from chip_smoke import resident_reads_n

    contig, spans, reads, min_scores = resident_reads_n()
    windows = [contig[a:a + n] for a, n in spans]
    cpu = torch.device("cpu")
    for function, extra in ((realign.screen_pairs, ()),
                            (realign.accept_pairs, (min_scores,))):
        got = function(reads, windows, *extra, device=cuda)
        want = function(reads, windows, *extra, device=cpu)
        assert (got == want).all() and want.any(), function.__name__


@pytest.mark.cuda
def test_plain_ops_on_the_card_match_the_cpu(cuda):
    """The offloaded ops without a kernel of their own (pileup histogram,
    blacklist and annotation interval triage, 8-mer screen, the fused
    read-filter step) give on the card what they give on the CPU."""
    import numpy as np

    from arriba_tpu_torch.entry import entry
    from arriba_tpu_torch.ops import annotation, blacklist, pileup

    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 7, 4000).astype(np.int32))
    cols = torch.from_numpy(rng.integers(-4, 68, 4000).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 5, 4000).astype(np.int32))
    assert torch.equal(
        pileup.pileup_histogram(codes.to(cuda), cols.to(cuda), rows.to(cuda),
                                5, 64).cpu(),
        pileup.pileup_histogram(codes, cols, rows, 5, 64))
    for got, want in zip(
            pileup.pileup_consensus(codes.to(cuda), cols.to(cuda),
                                    rows.to(cuda), 5, 64),
            pileup.pileup_consensus(codes, cols, rows, 5, 64)):
        assert torch.equal(got.cpu(), want)

    f_contig = rng.integers(0, 3, 60)
    f_start = rng.integers(0, 40000, 60)
    f_end = f_start + rng.integers(10, 2000, 60)
    queries = [(int(c), int(s), int(s) + 150) for c, s in zip(
        rng.integers(0, 3, 500), rng.integers(0, 45000, 500))]
    triage = [annotation.interval_overlap_triage(
        queries, f_contig, f_start, f_end, 3, device=device)
        for device in (cuda, torch.device("cpu"))]
    np.testing.assert_array_equal(*triage)
    offsets = blacklist.contig_offsets([50000, 50000, 50000])
    points = torch.from_numpy(offsets[f_contig].astype(np.int64) + f_start)
    hits = [blacklist.query_points(
        *blacklist.build_range_index(f_contig, f_start, f_end + 5, offsets,
                                     device), points.to(device)).cpu()
        for device in (cuda, torch.device("cpu"))]
    assert torch.equal(*hits) and bool(hits[0].all())

    reads = torch.from_numpy(rng.integers(0, 4, (64, 192)).astype(np.uint8))
    windows = torch.from_numpy(rng.integers(0, 4, (64, 8192))
                               .astype(np.uint8))
    windows[::2, 100:108] = reads[::2, 10:18]
    assert torch.equal(realign.shared_kmer_mask(reads.to(cuda),
                                                windows.to(cuda)).cpu(),
                       realign.shared_kmer_mask(reads, windows))

    card, host = ({key: value.cpu() for key, value in fn(*args).items()}
                  for fn, args in (entry(cuda), entry(torch.device("cpu"))))
    for key in ("mismatches", "alignment_length", "low_entropy_discard"):
        assert torch.equal(card[key], host[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("sample,env", [
    ("multi_event_sample", {"ARRIBA_TPU_TORCH_NO_NATIVE": "1"}),
    ("spliced_homolog_sample", {"ARRIBA_TPU_TORCH_NO_NATIVE_EVENT": "1"}),
    ("multi_event_sample", {"ARRIBA_TPU_TORCH_NO_NATIVE": "1",
                            "ARRIBA_TPU_TORCH_SHARDED_STATS": "4"}),
], ids=["python_engine", "python_events", "python_engine_sharded4"])
def test_cli_on_the_card_matches_the_host_path(cuda, tmp_path, sample, env):
    """The CLI with its offloaded stages on the card: the pure-Python
    engine (annotation triage, writer pileup, screen, accept), the Python
    event stages, and the pure-Python engine with its mid-cascade
    statistics over four row shards on the card give the host path's bytes
    and counters."""
    from . import scenario
    from .torch_cli import assert_same_outputs, run_cli

    args = getattr(scenario, sample)(tmp_path)
    assert_same_outputs(
        run_cli("arriba_tpu_torch", args, tmp_path, "host",
                {key: value for key, value in env.items()
                 if key != "ARRIBA_TPU_TORCH_SHARDED_STATS"}
                | {"ARRIBA_TPU_TORCH_DEVICE": "off"}),
        run_cli("arriba_tpu_torch", args, tmp_path, "card",
                dict(env, ARRIBA_TPU_TORCH_DEVICE="cuda")))
