"""The port on the card: the CUDA kernels (K1-K4) against their plain
PyTorch versions, the other offloaded ops and whole CLI runs against the
CPU and host paths, and the kernel wrappers' argument checks. The tests
that need a CUDA device are marked ``cuda`` and skip without one;
``python3 chip_smoke.py`` runs the kernel comparison at the main path's
shapes."""

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
@pytest.mark.parametrize("L,W,params", [(513, 256, (1, -1, -1)),
                                        (512, 256, (16, -1, -1)),
                                        (256, 256, (1, -200, -1))])
def test_smith_waterman_kernel_refuses_past_its_guard(cuda, L, W, params):
    reads = torch.zeros(4, L, dtype=torch.uint8, device=cuda)
    windows = torch.zeros(4, W, dtype=torch.uint8, device=cuda)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError):
        realign.smith_waterman_scores(reads, windows, *params)
    assert kernels.launch_counts == before


# a byte above code 4 in a read or a window: K3 reads code bit 2 as PAD and
# ships window codes in 3 bits, so smith_waterman refuses such a byte
@pytest.mark.cuda
@pytest.mark.parametrize("where,value", [("reads", 5), ("windows", 16)])
def test_smith_waterman_kernel_refuses_bytes_above_code_4(cuda, where,
                                                          value):
    reads = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    windows = torch.zeros(4, 64, dtype=torch.uint8, device=cuda)
    (reads if where == "reads" else windows)[2, 7] = value
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="codes 0-4"):
        realign.smith_waterman_scores(reads, windows)
    assert kernels.launch_counts == before


# rows past the packed counters' 3,072 codes (the three-counter kernel),
# the packed counters' widest rows, and a batch of rows too short to scan
@pytest.mark.cuda
@pytest.mark.parametrize("L,short", [(3100, False), (3072, False),
                                     (150, True)])
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
    got = readfilters._low_entropy_core_packed(packed, L, meta)
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta.unbind(dim=1))
    assert torch.equal(got, want)
    assert (int(want.sum()) == 0) if short else (0 < int(want.sum()) < 1000)


# K4 on chip_smoke.py's phase-2 cases, (a)-(c) on the first rows of the
# bench shape: the bench rows (early exits), no hit anywhere (the full
# product), PAD tails and bytes above 4, and 333 x 45 x 1,001
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


# odd N and one row; reads of 19 and 17 read tiles (two register groups)
# against windows of several chunks; rows narrower than one tile; reads or
# windows too short for an 8-mer; bytes 0-5 throughout
@pytest.mark.cuda
@pytest.mark.parametrize("N,L,W", [(1, 152, 8008), (17, 300, 5000),
                                   (31, 263, 2100), (65, 20, 12),
                                   (9, 7, 100), (9, 100, 7)])
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


@pytest.mark.cuda
def test_mxu_kmer_screen_kernel_refusals(cuda):
    """K4's wrapper refuses a wrong dtype, device, layout or row count
    before launch, and launches nothing for no rows; the op refuses k != 8
    on the card."""
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
    with pytest.raises(ValueError, match="8-mers"):
        realign.mxu_shared_kmer_mask(reads, windows, k=7)
    assert kernels.launch_counts == before
    assert realign.mxu_shared_kmer_mask(reads[:0], windows[:0]).shape == (0,)
    assert kernels.launch_counts == before


def test_smith_waterman_wrapper_checks_its_guard_before_launch(monkeypatch):
    """The wrapper refuses shapes and scores past K3's 16-bit guard before
    anything is launched (a CUDA-free check: the tensor checks are stubbed
    and a launch would fail the test)."""
    def no_launch(*args):
        raise AssertionError("launched past the guard")

    monkeypatch.setattr(kernels, "_require", lambda *args: None)
    monkeypatch.setattr(kernels, "_launch", no_launch)
    out = torch.zeros(2, dtype=torch.int32)
    for L, W, params in ((513, 64, (1, -1, -1)), (512, 64, (16, -1, -1)),
                         (64, 64, (1, -1, -200))):
        with pytest.raises(ValueError):
            kernels.launch_smith_waterman(
                torch.zeros(2, L, dtype=torch.uint8),
                torch.zeros(2, W, dtype=torch.uint8), out, *params)
    with pytest.raises(AssertionError, match="launched"):
        kernels.launch_smith_waterman(torch.zeros(2, 256, dtype=torch.uint8),
                                      torch.zeros(2, 256, dtype=torch.uint8),
                                      out)


@pytest.mark.parametrize("where,value,ok", [
    ("reads", 4, True), ("windows", 4, True), ("reads", 5, False),
    ("windows", 7, False), ("reads", 16, False), ("windows", 255, False),
])
def test_smith_waterman_codes_guard(where, value, ok):
    """K3 takes codes 0-4: sw_codes_guard passes those and refuses any
    larger byte, and smith_waterman refuses it before its tensor checks and
    its launch (a CUDA-free check on CPU tensors)."""
    reads = torch.randint(0, 5, (3, 40), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(value))
    windows = torch.randint(0, 5, (3, 70), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(7))
    (reads if where == "reads" else windows)[1, 13] = value
    before = dict(kernels.launch_counts)
    if ok:
        kernels.sw_codes_guard(reads, windows)
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            kernels.smith_waterman(reads, windows)
    else:
        for call in (kernels.sw_codes_guard, kernels.smith_waterman):
            with pytest.raises(ValueError, match="codes 0-4"):
                call(reads, windows)
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
])
def test_kernel_wrappers_refuse_cpu_tensors(name, args):
    """A wrapper launches its kernel or raises: CPU tensors never reach it
    (the ops take their plain versions for those) and are refused."""
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(kernels, name)(*args)
    assert kernels.launch_counts == before


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
