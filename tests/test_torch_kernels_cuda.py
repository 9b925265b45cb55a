"""The port on the card: the CUDA kernels against their plain PyTorch
versions, the other offloaded ops and whole CLI runs against the CPU and
host paths, and the kernel wrappers' argument checks. The tests that need a
CUDA device are marked ``cuda`` and skip without one; ``python3
chip_smoke.py`` runs the kernel comparison at the main path's shapes."""

import pytest
import torch

from arriba_tpu_torch import kernels
from arriba_tpu_torch.ops import readfilters, realign


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,W", [(64, 1024), (512, 8192)])
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


_AW_ARGS = (torch.zeros(2, 8, dtype=torch.uint8),
            torch.ones(2, 16, dtype=torch.uint8),
            torch.zeros(2, 5, dtype=torch.int32))
_LE_ARGS = (torch.zeros(2, 4, dtype=torch.uint8),
            torch.zeros(2, 8, dtype=torch.int32))
_SW_ARGS = (torch.zeros(2, 8, dtype=torch.uint8),
            torch.zeros(2, 16, dtype=torch.uint8))


@pytest.mark.parametrize("name,args", [
    ("accept_wavefront", _AW_ARGS),
    ("launch_accept_wavefront",
     _AW_ARGS + (torch.zeros(2, dtype=torch.int32),)),
    ("low_entropy", _LE_ARGS),
    ("launch_low_entropy", _LE_ARGS + (torch.zeros(2, dtype=torch.uint8),)),
    ("smith_waterman", _SW_ARGS),
    ("launch_smith_waterman",
     _SW_ARGS + (torch.zeros(2, dtype=torch.int32),)),
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
