"""The mismapper screen and K1 on resident tables (arriba_tpu_torch/ops/
realign.py: resident_pairs, screen_resident and K5's plain version,
accept_rows, accept_resident and K1's indexed plain version), on the CPU:
the vectorised rows against the row generator they replace, the verdicts
against the JAX package's screen_pairs and accept_pairs (each window
whole, or in the chunks the JAX package cuts), device_screen against the
JAX package's on a scenario sample, and the kernels' wrappers, which raise
where a build or a launch fails."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from arriba_tpu.ops import realign as jax_realign  # noqa: E402
from arriba_tpu_torch import kernels  # noqa: E402
from arriba_tpu_torch.kernels import build  # noqa: E402
from arriba_tpu_torch.ops import realign  # noqa: E402
from arriba_tpu_torch.seq import reverse_complement_str  # noqa: E402
from chip_smoke import (resident_chunk_edges, resident_layouts,  # noqa: E402
                        resident_main, resident_reads_n, resident_shared,
                        resident_short, resident_tail)

from . import scenario  # noqa: E402
from .torch_cli import run_cli  # noqa: E402

CPU = torch.device("cpu")
WINDOW_CHUNK = 8192


def _old_accept_rows(read_seqs, window_views, min_scores, window_chunk):
    """The row generator accept_pairs used before the windows stayed on the
    device, one (pair, forward or reverse complement read row, window
    chunk padded with 1, params) a row."""
    max_read = max(len(seq) for seq in read_seqs)
    L = -(-max(16, max_read) // 64) * 64
    stride = window_chunk - 2 * L
    for i, (seq, window) in enumerate(zip(read_seqs, window_views)):
        raw = np.frombuffer(seq.encode("latin-1"), np.uint8)
        fwd = np.zeros(L, np.uint8)
        fwd[:len(raw)] = raw
        rc_raw = np.frombuffer(reverse_complement_str(seq).encode("latin-1"),
                               np.uint8)
        rc = np.zeros(L, np.uint8)
        rc[:len(rc_raw)] = rc_raw
        c = 0
        while True:
            offset = c * stride
            chunk = window[offset:offset + window_chunk]
            lo = 0 if c == 0 else L
            hi = lo + stride - 1 if c > 0 else stride + L - 1
            if lo > len(chunk) - 10 and c > 0:
                break
            padded = np.ones(window_chunk, np.uint8)
            padded[:len(chunk)] = chunk
            meta = (len(raw), len(chunk), int(min_scores[i]), lo, hi)
            yield i, fwd, padded, meta
            yield i, rc, padded, meta
            c += 1
            if offset + window_chunk >= len(window):
                break


def _window_lengths(case):
    stride = WINDOW_CHUNK - 2 * 192
    return {
        "0_7_8_9": [0, 7, 8, 9],
        "chunk_edges": [WINDOW_CHUNK - 1, WINDOW_CHUNK, WINDOW_CHUNK + 1],
        "stride_edges": [k * stride + WINDOW_CHUNK + d for k in (1, 2, 3)
                         for d in (-1, 0, 1)],
        "random": list(np.random.default_rng(5).integers(0, 40_000, 40)),
    }[case]


@pytest.mark.parametrize("case", ["0_7_8_9", "chunk_edges", "stride_edges",
                                  "random"])
def test_accept_rows_match_the_generator(case):
    """resident_accept_rows (accept_rows, the offsets into the resident
    tables) gives the old generator's rows in its order: each row's read
    bytes, window bytes up to its win_len, and params, for window lengths
    at every edge of the chunking and reads from 0 bp to L (192)."""
    rng = np.random.default_rng(11)
    lengths = _window_lengths(case)
    contig = np.frombuffer(b"ACGTN", np.uint8)[
        rng.integers(0, 5, max(lengths) + 1000)]
    read_lengths = [0, 1, 8, 9, 10, 100, 150, 191, 192]
    reads, windows, min_scores = [], [], []
    for w, n in enumerate(lengths):
        for k, read_len in enumerate(read_lengths[w % 3::3]):
            start = int(rng.integers(0, len(contig) - read_len))
            reads.append(contig[start:start + read_len].tobytes().decode())
            windows.append(contig[w:w + n])
            min_scores.append(int(0.8 * read_len + 0.5) - k)
    resident = realign.resident_pairs(reads, windows, CPU)
    row_pair, offsets, params = realign.resident_accept_rows(
        resident, np.arange(len(reads)), min_scores, WINDOW_CHUNK)
    old = list(_old_accept_rows(reads, windows, min_scores, WINDOW_CHUNK))
    assert len(old) == len(row_pair)
    flat = resident.accept_reads.numpy().reshape(-1)
    table = resident.table.numpy()
    width = resident.accept_reads.shape[1]
    for row, (pair, read_row, window_row, meta) in enumerate(old):
        assert row_pair[row] == pair
        assert tuple(params[row]) == meta
        got_read = flat[offsets[row, 0]:offsets[row, 0] + width]
        np.testing.assert_array_equal(got_read[:len(read_row)], read_row)
        win_len = meta[1]
        np.testing.assert_array_equal(
            table[offsets[row, 1]:offsets[row, 1] + win_len],
            window_row[:win_len])


def _small_main():
    return resident_main(contig_len=300_000, n_windows=8, win_lo=2_000,
                         win_hi=20_000, n_pairs=384)


# the tail case at 1,024-byte chunks (SMALL_CHUNK): windows around one and
# two chunks
def _small_tail():
    return resident_tail(lengths=(0, 7, 20, 100, 600, 1023, 1024, 1025,
                                  2100))


_CASES = {
    "main": _small_main,
    "tail": _small_tail,
    "short": resident_short,
    "reads_n": resident_reads_n,
    "chunk_edges": resident_chunk_edges,
    "shared": lambda: resident_shared(n_pairs=300),
}


def _views(case):
    contig, spans, reads, min_scores = case
    return reads, [contig[a:a + n] for a, n in spans], min_scores


@pytest.mark.parametrize("case", list(_CASES))
def test_screen_matches_jax(case):
    """screen_pairs (K5's plain version, each pair against its whole
    window) equals the JAX package's screen_pairs (sorted screen over
    windows in chunks overlapping by 7), and so does the screen over the
    contig itself as the window table (windows at unaligned offsets, the
    bytes past each window the contig's): a read whose 8-mers occur only
    across its window's end ("tail", even pairs) shares none."""
    made = _CASES[case]()
    reads, windows, _ = _views(made)
    want = jax_realign.screen_pairs(reads, windows)
    got = realign.screen_pairs(reads, windows, device=CPU)
    np.testing.assert_array_equal(got, want)
    layouts = resident_layouts(made, CPU)
    np.testing.assert_array_equal(realign.screen_resident(layouts["contig"]),
                                  want)
    if case == "tail":
        assert not got[0::2].any() and got[1::2].any()
    if case == "shared":
        assert got.any() and not got.all()


# K1's chunks here: 1,024 bytes at a stride of 640 for 150 bp reads (L =
# 192), the chunking of the 8,192-byte chunks at an eighth of the steps
SMALL_CHUNK = 1024

_ACCEPT_CASES = dict(_CASES, chunk_edges=lambda: resident_chunk_edges(
    window_chunk=SMALL_CHUNK))


@pytest.mark.parametrize("case", ["tail", "short", "reads_n", "chunk_edges",
                                  "shared"])
def test_accept_matches_jax(case):
    """accept_pairs (K1's indexed plain version over the resident tables)
    equals the JAX package's accept_pairs, and so do K1's rows over the
    contig as the window table, where the bytes past a chunk's win_len are
    the window's or the contig's next bytes: no "tail" read accepts (each
    matches 119 bytes inside its window at min_score 120, 120 with one
    byte past it)."""
    made = _ACCEPT_CASES[case]()
    reads, windows, min_scores = _views(made)
    n = min(len(reads), 40)
    reads, windows, min_scores = reads[:n], windows[:n], min_scores[:n]
    want = jax_realign.accept_pairs(reads, windows, min_scores,
                                    window_chunk=SMALL_CHUNK)
    got = realign.accept_pairs(reads, windows, min_scores,
                               window_chunk=SMALL_CHUNK, device=CPU)
    np.testing.assert_array_equal(got, want)
    contig_layout = resident_layouts(made, CPU)["contig"]
    np.testing.assert_array_equal(
        realign.accept_resident(contig_layout, np.arange(n),
                                np.asarray(min_scores), SMALL_CHUNK), want)
    if case == "tail":
        assert not got.any()
    elif case != "short":
        assert got.any()


def test_accept_batches_fold_onto_their_pairs():
    """Rows that span several launches (batch_rows 7) fold onto their pairs
    as one launch does."""
    reads, windows, min_scores = (x[:16] for x in _views(resident_reads_n()))
    whole = realign.accept_pairs(reads, windows, min_scores,
                                 window_chunk=SMALL_CHUNK, device=CPU)
    assert whole.any()
    np.testing.assert_array_equal(
        realign.accept_pairs(reads, windows, min_scores,
                             window_chunk=SMALL_CHUNK, batch_rows=7,
                             device=CPU), whole)
    np.testing.assert_array_equal(
        realign.screen_pairs(reads, windows, batch_rows=5, device=CPU),
        realign.screen_pairs(reads, windows, device=CPU))


@pytest.mark.parametrize("rows_per_task", [1, 3, 256])
def test_screen_tasks_cut_each_window(rows_per_task):
    """screen_tasks orders the rows by window and cuts each window's rows
    into tasks of at most rows_per_task: every row in one task, of its own
    window."""
    rng = np.random.default_rng(rows_per_task)
    row_window = rng.integers(0, 9, 700) ** 2
    order, tasks = realign.screen_tasks(row_window, rows_per_task)
    assert sorted(order) == list(range(700))
    covered = np.zeros(700, int)
    for window, first, end in tasks:
        assert 0 < end - first <= rows_per_task
        assert (row_window[order[first:end]] == window).all()
        covered[first:end] += 1
    assert (covered == 1).all()
    assert realign.screen_tasks(row_window[:0])[1].shape == (0, 3)


@pytest.mark.parametrize("slice_len", [16, 48, realign.KB_SLICE])
@pytest.mark.parametrize("case", ["main", "short", "reads_n", "shared"])
def test_screen_schedule_covers_each_position_once(case, slice_len):
    """screen_inputs' schedule (screen_schedule), on a case's pairs less
    those of one window: the ranks are compact (0, 1, ... over the windows
    the tasks name, in increasing order, and no other), each task names its
    window's rank, and every position [0, len - 7) of every window in use
    is in exactly one slice of at most slice_len positions, no slice
    empty; the schedule's bytes count as uploaded rows."""
    made = _CASES[case]()
    resident = realign.resident_pairs(*_views(made)[:2], CPU)
    pairs = np.flatnonzero(resident.pair_window
                           != resident.pair_window[len(made[2]) // 2])
    rows_before = resident.uploaded["rows"]
    order, args, schedule = realign.screen_inputs(resident, pairs,
                                                  slice_len=slice_len)
    tasks = args[5].numpy()
    rank_window = schedule.rank_window.numpy()
    used = np.unique(resident.pair_window[pairs])
    np.testing.assert_array_equal(rank_window, used)
    np.testing.assert_array_equal(rank_window[schedule.task_rank.numpy()],
                                  tasks[:, 0])
    assert schedule.slice_len == slice_len
    covered = [np.zeros(max(int(resident.win_len[w]) - 7, 0), int)
               for w in rank_window]
    for rank, first in schedule.slices.numpy():
        n_pos = len(covered[rank])
        assert first % slice_len == 0 and first < n_pos
        covered[rank][first:first + slice_len] += 1
    assert all((c == 1).all() for c in covered)
    assert resident.uploaded["rows"] - rows_before == (
        sum(x.numel() * x.element_size() for x in args[2:])
        + schedule.nbytes())


def test_resident_tables_hold_each_window_and_read_once():
    """resident_pairs copies each distinct window (views of one buffer at
    one offset and length) and each distinct read once: windows from
    16-byte boundaries, 1 up to the next and kernels.AW_TABLE_SLACK past
    the last; reads as raw rows in both orientations, which K5 codes as
    the JAX package's screen codes each orientation; the bytes copied
    counted. Window ids given by the caller name the windows in place of
    the views' addresses."""
    contig = np.frombuffer(b"ACGTN", np.uint8)[
        np.random.default_rng(3).integers(0, 5, 5000)]
    windows = [contig[10:1010], contig[10:1010], contig[500:517],
               contig[10:1010], contig[0:0]]
    reads = ["ACGTNACGT", "TTGCA", "ACGTNACGT", "", "GGGGCCCCAAAATTTTN"]
    resident = realign.resident_pairs(reads, windows, CPU)
    assert resident.pair_window.tolist() == [0, 0, 1, 0, 2]
    assert resident.pair_read.tolist() == [0, 1, 0, 2, 3]
    assert resident.win_offset.tolist() == [0, 1008, 1040]
    table = resident.table.numpy()
    assert len(table) == 1040 + kernels.AW_TABLE_SLACK
    np.testing.assert_array_equal(table[0:1000], contig[10:1010])
    np.testing.assert_array_equal(table[1008:1025], contig[500:517])
    assert (table[1000:1008] == 1).all() and (table[1025:] == 1).all()
    raw = resident.accept_reads.numpy()
    codes = realign._kmer_codes_bytes(resident.accept_reads).numpy()
    for r, seq in enumerate(["ACGTNACGT", "TTGCA", "", "GGGGCCCCAAAATTTTN"]):
        rc = reverse_complement_str(seq).encode()
        assert raw[2 * r, :len(seq)].tobytes() == seq.encode()
        assert raw[2 * r + 1, :len(seq)].tobytes() == rc
        assert (raw[2 * r:2 * r + 2, len(seq):] == 0).all()
        back = np.frombuffer(seq[::-1].encode(), np.uint8)
        np.testing.assert_array_equal(codes[2 * r + 1, :len(seq)],
                                      jax_realign._SCREEN_RC_LUT[back])
        np.testing.assert_array_equal(
            codes[2 * r, :len(seq)],
            jax_realign._SCREEN_LUT[np.frombuffer(seq.encode(), np.uint8)])
    assert resident.uploaded == {"windows": table.nbytes,
                                 "reads": raw.nbytes, "rows": 0}
    named = realign.resident_pairs(reads, [w.copy() for w in windows], CPU,
                                   window_ids=[7, 7, 3, 7, 5])
    assert named.pair_window.tolist() == [2, 2, 0, 2, 1]
    assert named.win_len.tolist() == [17, 0, 1000]


_DUMP = r"""
import importlib, json, sys
cli = importlib.import_module("{package}.cli")
mismappers = importlib.import_module("{package}.filters.mismappers")
inner = mismappers.device_screen
verdicts = {{}}
def recording(*args, **kwargs):
    result = inner(*args, **kwargs)
    verdicts.update(result)
    return result
mismappers.device_screen = recording
status = cli.main(sys.argv[1:])
with open({dump!r}, "w") as handle:
    json.dump(sorted(list(key) + [value] for key, value in verdicts.items()),
              handle)
sys.exit(status)
"""


def test_device_screen_matches_jax_package(tmp_path):
    """device_screen's tri-state verdicts on a translocation sample (the
    Python event stages, every candidate pair through the screen) equal
    the JAX package's, bit for bit, rejects and undecided pairs both."""
    args = scenario.translocation_sample(tmp_path)
    got = {}
    for package, env in (
            ("arriba_tpu", {"ARRIBA_TPU_DEVICE": "1",
                            "ARRIBA_TPU_NO_NATIVE_EVENT": "1"}),
            ("arriba_tpu_torch", {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
                                  "ARRIBA_TPU_TORCH_NO_NATIVE_EVENT": "1"})):
        dump = tmp_path / f"{package}.json"
        rc, _, _, _, stderr = run_cli(
            package, args, tmp_path, package, env,
            wrapper=_DUMP.format(package=package, dump=str(dump)))
        assert rc == 0, stderr[-2000:]
        got[package] = json.loads(dump.read_text())
    assert got["arriba_tpu_torch"] == got["arriba_tpu"]
    states = {verdict for *_, verdict in got["arriba_tpu"]}
    assert {0, 1} <= states, states


class _OnTheCard:
    """A CPU tensor that says it lies on the card, so that a wrapper's
    checks pass and its launch is reached (stubbed by the tests)."""

    def __init__(self, tensor):
        self.tensor = tensor
        self.is_cuda = True
        self.dtype = tensor.dtype
        self.shape = tensor.shape
        self.device = CPU

    def dim(self):
        return self.tensor.dim()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.tensor.data_ptr()

    def numel(self):
        return self.tensor.numel()


def _card_args(name):
    """A launch's arguments, out included, as tensors on the card (K5's
    with its schedule: the window's 9 positions in one slice)."""
    z = torch.zeros
    if name == "kmer_bitmap_screen":
        tasks = torch.tensor([[0, 0, 3]], dtype=torch.int32)
        lengths = torch.tensor([16], dtype=torch.int32)
        schedule = realign.screen_schedule(tasks.numpy(), lengths.numpy(),
                                           device=CPU)
        for field in ("rank_window", "task_rank", "slices"):
            setattr(schedule, field, _OnTheCard(getattr(schedule, field)))
        return [_OnTheCard(x) for x in (
            z(4, 16, dtype=torch.uint8), z(64, dtype=torch.uint8),
            z(1, dtype=torch.int64), lengths, z(3, dtype=torch.int32), tasks,
            z(3, dtype=torch.uint8))] + [schedule]
    return [_OnTheCard(x) for x in (
        z(2, 64, dtype=torch.uint8), z(64, dtype=torch.uint8),
        z(3, 2, dtype=torch.int64), z(3, 5, dtype=torch.int32),
        z(3, dtype=torch.int32))] + [8192]


@pytest.mark.parametrize("name", ["kmer_bitmap_screen",
                                  "accept_wavefront_indexed"])
@pytest.mark.parametrize("failure", ["launch", "build"])
def test_kernel_failures_raise(monkeypatch, tmp_path, name, failure):
    """K5 and K1's indexed entry on the card launch or raise: a launch that
    returns a CUDA error (for K5, of either of its two passes, the other
    launching), or a build that nvcc fails, raises RuntimeError, counts no
    launch, and gives no verdict (nothing falls back to the plain
    version)."""
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    if failure == "build":
        monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
        monkeypatch.setattr(build, "nvcc", lambda: "false")
        monkeypatch.setattr(build, "_loaded", {})
        failings = [None]
    else:
        failings = (["kmer_bitmap_build", "kmer_bitmap_test"]
                    if name == "kmer_bitmap_screen" else [name])
    for failing in failings:
        launched = []
        if failure == "launch":
            def load(entry, failing=failing, launched=launched):
                def launch(*args):
                    launched.append(entry)
                    return 700 if entry == failing else 0
                return launch, lambda code: "an illegal memory access"

            monkeypatch.setattr(build, "load", load)
        before = dict(kernels.launch_counts)
        with pytest.raises(RuntimeError, match="failed to launch"
                           if failure == "launch" else "nvcc failed"):
            getattr(kernels, f"launch_{name}")(*_card_args(name))
        assert kernels.launch_counts == before
        if failure == "launch":
            assert launched[-1] == failing
