#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (arriba_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

0. The card: ``nvidia-smi`` name and power limit, torch's device name.
1. Build: the native engine (g++, from native/*.cpp) and the CUDA kernels
   (nvcc for sm_90a, from arriba_tpu_torch/kernels/csrc), with the seconds
   each took.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, with exact equality: K1 (accept wavefront) at
   512 rows x 192 read bytes x 8192 window bytes, K2 (low-entropy scan) at
   131,072 reads x 150 codes, K3 (Smith-Waterman scores) at 65,536 rows x
   256 read codes x 256 window codes. Kernel time is the median of
   CUDA-event timed launches after a warm-up, inputs checked and output
   allocated ahead; the bound is the larger of bytes over the memory rate
   and the operations the algorithm needs over the peak scalar rate.
3. The main path: the genome-scale 150 bp sample (bench_samples.build_tier2)
   through the port's CLI, in-process: (A) offload on the card with the
   event-level stages in Python (ARRIBA_TPU_TORCH_DEVICE=cuda
   ARRIBA_TPU_TORCH_NO_NATIVE_EVENT=1), which runs K2 in the read cascade and
   K1 in filter_mismappers; (B) the host path (DEVICE=off); (C) offload with
   the default native event stages (K2 only); (D) C with the mid-cascade
   statistics over four row shards on the card
   (ARRIBA_TPU_TORCH_SHARDED_STATS=4); (E) C with them across one NCCL rank
   per card (=<cards>procs), which also merges the candidate clusters and
   checks them against the host fusion table. The output files and every
   stage counter must be byte-equal across the runs, and K1 and K2 must have
   launched in run A. Each run reports its seconds and those of the
   offloaded ops. The sample is built at full size.
4. The flagship step (arriba_tpu_torch.entry) on the card against the CPU.
5. The data-parallel path at full size: entry.sharded_check on run A's
   pipeline state at 1 and 4 row shards on the card (the filter step over
   every tensorized mate, the realignment step with K3, the cluster step
   over the whole fusion table, the stats step), equal between the two and
   with the host fusion table; K3 must have launched in this phase.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

# published peak rates of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth, and 67 TFLOP/s float32 outside the tensor cores.
# The data sheet gives no integer rate; its scalar float32 rate stands in
# as the peak for the kernels' integer operations, so the bound stays a
# lower bound on the time.
MEMORY_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# integer operations the algorithm needs per unit of work; loads and stores
# are counted as bytes, tests fixed per read or per diagonal are hoisted
# out, and base codes are computed once per byte.
# K1, one valid (read, window) cell of a diagonal walk:
AW_OPS = {"byte match": 1, "code match": 1, "streak start": 2,
          "seed eligibility (i in the diagonal's interval, window not N)": 4,
          "streak eligibility": 2, "bsave": 2, "seed streak q": 2,
          "seed fires": 2, "seed score reaches min_score": 1,
          "mismatch run": 2, "walk score": 2, "walk dies": 2, "accept": 4,
          "fired score": 1, "best score": 1, "a": 2, "b": 2,
          "loop and exit": 3}
# K2, one scanned position of a read (the aligned-segment tests are
# position ranges fixed per read):
LE_OPS = {"code extract": 2, "3-mer shift": 3, "selection": 5,
          "three counters": 3, "three threshold tests": 5,
          "selected / crossed branches": 2, "loop": 2}
# K3, one valid (read, window) cell (a read and a window byte both not PAD):
SW_OPS = {"match test and select": 2, "three candidate adds": 3,
          "max of four": 3, "running best": 1}
AW_OPS_PER_CELL = sum(AW_OPS.values())          # 36
LE_OPS_PER_POSITION = sum(LE_OPS.values())      # 22
SW_OPS_PER_CELL = sum(SW_OPS.values())          # 9


def log(message: str) -> None:
    print(message, flush=True)


def cuda_ms(fn, runs: int, setup=None, warm_up: bool = True) -> float:
    """Median milliseconds of fn() over runs CUDA-event timed calls, after
    one warm-up call unless the caller has just made one; setup(), when
    given, runs before each call outside the timed window."""
    import torch

    if warm_up:
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple:
    byte_ms = n_bytes / MEMORY_BYTES_PER_S * 1e3
    op_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions

def accept_inputs(seed: int = 17, N: int = 512, L: int = 192, W: int = 8192,
                  read_len: int = 150):
    """K1's main-path shape: reads padded with byte 0 to L, windows padded
    with byte 1 to W. Embedded read copies (some mutated), random rejects,
    short win_len and per-row seed_lo/seed_hi, so both verdicts occur."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    reads = np.zeros((N, L), np.uint8)
    windows = np.ones((N, W), np.uint8)
    params = np.zeros((N, 5), np.int32)
    for row in range(N):
        win_len = W if row % 5 else int(rng.integers(read_len, W))
        window = alphabet[rng.choice(5, win_len,
                                     p=[.2475, .2475, .2475, .2475, .01])]
        kind = row % 4
        if kind == 3:                                   # random: reject
            read = alphabet[rng.integers(0, 4, read_len)]
        else:
            start = int(rng.integers(0, win_len - read_len + 1))
            read = window[start:start + read_len].copy()
            if kind == 1:                               # scattered errors
                flips = rng.integers(0, read_len, 4)
                read[flips] = alphabet[rng.integers(0, 4, 4)]
            elif kind == 2:                             # heavy errors
                flips = rng.integers(0, read_len, 40)
                read[flips] = alphabet[rng.integers(0, 4, 40)]
        reads[row, :read_len] = read
        windows[row, :win_len] = window
        lo, hi = 0, win_len + L - 1
        if row % 7 == 3:                                # a chunk's stride
            lo = int(rng.integers(0, win_len // 2))
            hi = lo + int(rng.integers(0, win_len // 2))
        params[row] = (read_len, win_len, int(0.8 * read_len + 0.5), lo, hi)
    return reads, windows, params


def low_entropy_inputs(seed: int = 3, n: int = 131072, L: int = 150):
    """K2's main-path shape: one chunk of 150 bp reads (codes 0-3, a few N
    clamped to 3), aligned segments inside the read, low-entropy rows
    planted (short repeated motifs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.002] = 4
    lengths = np.full(n, L, np.int32)
    short = rng.random(n) < 0.1
    lengths[short] = rng.integers(0, L, int(short.sum()))
    planted = rng.random(n) < 0.02
    for row in np.nonzero(planted)[0]:
        motif = rng.integers(0, 4, int(rng.integers(1, 4)))
        codes[row] = np.tile(motif, L)[:L]
    a1s = np.zeros(n, np.int32)
    a1e = rng.integers(40, L + 1, n).astype(np.int32)
    a2s = a1e.copy()
    a2e = np.full(n, L, np.int32)
    return codes, lengths, a1s, a1e, a2s, a2e


def smith_waterman_inputs(seed: int = 23, n: int = 65536, L: int = 256,
                          W: int = 256):
    """K3's main-path shape: code rows (0-3, PAD 4 beyond a row's length)
    as tensorize makes them for 150 bp reads, against windows of the dry
    run's width. By row % 4: an exact copy of a window stretch, a copy with
    5 % substitutions, a copy with a 1-8 base gap, a random read; a few
    windows end in PAD. Scores span 0 to the read length."""
    import numpy as np

    from arriba_tpu_torch.ops.encode import PAD_CODE

    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 4, (n, W)).astype(np.uint8)
    max_gap = 8
    span = min(L, W - max_gap)
    length = rng.integers(max(1, span // 4), span + 1, n)
    gap = np.where(np.arange(n) % 4 == 2, rng.integers(1, max_gap + 1, n), 0)
    cut = (rng.random(n) * length).astype(np.int64)
    start = (rng.random(n) * (W - length - gap + 1)).astype(np.int64)
    i = np.arange(L)[None, :]
    source = np.minimum(start[:, None] + i + np.where(i >= cut[:, None],
                                                      gap[:, None], 0), W - 1)
    reads = np.take_along_axis(windows, source, axis=1)
    kind = np.arange(n) % 4
    flips = (rng.random((n, L)) < 0.05) & (kind == 1)[:, None]
    reads[flips] = rng.integers(0, 4, int(flips.sum()))
    random_rows = kind == 3
    reads[random_rows] = rng.integers(0, 4, (int(random_rows.sum()), L))
    reads[i >= length[:, None]] = PAD_CODE
    short = rng.random(n) < 0.05
    windows[short[:, None] & (np.arange(W)[None, :]
                              >= rng.integers(0, W, n)[:, None])] = PAD_CODE
    reads[::1024] = PAD_CODE                            # empty reads
    return reads, windows


def check_kernels() -> list:
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import readfilters, realign

    cuda = torch.device("cuda")
    records = []

    # K1: accept wavefront
    reads, windows, params = accept_inputs()
    r, w, p = (torch.from_numpy(x).to(cuda) for x in (reads, windows, params))
    got = realign.accept_wavefront(r, w, p)
    torch.cuda.synchronize()
    want = realign.accept_wavefront_plain(r, w, *p.unbind(dim=1))
    err = int((got.int() - want.int()).abs().max())
    n_accept = int(want.sum())
    log(f"K1 accept_wavefront: {n_accept}/{len(reads)} rows accept, "
        f"max |kernel - plain| = {err}")
    if err != 0 or not 0 < n_accept < len(reads):
        raise SystemExit("K1 disagrees with its plain version or the input "
                         "does not exercise both verdicts")
    # the launch alone: K1 needs its output zeroed, which stays untimed
    out = torch.zeros(len(reads), dtype=torch.int32, device=cuda)
    ms = cuda_ms(lambda: kernels.launch_accept_wavefront(r, w, p, out), 20,
                 setup=out.zero_)
    # the plain version takes seconds at this shape: one call, warmed up by
    # the comparison above
    plain_ms = cuda_ms(
        lambda: realign.accept_wavefront_plain(r, w, *p.unbind(dim=1)), 1,
        warm_up=False)
    # each diagonal's walk ends at its first accepting cell: a row that
    # accepts needs as little as one diagonal (read_len cells), one that
    # does not needs every valid cell
    read_len, win_len = (params[:, c].astype(np.int64) for c in (0, 1))
    cells = float(np.where(want.cpu().numpy(), read_len,
                           read_len * win_len).sum())
    n_bytes = reads.nbytes + windows.nbytes + params.nbytes + 4 * len(reads)
    bound_ms, bound_by = bound(n_bytes, cells * AW_OPS_PER_CELL)
    records.append({
        "name": "accept_wavefront", "route": "cuda",
        "source": "arriba_tpu_torch/kernels/csrc/accept_wavefront.cu",
        "replaces": "arriba_tpu/ops/realign.py:444",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    # K2: low-entropy scan over the 2-bit-packed codes the cascade ships
    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs()
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1).astype(np.int32)
    packed = torch.from_numpy(readfilters.pack_codes(codes)).to(cuda)
    meta_d = torch.from_numpy(meta).to(cuda)
    L = codes.shape[1]
    got = readfilters._low_entropy_core_packed(packed, L, meta_d)
    torch.cuda.synchronize()
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta_d.unbind(dim=1))
    err = int((got.int() - want.int()).abs().max())
    n_flag = int(want.sum())
    log(f"K2 low_entropy: {n_flag}/{len(codes)} reads flagged, "
        f"max |kernel - plain| = {err}")
    if err != 0 or not 0 < n_flag < len(codes):
        raise SystemExit("K2 disagrees with its plain version or the input "
                         "does not exercise both verdicts")
    out = torch.empty(len(codes), dtype=torch.uint8, device=cuda)
    ms = cuda_ms(lambda: kernels.launch_low_entropy(packed, meta_d, out), 20)
    plain_ms = cuda_ms(lambda: readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta_d.unbind(dim=1)), 5)
    # a read's scan ends at its first crossing: count flagged reads as free
    # (a lower bound) and every position of the others
    positions = float(np.where(want.cpu().numpy(), 0, np.maximum(
        lengths.astype(np.int64) - 3, 0)).sum())
    n_bytes = packed.numel() + meta.nbytes + len(codes)
    bound_ms, bound_by = bound(n_bytes, positions * LE_OPS_PER_POSITION)
    records.append({
        "name": "low_entropy", "route": "cuda",
        "source": "arriba_tpu_torch/kernels/csrc/low_entropy.cu",
        "replaces": "arriba_tpu/ops/readfilters.py:206",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    # K3: Smith-Waterman scores at the dry run's shape
    from arriba_tpu_torch.ops.encode import PAD_CODE

    reads, windows = smith_waterman_inputs()
    r, w = (torch.from_numpy(x).to(cuda) for x in (reads, windows))
    got = realign.smith_waterman_scores(r, w)
    torch.cuda.synchronize()
    want = realign.smith_waterman_scores_plain(r, w)
    err = int((got - want).abs().max())
    read_len = (reads != PAD_CODE).sum(axis=1).astype(np.int64)
    win_len = (windows != PAD_CODE).sum(axis=1).astype(np.int64)
    low, high = int(want.min()), int(want.max())
    log(f"K3 smith_waterman: scores {low}..{high} (longest read "
        f"{int(read_len.max())}), max |kernel - plain| = {err}")
    if err != 0 or low != 0 or high != int(read_len.max()):
        raise SystemExit("K3 disagrees with its plain version or the scores "
                         "do not span 0 to the read length")
    out = torch.empty(len(reads), dtype=torch.int32, device=cuda)
    ms = cuda_ms(lambda: kernels.launch_smith_waterman(r, w, out), 20)
    plain_ms = cuda_ms(lambda: realign.smith_waterman_scores_plain(r, w), 3)
    # every cell whose read and window bytes are not PAD counts; none can be
    # skipped
    cells = float((read_len * win_len).sum())
    n_bytes = reads.nbytes + windows.nbytes + 4 * len(reads)
    bound_ms, bound_by = bound(n_bytes, cells * SW_OPS_PER_CELL)
    records.append({
        "name": "smith_waterman", "route": "cuda",
        "source": "arriba_tpu_torch/kernels/csrc/smith_waterman.cu",
        "replaces": "arriba_tpu/ops/realign.py:162",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return records


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI

COUNTER = re.compile(r"\((?:remaining|total|marked)=\d+\)")


def run_cli(sample: pathlib.Path, label: str, env: dict, threads: int):
    """One in-process CLI run with env set: (seconds, fusions bytes,
    discarded bytes, stage log)."""
    import bench_samples
    from arriba_tpu_torch import cli

    out = sample / f"fusions.{label}.tsv"
    discarded = sample / f"fusions.{label}.discarded.tsv"
    args = bench_samples.tier2_cli_args(sample) + [
        "-o", str(out), "-O", str(discarded), "-@", str(threads)]
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    stdout = io.StringIO()
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            status = cli.main(args)
        seconds = time.perf_counter() - start
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    text = stdout.getvalue()
    if status != 0:
        raise SystemExit(f"run {label} exited {status}:\n{text[-3000:]}")
    return seconds, out.read_bytes(), discarded.read_bytes(), text


# the offloaded ops whose seconds and calls each run reports: host wall time
# around the call, device work included (each ends in a synchronize)
TIMED_OPS = (("realign", "screen_pairs"), ("realign", "shared_kmer_mask"),
             ("realign", "accept_pairs"), ("realign", "accept_wavefront"),
             ("readfilters", "low_entropy_batch_chunked"))


@contextlib.contextmanager
def timed_ops(totals: dict):
    import importlib

    import torch

    saved = []
    for module_name, name in TIMED_OPS:
        module = importlib.import_module(f"arriba_tpu_torch.ops.{module_name}")
        inner = getattr(module, name)

        def wrapped(*args, _inner=inner, _name=name, **kwargs):
            start = time.perf_counter()
            result = _inner(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            seconds, calls = totals.get(_name, (0.0, 0))
            totals[_name] = (seconds + time.perf_counter() - start, calls + 1)
            return result

        saved.append((module, name, inner))
        setattr(module, name, wrapped)
    try:
        yield totals
    finally:
        for module, name, inner in saved:
            setattr(module, name, inner)


def runs(n_cards: int):
    """(label, environment): A is the main path, B the host reference, C
    the default engine configuration with offload on (only the low-entropy
    scan goes to the card there), D and E C with the sharded mid-cascade
    statistics, over four row shards on the card and across one NCCL rank
    per card."""
    return (("A", {"ARRIBA_TPU_TORCH_DEVICE": "cuda",
                   "ARRIBA_TPU_TORCH_NO_NATIVE_EVENT": "1"}),
            ("B", {"ARRIBA_TPU_TORCH_DEVICE": "off"}),
            ("C", {"ARRIBA_TPU_TORCH_DEVICE": "cuda"}),
            ("D", {"ARRIBA_TPU_TORCH_DEVICE": "cuda",
                   "ARRIBA_TPU_TORCH_SHARDED_STATS": "4"}),
            ("E", {"ARRIBA_TPU_TORCH_DEVICE": "cuda",
                   "ARRIBA_TPU_TORCH_SHARDED_STATS": f"{n_cards}procs"}))


@contextlib.contextmanager
def captured_states(states: list):
    """Append the PipelineState each pipeline.run returns to states."""
    from arriba_tpu_torch import pipeline

    inner = pipeline.run

    def wrapped(options):
        state = inner(options)
        states.append(state)
        return state

    pipeline.run = wrapped
    try:
        yield states
    finally:
        pipeline.run = inner


def main_path(sample: pathlib.Path, threads: int, runs,
              states=None) -> dict:
    """Every run of runs through the CLI; outputs and stage counters must
    equal the first run's. Returns {label: (seconds, chimeric reads, kernel
    launches, {op: (seconds, calls)})}; the launch counts are zeroed just
    before each run and read just after it. The first run's PipelineState
    is appended to states when given."""
    from arriba_tpu_torch import kernels

    results = {}
    reference = None
    for label, env in runs:
        ops: dict = {}
        kernels.reset_launch_counts()
        capture = (captured_states(states) if states is not None
                   and reference is None else contextlib.nullcontext())
        with timed_ops(ops), capture:
            seconds, fusions, discarded, text = run_cli(sample, label, env,
                                                        threads)
        launches = dict(kernels.launch_counts)
        counters = COUNTER.findall(text)
        total = re.search(r"Reading chimeric alignments.*\(total=(\d+)\)",
                          text)
        if total is None or not counters:
            raise SystemExit(f"run {label} printed no stage counters")
        if reference is None:
            reference = (label, fusions, discarded, counters)
        elif (fusions, discarded) != reference[1:3]:
            raise SystemExit(f"run {label}'s output files differ from run "
                             f"{reference[0]}'s")
        elif counters != reference[3]:
            raise SystemExit(f"run {label}'s stage counters differ from run "
                             f"{reference[0]}'s:\n{counters}\n{reference[3]}")
        results[label] = (seconds, int(total.group(1)), launches, ops)
        log(f"run {label} ({' '.join(f'{k}={v}' for k, v in env.items())}): "
            f"{seconds:.3f} s, {len(counters)} stage counters, kernel "
            f"launches {launches}")
        for name, (op_seconds, calls) in sorted(ops.items()):
            log(f"  {name}: {op_seconds:.3f} s in {calls} calls")
    n_fusions = reference[1].count(b"\n") - 1
    log(f"main path: every run's outputs and stage counters byte-equal "
        f"({n_fusions} fusions)")
    return results


# ---------------------------------------------------------------------------
# phase 4: the flagship step

def check_entry() -> None:
    import numpy as np
    import torch

    from arriba_tpu_torch.entry import entry

    results = {}
    for device in ("cuda", "cpu"):
        fn, args = entry(torch.device(device))
        results[device] = {key: value.cpu().numpy()
                           for key, value in fn(*args).items()}
    gpu, cpu = results["cuda"], results["cpu"]
    for key in ("mismatches", "alignment_length", "low_entropy_discard"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=key)
    # log C(n, k) is a difference of float32 lgamma values as large as
    # lgamma(n + 1), and the CUDA and CPU lgamma round differently: p must
    # agree within 8 ulps of lgamma(n + 1) on the log scale, the discard
    # mask wherever p is farther than that from the cutoff (0.01)
    lgamma = np.vectorize(math.lgamma)(cpu["alignment_length"] + 1.0)
    tolerance = 8 * np.spacing(lgamma.astype(np.float32)).astype(np.float64)
    log_gpu = np.log(gpu["pvalue"].astype(np.float64))
    log_cpu = np.log(cpu["pvalue"].astype(np.float64))
    worst = float(np.max(np.abs(log_gpu - log_cpu) / tolerance))
    if worst > 1:
        raise SystemExit(f"entry: p-values differ by {worst:.2f} x the "
                         f"tolerance")
    away = np.abs(log_cpu - np.log(0.01)) > tolerance
    np.testing.assert_array_equal(gpu["mismatch_discard"][away],
                                  cpu["mismatch_discard"][away])
    log(f"entry: read_filter_step on {len(cpu['pvalue'])} reads matches the "
        f"CPU ({int(gpu['low_entropy_discard'].sum())} low-entropy, "
        f"{int(gpu['mismatch_discard'].sum())} mismatch discards; p-values "
        f"within {worst:.3f} of the tolerance)")


# ---------------------------------------------------------------------------
# phase 5: the data-parallel path at full size

def check_sharded(state, n: int) -> int:
    """entry.sharded_check on run A's state at 1 and n shards on the card;
    returns K3's launches in it."""
    import torch

    from arriba_tpu_torch import entry, kernels

    kernels.reset_launch_counts()
    summary = entry.sharded_check(state, state.options, n,
                                  device=torch.device("cuda"))
    launches = dict(kernels.launch_counts)
    log(f"sharded check: {summary['reads']} tensorized mates "
        f"({summary['rows']} rows x {summary['width']}), tensorize "
        f"{summary['tensorize_seconds']:.3f} s; 1 and {n} shards equal; "
        f"{summary['total_alignable']} alignable, {summary['n_clusters']} "
        f"clusters (= host fusion table), {summary['partner_edges']} partner "
        f"edges; kernel launches {launches}")
    for shards, seconds in ((1, summary["reference_seconds"]),
                            (n, summary["seconds"])):
        log(f"  {shards} shard(s): " + ", ".join(
            f"{step} {value:.3f} s" for step, value in seconds.items()))
    if launches["smith_waterman"] <= 0:
        raise SystemExit("K3 never launched on the data-parallel path")
    return launches["smith_waterman"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    started = time.perf_counter()

    # phase 0
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on {kind}")

    # phase 1
    t0 = time.perf_counter()
    import arriba_tpu_torch  # noqa: F401  (builds the native engine)
    from arriba_tpu_torch import _native  # noqa: F401
    native_s = time.perf_counter() - t0
    from arriba_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    kernels_s = time.perf_counter() - t0
    log(f"build: native engine {native_s:.1f} s, CUDA kernels "
        f"{kernels_s:.1f} s ({', '.join(report) or 'up to date'})")
    for name, (_, ptxas) in report.items():
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 2
    t0 = time.perf_counter()
    records = check_kernels()
    log(f"phase 2: {time.perf_counter() - t0:.1f} s")

    # phase 3
    import bench_samples

    t0 = time.perf_counter()
    sample = bench_samples.build_tier2(REPO / "build" / "chip_smoke" / "tier2",
                                       quiet=True)
    log(f"sample: {sample} built in {time.perf_counter() - t0:.1f} s")
    # each run prints its stages' seconds to stderr
    os.environ["ARRIBA_TPU_TORCH_STAGE_TIMES"] = "1"
    threads = min(8, os.cpu_count() or 1)
    states: list = []
    t0 = time.perf_counter()
    results = main_path(sample, threads, runs(torch.cuda.device_count()),
                        states)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    seconds_a, chimeric, launches, _ = results["A"]
    log(f"run A: {seconds_a:.3f} s wall, {chimeric / seconds_a:.1f} "
        f"chimeric reads/s")

    # phase 4
    t0 = time.perf_counter()
    check_entry()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # phase 5: the data-parallel path is K3's main path
    t0 = time.perf_counter()
    launches["smith_waterman"] = check_sharded(states[0], 4)
    del states[:]
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")
    for record in records:
        record["launches"] = launches[record["name"]]
        where = "phase 5" if record["name"] == "smith_waterman" else "run A"
        log(f"{record['name']}: kernel {record['ms']:.4f} ms, plain "
            f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms "
            f"({record['bound_by']}), {record['launches']} launches in "
            f"{where}")
        if record["launches"] <= 0:
            raise SystemExit(f"{record['name']} never launched on the main "
                             f"path")

    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: record[key] for key in keys}
                                  for record in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
