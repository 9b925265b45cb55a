#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (arriba_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against KERNEL SOURCE [SOURCE ...]
    python3 chip_smoke.py --instruction-rates

The second form only times one kernel (accept_wavefront, low_entropy or
smith_waterman) built from other sources against this checkout's build
(compare); a SOURCE is a csrc directory, such as an earlier commit's
unpacked with ``git archive``. ``--k1-against SOURCE ...`` is ``--against
accept_wavefront SOURCE ...``. The third measures the issue rate of the
16x2 instructions K3's cells run against LOP3's (instruction_rates).
Phases of the first (any failure exits non-zero, and no result line is
printed):

0. The card: ``nvidia-smi`` name and power limit, maximum SM clock,
   torch's device name.
1. Build: the native engine (g++, from native/*.cpp) and the CUDA kernels
   (nvcc for sm_90a, from arriba_tpu_torch/kernels/csrc), with the seconds
   each took.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, with exact equality: K1 (accept wavefront) at
   512 rows x 192 read bytes x 8192 window bytes, on its adversarial rows
   (ACCEPT_KINDS) and on two low-complexity batches at that shape
   (accept_cases); K2
   (low-entropy scan) at 131,072 reads x 150 codes; K3 (Smith-Waterman
   scores) at 65,536 rows x 256 read codes x 256 window codes. Kernel time
   is the median of 20 CUDA-event timed windows after a warm-up, inputs
   checked and output allocated ahead: single launches for K1, whose output
   is zeroed before each, windows of 10 launches for K2 and K3, counted as
   their mean; the bound is the larger of bytes over the memory rate and
   the operations the algorithm needs over the card's rate for them. K1's
   operations are counted from its inputs (accept_work: window positions
   scanned, cells walked on the candidate diagonals).
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

# peak rates of one H100 SXM at its 700 W limit: HBM3 bandwidth (NVIDIA's
# data sheet), and the 32-bit integer rate the kernels' work runs at: 64
# integer adds, compares, min/max, logic operations or shifts a clock per
# SM (CUDA C++ Programming Guide, arithmetic instruction throughput table,
# compute capability 9.0) x 132 SMs x the H100 SXM's 1,980 MHz maximum SM
# clock, 16.7 T/s. (The data sheet's 67 TFLOP/s counts float32 fused
# multiply-adds, 4x the integer rate, and is no bound for integer work.)
MEMORY_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT_PER_CLOCK = 64
INT_OPS_PER_S = INT_PER_CLOCK * 132 * SM_CLOCK_HZ
# integer operations the algorithm needs per unit of work; loads and stores
# are counted as bytes, tests fixed per read or per diagonal are hoisted
# out, and base codes are computed once per byte.
# K1, one window position of a row's seed scan (its eligible range is fixed
# per row):
AW_SCAN_OPS = {"base code and 'N' flag": 4, "'N' test": 1,
               "rolling 8-mer": 3, "bitmap word and bit": 3, "hit test": 1,
               "loop": 2}
# K1, one valid (read, window) cell of a diagonal walk:
AW_OPS = {"byte match": 1, "code match": 1, "streak start": 2,
          "seed eligibility (i in the diagonal's interval, window not N)": 4,
          "streak eligibility": 2, "bsave": 2, "seed streak q": 2,
          "seed fires": 2, "seed score reaches min_score": 1,
          "mismatch run": 2, "walk score": 2, "walk dies": 2, "accept": 4,
          "fired score": 1, "best score": 1, "a": 2, "b": 2,
          "loop and exit": 3}
# K2 counts a selected 3-mer into one 32-bit word, its three counters in
# 10-bit fields, and tests the thresholds once a 3-mer when the read is
# done, so no read's scan ends early: every eligible position of every read
# counts. One eligible position (the aligned segments are position ranges
# fixed per read, so a position's counter weight is fixed between two range
# ends and the add is predicated on the selection):
LE_OPS = {"3-mer from the byte pair": 2,
          "byte pair and loop, shared by four positions": 1,
          "selection: two equality tests and their combine": 3,
          "counter address": 1, "counter add": 1}
# K2, each of a read's 64 counter words: clearing it and reading it back
# (128-bit shared-memory stores and loads, four words each), its whole-read
# and first-segment fields (the second segment's is the top field), and the
# tests against c_all >= 1 and the three thresholds, chained
LE_WORD_OPS = {"clear and read back": 0.5, "two fields": 3,
               "four threshold tests": 4}
# K3, a pair of valid (read, window) cells, one of each of two independent
# rows (a read and a window byte both not PAD): the instructions any
# implementation needs, each with its issue rate a clock per SM. Every
# score fits 16 bits (kernels.sw_guard), so sm_90's 16x2 forms do both
# rows' cells in one 32-bit instruction. One byte permute takes the match
# test and the select from two score words built once a column; h + gap
# serves as "up" for the cell below and as "left" for the next column; the
# add of the diagonal's score, the max and the floor at 0 are one DPX
# instruction. max.s16x2 issues at twice the 32-bit integer rate
# (--instruction-rates on an H100 80GB HBM3 at 700 W: 123.4 a clock per SM
# against LOP3's 64; prmt 64.0, add.s16x2 65.5, viaddmax_s16x2_relu 61.0).
SW_OPS = {"match test and select (prmt)": (1, INT_PER_CLOCK),
          "h + gap (add.s16x2)": (1, INT_PER_CLOCK),
          "max of up and left (max.s16x2)": (1, 2 * INT_PER_CLOCK),
          "add, max and floor at 0 (viaddmax_s16x2_relu)": (1, INT_PER_CLOCK),
          "running best (max.s16x2)": (1, 2 * INT_PER_CLOCK)}
AW_OPS_PER_POSITION = sum(AW_SCAN_OPS.values())  # 14
AW_OPS_PER_CELL = sum(AW_OPS.values())          # 36
LE_OPS_PER_POSITION = sum(LE_OPS.values())      # 8
LE_OPS_PER_READ = 64 * sum(LE_WORD_OPS.values())  # 480
# in slots of the 32-bit integer rate: 4 a pair of cells, 2 a cell
SW_SLOTS_PER_CELL = sum(n * INT_PER_CLOCK / rate
                        for n, rate in SW_OPS.values()) / 2


def log(message: str) -> None:
    print(message, flush=True)


def cuda_ms(fn, runs: int, setup=None, warm_up: bool = True,
            batch: int = 1) -> float:
    """Median milliseconds of fn() over runs CUDA-event timed windows, after
    one warm-up call unless the caller has just made one; setup(), when
    given, runs before each window outside it. A window holds batch calls
    back to back and counts their mean. The card spins (torch.cuda._sleep,
    0.2 ms a call) before each window while the host queues it, so that
    the host's time to launch a call does not show in a short kernel's."""
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
        torch.cuda._sleep(int(2e-4 * SM_CLOCK_HZ * batch))
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple:
    byte_ms = n_bytes / MEMORY_BYTES_PER_S * 1e3
    op_ms = n_ops / INT_OPS_PER_S * 1e3
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


# K1's adversarial rows by row % 14, and the verdict each must give
ACCEPT_KINDS = (
    ("poly-A read, poly-A window", True),
    ("poly-A read, N-rich window (A and N share code 3)", False),
    ("poly-A read, (A8 G4)* window: every diagonal a candidate", False),
    ("(AC)* read, (AC)* window", True),
    ("embedded copy, window 'N' at its seed start", False),
    ("only the read suffix from the last eligible start s_max", True),
    ("only the read suffix from s_max + 1", False),
    ("embedded copy, seed_lo one past its start", False),
    ("embedded copy, seed_hi 3 past its start", True),
    ("embedded copy, seed_lo 3 past its start", False),
    ("read_len 8", False),
    ("read_len 9, embedded", True),
    ("win_len 9", False),
    ("win_len 10, read 9 at its start", True),
)


def accept_adversarial_inputs(seed: int = 29, N: int = 56, L: int = 192,
                              W: int = 8192):
    """K1's adversarial rows (ACCEPT_KINDS, cycled over the N rows) at
    reads padded with byte 0 to L and windows padded with byte 1 to W:
    low-complexity rows, 'N' at a seed start, seeds at and past the last
    eligible read start, streaks cut by seed_lo / seed_hi, reads and
    windows too short to seed. Read length min(150, L - 8), min_score as
    accept_pairs computes it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"ACGT", np.uint8)
    reads = np.zeros((N, L), np.uint8)
    windows = np.ones((N, W), np.uint8)
    params = np.zeros((N, 5), np.int32)

    def score(n):
        return int(0.8 * n + 0.5)

    for row in range(N):
        kind = row % len(ACCEPT_KINDS)
        read_len = min(150, L - 8)
        win_len = W - int(rng.integers(0, 64))
        window = base[rng.integers(0, 4, win_len)]
        read = base[rng.integers(0, 4, read_len)]
        lo, hi = 0, win_len + L - 1
        start = int(rng.integers(16, win_len - read_len - 16))
        if kind == 0:
            read[:] = ord("A")
            window[:] = ord("A")
        elif kind == 1:
            read[:] = ord("A")
            window = np.where(rng.random(win_len) < 0.25, ord("A"),
                              ord("N")).astype(np.uint8)
        elif kind == 2:
            read[:] = ord("A")
            window = np.resize(np.frombuffer(b"AAAAAAAAGGGG", np.uint8),
                               win_len)
        elif kind == 3:
            read = np.resize(np.frombuffer(b"AC", np.uint8), read_len)
            window = np.resize(np.frombuffer(b"AC", np.uint8), win_len)
        elif kind in (4, 7, 8, 9):
            window[start:start + read_len] = read
            if kind == 4:
                read[0] = ord("A")
                window[start] = ord("N")
            elif kind == 7:
                lo = start + 1
            elif kind == 8:
                hi = start + 3
            else:
                lo = start + 3
        elif kind in (5, 6):
            ms = score(read_len)
            s = min((read_len + 16 - ms) // 2 + 1, read_len - 8) - 1
            s += kind - 5
            window[start:start + read_len - s] = read[s:]
            # the cell before the suffix is a code mismatch, so the streak
            # starts at s
            window[start - 1] = ord("G") if read[s - 1] == ord("T") else \
                ord("T")
        elif kind in (10, 11):
            read_len = kind - 2
            read = read[:read_len]
            window[start:start + read_len] = read
        else:
            win_len = kind - 3
            window = window[:win_len]
            read_len = 9
            read = window[:9].copy()
        reads[row, :read_len] = read
        windows[row, :win_len] = window
        params[row] = (read_len, win_len, score(read_len), lo, hi)
    return reads, windows, params


def accept_work(reads, windows, params) -> dict:
    """The work K1's seed lookup needs on these inputs, counted with plain
    torch ops on their device: the window positions in the eligible range
    of the rows that have an eligible read start, the candidate diagonals
    (an eligible window 8-mer equal to the 8-mer of an eligible read start
    names j - s), and the cells walked on them, from each diagonal's first
    valid cell to its first accepting cell or its end. The walks repeat
    aw_step of kernels/csrc/accept_wavefront.cuh over all candidates at
    once (a change to aw_step must be made here too), so the rows with an
    accepting candidate come out too, for a check against the plain
    version."""
    import torch

    N, L = reads.shape
    W = windows.shape[1]
    device = reads.device
    neg = -(1 << 20)
    p = params.long()
    read_len = p[:, 0].clamp(0, L)
    win_len = p[:, 1].clamp(max=W)
    min_score = p[:, 2]
    x = read_len + 16 - min_score
    n_seeds = torch.where(x >= 0, torch.minimum(x // 2 + 1, read_len - 8),
                          0).clamp(min=0)
    lo = p[:, 3].clamp(min=0)
    hi = torch.minimum(p[:, 4], win_len - 10)
    positions = int(torch.where(n_seeds > 0, (hi - lo + 1).clamp(min=0),
                                0).sum())

    def codes(raw):
        return torch.where(raw == ord("T"), 0, torch.where(
            raw == ord("G"), 1, torch.where(raw == ord("C"), 2, 3)))

    def kmers(c):
        n = c.shape[1] - 7
        k = torch.zeros(c.shape[0], n, dtype=torch.int64, device=device)
        for t in range(8):
            k = k * 4 + c[:, t:t + n]
        return k

    read_kmers = kmers(codes(reads.long()))
    window_kmers = kmers(codes(windows.long()))
    j = torch.arange(W - 7, device=device)[None, :]
    eligible_j = (j >= lo[:, None]) & (j <= hi[:, None]) & (
        windows[:, :W - 7] != ord("N"))
    candidates = torch.zeros(N, L + W - 1, dtype=torch.bool, device=device)
    for s in range(int(n_seeds.max())):
        hit = (eligible_j & (window_kmers == read_kmers[:, s:s + 1])
               & (s < n_seeds)[:, None])
        candidates[:, L - 1 - s:L - 1 - s + W - 7] |= hit
    rows, index = candidates.nonzero(as_tuple=True)
    delta = index - (L - 1)
    rl, wl, ms = read_len[rows], win_len[rows], min_score[rows]
    lo_r, hi_r = lo[rows], torch.minimum(p[rows, 4], wl - 10)
    i0 = (-delta).clamp(min=0)
    i1 = torch.minimum(rl, wl - delta)

    zeros = torch.zeros_like(delta)
    a, b, q, bsave, cons = zeros, zeros, zeros, zeros, zeros
    sc = torch.full_like(delta, neg)
    sok = torch.zeros_like(delta, dtype=torch.bool)
    first = torch.full_like(delta, -1)
    for i in range(L):
        jj = i + delta
        valid = (i >= i0) & (i < i1) & (first < 0)
        if not bool(valid.any()):
            continue
        rb = reads[rows, i].long()
        wb = windows[rows, jj.clamp(0, W - 1)].long()
        elig = ((i + 8 < rl) & (2 * i <= rl + 16 - ms) & (jj >= lo_r)
                & (jj <= hi_r) & (wb != ord("N")))
        m = rb == wb
        cm = codes(rb) == codes(wb)
        starts = cm & (q == 0)
        sok_n = cm & torch.where(starts, elig, sok)
        bsave_n = torch.where(cm, torch.where(starts, b, bsave), 0)
        q_n = torch.where(cm, q + 1, 0)
        fired = (q_n == 8) & sok_n
        candidate = 8 + bsave_n
        cons_n = torch.where(m, 0, cons + 1)
        step = torch.where(cons_n >= 4, neg, torch.where(m, sc + 1, sc - 1))
        accept = (m & (step >= ms)) | (fired & (candidate >= ms))
        updates = ((a, torch.where(m, a + 1, 0)), (b, torch.where(m, b + 1, a)),
                   (q, q_n), (bsave, bsave_n), (cons, cons_n),
                   (sc, torch.maximum(step, torch.where(fired, candidate,
                                                        neg))),
                   (sok, sok_n))
        a, b, q, bsave, cons, sc, sok = (torch.where(valid, new, old)
                                         for old, new in updates)
        first = torch.where(valid & accept, i, first)
    cells = int(torch.where(first >= 0, first - i0 + 1,
                            (i1 - i0).clamp(min=0)).sum())
    accepting = torch.zeros(N, dtype=torch.bool, device=device)
    accepting[rows[first >= 0]] = True
    return {"positions": positions, "candidates": int(len(rows)),
            "cells": cells, "accepting": accepting}


def accept_cases() -> dict:
    """K1's phase-2 inputs by name: the main path's shape (accept_inputs),
    the adversarial rows (accept_adversarial_inputs), and two
    low-complexity batches at the main shape, where every row or every 4th
    row (the random rejects) is a poly-A read against a window of A8 G4
    repeats (ACCEPT_KINDS[2]): a rejecting row on which every diagonal is a
    candidate."""
    main = accept_inputs()
    cases = {"main": main, "adversarial": accept_adversarial_inputs()}
    low = [x[2] for x in accept_adversarial_inputs(N=len(ACCEPT_KINDS))]
    for name, every in (("low_complexity", 1), ("mixed", 4)):
        arrays = [x.copy() for x in main]
        for x, row in zip(arrays, low):
            x[every - 1::every] = row
        cases[name] = arrays
    return cases


def check_accept(name: str, arrays) -> tuple:
    """K1 through realign.accept_wavefront against its plain version on one
    case, the launch's median ms, and its bounds: the work the seed lookup
    needs (accept_work) and, as PERF.md's kernel table carries it across
    designs, every diagonal walked (a row that accepts needs as little as
    one diagonal, read_len cells; one that does not every valid cell).
    Returns (summary, the plain verdicts)."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    reads, windows, params = arrays
    r, w, p = (torch.from_numpy(x).to("cuda") for x in arrays)
    got = realign.accept_wavefront(r, w, p)
    want = realign.accept_wavefront_plain(r, w, *p.unbind(dim=1))
    err = int((got.int() - want.int()).abs().max())
    if err != 0:
        raise SystemExit(f"K1 disagrees with its plain version ({name})")
    # the launch alone: K1 needs its output zeroed, which stays untimed
    out = torch.zeros(len(reads), dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: kernels.launch_accept_wavefront(r, w, p, out), 20,
                 setup=out.zero_)
    work = accept_work(r, w, p)
    if not torch.equal(work["accepting"], want):
        raise SystemExit(f"K1's candidate diagonals do not give the plain "
                         f"version's verdicts ({name})")
    n_bytes = reads.nbytes + windows.nbytes + params.nbytes + 4 * len(reads)
    bound_ms, bound_by = bound(n_bytes, work["positions"] * AW_OPS_PER_POSITION
                               + work["cells"] * AW_OPS_PER_CELL)
    read_len, win_len = (params[:, c].astype(np.int64) for c in (0, 1))
    cells = float(np.where(want.cpu().numpy(), read_len,
                           read_len * win_len).sum())
    walk_all_ms, _ = bound(n_bytes, cells * AW_OPS_PER_CELL)
    summary = {"rows": len(reads), "accepting": int(want.sum()),
               "max_abs_err": err, "ms": ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "walk_all_bound_ms": walk_all_ms,
               "positions": work["positions"],
               "candidates": work["candidates"], "cells": work["cells"]}
    log(f"K1 {name}: {summary['accepting']}/{len(reads)} rows accept, equal "
        f"to the plain version; {ms:.4f} ms a launch; "
        f"{work['positions']} window positions scanned, "
        f"{work['candidates']} candidate diagonals, {work['cells']} cells "
        f"walked; bound {bound_ms:.4f} ms ({bound_by}), every diagonal "
        f"{walk_all_ms:.4f} ms")
    return summary, want


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


# launches a timed window of K2 or K3 holds, here and in compare
K2_K3_BATCH = 10


def check_kernels() -> list:
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import readfilters, realign

    cuda = torch.device("cuda")
    records = []

    # K1: accept wavefront, on each of its phase-2 cases
    inputs = accept_cases()
    cases, verdicts = {}, {}
    for name, arrays in inputs.items():
        cases[name], verdicts[name] = check_accept(name, arrays)
    main = cases["main"]
    if not 0 < main["accepting"] < main["rows"]:
        raise SystemExit("K1's main input does not exercise both verdicts")
    rows = torch.arange(cases["adversarial"]["rows"]) % len(ACCEPT_KINDS)
    expected = torch.tensor([verdict for _, verdict in ACCEPT_KINDS])[rows]
    if not torch.equal(verdicts["adversarial"].cpu(), expected):
        raise SystemExit("the adversarial rows do not give their verdicts")
    if cases["low_complexity"]["accepting"] != 0:
        raise SystemExit("a low-complexity row accepts")
    # the plain version takes seconds at the main shape: one call, warmed
    # up by the comparisons above
    r, w, p = (torch.from_numpy(x).to(cuda) for x in inputs["main"])
    plain_ms = cuda_ms(
        lambda: realign.accept_wavefront_plain(r, w, *p.unbind(dim=1)), 1,
        warm_up=False)
    records.append({
        "name": "accept_wavefront", "route": "cuda",
        "source": "arriba_tpu_torch/kernels/csrc/accept_wavefront.cu",
        "replaces": "arriba_tpu/ops/realign.py:444",
        "max_abs_err": max(case["max_abs_err"] for case in cases.values()),
        "ms": main["ms"], "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "walk_all_bound_ms": main["walk_all_bound_ms"],
        "cases": cases})

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
    ms = cuda_ms(lambda: kernels.launch_low_entropy(packed, meta_d, out), 20,
                 batch=K2_K3_BATCH)
    plain_ms = cuda_ms(lambda: readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, L), *meta_d.unbind(dim=1)), 5)
    # every eligible position of every read (LE_OPS)
    positions = float(np.maximum(lengths.astype(np.int64) - 3, 0).sum())
    n_bytes = packed.numel() + meta.nbytes + len(codes)
    bound_ms, bound_by = bound(n_bytes, positions * LE_OPS_PER_POSITION
                               + len(codes) * LE_OPS_PER_READ)
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
    ms = cuda_ms(lambda: kernels.launch_smith_waterman(r, w, out), 20,
                 batch=K2_K3_BATCH)
    plain_ms = cuda_ms(lambda: realign.smith_waterman_scores_plain(r, w), 3)
    # every cell whose read and window bytes are not PAD counts; none can be
    # skipped
    cells = float((read_len * win_len).sum())
    n_bytes = reads.nbytes + windows.nbytes + 4 * len(reads)
    bound_ms, bound_by = bound(n_bytes, cells * SW_SLOTS_PER_CELL)
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


def against_cases(kernel: str) -> dict:
    """The phase-2 inputs of a kernel for compare: {case: (arguments of its
    C entry point before the stream, setup run before each launch or None,
    a check that the output equals the plain version's)}. K1: the main,
    low-complexity and mixed batches; K2 and K3: their phase-2 batch."""
    import numpy as np
    import torch

    from arriba_tpu_torch.ops import readfilters, realign

    cuda = torch.device("cuda")
    cases = {}
    if kernel == "accept_wavefront":
        for name, arrays in accept_cases().items():
            if name == "adversarial":
                continue
            r, w, p = (torch.from_numpy(x).to(cuda) for x in arrays)
            out = torch.zeros(len(r), dtype=torch.int32, device=cuda)
            want = realign.accept_wavefront_plain(r, w, *p.unbind(dim=1))
            cases[name] = ((r, w, p, out, *r.shape, w.shape[1]), out.zero_,
                           lambda out=out, want=want: torch.equal(out != 0,
                                                                  want))
    elif kernel == "low_entropy":
        codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs()
        th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
        meta = torch.from_numpy(np.stack([lengths, a1s, a1e, a2s, a2e, *th],
                                         1).astype(np.int32)).to(cuda)
        packed = torch.from_numpy(readfilters.pack_codes(codes)).to(cuda)
        out = torch.empty(len(codes), dtype=torch.uint8, device=cuda)
        want = readfilters._low_entropy_core_plain(
            readfilters._unpack_codes(packed, codes.shape[1]),
            *meta.unbind(dim=1))
        cases["main"] = ((packed, meta, out, *packed.shape), None,
                         lambda: torch.equal(out.view(torch.bool), want))
    elif kernel == "smith_waterman":
        r, w = (torch.from_numpy(x).to(cuda) for x in smith_waterman_inputs())
        out = torch.empty(len(r), dtype=torch.int32, device=cuda)
        want = realign.smith_waterman_scores_plain(r, w)
        cases["main"] = ((r, w, out, *r.shape, w.shape[1], 1, -1, -1), None,
                         lambda: torch.equal(out, want))
    else:
        raise SystemExit(f"--against takes accept_wavefront, low_entropy or "
                         f"smith_waterman, not {kernel}")
    return cases


def compare(kernel: str, sources: list) -> None:
    """The kernel built from each source against this checkout's build, on
    its phase-2 inputs (against_cases). A source is a csrc directory whose
    <kernel>.cu has this checkout's C entry point, such as an earlier
    commit's. Every build must give the plain version's output. Each case
    times the launches (median of 20 windows of K2_K3_BATCH, or of single
    launches where the output is zeroed before each) in the order this
    checkout, the sources, the sources reversed, this checkout, and one
    JSON line gives the mean of each build's two times."""
    import ctypes

    import torch

    from arriba_tpu_torch.kernels import build

    symbol, argtypes = build._SIGNATURES[kernel]
    procs = []
    for k, source in enumerate(sources):
        target = REPO / "build" / "against" / kernel / str(k) / "lib.so"
        target.parent.mkdir(parents=True, exist_ok=True)
        procs.append((source, target, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(target),
             str(pathlib.Path(source) / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for _, ptxas in build.build((kernel,)).values():
        for line in ptxas_lines(ptxas):
            log(f"built this checkout: {line}")
    entries = {"this checkout": build.load(kernel)[0]}
    for source, target, proc in procs:
        report = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {source}:\n{report[-4000:]}")
        for line in ptxas_lines(report):
            log(f"built {source}: {line}")
        entry = getattr(ctypes.CDLL(str(target)), symbol)
        entry.argtypes, entry.restype = argtypes, ctypes.c_int
        entries[source] = entry

    def launcher(label, args):
        values = [x.data_ptr() if torch.is_tensor(x) else x for x in args]

        def launch():
            code = entries[label](*values,
                                  torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise SystemExit(f"{kernel} from {label} failed to launch "
                                 f"({code})")
        return launch

    result = {}
    for name, (args, setup, check) in against_cases(kernel).items():
        times: dict = {label: [] for label in entries}
        for label in list(entries) + list(reversed(entries)):
            launch = launcher(label, args)
            if setup is not None:
                setup()
            launch()
            if not check():
                raise SystemExit(f"{kernel} from {label} disagrees with the "
                                 f"plain version ({name})")
            times[label].append(cuda_ms(
                launch, 20, setup=setup, batch=1 if setup else K2_K3_BATCH))
        result[name] = {label: statistics.mean(t) for label, t in times.items()}
        log(f"{kernel} {name}: " + ", ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in times[label])} ms"
            for label in entries))
    print(json.dumps({"against": {"kernel": kernel, "cases": result}}))


# A micro-loop per instruction: every thread runs 8 independent chains of
# it, so the rate is the instruction's issue rate, not its latency
RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int OP>
__device__ inline uint32_t op(uint32_t x, uint32_t y, uint32_t z) {
    uint32_t r;
    if (OP == 0) asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;"
                              : "=r"(r) : "r"(x), "r"(y), "r"(z));
    if (OP == 1) asm volatile("add.s16x2 %0, %1, %2;"
                              : "=r"(r) : "r"(x), "r"(y));
    if (OP == 2) asm volatile("max.s16x2 %0, %1, %2;"
                              : "=r"(r) : "r"(x), "r"(y));
    if (OP == 3) r = __viaddmax_s16x2_relu(x, y, z);
    if (OP == 4) asm volatile("prmt.b32 %0, %1, %2, %3;"
                              : "=r"(r) : "r"(x), "r"(y), "r"(z));
    return r;
}

template <int OP>
__global__ void rate(uint32_t* out, int iters, uint32_t y, uint32_t z) {
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = threadIdx.x * 8 + k;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = op<OP>(x[k], y, z);
    }
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc ^= x[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int instruction_rate(int which, void* out, int blocks, int iters,
                                void* stream) {
    void (*kernels[])(uint32_t*, int, uint32_t, uint32_t) = {
        rate<0>, rate<1>, rate<2>, rate<3>, rate<4>};
    kernels[which]<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, iters, 0x00050003u, 0x3210u);
    return (int)cudaGetLastError();
}
"""
RATE_OPS = ("lop3.b32", "add.s16x2", "max.s16x2", "viaddmax_s16x2_relu",
            "prmt.b32")


def instruction_rates() -> None:
    """The issue rate of the instructions K3's cells run, each against LOP3
    (64 a clock per SM by the CUDA C++ Programming Guide's table) in the
    same call, so the clock cancels: each as instructions a clock per SM
    = 64 x LOP3's time / its time, and as instructions per second."""
    import ctypes

    import torch

    from arriba_tpu_torch.kernels import build

    target = REPO / "build" / "instruction_rate" / "lib.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    source = target.with_name("rate.cu")
    source.write_text(RATE_SOURCE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(target),
                    str(source)], check=True, capture_output=True)
    entry = ctypes.CDLL(str(target)).instruction_rate
    entry.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    blocks, iters = 132 * 8, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")

    def launch(which):
        code = entry(which, out.data_ptr(), blocks, iters,
                     torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise SystemExit(f"instruction_rate failed to launch ({code})")

    times = {name: cuda_ms(lambda k=k: launch(k), 10)
             for k, name in enumerate(RATE_OPS)}
    count = blocks * 256 * iters * 8 / 32  # warp instructions
    result = {name: {"ms": ms, "per_clock_per_sm": 64 * times["lop3.b32"] / ms,
                     "warp_instructions_per_s": count / ms * 1e3}
              for name, ms in times.items()}
    for name, r in result.items():
        log(f"{name}: {r['ms']:.4f} ms, {r['per_clock_per_sm']:.1f} a clock "
            f"per SM (LOP3 = 64)")
    print(json.dumps({"instruction_rates": result}))


def ptxas_lines(report: str) -> list:
    """ptxas's register, shared memory and spill lines of an nvcc log"""
    return [line.strip() for line in report.splitlines()
            if "registers" in line or "spill" in line]


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
    if sys.argv[1:2] == ["--k1-against"]:
        compare("accept_wavefront", sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--against"] and len(sys.argv) > 2:
        compare(sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--instruction-rates"]:
        instruction_rates()
        return 0
    clock = subprocess.run(["nvidia-smi", "-i", "0",
                            "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, check=True)
    log(f"maximum SM clock {clock.stdout.strip()} (the bounds take "
        f"{SM_CLOCK_HZ / 1e6:.0f} MHz: {INT_OPS_PER_S / 1e12:.2f} T integer "
        f"operations/s)")
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
        for line in ptxas_lines(ptxas):
            log(f"  {name}: {line}")

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
            f"({record['bound_by']}, {record['bound_ms'] / record['ms']:.1%} "
            f"of the kernel's time), {record['launches']} launches in "
            f"{where}")
        if record["launches"] <= 0:
            raise SystemExit(f"{record['name']} never launched on the main "
                             f"path")

    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    # K1 adds its every-diagonal bound and its phase-2 cases
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "walk_all_bound_ms", "cases")
    print(json.dumps({"kernels": [{key: record[key] for key in keys
                                   if key in record}
                                  for record in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
