#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (arriba_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against KERNEL SOURCE [SOURCE ...]
    python3 chip_smoke.py --instruction-rates

The second form only times one kernel (accept_wavefront, low_entropy,
smith_waterman or mxu_kmer_screen) built from other sources against this
checkout's build (compare); a SOURCE is a csrc directory, such as an
earlier commit's unpacked with ``git archive``. ``--k1-against SOURCE ...`` is ``--against
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
   scores) at 65,536 rows x 256 read codes x 256 window codes; K4 (the
   one-hot 8-mer screen on the int8 tensor cores) at the JAX package's
   bench shape, 512 x 152 x 8,008, on its bench rows, on rows with no hit
   (the full product), with PAD tails and bytes above 4, and at 333 x 45
   x 1,001 (MXU_CASES). Kernel time
   is the median of 20 CUDA-event timed windows after a warm-up, inputs
   checked and output allocated ahead: single launches for K1, whose output
   is zeroed before each, windows of 10 launches for K2, K3 and K4, counted
   as their mean; the bound is the larger of bytes over the memory rate and
   the operations the algorithm needs over the card's rate for them. K1's
   operations are counted from its inputs (accept_work: window positions
   scanned, cells walked on the candidate diagonals), K4's too (mxu_work:
   each row's read k-mers against its window k-mers up to the first that
   matches, 32 multiply-adds a pair), at the int8 tensor-core rate; K4's library_ms is one torch.bmm of the one-hot
   encodings (onehot_product_ms).
3. The main path: the genome-scale 150 bp sample (bench_samples.build_tier2)
   through the port's CLI, in-process: (A) offload on the card with the
   event-level stages in Python (ARRIBA_TPU_TORCH_DEVICE=cuda
   ARRIBA_TPU_TORCH_NO_NATIVE_EVENT=1), which runs K2 in the read cascade and
   K1 in filter_mismappers; (B) the host path (DEVICE=off); (C) offload with
   the default native event stages (K2 only). Then, on the same sample with
   a tenth of its chimeric fragments (build_tier2_tenth), its own host run
   (B10) and: (D) C with the mid-cascade statistics over four row shards on
   the card (ARRIBA_TPU_TORCH_SHARDED_STATS=4); (E) C with them across one
   NCCL rank per card (=<cards>procs), which also merges the candidate
   clusters and checks them against the host fusion table. Both run the
   Python event stages from the e-value stage on, so K1 and the 8-mer
   screen too. The output files and every stage counter must be byte-equal
   across the runs of each sample, and K1 and K2 must have launched in run
   A. Each run reports its seconds and those of the offloaded ops.
4. The flagship step (arriba_tpu_torch.entry) on the card against the CPU.
5. The data-parallel path at full size: entry.sharded_check on run A's
   pipeline state at 1 and 4 row shards on the card (the filter step over
   every tensorized mate, the realignment step with K3, the cluster step
   over the whole fusion table, the stats step), equal between the two and
   with the host fusion table; K3 must have launched in this phase.
6. K4's caller: realign.mxu_shared_kmer_mask on the bench rows, as the JAX
   package's bench calls its twin, equal to the sorted screen (mxu_path).
7. The cohort runner: python -m arriba_tpu_torch.parallel.cohort on the
   genome-scale sample listed three times, three workers on the one card
   under run C's environment with jax blocked; each worker's outputs equal
   run C's and each launched K2 (cohort_phase).
8. A downstream tool on the card's machine: convert_fusions_to_vcf on run
   C's fusions.tsv with jax blocked (tool_phase).

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
# K4's bound: the dense int8 tensor-core rate (NVIDIA's H100 SXM data
# sheet), 2 operations a multiply-add
INT8_OPS_PER_S = 1.979e15
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


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = INT_OPS_PER_S) -> tuple:
    byte_ms = n_bytes / MEMORY_BYTES_PER_S * 1e3
    op_ms = n_ops / ops_per_s * 1e3
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


def mxu_inputs(case: str, seed: int = 31, N: int = 512, L: int = 152,
               W: int = 8008):
    """K4's phase-2 inputs (reads uint8 [N, L], windows uint8 [N, W]) by
    case. 'bench': the JAX package's bench row (bench.py:650-655), random
    codes 0-3 with a read 8-mer planted in the window of every other row;
    at 145 x 8,001 k-mer pairs a row, ~18 chance hits are expected too, so
    nearly every row stops early. 'no_hit': reads over codes {0, 1},
    windows over {2, 3}: no shared 8-mer anywhere, the full product.
    'pad': the no_hit background with PAD (4) tails and bytes 5-255, and
    by row % 4 a clean planted 8-mer (a hit), a planted 8-mer holding a
    byte above 4 in both (none: such a byte one-hots to zero), one holding
    PAD (none), nothing (none). 'odd': N, L and W that are not multiples
    of the 16 x 8 tiles (333 x 45 x 1,001), seeds planted in every third
    row."""
    import numpy as np

    from arriba_tpu_torch.ops.encode import PAD_CODE

    rng = np.random.default_rng(seed)
    if case == "odd":
        N, L, W = 333, 45, 1001
    if case in ("bench", "odd"):
        reads = rng.integers(0, 4, (N, L)).astype(np.uint8)
        windows = rng.integers(0, 4, (N, W)).astype(np.uint8)
        for row in range(0, N, 2 if case == "bench" else 3):
            at = int(rng.integers(0, W - 8))
            start = min(40, L - 8)
            windows[row, at:at + 8] = reads[row, start:start + 8]
        return reads, windows
    reads = rng.integers(0, 2, (N, L)).astype(np.uint8)
    windows = rng.integers(2, 4, (N, W)).astype(np.uint8)
    if case == "no_hit":
        return reads, windows
    if case != "pad":
        raise ValueError(f"no K4 case {case}")
    odd = rng.integers(5, 256, (N, L)) * (rng.random((N, L)) < 0.02)
    reads = np.where(odd > 0, odd, reads).astype(np.uint8)
    odd = rng.integers(5, 256, (N, W)) * (rng.random((N, W)) < 0.02)
    windows = np.where(odd > 0, odd, windows).astype(np.uint8)
    for row in range(N):
        reads[row, int(rng.integers(L // 2, L + 1)):] = PAD_CODE
        windows[row, int(rng.integers(W // 2, W + 1)):] = PAD_CODE
        seed_kmer = rng.integers(0, 4, 8).astype(np.uint8)
        kind = row % 4
        if kind == 3:
            continue
        if kind == 1:
            seed_kmer[3] = int(rng.integers(5, 256))
        elif kind == 2:
            seed_kmer[5] = PAD_CODE
        at, start = int(rng.integers(0, W // 2 - 8)), int(rng.integers(
            0, L // 2 - 8))
        reads[row, start:start + 8] = seed_kmer
        windows[row, at:at + 8] = seed_kmer
    return reads, windows


def mxu_work(reads, windows) -> dict:
    """The work K4's function needs on these inputs, counted with plain
    torch ops on their device: each row's R = L - 7 read k-mers against its
    window k-mers, in order, up to and including the first equal to a read
    k-mer (both over codes 0-3 only), or against all WK = W - 7 of them for
    a row with none, 32 multiply-adds a pair ("macs", what the bound
    counts); the full product's multiply-adds, N x R x WK x 32. Also, as a
    diagnostic of the kernel's own waste, the 16 x 8 x 32 MMA tiles its
    order issues up to each row's first hit ("tiles": whole read tiles
    against whole window tiles), each row's first such window tile (-1 for
    none) and its verdict, for checks against the plain version and the
    kernel's emulation."""
    import torch

    N, L = reads.shape
    W = windows.shape[1]
    R, WK = L - 7, W - 7
    first = torch.full((N,), -1, dtype=torch.int64, device=reads.device)
    if R <= 0 or WK <= 0:
        return {"macs": 0, "tiles": 0, "full_macs": 0, "first_tile": first,
                "verdict": first >= 0}

    def kmers(x, n_pos, invalid):
        value = torch.zeros(N, n_pos, dtype=torch.int64, device=x.device)
        valid = torch.ones(N, n_pos, dtype=torch.bool, device=x.device)
        for t in range(8):
            code = x[:, t:t + n_pos].long()
            value = value * 4 + code.clamp(max=3)
            valid &= code <= 3
        return torch.where(valid, value, invalid)

    read_kmers = torch.sort(kmers(reads, R, -1), dim=1).values
    window_kmers = kmers(windows, WK, -2)
    index = torch.searchsorted(read_kmers, window_kmers).clamp(max=R - 1)
    found = torch.gather(read_kmers, 1, index) == window_kmers
    hit = found.any(dim=1)
    first_kmer = found.to(torch.uint8).argmax(dim=1)
    macs = int(torch.where(hit, first_kmer + 1, WK).sum()) * R * 32
    first = torch.where(hit, first_kmer // 8, -1)
    window_tiles = -(-WK // 8)
    read_tiles = -(-R // 16)
    tiles = int(torch.where(hit, first + 1, window_tiles).sum()) * read_tiles
    return {"macs": macs, "tiles": tiles, "full_macs": N * R * WK * 32,
            "first_tile": first, "verdict": hit}


# K4's phase-2 cases (mxu_inputs), the first at the bench's shape
MXU_CASES = ("bench", "no_hit", "pad", "odd")


def onehot_product_ms(reads, windows) -> float:
    """One torch.bmm of the float16 one-hot encodings of every read and
    window k-mer (exact: 0/1 products, sums of at most 32): the product
    K4 fuses with its test, alone, as a library yardstick the port never
    calls. Median of 5 CUDA-event timed calls."""
    import torch

    def onehot(x, n_pos):
        stacked = torch.stack([x[:, j:j + n_pos] for j in range(8)], -1)
        return (stacked[..., None] == torch.arange(4, device=x.device)).to(
            torch.float16).reshape(len(x), n_pos, 32)

    a = onehot(reads, reads.shape[1] - 7)
    b = onehot(windows, windows.shape[1] - 7).transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.bmm(a, b), 5)
    del a, b
    torch.cuda.empty_cache()
    return ms


def check_mxu() -> dict:
    """K4 through realign.mxu_shared_kmer_mask against its plain version on
    the card, exactly, on each case of MXU_CASES, with each case's launch
    time (median of 20 windows of K2_K3_BATCH launches), its bounds at the
    int8 tensor-core rate (the k-mer pairs up to each row's first hit,
    mxu_work, and the full product) and the plain version's time; library_ms (the bench and
    no_hit cases) is onehot_product_ms. Returns K4's record."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    cases = {}
    for name in MXU_CASES:
        reads, windows = mxu_inputs(name)
        r, w = (torch.from_numpy(x).to("cuda") for x in (reads, windows))
        got = realign.mxu_shared_kmer_mask(r, w)
        want = realign.mxu_shared_kmer_mask_plain(r, w)
        err = int((got.int() - want.int()).abs().max())
        work = mxu_work(r, w)
        hits = int(want.sum())
        expected = {"no_hit": hits == 0, "bench": hits == len(reads),
                    "pad": want.cpu().tolist() == [row % 4 == 0 for row in
                                                   range(len(reads))],
                    "odd": 0 < hits < len(reads)}[name]
        if err != 0 or not torch.equal(work["verdict"], want):
            raise SystemExit(f"K4 disagrees with its plain version ({name})")
        if not expected:
            raise SystemExit(f"K4's {name} case does not give its verdicts")
        out = torch.empty(len(reads), dtype=torch.uint8, device="cuda")
        ms = cuda_ms(lambda: kernels.launch_mxu_kmer_screen(r, w, out), 20,
                     batch=K2_K3_BATCH)
        plain_ms = cuda_ms(lambda: realign.mxu_shared_kmer_mask_plain(r, w),
                           3)
        n_bytes = reads.nbytes + windows.nbytes + len(reads)
        bound_ms, bound_by = bound(n_bytes, 2 * work["macs"],
                                   INT8_OPS_PER_S)
        full_ms, _ = bound(n_bytes, 2 * work["full_macs"], INT8_OPS_PER_S)
        cases[name] = {"rows": len(reads), "width": [reads.shape[1],
                                                     windows.shape[1]],
                       "hits": hits, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "macs": work["macs"],
                       "tiles": work["tiles"],
                       "full_product_bound_ms": full_ms}
        if name in ("bench", "no_hit"):
            cases[name]["library_ms"] = onehot_product_ms(r, w)
        log(f"K4 {name}: {hits}/{len(reads)} rows share an 8-mer, equal to "
            f"the plain version; {ms:.4f} ms a launch, plain {plain_ms:.4f} "
            f"ms; {2 * work['macs']} int8 operations to the first hits "
            f"({work['tiles']} MMA tiles in K4's order), bound "
            f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%}); full "
            f"product {full_ms:.4f} ms ({full_ms / ms:.1%})"
            + (f"; torch.bmm of the one-hots {cases[name]['library_ms']:.4f}"
               f" ms" if "library_ms" in cases[name] else ""))
    main = cases["bench"]
    return {"name": "mxu_kmer_screen", "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/mxu_kmer_screen.cu",
            "replaces": "arriba_tpu/ops/realign.py:79",
            "max_abs_err": max(case["max_abs_err"] for case in cases.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "full_product_bound_ms": main["full_product_bound_ms"],
            "cases": cases}


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

    # K4: the one-hot 8-mer screen on the int8 tensor cores
    records.append(check_mxu())
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


# ---------------------------------------------------------------------------
# phase 6: the one-hot 8-mer screen as its caller drives it

def mxu_path() -> int:
    """realign.mxu_shared_kmer_mask on the bench's inputs, as the JAX
    package's bench calls its twin (bench.py:650-660; no CLI path calls
    it), held against the sorted 8-mer screen on the card. Returns K4's
    launches in it, counted from 0."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    r, w = (torch.from_numpy(x).to("cuda") for x in mxu_inputs("bench"))
    kernels.reset_launch_counts()
    verdict = realign.mxu_shared_kmer_mask(r, w)
    torch.cuda.synchronize()
    launches = kernels.launch_counts["mxu_kmer_screen"]
    if not torch.equal(verdict, realign.shared_kmer_mask(r, w)):
        raise SystemExit("the one-hot 8-mer screen disagrees with the "
                         "sorted screen")
    log(f"mxu screen: {int(verdict.sum())}/{len(r)} rows share an 8-mer, "
        f"equal to the sorted screen; kernel launches "
        f"{dict(kernels.launch_counts)}")
    return launches


# ---------------------------------------------------------------------------
# phase 3, runs D and E: a tenth of the sample's chimeric fragments

def build_tier2_tenth(sample: pathlib.Path,
                      out_dir: pathlib.Path) -> pathlib.Path:
    """The genome-scale sample with a tenth of its chimeric fragments:
    split fragments f<i> and discordant pairs d<i> with i % 10 == 0, and
    every proper pair and viral fragment; its genome, annotation and
    blacklist linked. Cached (out_dir/.complete)."""
    import mmap

    marker = out_dir / ".complete"
    if marker.exists() and marker.read_text() == "tenth v1\n":
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("genome.fa", "genes.gtf", "blacklist.tsv"):
        link = out_dir / name
        if link.is_symlink() or link.exists():
            link.unlink()
        link.symlink_to(sample / name)
    with open(sample / "aligned.sam", "rb") as src, \
            open(out_dir / "aligned.sam", "wb") as dst:
        # the proper pairs come first: copy them in bulk up to f0
        with mmap.mmap(src.fileno(), 0, access=mmap.ACCESS_READ) as whole:
            first = whole.find(b"\nf0\t") + 1
        if first <= 0:
            raise SystemExit("the sample has no split fragments")
        remaining = first
        while remaining:
            block = src.read(min(remaining, 1 << 24))
            dst.write(block)
            remaining -= len(block)
        for line in src:
            if line[:1] in (b"f", b"d") and int(
                    line[1:line.index(b"\t")]) % 10:
                continue
            dst.write(line)
    marker.write_text("tenth v1\n")
    return out_dir


def reduced_runs(n_cards: int):
    """(label, environment) of the runs on the tenth: its own host run,
    then D and E (runs)."""
    return (("B10", {"ARRIBA_TPU_TORCH_DEVICE": "off"}),) + runs(n_cards)[3:]


# ---------------------------------------------------------------------------
# phases 7 and 8: the cohort runner and a downstream tool

# Appended to import_blocker.py (jax and the JAX package unimportable) as
# the sitecustomize of every Python process a phase starts: the port's CLI
# (which leaves through os._exit) prints its kernel launch counts and the
# nvcc builds it started to stderr as it exits.
SITE_REPORT = r"""
import json
import subprocess

_exit = os._exit
_popen_init = subprocess.Popen.__init__
_nvcc = []


def _counting_init(self, args, *rest, **kwargs):
    if isinstance(args, (list, tuple)) and str(args[0]).endswith("nvcc"):
        _nvcc.append(os.path.basename(str(args[-1])))
    _popen_init(self, args, *rest, **kwargs)


def _report_and_exit(status):
    kernels = sys.modules.get("arriba_tpu_torch.kernels")
    if kernels is not None:
        print("LAUNCH_COUNTS " + json.dumps(kernels.launch_counts),
              file=sys.stderr, flush=True)
        print("NVCC_BUILDS " + json.dumps(_nvcc), file=sys.stderr, flush=True)
    _exit(status)


subprocess.Popen.__init__ = _counting_init
os._exit = _report_and_exit
"""


def site_env(work: pathlib.Path, env: dict) -> dict:
    """os.environ with env, and a sitecustomize of import_blocker.py and
    SITE_REPORT on PYTHONPATH before the repo."""
    site = work / "site"
    site.mkdir(parents=True, exist_ok=True)
    (site / "sitecustomize.py").write_text(
        (REPO / "import_blocker.py").read_text() + SITE_REPORT)
    return dict(os.environ, **env, PYTHONPATH=os.pathsep.join(
        [str(site), str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))


def cohort_phase(sample: pathlib.Path, threads: int, outputs: tuple,
                 seconds_c: float, n: int = 3) -> dict:
    """python -m arriba_tpu_torch.parallel.cohort on a manifest of the
    sample listed n times, n worker processes under run C's environment,
    all on the one card, jax blocked in each (site_env). Each worker's
    fusions.tsv and fusions.discarded.tsv must equal run C's (outputs), and
    each must have launched K2 (its LAUNCH_COUNTS line in its run.log).
    K2's library is deleted first, so the workers reach its first build
    together: one must compile it and the others wait on the build lock and
    load it (one nvcc in all, their NVCC_BUILDS lines). The card's memory
    in use is sampled every 0.2 s while it runs."""
    import shutil

    import bench_samples
    import torch

    from arriba_tpu_torch.kernels import build

    work = REPO / "build" / "chip_smoke" / "cohort"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    args = bench_samples.tier2_cli_args(sample)
    alignments, common = args[1], args[2:]
    manifest = work / "manifest.tsv"
    manifest.write_text("".join(f"s{k}\t{alignments}\t{work / f's{k}'}\n"
                                for k in range(n)))
    env = site_env(work, dict(runs(1))["C"])
    build.library_path("low_entropy").unlink()
    free, total = torch.cuda.mem_get_info()
    before = peak = total - free
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "arriba_tpu_torch.parallel.cohort",
         str(manifest), "--processes", str(n), "--", *common, "-@",
         str(max(1, threads // n))],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    while proc.poll() is None:
        free, total = torch.cuda.mem_get_info()
        peak = max(peak, total - free)
        time.sleep(0.2)
    seconds = time.perf_counter() - start
    report = proc.communicate()[0]
    logs = {k: (work / f"s{k}" / "run.log").read_text(errors="replace")
            if (work / f"s{k}" / "run.log").exists() else ""
            for k in range(n)}
    if proc.returncode != 0:
        raise SystemExit(f"the cohort exited {proc.returncode}:\n{report}\n"
                         + "\n".join(log[-2000:] for log in logs.values()))
    launches, builds = [], []
    for k in range(n):
        out = work / f"s{k}"
        if ((out / "fusions.tsv").read_bytes(),
                (out / "fusions.discarded.tsv").read_bytes()) != outputs:
            raise SystemExit(f"cohort sample s{k}'s outputs differ from run "
                             f"C's")
        found = re.findall(r"^LAUNCH_COUNTS (.*)$", logs[k], re.M)
        if not found or json.loads(found[-1])["low_entropy"] <= 0:
            raise SystemExit(f"cohort sample s{k} did not run K2 on the "
                             f"card:\n{logs[k][-2000:]}")
        launches.append(json.loads(found[-1])["low_entropy"])
        builds += json.loads(re.findall(r"^NVCC_BUILDS (.*)$", logs[k],
                                        re.M)[-1])
    if builds != ["low_entropy.cu"]:
        raise SystemExit(f"the cohort's workers built K2 {len(builds)} "
                         f"times, not once: {builds}")
    per_worker = (peak - before) / n / 2**30
    log(f"cohort: {n} samples in {n} workers on one card, {seconds:.3f} s "
        f"wall (run C: {seconds_c:.3f} s for one); every worker's outputs "
        f"equal run C's; K2 launches per worker {launches}, built by one of "
        f"them while the others waited; card memory in "
        f"use peaked {(peak - before) / 2**30:.2f} GiB above this "
        f"process's ({per_worker:.2f} GiB a worker)")
    return {"seconds": seconds, "launches": launches,
            "gib_per_worker": per_worker}


def tool_phase(sample: pathlib.Path, fusions: pathlib.Path) -> None:
    """python -m arriba_tpu_torch.tools.convert_fusions_to_vcf on run C's
    fusions.tsv with jax blocked (site_env): two BND records a fusion."""
    work = REPO / "build" / "chip_smoke" / "tool"
    vcf = work / "fusions.vcf"
    env = site_env(work, {})
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "arriba_tpu_torch.tools.convert_fusions_to_vcf",
         str(sample / "genome.fa"), str(fusions), str(vcf)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise SystemExit(f"convert_fusions_to_vcf exited {proc.returncode}:"
                         f"\n{proc.stderr[-3000:]}")
    lines = vcf.read_text().splitlines()
    n_fusions = fusions.read_bytes().count(b"\n") - 1
    records = [line for line in lines if not line.startswith("#")]
    if lines[0] != "##fileformat=VCFv4.3" or len(records) != 2 * n_fusions:
        raise SystemExit(f"convert_fusions_to_vcf wrote {len(records)} "
                         f"records for {n_fusions} fusions")
    log(f"tool: convert_fusions_to_vcf, jax blocked, {len(records)} BND "
        f"records for {n_fusions} fusions in {seconds:.3f} s")


def against_cases(kernel: str) -> dict:
    """The phase-2 inputs of a kernel for compare: {case: (arguments of its
    C entry point before the stream, setup run before each launch or None,
    a check that the output equals the plain version's)}. K1: the main,
    low-complexity and mixed batches; K2 and K3: their phase-2 batch; K4:
    its bench and no_hit cases."""
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
    elif kernel == "mxu_kmer_screen":
        for name in ("bench", "no_hit"):
            r, w = (torch.from_numpy(x).to(cuda) for x in mxu_inputs(name))
            out = torch.empty(len(r), dtype=torch.uint8, device=cuda)
            want = realign.mxu_shared_kmer_mask_plain(r, w)
            cases[name] = ((r, w, out, *r.shape, w.shape[1]), None,
                           lambda out=out, want=want: torch.equal(
                               out.view(torch.bool), want))
    else:
        raise SystemExit(f"--against takes accept_wavefront, low_entropy, "
                         f"smith_waterman or mxu_kmer_screen, not {kernel}")
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
    tenth = build_tier2_tenth(sample, REPO / "build" / "chip_smoke"
                              / "tier2_tenth")
    log(f"sample: {sample} and {tenth} built in "
        f"{time.perf_counter() - t0:.1f} s")
    # each run prints its stages' seconds to stderr
    os.environ["ARRIBA_TPU_TORCH_STAGE_TIMES"] = "1"
    threads = min(8, os.cpu_count() or 1)
    states: list = []
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    results = main_path(sample, threads, runs(n_cards)[:3], states)
    reduced = main_path(tenth, threads, reduced_runs(n_cards))
    for label in ("D", "E"):
        _, _, run_launches, ops = reduced[label]
        if run_launches["accept_wavefront"] <= 0 or ops.get(
                "shared_kmer_mask", (0, 0))[1] <= 0:
            raise SystemExit(f"run {label} never reached the 8-mer screen "
                             f"and K1")
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

    # phase 6: K4's caller
    t0 = time.perf_counter()
    launches["mxu_kmer_screen"] = mxu_path()
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # phase 7: the cohort runner, every worker on the card
    t0 = time.perf_counter()
    out_c = sample / "fusions.C.tsv"
    cohort_phase(sample, threads, (out_c.read_bytes(), sample.joinpath(
        "fusions.C.discarded.tsv").read_bytes()), results["C"][0])
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")

    # phase 8: a downstream tool
    t0 = time.perf_counter()
    tool_phase(sample, out_c)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")

    where = {"smith_waterman": "phase 5", "mxu_kmer_screen": "phase 6"}
    for record in records:
        record["launches"] = launches[record["name"]]
        log(f"{record['name']}: kernel {record['ms']:.4f} ms, plain "
            f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms "
            f"({record['bound_by']}, {record['bound_ms'] / record['ms']:.1%} "
            f"of the kernel's time), {record['launches']} launches in "
            f"{where.get(record['name'], 'run A')}")
        if record["launches"] <= 0:
            raise SystemExit(f"{record['name']} never launched on the main "
                             f"path")

    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    # K1 adds its every-diagonal bound, K4 its full-product bound, both
    # their phase-2 cases
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "walk_all_bound_ms", "full_product_bound_ms", "cases")
    print(json.dumps({"kernels": [{key: record[key] for key in keys
                                   if key in record}
                                  for record in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
