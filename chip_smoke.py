#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (arriba_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against KERNEL SOURCE [SOURCE ...]
    python3 chip_smoke.py --instruction-rates
    python3 chip_smoke.py --k4-occupancy
    python3 chip_smoke.py --run-a CHECKOUT [CHECKOUT ...]
    python3 chip_smoke.py --k6

The second form only times one kernel (accept_wavefront, low_entropy,
smith_waterman, smith_waterman_wide, mxu_kmer_screen at k = 8,
mxu_kmer_screen_any_k or kmer_bitmap_screen) built from other sources
against this checkout's build (compare; K4's builds, at k = 8 or any k,
also go through their stress step; K3w's builds run the width the router
picks, an older build without the 16-bit entry point its 32-bit one; K5's
earlier builds run their one-pass entry point, this checkout its two
passes);
a SOURCE is a csrc directory, such as an earlier commit's unpacked with
``git archive``. ``--k1-against SOURCE ...`` is ``--against
accept_wavefront SOURCE ...``. The third measures the issue rate of the
16x2 instructions K3's cells run against LOP3's (instruction_rates). The
fourth times K4 on the full product at 1-4 rows an SM (mxu_occupancy).
The fifth runs run A (below) of each checkout directory in turn, each in
its own process with its own package and kernels, on this checkout's
sample, and holds their outputs byte-equal (run_a_against): give the
parent, this checkout, this checkout, the parent. Phases of the first (any failure exits non-zero, and no result line is
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
   (the full product), with PAD tails and bytes above 4, at 333 x 45 x
   1,001, and on 4,096 rows that mix early, late and no hits, more rows
   than K4 has blocks (MXU_CASES), then K4's stress step: 200 launches on
   the first 64 bench rows and 200 on all 512, 50 on 4,096 mixed rows at
   one and at two slabs of read k-mers, every verdict checked
   (mxu_stress). Then what the wrappers route to a second kernel, or what
   K1 used to refuse: K3w on SWW_CASES, each in the width the router
   picks and the 16-bit ones also in 32-bit lanes (the realign step's own
   600 bp reads, 65,536 x 640 x 256, and reads of 62-248 positions at that
   shape, in 16-bit pairs; 16,384 x 1,024 x 2,048 in 16-bit pairs and with
   bytes 5-255 in 32-bit lanes; bytes 5-255; the scores (2, -3, -5) past
   2^13; match - gap outside a signed byte); K2's long-row kernel on
   8,192 reads of 4,000 codes (LE_LONG_SHAPE) and on 2,048 reads long
   enough that its lanes flush their packed counters, a homopolymer every
   64th row (le_long_cases); K4's any-k kernel at k =
   1, 4, 12, 16 and 31 (MXU_ANY_K) on the bench rows, case (d) and rows
   with no hit, on 4,096 mixed rows at k = 12 and 31, and an empty launch
   of each k's grid, then its stress step (MXU_ANY_STRESS: 50 launches on
   the mixed rows at each of the two k, every verdict checked); K1 on 512
   x 192 x 2,048 rows of which half walk every diagonal (min_score -2^20 +
   1 or read_len - 2^20) and on 70,000 rows of 64 x 64 in one launch.
   Then the two kernels of the mismapper screen on resident tables
   (realign.resident_pairs): K5 (the 8-mer bitmap screen) on
   RESIDENT_CASES, each laid out as resident_pairs packs it and with the
   contig itself as the window table (resident_layouts: unaligned windows
   whose next bytes continue them): the main path's shape (32,768 pairs of
   150 bp reads against 128 gene windows of 20-80 kb), windows whose tail
   continues the read, windows of 0-17 bytes, reads with N, windows at the
   edges of K1's chunks, one window shared by 10,000 rows (also as one
   task), then the edges of K5's schedule (KB_EDGE_CASES: windows at a
   slice's edges, a window no task names, tasks of one row, reads of 0-8
   bytes); the main and shared cases timed in each of KB_VARIANTS (tasks
   of 64 rows, and of 32 and 256; slices of 16,384 positions, and of
   4,096), the pair of passes and each alone (kb_timed); K1's
   indexed entry on K1's main rows at unaligned offsets (and against the
   dense entry) and on the first 5,000 pairs of the other
   cases in both layouts (check_kmer_bitmap_screen,
   check_accept_indexed). K5's bound counts its work from its inputs
   (kb_work: each distinct window's positions once, each row's tests up to
   its first set bit, each read's bytes up to its rows' furthest test;
   kb_bound); its library_ms is the sorted screen
   (realign.shared_kmer_mask, torch.sort and torch.searchsorted) on the
   chunked rows it took before (sorted_screen_ms), which must agree.
   Kernel time
   is the median of 20 CUDA-event timed windows after a warm-up, inputs
   checked and output allocated ahead: single launches for K1, whose output
   is zeroed before each, windows of 10 launches for K2, K3 and K4, counted
   as their mean; the bound is the larger of bytes over the memory rate and
   the operations the algorithm needs over the card's rate for them. K1's
   operations are counted from its inputs (accept_work: window positions
   scanned, cells walked on the candidate diagonals), K4's too (mxu_work:
   each row's read k-mers against its window k-mers up to the first that
   matches, 4k multiply-adds a pair), at the int8 tensor-core rate; K4's library_ms is one torch.bmm of the one-hot
   encodings (onehot_product_ms); K2's long-row kernel's from its
   function's steps up to each read's first threshold (le_long_work), the
   steps it shares with the packed kernel at LE_OPS's rates.
3. The main path: the genome-scale 150 bp sample (bench_samples.build_tier2)
   through the port's CLI, in-process: (A) offload on the card with the
   event-level stages in Python (ARRIBA_TPU_TORCH_DEVICE=cuda
   ARRIBA_TPU_TORCH_NO_NATIVE_EVENT=1), which runs K2 in the read cascade and
   K5 and K1's indexed entry in filter_mismappers; (B) the host path (DEVICE=off); (C) offload with
   the default native event stages (K2 only). Then, on the same sample with
   a tenth of its chimeric fragments (build_tier2_tenth), its own host run
   (B10) and: (D) C with the mid-cascade statistics over four row shards on
   the card (ARRIBA_TPU_TORCH_SHARDED_STATS=4); (E) C with them across one
   NCCL rank per card (=<cards>procs), which also merges the candidate
   clusters and checks them against the host fusion table. Both run the
   Python event stages from the e-value stage on, so K1 and the 8-mer
   screen too. The output files and every stage counter must be byte-equal
   across the runs of each sample; K5, K1's indexed entry and K2 must have
   launched in run A, K5 and K1's indexed entry in D and E, and run A must
   not call the sorted screen. Each run reports its seconds, those of the
   offloaded ops and the bytes its resident tables copied to the card.
   Then each launch of K5 and of K1's indexed entry that run A made is made
   again on the same tensors and held against its plain version, K5 on
   every row, K1 on a stride of MAIN_K1_SAMPLE rows through them, and once
   more with run A's one-sided verdicts broken up (K5's windows cut to
   MAIN_KB_WINDOW_CUT bytes, K1's min_score lowered), where both verdicts
   must occur; each with its time and bound (K5's from kb_work, with the
   sorted screen on its chunked rows as its library time; K1's from
   accept_work on the held rows, scaled to the launch) (check_main_launches).
4. The flagship step (arriba_tpu_torch.entry) on the card against the CPU.
5. The data-parallel path at full size: entry.sharded_check on run A's
   pipeline state at 1 and 4 row shards on the card (the filter step over
   every tensorized mate, the realignment step with K3, the cluster step
   over the whole fusion table, the stats step), equal between the two and
   with the host fusion table; K3 must have launched in this phase. Then
   the realign step on random_read_batch(rng, 4096, 600), 640 wide, at 1
   and 4 shards, equal to its plain arithmetic (realign_600bp): K3w's
   16-bit pairs must have launched there.
6. K4's caller: realign.mxu_shared_kmer_mask on the bench rows, as the JAX
   package's bench calls its twin, equal to the sorted screen, and the
   bench's other number: the port's sorted screen (shared_kmer_mask, plain
   torch) timed on the same rows (mxu_path); the same op at each k of
   MXU_ANY_K (mxu_any_k_path), K1's op (its dense entry) on 70,000 rows
   a quarter of which walk every diagonal (accept_path), the
   Smith-Waterman op on
   4,096 x 1,024 x 2,048 rows with bytes 5-255, which K3w's 32-bit lanes
   score (sww_path), and the low-entropy scan on 2,048 reads of 4,000
   codes, which K2's long-row kernel takes (low_entropy_long_path).
7. The cohort runner: python -m arriba_tpu_torch.parallel.cohort on the
   genome-scale sample listed three times, three workers on the one card
   under run C's environment with jax blocked; each worker's outputs equal
   run C's and each launched K2 (cohort_phase).
8. A downstream tool on the card's machine: convert_fusions_to_vcf on run
   C's fusions.tsv with jax blocked (tool_phase).
9. K6, the card pass over a BGZF BAM (ingest/card.py), on the benchmark's
   own sample (benchmark/samples.py, K6_CELL at K6_SEED: 9.4 M records,
   652 MB at level 1, 32 MB read a chunk) through the CLI on the card, the
   launch counts reset just before the pass: each K6 launch timed on its
   stream with CUDA events, the pass held against card.plain_pass on the
   same file and tables (the records taken and left, the mapped reads,
   the chains and placeholders, the coverage planes and flags, the
   residue's bytes), the device memory it took, and the CLI's outputs
   and stage counters against the engine alone (DEVICE=off); a kernels
   record a K6 launch with its launches, its mean time a launch, the
   plain pass's step a launch, and its bound from the bytes it must move
   (k6_work) (check_bam_ingest). ``python3 chip_smoke.py --k6`` runs the
   build and this phase alone.

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
# K2's long-row kernel (rows past kernels.LE_PACKED_MAX_CODES codes, le_row
# in csrc/low_entropy.cuh) computes the same function on longer rows, with
# three 32-bit counters a 3-mer. Its bound is the lesser of two ways to do
# that work on this run's rows (le_long_ops). Both count the steps the
# packed kernel shares at LE_OPS's rates, LE_OPS_PER_POSITION a position
# walked (the 3-mer, the byte pair and loop, the selection, the whole-read
# counter's address and its predicated add), and a segment counter's add
# for each aligned segment a selected position counts for (its address a
# fixed offset of the whole-read counter's; the segments are position
# ranges fixed per read). Then "stop" walks each read only up to the first
# position whose count reaches a threshold (le_long_work), testing each
# counter it adds, chained into the walk's exit test; "end" walks every
# eligible position and tests each 3-mer's counters once when the read is
# done, as the packed kernel does.
# each counter added, on the walk that stops: its threshold test
LE_LONG_TEST_OPS = 1
# each read: clearing its 192 counters, four a 128-bit store
LE_LONG_CLEAR_OPS = 3 * 64 / 4
# each read walked whole: clearing and reading back each 3-mer's three
# counters (LE_WORD_OPS's rate) and its four threshold tests
LE_LONG_END_OPS = 64 * (3 * LE_WORD_OPS["clear and read back"]
                        + LE_WORD_OPS["four threshold tests"])
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
# K3w, one valid (read, window) cell in 32-bit lanes (a read and a window
# byte both not PAD; csrc/smith_waterman_wide.cu): the byte compare and the
# select of match or mismatch, the max of up and left, + gap, the add, max
# and floor at 0 (one DPX instruction), the PAD select, the running best
SWW_OPS = {"byte compare": 1, "select match or mismatch": 1,
           "max of up and left": 1, "+ gap": 1,
           "add, max and floor at 0 (viaddmax_s32_relu)": 1,
           "PAD select": 1, "running best": 1}
SWW_OPS_PER_CELL = sum(SWW_OPS.values())        # 7
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


def accept_work(reads, windows, params, verdicts=None) -> dict:
    """The work K1 needs on these inputs, counted with plain torch ops on
    their device. Rows that take the seed lookup: the window positions in
    the eligible range of the rows that have an eligible read start, the
    candidate diagonals (an eligible window 8-mer equal to the 8-mer of an
    eligible read start names j - s), and the cells walked on them, from
    each diagonal's first valid cell to its first accepting cell or its
    end. The walks repeat aw_step of kernels/csrc/accept_wavefront.cuh over
    all candidates at once (a change to aw_step must be made here too), so
    those rows' verdicts come out too ("accepting"), for a check against
    the plain version. Rows that walk every diagonal (min_score within an
    unseeded walk's reach, kernels.accept_walks_all), given their verdicts:
    every valid cell of a row that rejects, and one diagonal of read_len
    cells of a row that accepts (as little as it can need)."""
    import torch

    from arriba_tpu_torch import kernels

    N, L = reads.shape
    W = windows.shape[1]
    device = reads.device
    neg = -(1 << 20)
    p = params.long()
    read_len = p[:, 0].clamp(0, L)
    win_len = p[:, 1].clamp(max=W)
    min_score = p[:, 2]
    walks_all = kernels.accept_walks_all(params, L)
    x = read_len + 16 - min_score
    n_seeds = torch.where((x >= 0) & ~walks_all,
                          torch.minimum(x // 2 + 1, read_len - 8),
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
    if bool(walks_all.any()):
        if verdicts is None:
            raise ValueError("rows that walk every diagonal need verdicts")
        cells += int(torch.where(
            verdicts, read_len, read_len * win_len.clamp(min=0))[
                walks_all].sum())
    return {"positions": positions, "candidates": int(len(rows)),
            "cells": cells, "accepting": accepting, "walks_all": walks_all}


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


def accept_low_min_score_inputs(seed: int = 41, N: int = 512, L: int = 192,
                                W: int = 2048):
    """K1's rows half of which an unseeded walk can reach: accept_inputs at
    that shape with, by row % 8, min_score -2^20 + 1 at 2, 4 and 6 and
    read_len - 2^20 (the reach's edge) at 0, so those rows walk every
    diagonal, the odd rows as accept_inputs made them (the seed lookup);
    rows 2 (mod 8) get a poly-A read against a window of C and G, where no
    cell matches and even that min_score rejects."""
    reads, windows, params = accept_inputs(seed, N, L, W)
    neg = -(1 << 20)
    params[::2, 2] = neg + 1
    params[::8, 2] = params[::8, 0] + neg
    for row in range(2, N, 8):
        read_len, win_len = int(params[row, 0]), int(params[row, 1])
        reads[row, :read_len] = ord("A")
        windows[row, :win_len] = ord("C")
        windows[row, 1:win_len:2] = ord("G")
    return reads, windows, params


def accept_many_rows_inputs(N: int = 70000, L: int = 64, W: int = 64):
    """K1 on more rows than a grid dimension holds (65,535): accept_inputs
    at 48 bp reads in 64 x 64 rows, narrow so that the plain version is
    quick; every 4th row from row 1 with min_score -2^20 + 1 (every
    diagonal walked)."""
    reads, windows, params = accept_inputs(43, N, L, W, read_len=48)
    params[1::4, 2] = -(1 << 20) + 1
    return reads, windows, params


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
    work = accept_work(r, w, p, want)
    seeded = ~work["walks_all"]
    if not torch.equal(work["accepting"][seeded], want[seeded]):
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
               "walks_all_rows": int(work["walks_all"].sum()),
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


def le_long_work(packed, length, a1s, a1e, a2s, a2e, th_all, th_a1,
                 th_a2, rows: int = 256) -> dict:
    """The work le_row does on these rows (packed codes on the card, the
    rest int tensors [N] there): each read walks its positions p < length -
    3 in order and stops at the first selected position where one of its
    3-mer's counters reaches its threshold. Counted with plain torch ops
    (the selection carried position by position over all reads, the
    counters as cumulative sums over rows at a time): positions walked,
    selected positions among them, the segment counts of those (a selected
    position counted once for each aligned segment it counts for), the
    eligible positions and their segment counts (a walk to each read's
    end), and each read's verdict (a stop)."""
    import torch

    from arriba_tpu_torch.ops import readfilters

    n = packed.shape[0]
    L = 4 * packed.shape[1]
    codes = readfilters._unpack_codes(packed, L).long()
    P = max(0, min(L, int(length.max())) - 3)
    kv = codes[:, :P] << 4 | codes[:, 1:P + 1] << 2 | codes[:, 2:P + 2]
    p = torch.arange(P, device=packed.device)
    eligible = p[None, :] < (length.long() - 3)[:, None]
    sel = torch.zeros(n, P, dtype=torch.bool, device=packed.device)
    sel1 = torch.zeros(n, dtype=torch.bool, device=packed.device)
    sel2 = torch.zeros_like(sel1)
    for q in range(P):
        now = eligible[:, q].clone()
        if q >= 1:
            now &= ~(sel1 & (kv[:, q] == kv[:, q - 1]))
        if q >= 2:
            now &= ~(sel2 & (kv[:, q] == kv[:, q - 2]))
        sel[:, q] = now
        sel2, sel1 = sel1, now
    walked = selected = in_segments = all_segments = 0
    stops = torch.zeros(n, dtype=torch.bool, device=packed.device)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        v, s = kv[lo:hi], sel[lo:hi]
        onehot = torch.nn.functional.one_hot(v, 64).to(torch.int32)
        crossed = torch.zeros_like(s)
        segments = [s & (p[None] + 1 >= a1s[lo:hi, None])
                    & (p[None] < a1e[lo:hi, None]),
                    s & (p[None] + 1 >= a2s[lo:hi, None])
                    & (p[None] < a2e[lo:hi, None])]
        for flags, th in zip([s] + segments, (th_all, th_a1, th_a2)):
            count = torch.cumsum(onehot * flags[..., None], dim=1)
            mine = torch.gather(count, 2, v[..., None])[..., 0]
            crossed |= s & (mine >= th[lo:hi, None].long())
        stop = crossed.any(dim=1)
        first = crossed.to(torch.uint8).argmax(dim=1)
        n_pos = eligible[lo:hi].sum(dim=1)
        upto = torch.where(stop, first + 1, n_pos)
        before = p[None] < upto[:, None]
        walked += int(upto.sum())
        selected += int((s & before).sum())
        in_segments += sum(int((flags & before).sum()) for flags in segments)
        all_segments += sum(int(flags.sum()) for flags in segments)
        stops[lo:hi] = stop
    return {"positions": walked, "selected": selected,
            "segment_counts": in_segments,
            "eligible": int(eligible.sum()),
            "all_segment_counts": all_segments, "verdict": stops}


def le_long_ops(work: dict, reads: int) -> dict:
    """The integer operations of K2's function on long rows from
    le_long_work's counts: {"stop": walking each read to its first
    threshold, "end": walking it whole}."""
    return {"stop": (work["positions"] * LE_OPS_PER_POSITION
                     + work["segment_counts"]
                     + (work["selected"] + work["segment_counts"])
                     * LE_LONG_TEST_OPS
                     + reads * LE_LONG_CLEAR_OPS),
            "end": (work["eligible"] * LE_OPS_PER_POSITION
                    + work["all_segment_counts"]
                    + reads * (LE_LONG_CLEAR_OPS + LE_LONG_END_OPS))}


def smith_waterman_inputs(seed: int = 23, n: int = 65536, L: int = 256,
                          W: int = 256, above_4: bool = False):
    """K3's main-path shape: code rows (0-3, PAD 4 beyond a row's length)
    as tensorize makes them for 150 bp reads, against windows of the dry
    run's width. By row % 4: an exact copy of a window stretch, a copy with
    5 % substitutions, a copy with a 1-8 base gap, a random read; a few
    windows end in PAD. Scores span 0 to the read length. With above_4,
    5 % of the window bytes are 5-255 before the copies are taken, so the
    copies hold them too (K3w's bytes)."""
    import numpy as np

    from arriba_tpu_torch.ops.encode import PAD_CODE

    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 4, (n, W)).astype(np.uint8)
    if above_4:
        spots = rng.random((n, W)) < 0.05
        windows[spots] = rng.integers(5, 256, int(spots.sum()))
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

# K3w's phase-2 cases: rows, L, W, (match, mismatch, gap), the inputs
# (sww_inputs) and the width kernels.sw_route must pick. The first is the
# data-parallel realign step's own inputs: random_read_batch(rng, 65536,
# 600), reads of 600 positions in rows 640 wide, against ref[:, :256];
# dp_600bp is that shape with smith_waterman_inputs' reads, 62-248
# positions long (kept under its earlier name). Then reads of up to two
# 512-position tiles against 2,048-byte windows, in 16-bit pairs and with
# bytes above code 4 (the 32-bit tiles at scale); bytes above code 4; the
# scores (2, -3, -5) with h past 2^13 (reads of 4,608); a gap that puts
# match - gap outside a signed byte: each a batch K3 does not carry.
SWW_CASES = {
    "reads_600": (65536, 640, 256, (1, -1, -1), "read_batch",
                  "smith_waterman_wide16"),
    "dp_600bp": (65536, 640, 256, (1, -1, -1), "codes",
                 "smith_waterman_wide16"),
    "long": (16384, 1024, 2048, (1, -1, -1), "codes",
             "smith_waterman_wide16"),
    "long_bytes": (16384, 1024, 2048, (1, -1, -1), "above_4",
                   "smith_waterman_wide"),
    "bytes_above_4": (8192, 256, 256, (1, -1, -1), "above_4",
                      "smith_waterman_wide"),
    "past_2_13": (128, 4608, 4608, (2, -3, -5), "codes",
                  "smith_waterman_wide"),
    "gap_past_a_byte": (8192, 256, 256, (1, -1, -200), "codes",
                        "smith_waterman_wide"),
}


def sww_inputs(name: str):
    """(reads, windows) uint8 of a SWW_CASES case: random_read_batch's
    bases and ref[:, :256] ("read_batch"), or smith_waterman_inputs with
    codes 0-4 ("codes") or bytes 5-255 ("above_4")."""
    import numpy as np

    from arriba_tpu_torch.ops.encode import random_read_batch

    n, L, W, _, kind, _ = SWW_CASES[name]
    if kind == "read_batch":
        batch = random_read_batch(np.random.default_rng(5), n, 600)
        return batch.bases, np.ascontiguousarray(batch.ref[:, :W])
    return smith_waterman_inputs(n=n, L=L, W=W, above_4=kind == "above_4")


def mxu_inputs(case: str, seed: int = 31, N: int | None = None,
               L: int = 152, W: int = 8008, k: int = 8,
               chunk: int | None = None):
    """K4's phase-2 inputs (reads uint8 [N, L], windows uint8 [N, W]) by
    case, N rows (default 512, 4,096 for 'mixed'). 'bench': the JAX
    package's bench row (bench.py:650-655), random codes 0-3 with a read
    8-mer planted in the window of every other row; at 145 x 8,001 k-mer
    pairs a row, ~18 chance hits are expected too, so nearly every row
    stops early. 'no_hit': reads over codes {0, 1}, windows over {2, 3}:
    no shared 8-mer anywhere, the full product.
    'pad': the no_hit background with PAD (4) tails and bytes 5-255, and
    by row % 4 a clean planted 8-mer (a hit), a planted 8-mer holding a
    byte above 4 in both (none: such a byte one-hots to zero), one holding
    PAD (none), nothing (none). 'odd': N, L and W that are not multiples
    of the 16 x 8 tiles (333 x 45 x 1,001), seeds planted in every third
    row. 'mixed': the no_hit background with, by a random kind a row, no
    hit, or a read 8-mer (from anywhere in the read) planted in the first
    16th of the window, anywhere in it, or at its last k-mer; given more
    rows than the card holds blocks of K4 (each block then takes rows in
    turn), a block meets rows that a hit decides early next to rows that
    run to the window's end. 'straddle': the no_hit background with, in
    every other row, a read k-mer (its last base code 3) planted by turns
    where a k-mer straddles the any-k kernel's first chunk boundary
    (chunk, the window k-mers of a stage at k: kernels.mxu_any_chunk; the
    chunk's last k-mer, and one from half a k-mer before the boundary), at
    the window's 2,048th k-mer and at its last. k: the k-mers planted (8
    for K4's own cases; the any-k kernel's cases plant k-mers of their k
    the same way)."""
    import numpy as np

    from arriba_tpu_torch.ops.encode import PAD_CODE

    rng = np.random.default_rng(seed)
    if N is None:
        N = 4096 if case == "mixed" else 512
    if case == "odd":
        N, L, W = 333, 45, 1001
    if case in ("bench", "odd"):
        reads = rng.integers(0, 4, (N, L)).astype(np.uint8)
        windows = rng.integers(0, 4, (N, W)).astype(np.uint8)
        for row in range(0, N, 2 if case == "bench" else 3):
            at = int(rng.integers(0, W - k))
            start = min(40, L - k)
            windows[row, at:at + k] = reads[row, start:start + k]
        return reads, windows
    reads = rng.integers(0, 2, (N, L)).astype(np.uint8)
    windows = rng.integers(2, 4, (N, W)).astype(np.uint8)
    if case == "no_hit":
        return reads, windows
    if case == "straddle":
        if chunk is None:
            raise ValueError("the straddle rows need the chunk at k")
        spots = (chunk - 1, chunk - k // 2 - 1, 2047, W - k)
        for row in range(0, N, 2):
            kmer = rng.integers(0, 4, k).astype(np.uint8)
            kmer[-1] = 3
            start = int(rng.integers(0, L - k + 1))
            at = spots[row // 2 % len(spots)]
            reads[row, start:start + k] = kmer
            windows[row, at:at + k] = kmer
        return reads, windows
    if case == "mixed":
        R, WK = L - k + 1, W - k + 1
        kind = rng.integers(0, 4, N)
        for row in np.flatnonzero(kind):
            at = (int(rng.integers(0, max(1, WK // 16))) if kind[row] == 1
                  else int(rng.integers(0, WK)) if kind[row] == 2
                  else WK - 1)
            start = int(rng.integers(0, R))
            windows[row, at:at + k] = reads[row, start:start + k]
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
        seed_kmer = rng.integers(0, 4, k).astype(np.uint8)
        kind = row % 4
        if kind == 3:
            continue
        if kind == 1:
            seed_kmer[min(3, k - 1)] = int(rng.integers(5, 256))
        elif kind == 2:
            seed_kmer[min(5, k - 1)] = PAD_CODE
        at, start = int(rng.integers(0, W // 2 - k)), int(rng.integers(
            0, L // 2 - k))
        reads[row, start:start + k] = seed_kmer
        windows[row, at:at + k] = seed_kmer
    return reads, windows


def mxu_work(reads, windows, k: int = 8) -> dict:
    """The work K4's function needs on these inputs at k-mers of length k
    (1-31), counted with plain torch ops on their device: each row's R =
    L - k + 1 read k-mers against its window k-mers, in order, up to and
    including the first equal to a read k-mer (both over codes 0-3 only),
    or against all WK = W - k + 1 of them for a row with none, 4k
    multiply-adds a pair ("macs", what the bound counts); the full
    product's multiply-adds, N x R x WK x 4k; each row's first tile with a
    hit in the kernel's order (the read's slabs of 160 k-mers in turn, each
    against the window's tiles of 64 k-mers: slab x the window's tiles +
    window tile; -1 for none) and its verdict, for checks against the plain
    version and the kernel's emulation."""
    import torch

    if not 1 <= k <= 31:
        raise ValueError("mxu_work packs a k-mer into 62 bits: k <= 31")
    N, L = reads.shape
    W = windows.shape[1]
    R, WK = L - k + 1, W - k + 1
    first = torch.full((N,), -1, dtype=torch.int64, device=reads.device)
    if R <= 0 or WK <= 0:
        return {"macs": 0, "full_macs": 0, "first_tile": first,
                "verdict": first >= 0}

    def kmers(x, n_pos, invalid):
        value = torch.zeros(N, n_pos, dtype=torch.int64, device=x.device)
        valid = torch.ones(N, n_pos, dtype=torch.bool, device=x.device)
        for t in range(k):
            code = x[:, t:t + n_pos].long()
            value = value * 4 + code.clamp(max=3)
            valid &= code <= 3
        return torch.where(valid, value, invalid)

    def first_match(read_kmers, window_kmers):
        """(any window k-mer equals one of read_kmers, index of the first)"""
        ordered = torch.sort(read_kmers, dim=1).values
        index = torch.searchsorted(ordered, window_kmers).clamp(
            max=ordered.shape[1] - 1)
        found = torch.gather(ordered, 1, index) == window_kmers
        return found.any(dim=1), found.to(torch.uint8).argmax(dim=1)

    read_kmers = kmers(reads, R, -1)
    window_kmers = kmers(windows, WK, -2)
    hit, first_kmer = first_match(read_kmers, window_kmers)
    macs = int(torch.where(hit, first_kmer + 1, WK).sum()) * R * 4 * k
    slab, window_tiles = 160, -(-WK // 64)
    for s in reversed(range(0, R, slab)):
        slab_hit, slab_first = first_match(read_kmers[:, s:s + slab],
                                           window_kmers)
        first = torch.where(slab_hit, s // slab * window_tiles
                            + slab_first // 64, first)
    return {"macs": macs, "full_macs": N * R * WK * 4 * k,
            "first_tile": first, "verdict": hit}


# K4's phase-2 cases (mxu_inputs), the first at the bench's shape
MXU_CASES = ("bench", "no_hit", "pad", "odd", "mixed")


def onehot_product_ms(reads, windows, k: int = 8) -> float:
    """One torch.bmm of the float16 one-hot encodings of every read and
    window k-mer (exact: 0/1 products, sums of at most 4k <= 2,048): the
    product K4 fuses with its test, alone, as a library yardstick the port
    never calls. Median of 5 CUDA-event timed calls."""
    import torch

    def onehot(x, n_pos):
        stacked = torch.stack([x[:, j:j + n_pos] for j in range(k)], -1)
        return (stacked[..., None] == torch.arange(4, device=x.device)).to(
            torch.float16).reshape(len(x), n_pos, 4 * k)

    a = onehot(reads, reads.shape[1] - k + 1)
    b = onehot(windows, windows.shape[1] - k + 1).transpose(1, 2).contiguous()
    ms = cuda_ms(lambda: torch.bmm(a, b), 5)
    del a, b
    torch.cuda.empty_cache()
    return ms


# K4's stress step: (mxu_inputs case, rows, read length, launches), each
# verdict held against the plain verdict. The bench rows are the first 64
# and all 512 of case (a); the mixed rows, 4,096 at one and at two slabs of
# read k-mers, outnumber the blocks K4 launches on an H100 (132 SMs x 4),
# so each block takes ~8 rows in turn.
MXU_STRESS = (("bench", 64, 152, 200), ("bench", 512, 152, 200),
              ("mixed", 4096, 152, 50), ("mixed", 4096, 300, 50))
# the any-k kernel's: 4,096 mixed rows at k = 12 and 31 (k-mers of that k
# planted), more rows than its blocks, so each block takes rows in turn
# and its copy ring runs on across rows that early hits decide
MXU_ANY_STRESS = (("mixed", 4096, 152, 50, 12), ("mixed", 4096, 152, 50, 31))


def mxu_stress(launch, label: str, sets=MXU_STRESS) -> int:
    """K4's stress step: launch(reads, windows, out, k) on each set of rows
    (case, rows, read length, launches[, k], k = 8 where a set names none)
    as many times as it says, every verdict against the plain verdict
    computed once; out is filled with 2 before each launch, so a row left
    unwritten shows too. A mismatch is a SystemExit that names the build,
    the case, the launch and the first rows that differ. Returns the
    launches made."""
    import torch

    from arriba_tpu_torch.ops import realign

    count = 0
    for case, rows, L, repeats, *rest in sets:
        k = rest[0] if rest else 8
        reads, windows = mxu_inputs(case, N=max(rows, 512), L=L, k=k)
        r, w = (torch.from_numpy(x[:rows].copy()).to("cuda")
                for x in (reads, windows))
        want = realign.mxu_shared_kmer_mask_plain(r, w, k).to(torch.uint8)
        if case == "mixed" and not 0 < int(want.sum()) < rows:
            raise SystemExit(f"K4's mixed stress rows ({rows} x {L}, k = "
                             f"{k}) do not mix hits and rows without one")
        out = torch.empty(rows, dtype=torch.uint8, device="cuda")
        for repeat in range(repeats):
            out.fill_(2)
            launch(r, w, out, k)
            bad = torch.nonzero(out != want).flatten()[:8]
            if len(bad):
                raise SystemExit(
                    f"K4 ({label}) disagrees with its plain version on the "
                    f"first {rows} {case} rows of length {L} at k = {k} at "
                    f"launch {repeat + 1} of {repeats}: rows "
                    f"{bad.tolist()} give {out[bad].tolist()}, the plain "
                    f"version {want[bad].tolist()}")
            count += 1
    log(f"K4 stress ({label}): {count} launches, every verdict equal to the "
        f"plain version")
    return count


def mxu_occupancy() -> None:
    """K4 (this checkout's build) on rows with no hit, the full product
    (mxu_inputs 'no_hit' at the bench's widths), at 1, 2, 3 and 4 rows an
    SM: K4 runs a block a row, all at once at these counts. If the time
    stays flat as the rows grow, each block's own chain of dependent steps
    holds K4 (latency); if it grows with them, a unit the blocks of an SM
    share does (throughput). One JSON line: rows an SM -> ms a launch
    (median of 20 windows of K2_K3_BATCH launches)."""
    import torch

    from arriba_tpu_torch import kernels

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for per_sm in (1, 2, 3, 4):
        r, w = (torch.from_numpy(x).to("cuda")
                for x in mxu_inputs("no_hit", N=per_sm * sms))
        out = torch.empty(len(r), dtype=torch.uint8, device="cuda")
        result[per_sm] = cuda_ms(
            lambda: kernels.launch_mxu_kmer_screen(r, w, out), 20,
            batch=K2_K3_BATCH)
        if bool(out.any()):
            raise SystemExit("K4 finds a hit in rows that have none")
        log(f"K4 no_hit, {per_sm} rows an SM ({len(r)} rows): "
            f"{result[per_sm]:.4f} ms")
    print(json.dumps({"k4_occupancy": {"sms": sms, "ms": result}}))


def mxu_case_record(name: str, k: int, launch, library: bool) -> dict:
    """One case of K4 (k = 8) or its any-k kernel: realign.
    mxu_shared_kmer_mask on mxu_inputs(name, k=k) against the plain version
    on the card, exactly, and three more launches with the output filled
    with 2 first, every verdict checked; the launch time (median of 20
    windows of K2_K3_BATCH launches of launch(r, w, out, k)), its bound
    (mxu_work at k: 4k multiply-adds a k-mer pair up to each row's first
    hit, at the int8 tensor-core rate), the full product's bound and the
    kernel's share of it, the plain version's time and, where library is
    set, one torch.bmm of the one-hots (onehot_product_ms)."""
    import torch

    from arriba_tpu_torch.ops import realign

    reads, windows = mxu_inputs(name, k=k)
    r, w = (torch.from_numpy(x).to("cuda") for x in (reads, windows))
    got = realign.mxu_shared_kmer_mask(r, w, k)
    want = realign.mxu_shared_kmer_mask_plain(r, w, k)
    work = mxu_work(r, w, k)
    err = int((got.int() - want.int()).abs().max())
    if err != 0 or not torch.equal(work["verdict"], want):
        raise SystemExit(f"K4 at k = {k} disagrees with its plain version "
                         f"({name})")
    out = torch.empty(len(reads), dtype=torch.uint8, device="cuda")
    for _ in range(3):
        out.fill_(2)
        launch(r, w, out, k)
        if not torch.equal(out, want.to(torch.uint8)):
            raise SystemExit(f"K4 at k = {k} disagrees on a repeat ({name})")
    hits = int(want.sum())
    # every planted row hits (bench: every other row, odd: every third;
    # pad: exactly the clean plants, every fourth); chance hits come on top
    expected = {"no_hit": hits == 0, "bench": bool(want[::2].all()),
                "pad": want.cpu().tolist() == [row % 4 == 0 for row in
                                               range(len(reads))],
                "odd": bool(want[::3].all()),
                "mixed": 0 < hits < len(reads)}[name]
    if k == 8:
        # K4's own inputs give their mix too: the chance hits take every
        # bench row, and case (d) keeps rows with no hit
        expected &= {"bench": hits == len(reads),
                     "odd": hits < len(reads)}.get(name, True)
    if not expected:
        raise SystemExit(f"K4's {name} case at k = {k} does not give its "
                         f"verdicts")
    ms = cuda_ms(lambda: launch(r, w, out, k), 20, batch=K2_K3_BATCH)
    plain_ms = cuda_ms(lambda: realign.mxu_shared_kmer_mask_plain(r, w, k),
                       3)
    n_bytes = reads.nbytes + windows.nbytes + len(reads)
    bound_ms, bound_by = bound(n_bytes, 2 * work["macs"], INT8_OPS_PER_S)
    full_ms, _ = bound(n_bytes, 2 * work["full_macs"], INT8_OPS_PER_S)
    case = {"rows": len(reads), "width": [reads.shape[1], windows.shape[1]],
            "hits": hits, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "macs": work["macs"],
            "full_product_bound_ms": full_ms,
            "full_product_share": full_ms / ms}
    if library:
        case["library_ms"] = onehot_product_ms(r, w, k)
    log(f"K4 k={k} {name}: {hits}/{len(reads)} rows share a k-mer, equal "
        f"to the plain version; {ms:.4f} ms a launch, plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
        f"{bound_ms / ms:.1%}); full product {full_ms:.4f} ms "
        f"({full_ms / ms:.1%})"
        + (f"; torch.bmm of the one-hots {case['library_ms']:.4f} ms"
           if library else ""))
    return case


def check_mxu() -> dict:
    """K4 on each case of MXU_CASES (mxu_case_record at k = 8; the library
    call on the bench and no_hit rows), then its stress step (mxu_stress).
    Returns K4's record, the bench rows its main case."""
    from arriba_tpu_torch import kernels

    cases = {name: mxu_case_record(name, 8, kernels.launch_mxu_kmer_screen,
                                   name in ("bench", "no_hit"))
             for name in MXU_CASES}
    mxu_stress(kernels.launch_mxu_kmer_screen, "this checkout")
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


def check_smith_waterman_wide() -> list:
    """K3w through realign.smith_waterman_scores against its plain version
    on the card, exactly, on each case of SWW_CASES, each routed before
    launch (kernels.sw_route) to the width the case names, with each case's
    launch time in that width (median of 10 CUDA-event timed windows of 3
    launches), its bound in that width (every cell whose read and window
    bytes are both not PAD: SW_SLOTS_PER_CELL slots of the 32-bit integer
    rate in the 16-bit pairs, SWW_OPS_PER_CELL integer operations in the
    32-bit lanes, against the bytes read and written once), the 32-bit
    bound too (for comparison with the 32-bit kernel's), and the plain
    version's time (one call, after the comparison's). A case the 16-bit
    pairs take is also
    launched and timed in the 32-bit lanes (ms_32), equal to the plain
    version. No PyTorch call computes these scores: library_ms is null.
    Returns a record a width: the 16-bit pairs' main case the data-parallel
    step's own inputs (reads_600), the 32-bit lanes' long_bytes."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign
    from arriba_tpu_torch.ops.encode import PAD_CODE

    cases = {route: {} for route in ("smith_waterman_wide16",
                                     "smith_waterman_wide")}
    for name, (n, L, W, params, _, want_route) in SWW_CASES.items():
        reads, windows = sww_inputs(name)
        r, w = (torch.from_numpy(x).to("cuda") for x in (reads, windows))
        route = kernels.sw_route(r, w, *params)
        if route != want_route:
            raise SystemExit(f"K3w's case {name} routes to {route}, not "
                             f"{want_route}")
        got = realign.smith_waterman_scores(r, w, *params)
        want = realign.smith_waterman_scores_plain(r, w, *params)
        err = int((got - want).abs().max())
        high = int(want.max())
        if err != 0 or high <= 8:
            raise SystemExit(f"K3w disagrees with its plain version or its "
                             f"scores stay at 8 or below ({name})")
        if name == "past_2_13" and high < 1 << 13:
            raise SystemExit("K3w's past_2_13 case stays below 2^13")
        plain_ms = cuda_ms(
            lambda: realign.smith_waterman_scores_plain(r, w, *params), 1,
            warm_up=False)
        out = torch.empty(n, dtype=torch.int32, device="cuda")
        times = {}
        for width in dict.fromkeys((route, "smith_waterman_wide")):
            launch = getattr(kernels, f"launch_{width}")
            carry = kernels.sw_wide_carry(r, w, width)
            out.fill_(-1)
            times[width] = cuda_ms(
                lambda: launch(r, w, out, carry, *params), 10, batch=3)
            if not torch.equal(out, want):
                raise SystemExit(f"K3w's timed launches disagree ({name}, "
                                 f"{width})")
            del carry
        ms, ms_32 = times[route], times["smith_waterman_wide"]
        read_len = (reads != PAD_CODE).sum(axis=1).astype(np.int64)
        win_len = (windows != PAD_CODE).sum(axis=1).astype(np.int64)
        cells = float((read_len * win_len).sum())
        n_bytes = reads.nbytes + windows.nbytes + 4 * n
        bound_32, _ = bound(n_bytes, cells * SWW_OPS_PER_CELL)
        bound_ms, bound_by = bound(n_bytes, cells * (
            SW_SLOTS_PER_CELL if route == "smith_waterman_wide16"
            else SWW_OPS_PER_CELL))
        cases[route][name] = {
            "rows": n, "width": [L, W], "scores": list(params),
            "route": route, "lanes": 16 if route != "smith_waterman_wide"
            else 32, "max_score": high, "max_abs_err": err, "ms": ms,
            "ms_32": ms_32, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_32_ms": bound_32, "cells": cells}
        log(f"K3w {name} ({n} x {L} x {W}, scores {params}) -> {route}: "
            f"max score {high}, equal to the plain version; {ms:.4f} ms a "
            f"launch, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}, {bound_ms / ms:.1%}); 32-bit lanes {ms_32:.4f} "
            f"ms against their bound {bound_32:.4f} ms "
            f"({bound_32 / ms_32:.1%})")
        del r, w, out, got, want
        torch.cuda.empty_cache()
    records = []
    for route, main in (("smith_waterman_wide16", "reads_600"),
                        ("smith_waterman_wide", "long_bytes")):
        case = cases[route][main]
        records.append({
            "name": route, "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/smith_waterman_wide.cu",
            "replaces": "arriba_tpu/ops/realign.py:162",
            "max_abs_err": max(c["max_abs_err"]
                               for c in cases[route].values()),
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "ms_32": case["ms_32"], "bound_32_ms": case["bound_32_ms"],
            "library_ms": None,
            "cases": cases[route]})
    return records


# K4's any-k kernel: the k it is checked and timed at, each on the bench
# rows (mxu_inputs 'bench'), case (d) ('odd') and rows with no hit
# ('no_hit', the full product), k-mers of that k planted; at MXU_ANY_MIXED
# also on 4,096 mixed rows (more rows than blocks), which then go through
# the stress step (MXU_ANY_STRESS)
MXU_ANY_K = (1, 4, 12, 16, 31)
MXU_ANY_CASES = ("bench", "odd", "no_hit")
MXU_ANY_MIXED = (12, 31)


def mxu_any_empty_inputs(k: int):
    """The bench rows' reads (512 x 152) against windows of k - 1 bytes,
    on the card: no window holds a k-mer, so a launch of the any-k kernel
    at k is its grid's fixed cost (every block writes its rows' zeros)."""
    import torch

    reads, _ = mxu_inputs("bench", k=k)
    return (torch.from_numpy(reads).to("cuda"),
            torch.zeros((len(reads), k - 1), dtype=torch.uint8,
                        device="cuda"))


def check_mxu_any_k() -> list:
    """K4's any-k kernel, each k of MXU_ANY_K routed before launch
    (kernels.mxu_route), on each case of MXU_ANY_CASES and, at each k of
    MXU_ANY_MIXED, on 4,096 mixed rows (mxu_case_record; the library call
    on the bench and no_hit rows), and the time of an empty launch of its
    grid (mxu_any_empty_inputs, as mxu_case_record times); then its stress
    step (mxu_stress on MXU_ANY_STRESS). Returns a record a k, the bench
    rows its main case."""
    import torch

    from arriba_tpu_torch import kernels

    records = []
    for k in MXU_ANY_K:
        if kernels.mxu_route(k) != "mxu_kmer_screen_any_k":
            raise SystemExit(f"k = {k} does not route to the any-k kernel")
        names = MXU_ANY_CASES + (("mixed",) if k in MXU_ANY_MIXED else ())
        cases = {name: mxu_case_record(name, k,
                                       kernels.launch_mxu_kmer_screen,
                                       name in ("bench", "no_hit"))
                 for name in names}
        r, w = mxu_any_empty_inputs(k)
        out = torch.ones(len(r), dtype=torch.uint8, device="cuda")
        empty_ms = cuda_ms(lambda: kernels.launch_mxu_kmer_screen(r, w, out,
                                                                  k),
                           20, batch=K2_K3_BATCH)
        if bool(out.any()):
            raise SystemExit(f"K4 at k = {k} finds a k-mer in windows of "
                             f"{k - 1} bytes")
        log(f"K4 k={k}: an empty launch of its grid {empty_ms:.4f} ms")
        main = cases["bench"]
        records.append({
            "name": f"mxu_kmer_screen_any_k k={k}", "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/mxu_kmer_screen.cu",
            "replaces": "arriba_tpu/ops/realign.py:79",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "full_product_bound_ms": main["full_product_bound_ms"],
            "empty_ms": empty_ms, "cases": cases})
    mxu_stress(kernels.launch_mxu_kmer_screen, "any-k, this checkout",
               MXU_ANY_STRESS)
    return records


def check_accept_variants() -> list:
    """K1's rows that walk every diagonal (accept_low_min_score_inputs,
    512 x 192 x 2,048, half the rows) and a launch of more rows than a grid
    dimension holds (accept_many_rows_inputs, 70,000 x 64 x 64), each
    through realign.accept_wavefront against the plain version on the card
    and timed as check_accept times K1; the plain version's time is one
    call. Returns a record each."""
    import torch

    from arriba_tpu_torch.ops import realign

    records = []
    for name, make in (("every_diagonal", accept_low_min_score_inputs),
                       ("rows_70000", accept_many_rows_inputs)):
        arrays = make()
        summary, want = check_accept(name, arrays)
        if not 0 < summary["walks_all_rows"] < summary["rows"] or not (
                0 < summary["accepting"] < summary["rows"]):
            raise SystemExit(f"K1's {name} case does not mix both modes and "
                             f"both verdicts")
        r, w, p = (torch.from_numpy(x).to("cuda") for x in arrays)
        summary["plain_ms"] = cuda_ms(
            lambda: realign.accept_wavefront_plain(r, w, *p.unbind(dim=1)),
            1, warm_up=False)
        records.append({
            "name": f"accept_wavefront {name}", "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/accept_wavefront.cu",
            "replaces": "arriba_tpu/ops/realign.py:444",
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"], "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"], "library_ms": None,
            "walk_all_bound_ms": summary["walk_all_bound_ms"],
            "cases": {name: summary}})
    return records


# ---------------------------------------------------------------------------
# phase 2: K5 and K1's indexed entry on resident tables

# K5, one position of a distinct window (the work sets each window's bitmap
# once; the kernel's blocks that share a window set it again):
KB_SCAN_OPS = {"base code": 4, "rolling 8-mer": 3, "bitmap word and bit": 3,
               "set the bit": 1, "loop": 2}
# K5, one read 8-mer tested, up to and with a row's first set bit (every
# test of a row without one):
KB_TEST_OPS = {"code and PAD test": 2, "rolling 8-mer": 3,
               "bitmap word and bit": 3, "test": 1, "loop": 2}
KB_OPS_PER_POSITION = sum(KB_SCAN_OPS.values())  # 13
KB_OPS_PER_TEST = sum(KB_TEST_OPS.values())      # 11

# the resident cases (resident_case): the main path's shape, then the edges
RESIDENT_CASES = ("main", "tail", "short", "reads_n", "chunk_edges",
                  "shared_10000")
# the pairs of a case K1's plain version takes on the card (its cost grows
# with rows x (read + window) steps): shared_10000's first 5,000, 10,000
# rows of its one window
RESIDENT_K1_PAIRS = 5000


def resident_main(seed: int = 53, contig_len: int = 4_000_000,
                  n_windows: int = 128, win_lo: int = 20_000,
                  win_hi: int = 80_000, n_pairs: int = 32_768,
                  read_len: int = 150, n_runs: int = 0,
                  run_len: int = 2000):
    """The screen's main-path shape: gene windows (gene plus twice the mate
    gap and read length, 20-80 kb) of one random contig with 0.5 % N,
    chosen by pairs with a 1 / rank skew, and 150 bp reads: by pair % 8
    copies of the window (0), their reverse complements (1), copies with
    40 substitutions (2), reads across the window's end (3, 4; the bytes
    past it continue the read), random reads (5, 6), and pair 7 the read
    of pair 6 against another window; with n_runs runs of run_len N at
    random places of the contig (none by default). (contig, spans, reads,
    min_scores)"""
    import numpy as np

    from arriba_tpu_torch.seq import COMPLEMENT_LUT

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    contig = alphabet[rng.choice(5, contig_len,
                                 p=[.24875, .24875, .24875, .24875, .005])]
    for at in np.random.default_rng(seed + 1).integers(
            0, contig_len - run_len, n_runs):
        contig[at:at + run_len] = ord("N")
    lens = rng.integers(win_lo, win_hi, n_windows)
    starts = rng.integers(0, contig_len - win_hi - read_len, n_windows)
    weights = 1.0 / np.arange(1, n_windows + 1)
    pick = rng.choice(n_windows, n_pairs, p=weights / weights.sum())
    spans, reads = [], []
    for i, w in enumerate(pick):
        a, n = int(starts[w]), int(lens[w])
        kind = i % 8
        if kind == 7:
            reads.append(reads[-1])
        elif kind in (3, 4):
            s = a + n - read_len // 2
            reads.append(contig[s:s + read_len].tobytes().decode())
        elif kind in (5, 6):
            reads.append(alphabet[rng.integers(0, 4, read_len)]
                         .tobytes().decode())
        else:
            s = int(rng.integers(a, a + n - read_len))
            read = contig[s:s + read_len].copy()
            if kind == 1:
                read = COMPLEMENT_LUT[read][::-1]
            elif kind == 2:
                read[rng.integers(0, read_len, 40)] = alphabet[
                    rng.integers(0, 4, 40)]
            reads.append(read.tobytes().decode())
        spans.append((a, n))
    return contig, spans, reads, [int(0.8 * len(s) + 0.5) for s in reads]


RESIDENT_TAIL_LENGTHS = (0, 7, 20, 100, 1000, 4096, 8190, 8192, 8193,
                         16000, 16384, 17000)


def resident_tail(read_len: int = 150, lengths=RESIDENT_TAIL_LENGTHS):
    """Windows whose next bytes continue the read: each window a run of
    A (by default 0 to 17,000 bytes, at and around 8,192 and 16,384),
    followed in the contig by G and C bytes. A screen read (seven A, then
    G and C) has no 8-mer inside its window, its first across the
    window's end by one byte; an accept read (119 A, then 31 G and C)
    matches 119 bytes inside, 120 with one byte past the end, at min_score
    120. Both verdicts are False; reading one byte past a window makes
    them True."""
    import numpy as np

    rng = np.random.default_rng(61)
    contig, spans, reads = [], [], []
    at = 0
    for n in lengths:
        gc = np.frombuffer(b"GC", np.uint8)[rng.integers(0, 2, 200)]
        contig += [np.full(n, ord("A"), np.uint8), gc]
        for inside in (7, 119):
            inside = min(inside, n)
            reads.append(("A" * inside + gc[:read_len - inside].tobytes()
                          .decode()))
            spans.append((at, n))
        at += n + len(gc)
    return (np.concatenate(contig), spans, reads,
            [int(0.8 * len(s) + 0.5) for s in reads])


def resident_short():
    """Windows of 0, 1, 7, 8, 9, 10, 16 and 17 bytes, each against reads
    that hold it with 3 bytes either side and against reads of 0, 5, 8, 9
    and 30 bytes from elsewhere."""
    import numpy as np

    rng = np.random.default_rng(67)
    contig = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2000)]
    spans = [(100 * (k + 1), n) for k, n in enumerate((0, 1, 7, 8, 9, 10, 16,
                                                       17))]
    reads = [contig[a - 3:a + n + 3].tobytes().decode() for a, n in spans]
    reads += [contig[1500:1500 + n].tobytes().decode()
              for n in (0, 5, 8, 9, 30)]
    pairs = [(read, span) for read in reads for span in spans]
    return (contig, [span for _, span in pairs], [read for read, _ in pairs],
            [int(0.8 * len(read) + 0.5) for read, _ in pairs])


def resident_reads_n():
    """Reads with N: copies of 32 windows (300-3,000 bytes, N runs in the
    contig) with 1-5 bytes turned to N, all-N reads, and random reads."""
    import numpy as np

    rng = np.random.default_rng(71)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    contig = alphabet[rng.integers(0, 4, 200_000)]
    for at in rng.integers(0, len(contig) - 20, 200):
        contig[at:at + int(rng.integers(1, 20))] = ord("N")
    spans, reads = [], []
    for w in range(32):
        a, n = int(rng.integers(0, 190_000)), int(rng.integers(300, 3000))
        for kind in range(4):
            if kind < 2:
                s = int(rng.integers(a, a + n - 150))
                read = contig[s:s + 150].copy()
                read[rng.integers(0, 150, int(rng.integers(1, 6)))] = ord("N")
            elif kind == 2:
                read = np.full(int(rng.integers(8, 150)), ord("N"), np.uint8)
            else:
                read = alphabet[rng.integers(0, 4, 150)]
            reads.append(read.tobytes().decode())
            spans.append((a, n))
    return (contig, spans, reads,
            [int(0.8 * len(s) + 0.5) for s in reads])


def resident_chunk_edges(window_chunk: int = 8192, L: int = 192):
    """Windows of window_chunk - 1, window_chunk and window_chunk + 1 bytes
    and one and two strides (window_chunk - 2 L) past them, with 150 bp
    reads copied from each window's end, from across each chunk's end and
    from across each stride's start."""
    import numpy as np

    rng = np.random.default_rng(73)
    stride = window_chunk - 2 * L
    contig = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400_000)]
    spans, reads = [], []
    at = 1000
    for extra in (0, stride, 2 * stride):
        for delta in (-1, 0, 1):
            n = window_chunk + extra + delta
            cuts = {n - 150, window_chunk - 75, stride - 75,
                    stride + window_chunk - 75}
            for s in sorted(c for c in cuts if 0 <= c <= n - 150):
                reads.append(contig[at + s:at + s + 150].tobytes().decode())
                spans.append((at, n))
            at += n + 500
    return (contig, spans, reads,
            [int(0.8 * len(s) + 0.5) for s in reads])


def resident_shared(n_pairs: int = 10_000, window_len: int = 600):
    """One window of window_len bytes shared by n_pairs reads of 10-150
    bytes: every third a copy from the window, the others random."""
    import numpy as np

    rng = np.random.default_rng(79)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    contig = alphabet[rng.integers(0, 4, window_len + 100)]
    reads = []
    for i in range(n_pairs):
        n = int(rng.integers(10, 151))
        if i % 3 == 0:
            s = int(rng.integers(50, 50 + window_len - n))
            reads.append(contig[s:s + n].tobytes().decode())
        else:
            reads.append(alphabet[rng.integers(0, 4, n)].tobytes().decode())
    return (contig, [(50, window_len)] * n_pairs, reads,
            [int(0.8 * len(s) + 0.5) for s in reads])


def resident_slice_edge(window_len: int, plants, seed: int = 83):
    """A window of window_len 'T' bytes with a G/C 8-mer planted at each
    position of plants, and a read a plant ("NN", the 8-mer, "NN"), then a
    read of another G/C 8-mer planted nowhere; no 8-mer picked is another's
    reverse complement. N codes as A does and the window holds neither, so
    a read shares exactly its own plant with the window, forward.
    (contig, spans, reads, min_scores)"""
    import numpy as np

    rng = np.random.default_rng(seed)
    at0 = 42  # in the contig layout, a slice of S positions ends 10 bytes
    # past a 16-byte boundary: its last group needs the next one
    contig = np.full(window_len + 2 * at0, ord("T"), np.uint8)
    kmers, taken = [], set()
    while len(kmers) < len(plants) + 1:
        forward = "".join(rng.choice(list("GC"), 8))
        back = forward[::-1].translate(str.maketrans("GC", "CG"))
        if not {forward, back} & taken:
            kmers.append(forward)
            taken |= {forward, back}
    for at, kmer in zip(plants, kmers):
        contig[at0 + at:at0 + at + 8] = np.frombuffer(kmer.encode(),
                                                      np.uint8)
    reads = [f"NN{kmer}NN" for kmer in kmers]
    return contig, [(at0, window_len)] * len(reads), reads, [10] * len(reads)


def kb_slice_edge_cases() -> dict:
    """{case: (window bytes, plant positions)} of K5's slice edges (S =
    kernels.KB_SLICE): one slice whose last 8-mer ends at the window's last
    byte, two slices the second of one position, two slices the second one
    position short; with 8-mers across the first slice's edge (position
    S - 1 reads 7 bytes past it), at the first and last positions the
    window holds and at the second slice's only one."""
    from arriba_tpu_torch.kernels import KB_SLICE as S

    return {"slice_plus_7": (S + 7, (0, S - 9, S - 1)),
            "slice_plus_8": (S + 8, (0, S - 8, S)),
            "two_slices_plus_6": (2 * S + 6, (S - 1, S + 10, 2 * S - 2))}


def resident_long_reads(lengths=(250, 300, 517, 700), seed: int = 97):
    """Reads past 256 bytes, whose tests a warp stages in several pieces:
    a 2,000-byte window of T, G and C, and for each length a read of N, the
    same read with an 8-mer of the window 20 bytes before its end, with the
    reverse complement of one 5 bytes after its start (the reverse
    complement row holds it near its end), and with one at its very end.
    N codes as no window byte does, so only the planted 8-mers are shared.
    (contig, spans, reads, min_scores)"""
    import numpy as np

    from arriba_tpu_torch.seq import reverse_complement_str

    rng = np.random.default_rng(seed)
    contig = np.frombuffer(b"TGC", np.uint8)[rng.integers(0, 3, 3000)]
    window = contig[500:2500].tobytes().decode()
    reads = []
    for n in lengths:
        for at, kmer in ((None, ""), (n - 28, window[100:108]),
                         (5, reverse_complement_str(window[900:908])),
                         (n - 8, window[1990:1998])):
            read = ["N"] * n
            if at is not None:
                read[at:at + 8] = kmer
            reads.append("".join(read))
    return contig, [(500, 2000)] * len(reads), reads, [1] * len(reads)


# K5's edge cases (kb_edge_case)
KB_EDGE_CASES = ("slice_plus_7", "slice_plus_8", "two_slices_plus_6",
                 "unnamed_window", "one_row_tasks", "short_reads",
                 "long_reads")


def kb_edge_case(name: str):
    """(case, the resident window id whose pairs to leave out or None, rows
    a task) of an edge case of K5's schedule: the slice edges
    (kb_slice_edge_cases); a window no task names (reads_n without the
    pairs of window 1); tasks of one row (60 reads on one window); reads of
    0-8 bytes, each against a window that holds it and one of 7 bytes;
    reads of 250-700 bytes (resident_long_reads)."""
    import numpy as np

    edges = kb_slice_edge_cases()
    if name in edges:
        return resident_slice_edge(*edges[name]), None, 256
    if name == "unnamed_window":
        return resident_reads_n(), 1, 256
    if name == "one_row_tasks":
        return resident_shared(n_pairs=60), None, 1
    if name == "long_reads":
        return resident_long_reads(), None, 256
    rng = np.random.default_rng(89)
    contig = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)]
    reads = [contig[100 + 7 * n:100 + 8 * n].tobytes().decode()
             for n in range(9)]
    return (contig, [(90, 200), (0, 7)] * 9,
            [read for read in reads for _ in range(2)], [1] * 18), None, 256


def resident_case(name: str):
    """(contig, spans, reads, min_scores) of a resident case: pair i is
    reads[i] against contig[spans[i][0]:][:spans[i][1]]."""
    return {"main": resident_main, "tail": resident_tail,
            "short": resident_short, "reads_n": resident_reads_n,
            "chunk_edges": resident_chunk_edges,
            "shared_10000": resident_shared}[name]()


def resident_layouts(case, device) -> dict:
    """A case's pairs on device two ways: "packed", as realign.resident_pairs
    packs them (each distinct window from a 16-byte boundary, 1 bytes up to
    the next), and "contig", the same reads with the contig itself as the
    window table (each window at its own offset, unaligned, and the bytes
    past its end the contig's)."""
    import dataclasses

    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    contig, spans, reads, _ = case
    packed = realign.resident_pairs(
        reads, [contig[a:a + n] for a, n in spans], device)
    first = np.unique(packed.pair_window, return_index=True)[1]
    table = np.concatenate([contig, np.ones(kernels.AW_TABLE_SLACK,
                                            np.uint8)])
    in_contig = dataclasses.replace(
        packed, table=torch.from_numpy(table).to(device),
        win_offset=np.array([spans[i][0] for i in first], np.int64),
        uploaded=dict(packed.uploaded))
    return {"packed": packed, "contig": in_contig}


def read_codes(raw):
    """The screen's codes of raw read rows: kmer_to_int's (T 0, G 1, C 2,
    any other byte 3), PAD_CODE where the row holds byte 0 (past the
    read)."""
    import torch

    from arriba_tpu_torch.ops import realign
    from arriba_tpu_torch.ops.encode import PAD_CODE

    return torch.where(raw == 0, PAD_CODE, realign._kmer_codes_bytes(
        raw.long())).to(torch.uint8)


def kb_work(reads, table, offsets, lengths, row_read, tasks) -> dict:
    """The work K5 needs on these inputs, counted with plain torch ops on
    their device: the positions of each distinct window its tasks name
    (each window's bitmap set once), and each row's tests in the kernel's
    order (the forward row's 8-mers, then the reverse complement's) up to
    and with its first set bit, or all of them, and the bytes of each read
    those tests read, up to the last byte of its rows' furthest test
    ("read_bytes", each read once); with the verdicts that gives ("hit"),
    for a check against the plain version."""
    import torch

    from arriba_tpu_torch.ops import realign

    n = row_read.shape[0]
    row_window = realign._task_rows(tasks, n)
    used = torch.unique(row_window[row_window >= 0])
    n_pos = (lengths.long()[used] - 7).clamp(min=0)
    start = torch.repeat_interleave(offsets[used], n_pos) + (
        torch.arange(int(n_pos.sum()), device=reads.device)
        - torch.repeat_interleave(torch.cumsum(n_pos, 0) - n_pos, n_pos))
    code = realign._kmer_codes_bytes(table.long())
    kmer = torch.zeros_like(start)
    for t in range(8):
        kmer = kmer * 4 + code[start + t]
    keys = torch.unique(torch.repeat_interleave(used, n_pos) * 65536 + kmer)
    L = reads.shape[1]
    n_tests = 2 * max(L - 7, 0)
    tests, hit = 0, torch.zeros(n, dtype=torch.bool, device=reads.device)
    # _packed_kmers puts each 8-mer at its first byte of the 2 L-byte row
    # (the last 7 of each half are -1, no test), so a row's tests read up
    # to its first hit's byte + 8, or the whole row; a read's bytes reach
    # its rows' furthest
    extent = torch.zeros(reads.shape[0] // 2, dtype=torch.int64,
                         device=reads.device)
    for a in range(0, n, 4096):
        rows = torch.arange(a, min(a + 4096, n), device=reads.device)
        read = row_read[rows].long()
        codes = read_codes(torch.stack([reads[2 * read],
                                        reads[2 * read + 1]], 1))
        kmers = realign._packed_kmers(codes.flatten(0, 1), 8).reshape(
            len(rows), -1).long()
        query = row_window[rows, None] * 65536 + kmers
        at = torch.searchsorted(keys, query).clamp(max=max(len(keys) - 1, 0))
        found = (keys[at] == query) & (kmers >= 0) if len(keys) else \
            torch.zeros_like(kmers, dtype=torch.bool)
        any_hit = found.any(dim=1)
        first = found.long().argmax(dim=1)
        tests += int(torch.where(any_hit, first + 1 - 7 * (first >= L),
                                 n_tests).sum())
        reach = torch.where(any_hit, first + 8, 2 * L if n_tests else 0)
        extent.scatter_reduce_(0, read, reach, "amax")
        hit[rows] = any_hit
    return {"positions": int(n_pos.sum()), "tests": tests, "hit": hit,
            "windows": len(used),
            "window_bytes": int(lengths.long()[used].sum()),
            "reads": int(torch.unique(row_read).numel()),
            "read_bytes": int(extent.sum())}


def kb_bound(args, schedule, work) -> tuple:
    """K5's bound on one launch's inputs: the bytes it must move (each used
    window's bytes once, each used read's bytes as far as its tests reach,
    kb_work's read_bytes, the rows' read ids, the tasks, the windows'
    spans, the schedule, the verdicts) over the memory rate, against the
    work's operations (kb_work) over the integer rate: (ms, "bytes" or
    "operations")."""
    _, _, offsets, _, row_read, tasks = args
    n = row_read.shape[0]
    n_bytes = (work["window_bytes"] + work["read_bytes"] + 4 * n
               + 12 * tasks.shape[0] + 12 * offsets.shape[0]
               + schedule.nbytes() + n)
    return bound(n_bytes, work["positions"] * KB_OPS_PER_POSITION
                 + work["tests"] * KB_OPS_PER_TEST)


def kb_timed(args, schedule, want, runs: int = 20) -> dict:
    """K5 on one launch's inputs (kernels.kb_passes): the verdicts checked
    against want, then the median ms of the pair as the wrapper launches
    it (the scratch bitmap zeroed, both passes) and of each pass alone (the
    build pass ORs into the same bitmap again; the test pass reads the
    finished one)."""
    import torch

    from arriba_tpu_torch import kernels

    out = torch.full((args[4].shape[0],), 2, dtype=torch.uint8,
                     device="cuda")

    def pair():
        for name, pass_args in kernels.kb_passes(*args, out, schedule):
            kernels._call(name, *pass_args)

    pair()
    if not torch.equal(out.view(torch.bool), want):
        raise SystemExit("K5 disagrees with its plain version")
    (_, build_args), (_, test_args) = kernels.kb_passes(*args, out, schedule)
    return {"ms": cuda_ms(pair, runs),
            "build_ms": cuda_ms(
                lambda: kernels._call("kmer_bitmap_build", *build_args),
                runs),
            "test_ms": cuda_ms(
                lambda: kernels._call("kmer_bitmap_test", *test_args), runs)}


def old_screen_rows(resident, window_chunk: int = 8192):
    """The rows the sorted screen took before the windows stayed on the card
    (each window in chunks of window_chunk bytes at a stride of
    window_chunk - 7, a forward and a reverse complement row each, as the
    JAX package's screen_pairs builds them): (pair, chunk start) a chunk,
    one of each pair's chunks per row pair."""
    import numpy as np

    stride = window_chunk - 7
    wl = resident.win_len[resident.pair_window]
    chunks = 1 + np.maximum(0, -(-(wl - window_chunk) // stride))
    pair = np.repeat(np.arange(len(wl)), chunks)
    c = np.arange(len(pair)) - np.repeat(np.cumsum(chunks) - chunks, chunks)
    return pair, c * stride


def sorted_screen_ms(resident, verdict, window_chunk: int = 8192,
                     batch: int = 4096, runs: int = 3) -> float:
    """The library call beside K5: the sorted screen (realign.shared_kmer_mask,
    torch.sort and torch.searchsorted) on the rows it took before the
    windows stayed on the card (old_screen_rows), built on the card from
    the resident tables, batch rows at a time; the sum of each batch's
    median ms over runs calls. Its verdicts, OR-ed over each pair's rows,
    must equal K5's (verdict)."""
    import numpy as np
    import torch

    from arriba_tpu_torch.ops import realign
    from arriba_tpu_torch.ops.encode import PAD_CODE

    device = resident.table.device
    pair, start = old_screen_rows(resident, window_chunk)
    offsets = torch.from_numpy(
        resident.win_offset[resident.pair_window[pair]] + start).to(device)
    lengths = torch.from_numpy(np.minimum(
        resident.win_len[resident.pair_window[pair]] - start,
        window_chunk)).to(device)
    reads = torch.from_numpy(resident.pair_read[pair]).to(device)
    lanes = torch.arange(window_chunk, device=device)
    shared = torch.zeros(len(resident.pair_read), dtype=torch.int32,
                         device=device)
    pair_d = torch.from_numpy(pair).to(device)
    total = 0.0
    for a in range(0, len(pair), batch // 2):
        b = slice(a, a + batch // 2)
        raw = resident.table[(offsets[b, None] + lanes).clamp(
            max=resident.table.numel() - 1)]
        codes = torch.where(lanes < lengths[b, None],
                            realign._kmer_codes_bytes(raw.long()),
                            PAD_CODE).to(torch.uint8)
        windows = codes.repeat_interleave(2, dim=0)
        rows = torch.stack([2 * reads[b], 2 * reads[b] + 1], 1).flatten()
        read_rows = read_codes(resident.accept_reads[rows])
        hits = realign.shared_kmer_mask(read_rows, windows)
        shared.scatter_reduce_(0, pair_d[b].repeat_interleave(2),
                               hits.int(), "amax")
        total += cuda_ms(lambda: realign.shared_kmer_mask(read_rows, windows),
                         runs, warm_up=False)
    if not np.array_equal(shared.cpu().numpy() != 0, verdict):
        raise SystemExit("K5 disagrees with the sorted screen on the chunked "
                         "rows")
    return total


# K5's variants timed on phase 2's main and shared_10000 cases, (rows a
# task, positions a slice): the defaults, other task sizes, a smaller slice
KB_VARIANTS = ((64, 16384), (32, 16384), (256, 16384), (64, 4096))
# runs of 2,000 N over phase 2's main contig for K5's hot-word case (10 %
# of its 4 Mb)
KB_N_RUNS = 200


def check_kmer_bitmap_screen() -> dict:
    """K5 through realign.kmer_bitmap_screen against its plain version on
    the card, on each resident case in both layouts (resident_layouts),
    with the verdicts a case must give: no screen read of "tail" (its even
    pairs) shares an 8-mer, and every read of "short" that holds a window
    of 8 bytes or more does; then on the edges of its schedule
    (KB_EDGE_CASES), with the schedule given and made by
    realign.kmer_bitmap_screen. On
    "main" and "shared_10000" (packed) each variant of KB_VARIANTS
    (kb_timed: the pair and each pass), and shared_10000 as one task, then
    the main case with KB_N_RUNS runs of N (timed too); on
    "main" the bound from the work these inputs need (kb_work, its verdicts
    checked too; kb_bound), the plain version's ms and the sorted screen's
    on the rows it took before (sorted_screen_ms: library_ms). Returns its
    record, its ms those of the defaults (realign.KB_TASK_ROWS and
    kernels.KB_SLICE) on "main"."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    record = {"name": "kmer_bitmap_screen", "route": "cuda",
              "source": "arriba_tpu_torch/kernels/csrc/kmer_bitmap_screen.cu",
              "replaces": "arriba_tpu/ops/realign.py:61", "max_abs_err": 0,
              "cases": {}}
    defaults = (realign.KB_TASK_ROWS, kernels.KB_SLICE)
    for name in RESIDENT_CASES:
        case = resident_case(name)
        for layout, res in resident_layouts(case, "cuda").items():
            pairs = np.arange(len(res.pair_read))
            order, args, schedule = realign.screen_inputs(res, pairs)
            got = realign.kmer_bitmap_screen(*args, schedule=schedule)
            torch.cuda.synchronize()
            want = realign.kmer_bitmap_screen_plain(*args)
            err = int((got.int() - want.int()).abs().max())
            if err != 0:
                raise SystemExit(f"K5 disagrees with its plain version "
                                 f"({name}, {layout})")
            verdict = np.zeros(len(pairs), bool)
            verdict[order] = want.cpu().numpy()
            if name == "tail" and verdict[0::2].any():
                raise SystemExit(f"a tail read shares an 8-mer past its "
                                 f"window ({layout})")
            if name == "short":
                spans = case[1]
                holds = [len(read) >= 8 and span[1] >= 8
                         and read[3:3 + span[1]] == case[0][
                             span[0]:span[0] + span[1]].tobytes().decode()
                         for read, span in zip(case[2], spans)]
                if not verdict[np.array(holds)].all():
                    raise SystemExit("a read that holds its window does not "
                                     "share an 8-mer with it")
            summary = {"pairs": len(pairs), "windows": len(res.win_len),
                       "tasks": int(args[5].shape[0]),
                       "slices": int(schedule.slices.shape[0]),
                       "sharing": int(verdict.sum()), "max_abs_err": err}
            if layout == "packed" and name in ("main", "shared_10000"):
                variants = {}
                for rows, slice_len in KB_VARIANTS:
                    _, v_args, v_schedule = realign.screen_inputs(
                        res, pairs, rows, slice_len)
                    variants[f"{rows} rows, slice {slice_len}"] = dict(
                        kb_timed(v_args, v_schedule, want),
                        tasks=int(v_args[5].shape[0]),
                        slices=int(v_schedule.slices.shape[0]))
                summary["variants"] = variants
                summary.update(variants["%d rows, slice %d" % defaults])
            if layout == "packed" and name == "shared_10000":
                one = torch.tensor([[0, 0, len(pairs)]], dtype=torch.int32,
                                   device="cuda")
                one_args = args[:5] + (one,)
                one_schedule = realign.screen_schedule(
                    one.cpu().numpy(), res.win_len, device="cuda")
                summary["one_task_ms"] = kb_timed(
                    one_args, one_schedule, want)["ms"]
            if layout == "packed" and name == "main":
                if not verdict[np.arange(len(pairs)) % 8 <= 2].all():
                    raise SystemExit("a read copied from its window does not "
                                     "share an 8-mer with it")
                work = kb_work(*args)
                if not torch.equal(work["hit"], want):
                    raise SystemExit("K5's counted tests do not give the "
                                     "plain version's verdicts")
                bound_ms, bound_by = kb_bound(args, schedule, work)
                summary.update(positions=work["positions"],
                               tests=work["tests"], bound_ms=bound_ms,
                               bound_by=bound_by)
                record.update(
                    ms=summary["ms"], build_ms=summary["build_ms"],
                    test_ms=summary["test_ms"], bound_ms=bound_ms,
                    bound_by=bound_by,
                    plain_ms=cuda_ms(
                        lambda: realign.kmer_bitmap_screen_plain(*args), 3),
                    library_ms=sorted_screen_ms(res, verdict))
            record["cases"][f"{name} {layout}"] = summary
            log(f"K5 {name} ({layout}): {summary['sharing']}/{len(pairs)} "
                f"pairs share an 8-mer, equal to the plain version"
                + "".join(f"; {key} {summary[key]:.4f}"
                          for key in ("ms", "build_ms", "test_ms",
                                      "one_task_ms", "bound_ms")
                          if key in summary))
            for label, times in summary.get("variants", {}).items():
                log(f"  {label}: " + ", ".join(
                    f"{key} {value:.4f}" for key, value in times.items()
                    if key.endswith("ms")))
    # the main case with long runs of N: one hot 8-mer (65,535) a run
    contig, spans, reads, _ = resident_main(n_runs=KB_N_RUNS)
    res = realign.resident_pairs(
        reads, [contig[a:a + n] for a, n in spans], "cuda")
    _, args, schedule = realign.screen_inputs(res,
                                              np.arange(len(res.pair_read)))
    want = realign.kmer_bitmap_screen_plain(*args)
    runs = dict(kb_timed(args, schedule, want),
                pairs=len(reads), sharing=int(want.sum()), max_abs_err=0,
                contig_n=int((contig == ord("N")).sum()))
    record["cases"]["main_n_runs"] = runs
    log(f"K5 main with {KB_N_RUNS} runs of 2,000 N: {runs['sharing']}/"
        f"{len(reads)} pairs share an 8-mer, equal to the plain version; "
        + ", ".join(f"{key} {runs[key]:.4f}"
                    for key in ("ms", "build_ms", "test_ms")))
    for name in KB_EDGE_CASES:
        (contig, spans, reads, _), left_out, rows = kb_edge_case(name)
        res = realign.resident_pairs(
            reads, [contig[a:a + n] for a, n in spans], "cuda")
        pairs = np.flatnonzero(res.pair_window != (
            -1 if left_out is None else left_out))
        _, args, schedule = realign.screen_inputs(res, pairs, rows)
        want = realign.kmer_bitmap_screen_plain(*args)
        for given in (schedule, None):
            if not torch.equal(realign.kmer_bitmap_screen(
                    *args, schedule=given), want):
                raise SystemExit(f"K5 disagrees with its plain version on "
                                 f"the edge case {name}")
        record["cases"][name] = {"pairs": len(pairs),
                                 "sharing": int(want.sum()),
                                 "slices": int(schedule.slices.shape[0]),
                                 "max_abs_err": 0}
        log(f"K5 {name}: {int(want.sum())}/{len(pairs)} pairs share an "
            f"8-mer, equal to the plain version")
    return record


def accept_indexed_main():
    """K1's main-path rows (accept_inputs) as tables: the reads as a read
    table, each window's win_len bytes one after another in a window table
    with 3-15 random bytes after each (offsets not 16-byte aligned, bytes
    past each window not 1), AW_TABLE_SLACK after the last. Returns (the
    dense rows, (reads, table, offsets int64 [N, 2], params))."""
    import numpy as np

    reads, windows, params = dense = accept_inputs()
    rng = np.random.default_rng(19)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    parts, starts, at = [], [], 0
    for row in range(len(reads)):
        window = windows[row, :params[row, 1]]
        gap = alphabet[rng.integers(0, 4, 3 + row % 13)]
        parts += [window, gap]
        starts.append(at)
        at += len(window) + len(gap)
    table = np.concatenate(parts + [np.ones(16, np.uint8)])
    offsets = np.stack([np.arange(len(reads)) * reads.shape[1],
                        np.array(starts)], 1).astype(np.int64)
    return dense, (reads, table, offsets, params)


def check_accept_indexed() -> dict:
    """K1's indexed entry through realign.accept_wavefront_indexed against
    its plain version on the card: on accept_indexed_main (and against the
    dense entry's verdicts on the same rows), timed as check_accept times
    K1, its bound from the same work (accept_work on the dense rows); then
    on the first RESIDENT_K1_PAIRS pairs of each resident case but "main"
    in both layouts, each layout against the plain version of the packed
    one, with the verdict "tail" must give: no row accepts. Returns its
    record."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    cuda = torch.device("cuda")
    dense, indexed = accept_indexed_main()
    r, t, o, p = (torch.from_numpy(x).to(cuda) for x in indexed)
    W = dense[1].shape[1]
    got = realign.accept_wavefront_indexed(r, t, o, p, W)
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: realign.accept_wavefront_indexed_plain(
        r, t, o, p, W), 1, warm_up=False)
    want = realign.accept_wavefront_indexed_plain(r, t, o, p, W)
    rd, wd, pd = (torch.from_numpy(x).to(cuda) for x in dense)
    if not (torch.equal(got, want)
            and torch.equal(got, realign.accept_wavefront(rd, wd, pd))):
        raise SystemExit("K1's indexed entry disagrees with its plain version "
                         "or the dense entry (main)")
    out = torch.zeros(len(p), dtype=torch.int32, device=cuda)
    ms = cuda_ms(lambda: kernels.launch_accept_wavefront_indexed(
        r, t, o, p, out, W), 20, setup=out.zero_)
    work = accept_work(rd, wd, pd, want)
    n_bytes = sum(x.nbytes for x in indexed) + 4 * len(p)
    bound_ms, bound_by = bound(n_bytes, work["positions"] * AW_OPS_PER_POSITION
                               + work["cells"] * AW_OPS_PER_CELL)
    cases = {"main": {"rows": len(p), "accepting": int(want.sum()),
                      "max_abs_err": 0, "ms": ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "plain_ms": plain_ms}}
    log(f"K1 indexed main: {int(want.sum())}/{len(p)} rows accept, equal to "
        f"the plain version and the dense entry; {ms:.4f} ms a launch, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    for name in RESIDENT_CASES[1:]:
        case = resident_case(name)
        n = min(len(case[2]), RESIDENT_K1_PAIRS)
        pairs = np.arange(n)
        min_scores = np.asarray(case[3], np.int64)[:n]
        want = None
        for layout, res in resident_layouts(case, cuda).items():
            row_pair, offsets, params = realign.resident_accept_rows(
                res, pairs, min_scores)
            o, p = (torch.from_numpy(x).to(cuda) for x in (offsets, params))
            got = realign.accept_wavefront_indexed(res.accept_reads, res.table,
                                                   o, p, 8192)
            torch.cuda.synchronize()
            if want is None:
                want = realign.accept_wavefront_indexed_plain(
                    res.accept_reads, res.table, o, p, 8192)
            if not torch.equal(got, want):
                raise SystemExit(f"K1's indexed entry disagrees with its "
                                 f"plain version ({name}, {layout})")
            accepted = np.zeros(n, bool)
            np.logical_or.at(accepted, row_pair, want.cpu().numpy())
            if name == "tail" and accepted.any():
                raise SystemExit(f"a tail row accepts past its window "
                                 f"({layout})")
            cases[f"{name} {layout}"] = {"pairs": n, "rows": len(p),
                                         "accepting": int(want.sum()),
                                         "max_abs_err": 0}
            log(f"K1 indexed {name} ({layout}): {int(want.sum())}/{len(p)} "
                f"rows accept, equal to the plain version")
    return {"name": "accept_wavefront_indexed", "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/accept_wavefront.cu",
            "replaces": "arriba_tpu/ops/realign.py:444", "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "cases": cases}


# K1's indexed entry on the main path's launches: the rows its plain
# version takes, strided through the launches, and the rows it takes at a
# time
MAIN_K1_SAMPLE = 32_768
MAIN_K1_PLAIN_BATCH = 16_384
# The main path's verdicts are one-sided (run A: every pair shares an
# 8-mer with its 20-80 kb window, and no K1 row accepts), so each launch is
# held once more with them broken up: K5 with every window cut to its first
# MAIN_KB_WINDOW_CUT bytes, K1 with min_score lowered to 9 + row % 24
MAIN_KB_WINDOW_CUT = 128


def launch_as_resident(args):
    """One K5 launch's inputs as the resident tables old_screen_rows and
    sorted_screen_ms read, its rows as the pairs."""
    import types

    import numpy as np

    from arriba_tpu_torch.ops import realign

    reads, table, offsets, lengths, row_read, tasks = args
    return types.SimpleNamespace(
        table=table, accept_reads=reads, win_offset=offsets.cpu().numpy(),
        win_len=lengths.cpu().numpy().astype(np.int64),
        pair_window=realign._task_rows(tasks, row_read.shape[0]).cpu()
        .numpy(), pair_read=row_read.cpu().numpy().astype(np.int64))


def accept_held_work(args, rows, verdicts, batch: int = 2048) -> dict:
    """accept_work on the held rows of one launch of K1's indexed entry,
    made dense as its plain version makes them (the read's read_len bytes,
    0 past them; the window's win_len bytes, 1 past them, W wide), batch
    rows at a time: positions and cells summed."""
    import torch

    reads, table, offsets, params, W = args
    flat = reads.reshape(-1)
    L = reads.shape[1]
    lanes_r = torch.arange(L, device=reads.device)
    lanes_w = torch.arange(W, device=reads.device)
    total = {"positions": 0, "cells": 0}
    for a in range(0, len(rows), batch):
        held = rows[a:a + batch]
        off, p = offsets[held].long(), params[held]
        r = flat[(off[:, :1] + lanes_r).clamp(0, flat.numel() - 1)]
        r = torch.where(lanes_r < p[:, :1], r, 0)
        w = table[(off[:, 1:] + lanes_w).clamp(0, table.numel() - 1)]
        w = torch.where(lanes_w < p[:, 1:2], w, 1)
        work = accept_work(r, w, p, verdicts[a:a + batch])
        for key in total:
            total[key] += work[key]
    return total


def check_main_launches(kept: dict, records: list) -> None:
    """Each launch of K5 and of K1's indexed entry that the main path made
    (kept by kept_launches), made again on the same tensors through its
    wrapper and held against its plain version: K5 on every row of each
    launch (its verdicts also from kb_work), K1's indexed entry on a stride
    of every launch's rows (at most MAIN_K1_SAMPLE rows in all: its plain
    version walks every row's 8,192 window bytes); then each again with its
    verdicts broken up (MAIN_KB_WINDOW_CUT, the schedule then made by
    realign.kmer_bitmap_screen; K1's lowered min_score), where both
    verdicts must occur. Each launch's median ms (K5's pair and each pass,
    kb_timed) and its bound: K5's from the work its inputs need (kb_work,
    kb_bound), with the sorted screen on the rows it took before
    (sorted_screen_ms) as its library time; K1's from accept_work on the
    held rows, scaled by the launch's rows over them (an estimate from the
    stride). Adds a "main path" case to each kernel's record."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    by_name = {record["name"]: record for record in records}
    for name in ("kmer_bitmap_screen", "accept_wavefront_indexed"):
        if not kept.get(name):
            raise SystemExit(f"the main path made no launch of {name}")
    case = {"launches": [], "max_abs_err": 0}
    for args, schedule in kept["kmer_bitmap_screen"]:
        cut = args[:3] + (args[3].clamp(max=MAIN_KB_WINDOW_CUT),) + args[4:]
        wants = []
        for launch, given in ((args, schedule), (cut, None)):
            got = realign.kmer_bitmap_screen(*launch, schedule=given)
            torch.cuda.synchronize()
            wants.append(realign.kmer_bitmap_screen_plain(*launch))
            if not torch.equal(got, wants[-1]):
                raise SystemExit("K5 disagrees with its plain version on a "
                                 "main path launch")
        want = wants[0]
        sharing = [int(x.sum()) for x in wants]
        rows = int(args[4].shape[0])
        if not 0 < sharing[1] < rows:
            raise SystemExit("K5's main path launch with its windows cut "
                             "gave one verdict only")
        work = kb_work(*args)
        if not torch.equal(work["hit"], want):
            raise SystemExit("K5's counted tests on a main path launch do not "
                             "give the plain version's verdicts")
        bound_ms, bound_by = kb_bound(args, schedule, work)
        times = kb_timed(args, schedule, want, runs=5)
        library_ms = sorted_screen_ms(launch_as_resident(args),
                                      want.cpu().numpy(), runs=1)
        case["launches"].append(dict(
            times, rows=rows, tasks=int(args[5].shape[0]),
            windows=work["windows"], slices=int(schedule.slices.shape[0]),
            positions=work["positions"], tests=work["tests"],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            sharing=sharing[0], sharing_windows_cut=sharing[1]))
        log(f"K5 main path launch: {sharing[0]}/{rows} rows share an 8-mer "
            f"({sharing[1]} with the windows cut to "
            f"{MAIN_KB_WINDOW_CUT} bytes), equal to the plain version on "
            f"every row; {times['ms']:.4f} ms (build {times['build_ms']:.4f}"
            f", test {times['test_ms']:.4f}), bound {bound_ms:.4f} ms "
            f"({bound_by}: {work['positions']} positions, {work['tests']} "
            f"tests, {work['read_bytes']} read bytes), the sorted screen "
            f"{library_ms:.2f} ms")
    by_name["kmer_bitmap_screen"]["cases"]["main path"] = case
    launches = kept["accept_wavefront_indexed"]
    total = sum(args[2].shape[0] for (args,) in launches)
    stride = max(1, -(-total // MAIN_K1_SAMPLE))
    case = {"launches": [], "max_abs_err": 0, "stride": stride}
    for (args,) in launches:
        reads, table, offsets, params, W = args
        n = offsets.shape[0]
        lowered = params.clone()
        lowered[:, 2] = torch.minimum(params[:, 2], 9 + torch.arange(
            n, device="cuda", dtype=torch.int32) % 24)
        rows = torch.arange(0, n, stride, device="cuda")
        accepting, wants = [], []
        for p in (params, lowered):
            got = realign.accept_wavefront_indexed(reads, table, offsets, p,
                                                   W)
            torch.cuda.synchronize()
            wants.append(realign.accept_wavefront_indexed_plain(
                reads, table, offsets[rows], p[rows], W,
                batch_rows=MAIN_K1_PLAIN_BATCH))
            if not torch.equal(got[rows], wants[-1]):
                raise SystemExit("K1's indexed entry disagrees with its "
                                 "plain version on a main path launch")
            accepting.append((int(got.sum()), int(wants[-1].sum())))
        if not 0 < accepting[1][1] < len(rows):
            raise SystemExit("K1's main path launch with min_score lowered "
                             "gave one verdict only")
        out = torch.zeros(n, dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: kernels.launch_accept_wavefront_indexed(
            reads, table, offsets, params, out, W), 3, setup=out.zero_)
        work = accept_held_work(args, rows, wants[0])
        scale = n / len(rows)
        n_bytes = reads.numel() + table.numel() + 40 * n
        bound_ms, bound_by = bound(
            n_bytes, scale * (work["positions"] * AW_OPS_PER_POSITION
                              + work["cells"] * AW_OPS_PER_CELL))
        case["launches"].append({
            "rows": int(n), "held": len(rows), "accepting": accepting[0][0],
            "held_accepting": accepting[0][1],
            "accepting_lowered": accepting[1][0],
            "held_accepting_lowered": accepting[1][1], "ms": ms,
            "held_positions": work["positions"], "held_cells": work["cells"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_from": f"the held rows scaled by {scale:.3f} (an estimate "
                          f"from the stride)"})
        log(f"K1 indexed main path launch: {accepting[0][0]}/{n} rows "
            f"accept ({accepting[1][0]} at the lowered min_score); every "
            f"{stride}th row ({len(rows)}, {accepting[0][1]} / "
            f"{accepting[1][1]} accepting) equal to the plain version; "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, estimated "
            f"from the held rows' {work['positions']} positions and "
            f"{work['cells']} cells x {scale:.3f})")
    by_name["accept_wavefront_indexed"]["cases"]["main path"] = case


# K2's long-row kernel's phase-2 batches: 8,192 reads of 4,000 codes, past
# the packed counters' 3,072 ("long"), and 2,048 reads of LE_LONG_LANES x
# 3,069 + 100 codes (98,308 at 32 lanes), which take more tiles than a
# lane's 10-bit fields hold, so that each group flushes them, with a
# homopolymer every 64th row ("flush"; its plain version's tensors fit on
# the card)
LE_LONG_SHAPE = (8192, 4000)
LE_FLUSH_ROWS = 2048
# launches of each case checked one by one before the timed ones
LE_LONG_REPEATS = 20


def le_long_cases() -> dict:
    """{case: (rows, codes, homopolymers)} of K2's long-row kernel."""
    from arriba_tpu_torch import kernels

    return {"long": (*LE_LONG_SHAPE, False),
            "flush": (LE_FLUSH_ROWS, kernels.LE_LONG_LANES * 3069 + 100,
                      True)}


def le_long_inputs(n: int, L: int, seed: int = 11,
                   homopolymers: bool = False):
    """(packed uint8 [n, L / 4], meta int32 [n, 8]) on the card for K2's
    long-row kernel: low_entropy_inputs at that shape (codes 0-3, a few N,
    a tenth of the reads shorter, a fiftieth low-entropy motifs), with
    homopolymers a homopolymer of the full length every 64th row, and the
    thresholds of kmer_content 0.6; and the codes."""
    import numpy as np
    import torch

    from arriba_tpu_torch.ops import readfilters

    codes, lengths, a1s, a1e, a2s, a2e = low_entropy_inputs(seed=seed, n=n,
                                                            L=L)
    if homopolymers:
        rows = np.arange(0, n, 64)
        codes[rows] = (rows % 4)[:, None]
        lengths[rows] = L
    th = readfilters._thresholds(lengths, a1s, a1e, a2s, a2e, 0.6)
    meta = np.stack([lengths, a1s, a1e, a2s, a2e, *th], 1).astype(np.int32)
    return (torch.from_numpy(readfilters.pack_codes(codes)).to("cuda"),
            torch.from_numpy(meta).to("cuda"), codes)


def check_low_entropy_long() -> dict:
    """K2's long-row kernel (rows past LE_PACKED_MAX_CODES codes, routed
    before launch by kernels.le_route) on each of le_long_cases through
    readfilters._low_entropy_core_packed against the plain version on the
    card, exactly, on LE_LONG_REPEATS launches each checked; its time
    (median of 20 windows of K2_K3_BATCH launches),
    the plain version's (the one call that gives the verdicts it is held
    against) and its bound: the packed rows, meta and verdicts once each
    against the fewer of the function's operations on these rows
    (le_long_ops: walking each read to its first threshold, or whole).
    Returns its record: the "long" case's numbers, and each case's under
    "cases"."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import readfilters

    cases = {}
    for name, (n, L, homopolymers) in le_long_cases().items():
        packed, meta, codes = le_long_inputs(n, L,
                                             homopolymers=homopolymers)
        if kernels.le_route(packed.shape[1]) != "low_entropy_long":
            raise SystemExit(f"rows of {L} codes do not route to K2's "
                             f"long-row kernel")
        got = readfilters._low_entropy_core_packed(packed, L, meta)
        held = {}

        def plain():
            held["want"] = readfilters._low_entropy_core_plain(
                readfilters._unpack_codes(packed, L), *meta.unbind(dim=1))

        plain_ms = cuda_ms(plain, 1, warm_up=False)
        want = held.pop("want")
        work = le_long_work(packed, *meta.unbind(dim=1),
                            rows=max(1, 2 ** 20 // L))
        err = int((got.int() - want.int()).abs().max())
        n_flag = int(want.sum())
        if err != 0 or not torch.equal(work["verdict"], want) or not (
                0 < n_flag < n):
            raise SystemExit(f"K2's long-row kernel disagrees with its plain "
                             f"version, le_long_work disagrees with both, or "
                             f"the input does not exercise both verdicts "
                             f"({name})")
        if homopolymers and not bool(want[::64].all()):
            raise SystemExit("a homopolymer row is not flagged")
        out = torch.empty(n, dtype=torch.uint8, device="cuda")
        for _ in range(LE_LONG_REPEATS):  # every repeat writes every row
            out.fill_(2)
            kernels.launch_low_entropy(packed, meta, out)
            if not torch.equal(out, want.to(torch.uint8)):
                raise SystemExit(f"K2's long-row kernel changed its verdicts "
                                 f"over repeated launches ({name})")
        ms = cuda_ms(lambda: kernels.launch_low_entropy(packed, meta, out),
                     20, batch=K2_K3_BATCH)
        ops = le_long_ops(work, n)
        n_bytes = packed.numel() + meta.numel() * 4 + n
        bound_ms, bound_by = bound(n_bytes, min(ops.values()))
        log(f"K2 low_entropy_long {name}: {n_flag}/{n} reads of {L} codes "
            f"flagged, equal to the plain version; {ms:.4f} ms a launch, "
            f"plain {plain_ms:.4f} ms; {work['positions']} positions walked "
            f"({work['selected']} selected, {work['segment_counts']} segment "
            f"counts; {work['eligible']} eligible), {ops['stop']} integer "
            f"operations to the first thresholds, {ops['end']} to the ends: "
            f"bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%})")
        cases[name] = {"rows": n, "codes": L, "flagged": n_flag,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "positions": work["positions"],
                       "selected": work["selected"],
                       "segment_counts": work["segment_counts"],
                       "eligible": work["eligible"], "operations": ops}
    main = cases["long"]
    return {"name": "low_entropy_long", "route": "cuda",
            "source": "arriba_tpu_torch/kernels/csrc/low_entropy.cu",
            "replaces": "arriba_tpu/ops/readfilters.py:206",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "cases": cases}


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
    # its long-row kernel, on rows past the packed counters' 3,072 codes
    records.append(check_low_entropy_long())

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

    # K3w, in 16-bit pairs and in 32-bit lanes: what K3 does not carry
    records.extend(check_smith_waterman_wide())

    # K4: the one-hot 8-mer screen on the int8 tensor cores, then its
    # any-k kernel
    records.append(check_mxu())
    records += check_mxu_any_k()

    # K1's rows that walk every diagonal, and 70,000 rows a launch
    records += check_accept_variants()

    # K5 and K1's indexed entry, on resident tables
    records.append(check_kmer_bitmap_screen())
    records.append(check_accept_indexed())
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
# around the call, device work included (each ends in a synchronize); the
# sorted screen (shared_kmer_mask) so that a run that calls it shows
TIMED_OPS = (("realign", "resident_pairs"), ("realign", "screen_resident"),
             ("realign", "kmer_bitmap_screen"),
             ("realign", "accept_resident"),
             ("realign", "accept_wavefront_indexed"),
             ("realign", "shared_kmer_mask"),
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


@contextlib.contextmanager
def resident_bytes(totals: dict):
    """Sum into totals what each realign.ResidentPairs made meanwhile
    copied to the device ("windows", "reads", "rows"), with the distinct
    windows' own bytes ("window_bytes") and the pairs."""
    from arriba_tpu_torch.ops import realign

    made = []
    inner = realign.resident_pairs

    def wrapped(*args, **kwargs):
        made.append(inner(*args, **kwargs))
        return made[-1]

    realign.resident_pairs = wrapped
    try:
        yield totals
    finally:
        realign.resident_pairs = inner
        for resident in made:
            for key, value in dict(
                    resident.uploaded,
                    window_bytes=int(resident.win_len.sum()),
                    pairs=len(resident.pair_read)).items():
                totals[key] = totals.get(key, 0) + value


@contextlib.contextmanager
def kept_launches(kept: dict):
    """Keep in kept, by kernel, the arguments of each launch of K5 (with its
    schedule) and of K1's indexed entry that realign.screen_launches and
    realign.accept_launches give meanwhile (their tensors stay on the
    card), so that check_main_launches makes those launches again."""
    from arriba_tpu_torch.ops import realign

    inner = {"kmer_bitmap_screen": ("screen_launches",
                                    realign.screen_launches),
             "accept_wavefront_indexed": ("accept_launches",
                                          realign.accept_launches)}

    def keeping(name, launches):
        def wrapped(*args, **kwargs):
            for rows, *launch in launches(*args, **kwargs):
                kept.setdefault(name, []).append(tuple(launch))
                yield (rows, *launch)
        return wrapped

    for name, (attribute, launches) in inner.items():
        setattr(realign, attribute, keeping(name, launches))
    try:
        yield kept
    finally:
        for attribute, launches in inner.values():
            setattr(realign, attribute, launches)


def main_path(sample: pathlib.Path, threads: int, runs,
              states=None, kept=None) -> dict:
    """Every run of runs through the CLI; outputs and stage counters must
    equal the first run's. Returns {label: (seconds, chimeric reads, kernel
    launches, {op: (seconds, calls)})}; the launch counts are zeroed just
    before each run and read just after it. The first run's PipelineState
    is appended to states, and its launches of K5 and K1's indexed entry
    kept in kept (kept_launches), when given. Each run also logs the bytes
    its resident tables copied to the card (resident_bytes)."""
    from arriba_tpu_torch import kernels

    results = {}
    reference = None
    for label, env in runs:
        ops: dict = {}
        copied: dict = {}
        kernels.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            for context in (timed_ops(ops), resident_bytes(copied)):
                stack.enter_context(context)
            if reference is None and states is not None:
                stack.enter_context(captured_states(states))
            if reference is None and kept is not None:
                stack.enter_context(kept_launches(kept))
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
        if copied:
            log(f"  copied to the card: {copied}")
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


def realign_600bp(n_reads: int = 4096, cpu: bool = False) -> dict:
    """The data-parallel realign step (parallel.dp.sharded_realign_step) on
    random_read_batch(rng, n_reads, 600): a ReadBatch 640 wide, which K3
    does not carry (its reads are 600 positions long), against ref[:,
    :256], at 1 and 4 shards on the card,
    equal to each other and to the step's plain arithmetic on the card (the
    8-mer screen and smith_waterman_scores_plain); with cpu, the 1-shard
    step on the CPU (the plain versions) too. Returns the kernel launches
    of the card runs, counted from 0, and each card run's seconds."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign
    from arriba_tpu_torch.ops.encode import random_read_batch
    from arriba_tpu_torch.parallel.dp import (make_mesh, shard_batch,
                                              sharded_realign_step)

    batch = random_read_batch(np.random.default_rng(5), n_reads, 600)
    runs = [(torch.device("cuda"), 1), (torch.device("cuda"), 4)]
    if cpu:
        runs.append((torch.device("cpu"), 1))
    results, seconds = [], {}
    kernels.reset_launch_counts()
    for device, shards in runs:
        if device.type == "cpu":
            launches = dict(kernels.launch_counts)
        mesh = make_mesh(shards, device)
        sharded = shard_batch(batch, mesh)
        start = time.perf_counter()
        result, total = sharded_realign_step(mesh)(
            sharded.bases, sharded.ref[:, :256].contiguous(), sharded.length)
        values = {key: value[:n_reads].cpu() for key, value in result.items()}
        if device.type == "cuda":
            seconds[shards] = time.perf_counter() - start
        results.append((f"{device.type} x {shards}", values, int(total)))
    if not cpu:
        launches = dict(kernels.launch_counts)
    bases = torch.from_numpy(batch.bases[:n_reads]).to("cuda")
    ref = torch.from_numpy(batch.ref[:n_reads, :256].copy()).to("cuda")
    length = torch.from_numpy(batch.length[:n_reads]).to("cuda")
    seeds = realign.shared_kmer_mask(bases, ref)
    scores = realign.smith_waterman_scores_plain(bases, ref)
    min_score = (torch.tensor(0.8, device="cuda") * length.float()
                 + 0.5).int()
    plain = {"seed_hit": seeds.cpu(), "sw_score": scores.cpu(),
             "can_align": (seeds & (scores >= min_score)).cpu()}
    for label, values, total in results:
        for key, want in plain.items():
            if not torch.equal(values[key], want):
                raise SystemExit(f"the realign step on 600 bp reads: {key} "
                                 f"differs from the plain version ({label})")
        if total != int(plain["can_align"].sum()):
            raise SystemExit(f"the realign step on 600 bp reads: the "
                             f"alignable total differs ({label})")
    log(f"realign step on {n_reads} reads of 600 bp ({batch.bases.shape[1]}"
        f" wide) x ref[:, :256]: 1 and 4 shards on the card"
        + (" and 1 on the CPU" if cpu else "") + " equal to the plain "
        f"version (scores {int(scores.min())}..{int(scores.max())}); "
        f"{', '.join(f'{n} shard(s) {t:.3f} s' for n, t in seconds.items())}"
        f"; kernel launches {launches}")
    if launches["smith_waterman_wide16"] <= 0:
        raise SystemExit("K3w's 16-bit pairs never launched on the 600 bp "
                         "realign step")
    return {"launches": launches, "seconds": seconds}


def sww_path(n: int = 4096) -> int:
    """realign.smith_waterman_scores, the op itself, on a batch K3's 16
    bits cannot carry: n rows of 1,024 read bytes against 2,048-byte
    windows with bytes 5-255 (smith_waterman_inputs, above_4), as a caller
    whose sequences hold such bytes would call it, equal to the plain
    version on the card. Returns K3w's 32-bit launches, counted from 0."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    r, w = (torch.from_numpy(x).to("cuda") for x in smith_waterman_inputs(
        n=n, L=1024, W=2048, above_4=True))
    kernels.reset_launch_counts()
    start = time.perf_counter()
    got = realign.smith_waterman_scores(r, w)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(kernels.launch_counts)
    if not torch.equal(got, realign.smith_waterman_scores_plain(r, w)):
        raise SystemExit("the Smith-Waterman op on bytes above 4 differs "
                         "from the plain version")
    log(f"Smith-Waterman op on {n} x 1024 x 2048 rows with bytes 5-255: "
        f"equal to the plain version, {seconds:.3f} s; kernel launches "
        f"{launches}")
    if launches["smith_waterman_wide"] <= 0:
        raise SystemExit("K3w's 32-bit lanes never launched on the op")
    return launches["smith_waterman_wide"]


# ---------------------------------------------------------------------------
# phase 6: the one-hot 8-mer screen as its caller drives it

def mxu_path() -> tuple:
    """realign.mxu_shared_kmer_mask on the bench's inputs, as the JAX
    package's bench calls its twin (bench.py:650-660; no CLI path calls
    it), held against the sorted 8-mer screen on the card. Returns K4's
    launches in it, counted from 0, and, as the bench's other number, the
    milliseconds of the port's sorted screen (realign.shared_kmer_mask,
    plain torch) on the same rows (median of 20 calls)."""
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
    sorted_ms = cuda_ms(lambda: realign.shared_kmer_mask(r, w), 20)
    log(f"the sorted screen on the bench rows: {sorted_ms:.4f} ms")
    return launches, sorted_ms


def mxu_any_k_path() -> dict:
    """realign.mxu_shared_kmer_mask on the bench rows at each k of
    MXU_ANY_K (k-mers of that k planted), as a caller of the JAX package's
    op with another k would call it, held against the sorted screen at k
    (k <= 15, where its k-mer values fit int32) or the plain version.
    Returns the any-k kernel's launches at each k, each counted from 0."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    launches = {}
    for k in MXU_ANY_K:
        r, w = (torch.from_numpy(x).to("cuda")
                for x in mxu_inputs("bench", k=k))
        kernels.reset_launch_counts()
        verdict = realign.mxu_shared_kmer_mask(r, w, k)
        torch.cuda.synchronize()
        launches[k] = kernels.launch_counts["mxu_kmer_screen_any_k"]
        want = (realign.shared_kmer_mask(r, w, k) if k <= 15
                else realign.mxu_shared_kmer_mask_plain(r, w, k))
        if not torch.equal(verdict, want):
            raise SystemExit(f"the one-hot screen at k = {k} disagrees with "
                             f"the sorted screen or the plain version")
        log(f"mxu screen at k = {k}: {int(verdict.sum())}/{len(r)} rows "
            f"share a k-mer, equal to the "
            f"{'sorted screen' if k <= 15 else 'plain version'}; kernel "
            f"launches {dict(kernels.launch_counts)}")
    return launches


def low_entropy_long_path(n: int = 2048) -> int:
    """readfilters.low_entropy_batch_chunked, the read cascade's call, on
    n reads of LE_LONG_SHAPE's 4,000 codes (le_long_inputs), on the card,
    against the plain version there. Returns the launches of K2's long-row
    kernel in it, counted from 0."""
    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import readfilters

    packed, meta, codes = le_long_inputs(n, LE_LONG_SHAPE[1], seed=13)
    host = meta.cpu().numpy()
    kernels.reset_launch_counts()
    flags = readfilters.low_entropy_batch_chunked(
        codes, *(host[:, i] for i in range(5)), 0.6,
        device=torch.device("cuda"))
    launches = kernels.launch_counts["low_entropy_long"]
    want = readfilters._low_entropy_core_plain(
        readfilters._unpack_codes(packed, codes.shape[1]),
        *meta.unbind(dim=1)).cpu().numpy()
    if not np.array_equal(flags, want):
        raise SystemExit("the low-entropy scan on reads of 4,000 codes "
                         "disagrees with the plain version")
    log(f"low-entropy scan on {n} reads of {codes.shape[1]} codes: "
        f"{int(flags.sum())} flagged, equal to the plain version; kernel "
        f"launches {dict(kernels.launch_counts)}")
    return launches


def accept_path() -> int:
    """realign.accept_wavefront, the op, on accept_many_rows_inputs (70,000
    rows of 64 x 64 in one launch, a quarter of them with min_score
    -2^20 + 1, so both of K1's modes), against the plain version on the
    card. Returns K1's launches in it, counted from 0."""
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ops import realign

    r, w, p = (torch.from_numpy(x).to("cuda")
               for x in accept_many_rows_inputs())
    kernels.reset_launch_counts()
    verdict = realign.accept_wavefront(r, w, p)
    torch.cuda.synchronize()
    launches = kernels.launch_counts["accept_wavefront"]
    if not torch.equal(verdict, realign.accept_wavefront_plain(
            r, w, *p.unbind(dim=1))):
        raise SystemExit("K1 on 70,000 rows disagrees with the plain version")
    log(f"accept wavefront op: {int(verdict.sum())}/{len(r)} rows accept "
        f"({int(kernels.accept_walks_all(p, r.shape[1]).sum())} walk every "
        f"diagonal), equal to the plain version; kernel launches "
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


# ---------------------------------------------------------------------------
# phase 9: K6, the card pass over a BGZF BAM, on the benchmark's own sample

K6_LAUNCHES = ("bgzf_inflate", "bam_frame", "bam_pairs", "bam_residue",
               "bam_coverage_finish")
K6_CELL = "genome150-native.whole"
K6_SEED = 2147000777


def k6_sample():
    """The benchmark's sample of K6_CELL at K6_SEED (benchmark/samples.py:
    9.4 M records, 652 MB of BGZF at level 1, its background cached under
    build/benchmark/cache) and the CLI's arguments for it."""
    from benchmark import harness, samples

    workload = harness.load_json("workloads", K6_CELL)
    config = harness.load_json("configs", workload["config"])
    traffic = harness.load_json("traffic", workload["traffic"])
    bg, _, _ = samples.make(config, traffic, K6_SEED, harness.BUILD / "cache",
                            int(config["threads"]))
    return bg, harness.cli_args(config, bg,
                                REPO / "build" / "chip_smoke" / "k6")


def k6_cli(args: list, label: str, device: str):
    """One in-process CLI run on device: (seconds, fusions bytes,
    discarded bytes, stage counters)."""
    from arriba_tpu_torch import cli

    out = REPO / "build" / "chip_smoke" / "k6"
    out.mkdir(parents=True, exist_ok=True)
    args = list(args)
    args[args.index("-o") + 1] = str(out / f"{label}.tsv")
    args[args.index("-O") + 1] = str(out / f"{label}.discarded.tsv")
    saved = os.environ.get("ARRIBA_TPU_TORCH_DEVICE")
    os.environ["ARRIBA_TPU_TORCH_DEVICE"] = device
    stdout = io.StringIO()
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            status = cli.main(args)
        seconds = time.perf_counter() - start
    finally:
        if saved is None:
            os.environ.pop("ARRIBA_TPU_TORCH_DEVICE", None)
        else:
            os.environ["ARRIBA_TPU_TORCH_DEVICE"] = saved
    text = stdout.getvalue()
    if status != 0:
        raise SystemExit(f"K6 run {label} exited {status}:\n{text[-3000:]}")
    counters = re.findall(r"\((?:remaining|total|marked)=\d+\)", text)
    return (seconds, (out / f"{label}.tsv").read_bytes(),
            (out / f"{label}.discarded.tsv").read_bytes(), counters)


def k6_work(path: str, contigs, result) -> dict:
    """The bytes each K6 launch must move at least, summed over the
    file: inflate reads each member and writes its ISIZE bytes; the
    framing reads each record's block_size and writes its start (12 bytes
    a record); the pair test reads each record's 36-byte fixed part and
    writes its six flags and sizes (16 bytes); the residue copy reads and
    writes each kept byte and reads three sums and writes three slots a
    record (20 + 17 bytes); the coverage finish reads 4 and writes 2
    bytes a window."""
    from arriba_tpu_torch.ingest import card

    data = pathlib.Path(path).read_bytes()
    members = list(card._members(data))
    isize = sum(int.from_bytes(data[at + size - 4:at + size], "little")
                for at, size in members)
    records = result.taken + result.residue
    residue_bytes = (os.path.getsize(result.path) - len(contigs.header)
                     - result.placeholders * len(card.PLACEHOLDER))
    return {"bgzf_inflate": len(data) + isize,
            "bam_frame": 12 * records,
            "bam_pairs": (36 + 16) * records,
            "bam_residue": 2 * residue_bytes + 20 * records
            + 17 * result.residue,
            "bam_coverage_finish": 6 * contigs.windows,
            "records": records, "members": len(members), "isize": isize,
            "residue_bytes": residue_bytes}


def check_bam_ingest() -> list:
    """K6 on the benchmark's sample through the CLI: each launch of the
    pass timed on its stream with CUDA events (the launch counts reset
    just before), the pass held against card.plain_pass on the same file
    and tables (taken, residue, mapped, chains, placeholders, the coverage
    planes and flags, the residue's bytes), the device memory it took,
    and the outputs against the engine alone (DEVICE=off). Returns a
    kernels record a K6 launch: launches, mean ms a launch, the plain
    pass's step over the whole file a launch, and the bound from k6_work's
    bytes."""
    import filecmp

    import numpy as np
    import torch

    from arriba_tpu_torch import kernels
    from arriba_tpu_torch.ingest import card

    t0 = time.perf_counter()
    bg, args = k6_sample()
    log(f"phase 9: the sample {bg.sample} ({bg.sample.stat().st_size:,} "
        f"bytes) in {time.perf_counter() - t0:.1f} s")
    originals = {name: getattr(kernels, f"launch_{name}")
                 for name in K6_LAUNCHES}
    events = {name: [] for name in K6_LAUNCHES}
    cuts = []

    def timed(name):
        def launch(*a):
            if name == "bam_residue" and a[3] > 0:  # a chunk's first record
                cuts.append(a[3])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            originals[name](*a)
            end.record()
            events[name].append((start, end))
        return launch

    held = {}

    def compared(path, contigs):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for name in K6_LAUNCHES:
            setattr(kernels, f"launch_{name}", timed(name))
        try:
            start = time.perf_counter()
            result = card.card_pass(path, contigs)
            torch.cuda.synchronize()
            held["card_s"] = time.perf_counter() - start
        finally:
            for name, launch in originals.items():
                setattr(kernels, f"launch_{name}", launch)
        held["memory"] = torch.cuda.max_memory_allocated() - before
        held["launches"] = {name: kernels.launch_counts[name]
                            for name in K6_LAUNCHES}
        held["ms"] = {name: sum(a.elapsed_time(b) for a, b in pairs)
                      for name, pairs in events.items()}
        times = {}
        start = time.perf_counter()
        plain = card.plain_pass(path, contigs, times, cuts)
        held["plain_s"] = time.perf_counter() - start
        try:
            same = {
                "counts": (plain.taken, plain.residue, plain.mapped,
                           plain.chains, plain.placeholders)
                == (result.taken, result.residue, result.mapped,
                    result.chains, result.placeholders),
                "coverage": np.array_equal(
                    np.minimum(plain.coverage, 0xFFFF),
                    result.coverage.cpu().numpy().view(np.uint16)),
                "starts": np.array_equal(plain.starts,
                                         result.starts.cpu().numpy()),
                "ends": np.array_equal(plain.ends, result.ends.cpu().numpy()),
                "residue": filecmp.cmp(plain.path, result.path,
                                       shallow=False)}
            start = time.perf_counter()
            np.minimum(plain.coverage, 0xFFFF)
            times["coverage_finish"] = time.perf_counter() - start
            held["work"] = k6_work(path, contigs, result)
        finally:
            plain.close()
        held["plain_times"] = times
        # the CLI holds stdout: logged after it
        held["line"] = (
            f"K6 against the plain pass: {same}; card {result.taken:,} "
            f"records taken, {result.residue:,} left in {len(cuts) + 1} "
            f"chunks, {result.mapped:,} mapped, {result.chains} chains, "
            f"{result.placeholders} placeholders; the pass "
            f"{held['card_s']:.3f} s, the plain pass {held['plain_s']:.1f} s")
        if not all(same.values()):
            raise SystemExit(held["line"])
        return result

    saved = card.backend
    card.backend = lambda: compared
    try:
        on_card = k6_cli(args, "card", "cuda")
    finally:
        card.backend = saved
    if "launches" not in held:
        raise SystemExit("the CLI never entered the card pass on a BGZF BAM")
    log(held["line"])
    alone = k6_cli(args, "off", "off")
    equal = [on_card[k] == alone[k] for k in (1, 2, 3)]
    log(f"K6 run: {on_card[0]:.3f} s on the card, {alone[0]:.3f} s with "
        f"DEVICE=off; fusions, discarded, counters equal: {equal} "
        f"({len(on_card[3])} counters); device memory of the pass "
        f"{held['memory']:,} bytes; work {held['work']}")
    if not all(equal) or not on_card[3]:
        raise SystemExit("the card pass changed the CLI's outputs")
    records = []
    plain_step = {"bgzf_inflate": "inflate", "bam_frame": "frame",
                  "bam_pairs": "pairs", "bam_residue": "residue",
                  "bam_coverage_finish": "coverage_finish"}
    for name in K6_LAUNCHES:
        n = held["launches"][name]
        if n <= 0:
            raise SystemExit(f"{name} never launched in the card pass")
        ms = held["ms"][name] / n
        bound_ms, bound_by = bound(held["work"][name] / n, 0)
        records.append({
            "name": name, "route": "CUDA C++, bam_ingest.cu (K6)",
            "launches": n, "ms": ms,
            "plain_ms": held["plain_times"][plain_step[name]] * 1e3 / n,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "cases": {"sample": K6_CELL, "seed": K6_SEED,
                      "records": held["work"]["records"],
                      "members": held["work"]["members"],
                      "device_memory_bytes": held["memory"],
                      "pass_s": held["card_s"],
                      "plain_pass_s": held["plain_s"]}})
    return records


def against_cases(kernel: str) -> dict:
    """The phase-2 inputs of a kernel for compare: {case: (arguments of its
    C entry point before the stream, setup run before each launch or None,
    a check that the output equals the plain version's, and None or this
    checkout's own (entry point, arguments) where they differ)}. K1: the
    main, low-complexity and mixed batches; K2: its phase-2 batch and its
    long-row kernel's (le_long_cases, through arriba_low_entropy_long
    where a build has it, and the long case's grid with every read of
    length 0); K3: its phase-2 batch; K4: its
    phase-2 cases (MXU_CASES); its any-k kernel: MXU_ANY_CASES at each k of
    MXU_ANY_K and the mixed rows at MXU_ANY_MIXED; K3w: SWW_CASES, the other
    build through its 32-bit entry point, this checkout through the width
    sw_route picks, as does any other build that has that entry point (the
    output set to -1 before each launch); K5: RESIDENT_CASES packed, the
    other builds through the one-pass entry point (KB_ONE_PASS) on tasks of
    KB_ONE_PASS_ROWS rows, this checkout through its wrapper (both passes,
    the scratch bitmap zeroed) on its own tasks and schedule (the output
    set to 2 before each launch)."""
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
                                                                  want), None)
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
                         lambda: torch.equal(out.view(torch.bool), want),
                         None)
        # the long-row kernel's cases, through its own entry point where a
        # build has one (an older build's arriba_low_entropy routes inside)
        for name, (n, L, homopolymers) in le_long_cases().items():
            packed, meta, _ = le_long_inputs(n, L, homopolymers=homopolymers)
            out_long = torch.empty(n, dtype=torch.uint8, device=cuda)
            want_long = readfilters._low_entropy_core_plain(
                readfilters._unpack_codes(packed, L), *meta.unbind(dim=1))
            args = (packed, meta, out_long, *packed.shape)
            cases[name] = (args, None,
                           lambda out=out_long, want=want_long: torch.equal(
                               out.view(torch.bool), want),
                           ("low_entropy_long", args))
        # the long case's grid with every read of length 0: what a read
        # costs before its positions (clearing, folding, the vote)
        packed, meta, _ = le_long_inputs(*LE_LONG_SHAPE)
        meta[:, 0] = 0
        out_empty = torch.empty(len(packed), dtype=torch.uint8, device=cuda)
        args = (packed, meta, out_empty, *packed.shape)
        cases["long_empty"] = (args, None,
                               lambda: not bool(out_empty.any()),
                               ("low_entropy_long", args))
    elif kernel == "smith_waterman":
        r, w = (torch.from_numpy(x).to(cuda) for x in smith_waterman_inputs())
        out = torch.empty(len(r), dtype=torch.int32, device=cuda)
        want = realign.smith_waterman_scores_plain(r, w)
        cases["main"] = ((r, w, out, *r.shape, w.shape[1], 1, -1, -1), None,
                         lambda: torch.equal(out, want), None)
    elif kernel == "mxu_kmer_screen":
        for name in MXU_CASES:
            r, w = (torch.from_numpy(x).to(cuda) for x in mxu_inputs(name))
            out = torch.empty(len(r), dtype=torch.uint8, device=cuda)
            want = realign.mxu_shared_kmer_mask_plain(r, w)
            cases[name] = ((r, w, out, *r.shape, w.shape[1]), None,
                           lambda out=out, want=want: torch.equal(
                               out.view(torch.bool), want), None)
    elif kernel == "mxu_kmer_screen_any_k":
        ks = {name: MXU_ANY_K for name in MXU_ANY_CASES}
        ks["mixed"] = MXU_ANY_MIXED
        for name, at in ks.items():
            for k in at:
                r, w = (torch.from_numpy(x).to(cuda)
                        for x in mxu_inputs(name, k=k))
                out = torch.empty(len(r), dtype=torch.uint8, device=cuda)
                want = realign.mxu_shared_kmer_mask_plain(r, w, k)
                cases[f"{name} k={k}"] = (
                    (r, w, out, *r.shape, w.shape[1], k), None,
                    lambda out=out, want=want: torch.equal(
                        out.view(torch.bool), want), None)
        # an empty launch of each k's grid: windows of k - 1 bytes hold no
        # k-mer, so every block writes its rows' zeros and ends
        for k in MXU_ANY_K:
            r, w = mxu_any_empty_inputs(k)
            out = torch.empty(len(r), dtype=torch.uint8, device=cuda)
            cases[f"empty k={k}"] = (
                (r, w, out, *r.shape, w.shape[1], k), None,
                lambda out=out: not bool(out.any()), None)
    elif kernel == "smith_waterman_wide":
        from arriba_tpu_torch import kernels

        for name, (n, L, W, params, _, _) in SWW_CASES.items():
            r, w = (torch.from_numpy(x).to(cuda) for x in sww_inputs(name))
            out = torch.empty(n, dtype=torch.int32, device=cuda)
            want = realign.smith_waterman_scores_plain(r, w, *params)
            route = kernels.sw_route(r, w, *params)
            shape = (n, L, W, *params)
            cases[name] = (
                (r, w, out, kernels.sw_wide_carry(r, w), *shape),
                lambda out=out: out.fill_(-1),
                lambda out=out, want=want: torch.equal(out, want),
                (route, (r, w, out, kernels.sw_wide_carry(r, w, route),
                         *shape)))
    elif kernel == "kmer_bitmap_screen":
        from arriba_tpu_torch import kernels

        for name in RESIDENT_CASES:
            res = resident_layouts(resident_case(name), cuda)["packed"]
            pairs = np.arange(len(res.pair_read))
            _, args, schedule = realign.screen_inputs(res, pairs)
            _, one_pass = realign.screen_tasks(res.pair_window[pairs],
                                               KB_ONE_PASS_ROWS)
            one_pass = torch.from_numpy(one_pass).to(cuda)
            reads, table, offsets, lengths, row_read, _ = args
            out = torch.empty(len(pairs), dtype=torch.uint8, device=cuda)
            want = realign.kmer_bitmap_screen_plain(*args)
            cases[name] = (
                (reads, table, offsets, lengths, row_read, one_pass, out,
                 len(pairs), len(one_pass), reads.shape[1], reads.shape[0],
                 offsets.shape[0], table.numel()),
                lambda out=out: out.fill_(2),
                lambda out=out, want=want: torch.equal(out.view(torch.bool),
                                                       want),
                (None, lambda args=args, out=out, schedule=schedule:
                 kernels.launch_kmer_bitmap_screen(*args, out, schedule)))
    else:
        raise SystemExit(f"--against takes accept_wavefront, low_entropy, "
                         f"smith_waterman, smith_waterman_wide, "
                         f"mxu_kmer_screen, mxu_kmer_screen_any_k or "
                         f"kmer_bitmap_screen, not {kernel}")
    return cases


# K5's one-pass C entry point (the kernel before its two passes), which
# --against kmer_bitmap_screen runs from an earlier build, and the rows of
# that kernel's tasks
KB_ONE_PASS = ("arriba_kmer_bitmap_screen", 7, 5)
KB_ONE_PASS_ROWS = 256


def compare(kernel: str, sources: list) -> None:
    """The kernel built from each source against this checkout's build, on
    its phase-2 inputs (against_cases). A source is a csrc directory whose
    <kernel>.cu has this checkout's C entry point (K5: the one-pass entry
    point, KB_ONE_PASS), such as an earlier commit's; where a case names
    this checkout's own entry point (K3w's 16-bit pairs, K2's long-row
    kernel), a source that has it runs it too.
    Every build must give the plain version's output. Each case times the
    launches (median of 20 windows of K2_K3_BATCH, or of single
    launches where the output is zeroed before each) in the order this
    checkout, the sources, the sources reversed, this checkout, and one
    JSON line gives the mean of each build's two times. K4's builds first
    go through the stress step each (mxu_stress; MXU_ANY_STRESS for its
    any-k kernel), which checks every verdict of every repeat."""
    import ctypes

    import torch

    from arriba_tpu_torch.kernels import build

    if kernel == "kmer_bitmap_screen":
        symbol, pointers, ints = KB_ONE_PASS
        argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                    + [ctypes.c_longlong, ctypes.c_void_p])
    else:
        symbol, argtypes = build._SIGNATURES[kernel]
    library = build._LIBRARIES.get(kernel, kernel)
    procs = []
    for k, source in enumerate(sources):
        target = REPO / "build" / "against" / kernel / str(k) / "lib.so"
        target.parent.mkdir(parents=True, exist_ok=True)
        procs.append((source, target, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(target),
             str(pathlib.Path(source) / f"{library}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for _, ptxas in build.build((library,)).values():
        for line in ptxas_lines(ptxas):
            log(f"built this checkout: {line}")
    entries = {"this checkout": build.load(kernel)[0]
               if kernel in build._SIGNATURES else None}
    libraries = {}
    for source, target, proc in procs:
        report = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {source}:\n{report[-4000:]}")
        for line in ptxas_lines(report):
            log(f"built {source}: {line}")
        libraries[source] = ctypes.CDLL(str(target))
        entry = getattr(libraries[source], symbol)
        entry.argtypes, entry.restype = argtypes, ctypes.c_int
        entries[source] = entry

    def own_entry(label, name):
        """The entry point `name` of a build, or None where it has none"""
        if label == "this checkout":
            return build.load(name)[0]
        entry = getattr(libraries[label], build._SIGNATURES[name][0], None)
        if entry is not None:
            entry.argtypes = build._SIGNATURES[name][1]
            entry.restype = ctypes.c_int
        return entry

    def launcher(label, args, entry=None):
        values = [x.data_ptr() if torch.is_tensor(x) else x for x in args]
        entry = entry or entries[label]

        def launch():
            code = entry(*values, torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise SystemExit(f"{kernel} from {label} failed to launch "
                                 f"({code})")
        return launch

    result = {}
    if kernel in ("mxu_kmer_screen", "mxu_kmer_screen_any_k"):
        any_k = kernel == "mxu_kmer_screen_any_k"

        def stress_launch(label):
            def launch(r, w, out, k):
                launcher(label, (r, w, out, *r.shape, w.shape[1])
                         + ((k,) if any_k else ()))()
            return launch

        result["stress_launches"] = {
            label: mxu_stress(stress_launch(label), label,
                              MXU_ANY_STRESS if any_k else MXU_STRESS)
            for label in entries}
    for name, (args, setup, check, own) in against_cases(kernel).items():
        times: dict = {label: [] for label in entries}
        for label in list(entries) + list(reversed(entries)):
            entry = (own_entry(label, own[0])
                     if own is not None and own[0] is not None else None)
            if own is not None and own[0] is None:
                # this checkout's launch through its wrapper
                launch = (own[1] if label == "this checkout"
                          else launcher(label, args))
            elif entry is not None:
                launch = launcher(label, own[1], entry)
            else:
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


# run A of one checkout, in its own process from its root (--run-a)
RUN_A = r"""
import json, pathlib, sys
sys.path.insert(0, ".")
import chip_smoke
from arriba_tpu_torch.kernels import build
build.build()
result = chip_smoke.main_path(pathlib.Path(sys.argv[1]), int(sys.argv[2]),
                              chip_smoke.runs(1)[:1])
seconds, chimeric, launches, ops = result["A"]
print("RUN_A " + json.dumps({"seconds": seconds, "chimeric": chimeric,
                             "launches": launches, "ops": ops}))
"""


def run_a_against(checkouts: list) -> None:
    """Run A (the main path) of each checkout directory in turn, on this
    checkout's genome-scale sample, each in its own process from the
    checkout's root with its own package and kernels (built before the
    run): its wall seconds, op seconds and calls, kernel launches and, where
    the checkout counts them, the bytes its resident tables copied. Every
    run's output files must be byte-equal. Give the parent and this
    checkout as parent, this, this, parent to see the spread."""
    import bench_samples

    sample = bench_samples.build_tier2(REPO / "build" / "chip_smoke" / "tier2",
                                       quiet=True)
    threads = min(8, os.cpu_count() or 1)
    outputs, runs_a = None, []
    for checkout in checkouts:
        env = {key: value for key, value in os.environ.items()
               if key != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-c", RUN_A, str(sample), str(threads)],
            cwd=checkout, env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-3000:])
        if proc.returncode != 0:
            raise SystemExit(f"run A of {checkout} exited {proc.returncode}:"
                             f"\n{proc.stdout[-3000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith(("run A", "  ")):
                log(f"{checkout}: {line}")
        result = json.loads(proc.stdout.split("RUN_A ")[1].splitlines()[0])
        files = tuple(sample.joinpath(f"fusions.A{suffix}.tsv").read_bytes()
                      for suffix in ("", ".discarded"))
        if outputs is not None and files != outputs:
            raise SystemExit(f"run A of {checkout} differs in its outputs")
        outputs = files
        runs_a.append({"checkout": checkout, **result})
    log("run A: every checkout's outputs byte-equal")
    print(json.dumps({"run_a": runs_a}))


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
    """ptxas's function, register, spill and performance-loss lines of an
    nvcc log"""
    return [line.strip() for line in report.splitlines()
            if any(word in line for word in ("Compiling entry", "registers",
                                             "spill", "Performance Loss"))]


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
    if sys.argv[1:2] == ["--k4-occupancy"]:
        mxu_occupancy()
        return 0
    if sys.argv[1:2] == ["--run-a"]:
        run_a_against(sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--k6"]:
        import arriba_tpu_torch  # noqa: F401  (builds the native engine)
        from arriba_tpu_torch.kernels import build

        build.build()
        t0 = time.perf_counter()
        records = check_bam_ingest()
        log(f"phase 9: {time.perf_counter() - t0:.1f} s")
        for record in records:
            log(f"{record['name']}: kernel {record['ms']:.4f} ms, plain "
                f"{record['plain_ms']:.4f} ms, bound "
                f"{record['bound_ms']:.4f} ms ({record['bound_by']}, "
                f"{record['bound_ms'] / record['ms']:.1%} of the kernel's "
                f"time), {record['launches']} launches in phase 9")
        print(json.dumps({"kernels": records}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
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
    kept: dict = {}
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    results = main_path(sample, threads, runs(n_cards)[:3], states, kept)
    reduced = main_path(tenth, threads, reduced_runs(n_cards))
    for label in ("D", "E"):
        _, _, run_launches, ops = reduced[label]
        if (run_launches["accept_wavefront_indexed"] <= 0
                or run_launches["kmer_bitmap_screen"] <= 0):
            raise SystemExit(f"run {label} never reached the 8-mer screen "
                             f"(K5) and K1")
    if "shared_kmer_mask" in results["A"][3]:
        raise SystemExit("run A called the sorted screen")
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    # run A's own launches of K5 and K1's indexed entry, against their plain
    # versions
    t0 = time.perf_counter()
    check_main_launches(kept, records)
    kept.clear()
    log(f"phase 3, run A's launches: {time.perf_counter() - t0:.1f} s")
    seconds_a, chimeric, launches, _ = results["A"]
    log(f"run A: {seconds_a:.3f} s wall, {chimeric / seconds_a:.1f} "
        f"chimeric reads/s")

    # phase 4
    t0 = time.perf_counter()
    check_entry()
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # phase 5: the data-parallel path is K3's main path, and at 600 bp
    # reads that of K3w's 16-bit pairs
    t0 = time.perf_counter()
    launches["smith_waterman"] = check_sharded(states[0], 4)
    del states[:]
    launches["smith_waterman_wide16"] = realign_600bp()["launches"][
        "smith_waterman_wide16"]
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # phase 6: the callers of K4 (at k = 8 and at other k), of K1's op and
    # of K3w's 32-bit lanes
    t0 = time.perf_counter()
    launches["mxu_kmer_screen"], sorted_ms = mxu_path()
    for k, count in mxu_any_k_path().items():
        launches[f"mxu_kmer_screen_any_k k={k}"] = count
    count = accept_path()
    for name in ("", " every_diagonal", " rows_70000"):
        launches[f"accept_wavefront{name}"] = count
    launches["smith_waterman_wide"] = sww_path()
    launches["low_entropy_long"] = low_entropy_long_path()
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

    # phase 9: K6 on the benchmark's sample
    t0 = time.perf_counter()
    for record in check_bam_ingest():
        launches[record["name"]] = record["launches"]
        records.append(record)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")

    where = {"accept_wavefront_indexed": "run A",
             "kmer_bitmap_screen": "run A", "low_entropy": "run A",
             "smith_waterman": "phase 5", "smith_waterman_wide16": "phase 5"}
    where.update({name: "phase 9" for name in K6_LAUNCHES})
    for record in records:
        record["launches"] = launches[record["name"]]
        if record["name"] == "mxu_kmer_screen":
            record["sorted_screen_ms"] = sorted_ms
        log(f"{record['name']}: kernel {record['ms']:.4f} ms, plain "
            f"{record['plain_ms']:.4f} ms, bound {record['bound_ms']:.4f} ms "
            f"({record['bound_by']}, {record['bound_ms'] / record['ms']:.1%} "
            f"of the kernel's time), {record['launches']} launches in "
            f"{where.get(record['name'], 'phase 6')}")
        if record["launches"] <= 0:
            raise SystemExit(f"{record['name']} never launched on the main "
                             f"path")

    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    # K1 adds its every-diagonal bound, K4 its full-product bound and phase
    # 6's time of the sorted screen, its any-k kernel an empty launch's
    # time, K3w its 32-bit lanes' time and their bound, K5 each pass's
    # time, all their phase-2 cases
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "build_ms", "test_ms",
            "walk_all_bound_ms", "full_product_bound_ms", "sorted_screen_ms",
            "empty_ms", "ms_32", "bound_32_ms", "cases")
    print(json.dumps({"kernels": [{key: record[key] for key in keys
                                   if key in record}
                                  for record in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
