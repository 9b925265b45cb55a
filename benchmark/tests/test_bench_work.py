"""The frozen copies of K2's and K5's counts give PR 13's numbers on PR
13's cases (chip_smoke.py at commit 900208e: K2's 131,072 x 150 batch,
bound 0.0125 ms by operations; K5's main case, 59,985 tests, bound
0.0050 ms by operations)."""

import numpy as np

from benchmark.work import k2, k5


def low_entropy_inputs(seed=3, n=131072, L=150):
    # chip_smoke.low_entropy_inputs at 900208e
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.002] = 4
    lengths = np.full(n, L, np.int32)
    short = rng.random(n) < 0.1
    lengths[short] = rng.integers(0, L, int(short.sum()))
    return codes, lengths


def test_bench_k2_count_gives_pr13s_bound():
    codes, lengths = low_entropy_inputs()
    seconds, by = k2.bound((len(codes), (codes.shape[1] + 3) // 4), lengths)
    assert by == "operations"
    assert round(seconds * 1e3, 4) == 0.0125


def resident_main(seed=53, contig_len=4_000_000, n_windows=128,
                  win_lo=20_000, win_hi=80_000, n_pairs=32_768,
                  read_len=150):
    # chip_smoke.resident_main at 900208e, without runs of N
    from arriba_tpu_torch.seq import COMPLEMENT_LUT

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    contig = alphabet[rng.choice(5, contig_len,
                                 p=[.24875, .24875, .24875, .24875, .005])]
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
    return contig, spans, reads


def test_bench_k5_count_gives_pr13s_tests():
    from arriba_tpu_torch.ops import realign

    contig, spans, reads = resident_main()
    resident = realign.resident_pairs(
        reads, [contig[a:a + n] for a, n in spans], "cpu")
    _, args, schedule = realign.screen_inputs(resident,
                                              np.arange(len(reads)))
    work = k5.work(*args)
    assert work["tests"] == 59_985
    seconds, by = k5.bound(args, schedule, work)
    assert by == "operations" and round(seconds * 1e3, 4) == 0.0050
