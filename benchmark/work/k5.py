"""K5's work, the 8-mer bitmap screen, as a function of one launch's
inputs (reads, table, offsets, lengths, row_read, tasks) and its schedule.
Frozen from chip_smoke.py at commit 900208e: KB_SCAN_OPS and KB_TEST_OPS
(lines 1402-1409), read_codes (1732-1742), kb_work (1745-1801) and
kb_bound (1804-1817), with the program's helpers it called
(`realign._task_rows`, `_kmer_codes_bytes`, `_packed_kmers`) written out
here in plain torch.

The work sets each distinct window's bitmap once: a position of a window
a task names costs its base code (4), the rolling 8-mer (3), the bitmap
word and bit (3), setting the bit (1) and the loop (2). Each row then
tests its read's 8-mers in the kernel's order (the forward row's, then the
reverse complement's) up to and with its first hit, or all of them: a
test costs the code and PAD test (2), the rolling 8-mer (3), the bitmap
word and bit (3), the test (1) and the loop (2). Bytes: each used
window's bytes once, each used read's bytes as far as its rows' tests
reach, the rows' read ids, the tasks, the windows' spans, the schedule
and a verdict a row.
"""

from benchmark.work.peaks import bound_s

KB_OPS_PER_POSITION = 4 + 3 + 3 + 1 + 2     # 13
KB_OPS_PER_TEST = 2 + 3 + 3 + 1 + 2         # 11
K = 8
PAD_READ = 0      # the byte past a read in its row
PAD_CODE = 4


def kmer_codes(raw):
    """kmer_to_int's codes of raw bytes: T 0, G 1, C 2, any other 3."""
    import torch
    return torch.where(raw == ord("T"), 0, torch.where(
        raw == ord("G"), 1, torch.where(raw == ord("C"), 2, 3)))


def read_codes(raw):
    import torch
    return torch.where(raw == PAD_READ, PAD_CODE,
                       kmer_codes(raw.long())).to(torch.uint8)


def packed_kmers(codes, k: int = K):
    """[N, L] codes -> int64 [N, L] k-mer values, -1 where the k-mer runs
    past the row or covers PAD_CODE."""
    import torch
    L = codes.shape[1]
    values = torch.zeros(codes.shape, dtype=torch.int64, device=codes.device)
    pad = torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        shifted = torch.roll(codes, -j, dims=1)
        values = (values << 2) | shifted.clamp(max=3).long()
        pad |= shifted == PAD_CODE
    in_range = torch.arange(L, device=codes.device)[None, :] <= L - k
    return torch.where(in_range & ~pad, values, -1)


def task_rows(tasks, n: int):
    """int64 [n]: each row's window as tasks int32 [T, 3] = (window, first
    row, end row) name it, -1 for a row no task names."""
    import torch
    t = tasks.long()
    counts = (t[:, 2].clamp(max=n) - t[:, 1].clamp(min=0)).clamp(min=0)
    first = torch.repeat_interleave(t[:, 1].clamp(min=0), counts)
    step = torch.arange(int(counts.sum()), device=tasks.device) - \
        torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    out = torch.full((n,), -1, dtype=torch.int64, device=tasks.device)
    out[first + step] = torch.repeat_interleave(t[:, 0], counts)
    return out


def work(reads, table, offsets, lengths, row_read, tasks) -> dict:
    import torch

    n = row_read.shape[0]
    row_window = task_rows(tasks, n)
    used = torch.unique(row_window[row_window >= 0])
    n_pos = (lengths.long()[used] - 7).clamp(min=0)
    start = torch.repeat_interleave(offsets[used], n_pos) + (
        torch.arange(int(n_pos.sum()), device=reads.device)
        - torch.repeat_interleave(torch.cumsum(n_pos, 0) - n_pos, n_pos))
    code = kmer_codes(table.long())
    kmer = torch.zeros_like(start)
    for t in range(K):
        kmer = kmer * 4 + code[start + t]
    keys = torch.unique(torch.repeat_interleave(used, n_pos) * 65536 + kmer)
    L = reads.shape[1]
    n_tests = 2 * max(L - 7, 0)
    tests = 0
    extent = torch.zeros(reads.shape[0] // 2, dtype=torch.int64,
                         device=reads.device)
    for a in range(0, n, 4096):
        rows = torch.arange(a, min(a + 4096, n), device=reads.device)
        read = row_read[rows].long()
        codes = read_codes(torch.stack([reads[2 * read],
                                        reads[2 * read + 1]], 1))
        kmers = packed_kmers(codes.flatten(0, 1)).reshape(len(rows), -1)
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
    return {"positions": int(n_pos.sum()), "tests": tests,
            "windows": len(used),
            "window_bytes": int(lengths.long()[used].sum()),
            "read_bytes": int(extent.sum())}


def schedule_bytes(schedule) -> int:
    return sum(x.numel() * x.element_size() for x in (
        schedule.rank_window, schedule.task_rank, schedule.slices))


def bound(args, schedule, w: dict) -> tuple:
    """(seconds, "bytes" or "operations") of one launch."""
    _, _, offsets, _, row_read, tasks = args
    n = row_read.shape[0]
    n_bytes = (w["window_bytes"] + w["read_bytes"] + 4 * n
               + 12 * tasks.shape[0] + 12 * offsets.shape[0]
               + schedule_bytes(schedule) + n)
    return bound_s(n_bytes, w["positions"] * KB_OPS_PER_POSITION
                   + w["tests"] * KB_OPS_PER_TEST)
