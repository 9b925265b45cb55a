"""K2's work, the low-entropy scan, as a function of one launch's inputs:
packed uint8 [N, B] (four 2-bit codes a byte) and meta int32 [N, 8] =
(length, a1s, a1e, a2s, a2e, th_all, th_a1, th_a2). Frozen from
chip_smoke.py at commit 900208e: LE_OPS (lines 206-210), LE_WORD_OPS
(214-215), LE_OPS_PER_POSITION and LE_OPS_PER_READ (265-266), and the
bound of its packed kernel (2527-2532).

Every eligible position of every read (p + 3 < length) counts: the 3-mer
from the byte pair (2), the byte pair and loop shared by four positions
(1), the selection's two equality tests and their combine (3), the
counter's address (1) and its add (1). Each read clears and reads back
its 64 counter words (0.5 a word), takes two fields (3) and makes four
threshold tests (4). Bytes: the packed codes and meta read once, a flag
written a read.
"""

from benchmark.work.peaks import bound_s

LE_OPS_PER_POSITION = 2 + 1 + 3 + 1 + 1          # 8
LE_OPS_PER_READ = 64 * (0.5 + 3 + 4)              # 480


def work(packed_shape, lengths) -> dict:
    """lengths: the reads' lengths (meta's first column), a sequence of
    ints or a numpy array."""
    import numpy as np

    rows, row_bytes = packed_shape
    lengths = np.asarray(lengths, np.int64)
    positions = int(np.maximum(lengths - 3, 0).sum())
    return {"positions": positions, "reads": int(rows),
            "ops": positions * LE_OPS_PER_POSITION + rows * LE_OPS_PER_READ,
            "bytes": rows * row_bytes + rows * 8 * 4 + rows}


def bound(packed_shape, lengths) -> tuple:
    w = work(packed_shape, lengths)
    return bound_s(w["bytes"], w["ops"])
