"""Event cascade, the mismapper screen on the device event path: the share
of screened (read, window) pairs that neither K5 rejects nor K1 accepts,
which the host recursion decides, from the program's `screen.undecided`
and `screen.pairs` counters over the window (spans.py). None where no
pair was screened (the native event cascade screens none)."""

from benchmark import spans

UNIT = "%"


def read(run):
    found = spans.roots(run)
    if not found:
        return None
    pairs = sum(root.counters.get("screen.pairs", 0) for root in found)
    if not pairs:
        return None
    undecided = sum(root.counters.get("screen.undecided", 0)
                    for root in found)
    return 100.0 * undecided / pairs
