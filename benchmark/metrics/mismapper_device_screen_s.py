"""Event cascade, the mismapper screen on the device event path: a
sample's seconds in the program's `screen.resident_pairs` (the resident
tables and their copy to the card), `screen.k5` and `screen.accept` (K1)
spans, each ending where the call already waits for its results, with no
synchronize added (spans.py). None where no pair was screened (the native
event cascade screens none)."""

from benchmark import spans

UNIT = "s"
CALLS = ("screen.resident_pairs", "screen.k5", "screen.accept")


def read(run):
    found = spans.roots(run)
    if not found or not any(root.counters.get("screen.pairs", 0)
                            for root in found):
        return None
    return sum(spans.seconds(root, *CALLS) for root in found) / len(found)
