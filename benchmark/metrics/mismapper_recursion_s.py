"""Event cascade, the mismapper filter's host recursion on the device event
path: a sample's seconds in the program's `screen.host_recursion` span,
align() on the pairs the screen left undecided (spans.py). None where no
pair was screened (the native event cascade screens none)."""

from benchmark import spans

UNIT = "s"


def read(run):
    found = spans.roots(run)
    if not found or not any(root.counters.get("screen.pairs", 0)
                            for root in found):
        return None
    return sum(spans.seconds(root, "screen.host_recursion")
               for root in found) / len(found)
