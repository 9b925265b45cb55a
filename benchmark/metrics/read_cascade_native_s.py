"""Read cascade, the native engine's two bulk calls: a sample's seconds in
the program's `read_cascade.begin` (`cascade_begin_retained`: the
duplicate filter, stages 1-5, the mate gaps) and `read_cascade.finish`
(`cascade_finish`: stages 6-14 on the host) spans (spans.py)."""

from benchmark import spans

UNIT = "s"


def read(run):
    return spans.mean(run, lambda root: spans.seconds(
        root, "read_cascade.begin", "read_cascade.finish"))
