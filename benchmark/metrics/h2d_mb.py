"""Device: the megabytes (10^6 bytes) of host data the program hands to
the card a sample, its `h2d_bytes` counter (K2's packed codes and rows,
the mismapper screen's resident tables and rows, and the other offloaded
stages' inputs; spans.py)."""

from benchmark import spans

UNIT = "MB"


def read(run):
    return spans.mean(run, lambda root: root.counters.get("h2d_bytes", 0)
                      / 1e6)
