"""Read cascade, K2's offload: a sample's seconds in the program's
`k2.offload` span, the whole of the hybrid stage 13 (the rows' export, the
code matrix and its packing, the thresholds, the copies to the card, the
launches, the wait for the flags, and applying them back; spans.py)."""

from benchmark import spans

UNIT = "s"


def read(run):
    return spans.mean(run, lambda root: spans.seconds(root, "k2.offload"))
