"""The process's peak resident set over the window, in GiB, sampled every
10 ms (harness.RssPeak)."""

UNIT = "GiB"


def read(run):
    return run.rss_peak_bytes / 2 ** 30 if run.rss_peak_bytes else None
