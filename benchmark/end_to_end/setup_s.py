"""Seconds from the process's start to the window's: imports, the native
and kernel builds where they are missing, the sample, reading its files
once and the warm-up (one whole sample of the window's)."""

UNIT = "s"


def read(run):
    return run.setup_s
