"""Kernels, K5 (the 8-mer bitmap screen, its build and test passes): the
least time the card could take for the window's launches (work/k5.py),
as a share of the two passes' device time in the trace. Every sample
makes the same launches, so the first sample's stand for each."""

from benchmark.work import k5

UNIT = "%"
KERNELS = ("kmer_bitmap_build_kernel", "kmer_bitmap_test_kernel")


def read(run):
    profile = run.profile
    captures = run.captures
    if profile is None or captures is None or not captures.k5_launches:
        return None
    device_s = sum(profile.kernel_seconds(name) for name in KERNELS)
    if device_s <= 0:
        return None
    bound = sum(k5.bound(args, schedule, k5.work(*args))[0]
                for args, schedule in captures.k5_launches)
    return 100.0 * bound * len(run.completed) / device_s
