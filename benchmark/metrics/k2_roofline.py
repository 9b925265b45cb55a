"""Kernels, K2 (the low-entropy scan's packed kernel): the least time the
card could take for the window's launches (work/k2.py: the larger of
operations over the integer rate and bytes over the memory rate), as a
share of the kernel's device time in the trace. Every sample makes the
same launches, so the first sample's inputs stand for each."""

from benchmark.work import k2

UNIT = "%"
KERNEL = "low_entropy_kernel"


def read(run):
    profile = run.profile
    captures = run.captures
    if profile is None or captures is None or not captures.k2_inputs:
        return None
    device_s = profile.kernel_seconds(KERNEL)
    if device_s <= 0:
        return None
    bound = sum(k2.bound(tuple(packed.shape), meta[:, 0].cpu().numpy())[0]
                for packed, _, meta in captures.k2_inputs
                if 4 * packed.shape[1] <= 3072)
    return 100.0 * bound * len(run.completed) / device_s
