"""The spans of the Python event stages on the device event path
(arriba_tpu_torch: `EventCascade` in filters/native_cascade.py, the
discarded table's write in pipeline.py), read by the per-layer metrics of
the device cell."""

from benchmark import spans


def mean_seconds(run, name: str) -> float | None:
    """A sample's mean seconds in the span name over the window; None
    where a sample lacks it (a program without the span) or no pair was
    screened (the native event cascade screens none, and runs the native
    twins of these stages)."""
    found = spans.roots(run)
    if not found or not any(root.counters.get("screen.pairs", 0)
                            for root in found):
        return None
    if not all(any(s.name == name for s in root.spans) for root in found):
        return None
    return sum(spans.seconds(root, name) for root in found) / len(found)
