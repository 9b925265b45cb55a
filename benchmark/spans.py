"""The program's own spans and counters (arriba_tpu_torch/trace.py) for
the per-layer metrics of a traced run. The program keeps the root span of
each call of `cli.main` in memory, on `time.perf_counter()`, the clock the
harness stamps each Sample on, so a sample's root span lies inside its
Sample interval. A program without the tracer gives no spans, and every
metric that reads them gives None."""


def roots(run) -> list | None:
    """The root span of each completed sample of the window, matched one
    to one by time; None where the program kept no spans for them."""
    try:
        from arriba_tpu_torch import trace
    except ImportError:
        return None
    window = [r for r in trace.finished() if r.end is not None
              and run.window_start <= r.start and r.end <= run.window_end]
    matched = []
    for sample in run.completed:
        inside = [r for r in window
                  if sample.start <= r.start and r.end <= sample.end]
        if len(inside) != 1:
            return None
        matched.append(inside[0])
    return matched or None


def seconds(root, *names: str) -> float:
    """The seconds of a root's finished spans with one of names."""
    return sum(s.end - s.start for s in root.spans
               if s.name in names and s.end is not None)


def mean(run, value) -> float | None:
    """The mean of value(root) over the window's completed samples."""
    found = roots(run)
    if not found:
        return None
    return sum(value(root) for root in found) / len(found)
