"""The device trace of a `--trace 1` run: `torch.profiler` over the whole
window, CUDA activity only (kernels, copies and sets on the card), read
from its Chrome trace.

The trace's clock is tied to the host's by two marker kernels
(`torch.cuda._sleep`) launched right after the host reads its clock, one
at each end of the window, so that an idle gap can be named by the stage
the host was in.
"""

from __future__ import annotations

import json
import time

from benchmark.harness import BUILD, stage_intervals

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
MARKER_CYCLES = 20000


def _union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 100
    characters."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.strip()[:100] or "?"


class Profile:
    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.ops: list = []         # (name, start s, end s), trace clock
        self.marks: list = []       # host clock at each marker's launch
        self.busy_s = 0.0
        self.window_s = 0.0
        self.offset = None          # host clock - trace clock
        self.gaps: list = []        # (host stage, seconds)
        self._profiler = None

    def _mark(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def start(self) -> None:
        if not self.on_card:
            return
        import torch
        self._profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._profiler.__enter__()
        self._mark()

    def stop(self, run) -> None:
        self.window_s = run.window_end - run.window_start
        if not self.on_card:
            return
        self._mark()
        self._profiler.__exit__(None, None, None)
        path = BUILD / "trace.json"
        self._profiler.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        path.unlink()
        markers = []
        for event in events:
            if event.get("ph") != "X" or event.get("cat") not in \
                    DEVICE_CATEGORIES:
                continue
            start = float(event["ts"]) * 1e-6
            end = start + float(event.get("dur", 0)) * 1e-6
            if MARKER in event.get("name", ""):
                markers.append(start)
                continue
            self.ops.append((event.get("name", "?"), start, end))
        if len(markers) == 2:
            self.offset = self.marks[0] - markers[0]
        merged = _union([(s, e) for _, s, e in self.ops])
        self.busy_s = sum(e - s for s, e in merged)
        self._gaps(run, merged, markers)

    def _gaps(self, run, merged, markers) -> None:
        """The idle gaps inside the window, each named by the stage the
        host was in at its middle."""
        if self.offset is None:
            return
        lo = run.window_start - self.offset
        hi = run.window_end - self.offset
        edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
        stages = []
        for k, sample in enumerate(run.samples):
            times = [t for t, _ in sample.stages]
            for (message, _), t in zip(stage_intervals(sample), times):
                stages.append((t, f"sample {k}: {message[:80]}"))
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            middle = (a + b) / 2 + self.offset
            name = "between samples"
            for t, label in stages:
                if t <= middle:
                    name = label
                else:
                    break
            self.gaps.append((name, b - a))

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds fragment."""
        return sum(e - s for name, s, e in self.ops if fragment in name)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, s, e in self.ops:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
