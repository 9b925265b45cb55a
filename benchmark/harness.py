"""One run of one cell: set-up, a closed loop of whole samples through the
port's CLI for the measured window, the comparison with the reference, and
the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name: `workloads/<cell>.json` names the cell's
`configs/<config>.json` and `traffic/<mix>.json` (the parameters
samples.py's generator reads), `end_to_end/<metric>.py` and
`metrics/<metric>.py` (per-layer, read in a `--trace 1` run). A metric
module has `UNIT` and `read(run)`, which returns a number or None when the
run holds nothing for it to read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import pathlib
import re
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "benchmark"
COUNTER = re.compile(r"\((?:remaining|total|marked)=\d+\)")
TOTAL = re.compile(r"Reading chimeric alignments.*\(total=(\d+)\)")
STAGE = "[stage] "


# --------------------------------------------------------------------------
# the cell's files

def load_json(kind: str, name: str, base: pathlib.Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def metric_modules(kind: str, base: pathlib.Path = HERE) -> dict:
    """{name: module} of every `<kind>/<name>.py`, sorted by name."""
    out = {}
    for path in sorted((base / kind).glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{kind}.{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[path.stem] = module
    return out


# --------------------------------------------------------------------------
# what a run records

@dataclasses.dataclass
class Sample:
    start: float
    end: float = 0.0
    status: int = 0
    stages: list = dataclasses.field(default_factory=list)  # (t, message)
    counters: list = dataclasses.field(default_factory=list)
    total: int = 0


@dataclasses.dataclass
class Run:
    config: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    fragments: int = 0              # chimeric fragments a sample
    setup_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    samples: list = dataclasses.field(default_factory=list)
    rss_peak_bytes: int = 0
    captures: object = None         # hooks.Captures
    profile: object = None          # devtrace.Profile

    @property
    def completed(self) -> list:
        return [s for s in self.samples if s.end and s.status == 0]


class StageLog(io.TextIOBase):
    """A stderr that keeps each `[stage] ` line with the time it was
    written and passes nothing on."""

    def __init__(self, sink: list):
        self.sink = sink
        self.pending = ""

    def write(self, text: str) -> int:
        now = time.perf_counter()
        self.pending += text
        while "\n" in self.pending:
            line, self.pending = self.pending.split("\n", 1)
            if line.startswith(STAGE):
                self.sink.append((now, line[len(STAGE):].strip()))
        return len(text)


def stage_intervals(sample: Sample) -> list:
    """(message, seconds) of each stage line of a sample: the time from
    the line to the next, the last one's to the sample's end."""
    times = [t for t, _ in sample.stages] + [sample.end]
    return [(message, times[i + 1] - times[i])
            for i, (_, message) in enumerate(sample.stages)]


def stage_seconds(run: Run, prefixes) -> float | None:
    """Mean seconds a completed sample spends in the stages whose message
    starts with one of prefixes; None without stage lines."""
    samples = [s for s in run.completed if s.stages]
    if not samples:
        return None
    total = sum(seconds for s in samples for message, seconds in
                stage_intervals(s) if message.startswith(tuple(prefixes)))
    return total / len(samples)


# --------------------------------------------------------------------------
# memory

class RssPeak:
    """The process's peak resident set over a span, sampled from
    /proc/self/statm every INTERVAL seconds by a thread of its own (the
    kernel's high-water mark cannot be reset where /proc/self/clear_refs
    is not writable)."""

    INTERVAL = 0.01

    def __init__(self):
        import threading
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _read(self) -> int:
        with open("/proc/self/statm") as handle:
            return int(handle.read().split()[1]) * self._page

    def _watch(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self._read())
            self._stop.wait(self.INTERVAL)

    def start(self) -> None:
        self.peak = self._read()
        self._thread.start()

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._read())
        return self.peak


# --------------------------------------------------------------------------
# the set-up and the window

def parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a fault planted in the timed path, or the program's own path that
    # breaks a guarantee (the control); for the checks of the comparison,
    # never set in a measured run
    parser.add_argument("--fault", default="none")
    return parser.parse_args(argv)


def cli_args(config: dict, bg, out_dir: pathlib.Path) -> list:
    return (["-x", str(bg.sample)] + bg.cli_files() + list(config["cli_args"])
            + ["-@", str(config["threads"]),
               "-o", str(out_dir / "fusions.tsv"),
               "-O", str(out_dir / "fusions.discarded.tsv")])


def run_sample(cli, args: list, trace: bool) -> Sample:
    """One whole sample through `cli.main`, its stdout kept for the
    counters and, in a traced run, its stage lines with their times."""
    sample = Sample(start=time.perf_counter())
    stdout = io.StringIO()
    stderr = StageLog(sample.stages) if trace else io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        try:
            sample.status = cli.main(args)
        except SystemExit as exit_:
            sample.status = exit_.code if isinstance(exit_.code, int) else 1
    sample.end = time.perf_counter()
    text = stdout.getvalue()
    sample.counters = COUNTER.findall(text)
    total = TOTAL.search(text)
    sample.total = int(total.group(1)) if total else -1
    if sample.status != 0 and not trace:
        print(stderr.getvalue()[-3000:], file=sys.stderr)
    return sample


def log(message: str) -> None:
    print(f"[benchmark] {message}", file=sys.stderr, flush=True)


def main(argv, started: float) -> int:
    args = parse(argv)
    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    workload["traffic"] = load_json("traffic", workload["traffic"])

    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    return drive(args, workload, config, started, "cuda")


def drive(args, workload: dict, config: dict, started: float,
          device: str, runs: list = None) -> int:
    """Everything after the look for a chip: device is "cuda" on the card,
    "cpu" in the tests, where the port runs its plain versions. The Run is
    appended to runs where given."""
    from benchmark import devtrace, hooks, reference, samples

    run = Run(config, workload, args.seed, args.seconds, bool(args.trace))
    if runs is not None:
        runs.append(run)
    env = dict(config["env"])
    if device == "cpu":
        env["ARRIBA_TPU_TORCH_DEVICE"] = "cpu"
    if run.trace:
        env["ARRIBA_TPU_TORCH_STAGE_TIMES"] = "1"
    os.environ.update(env)
    os.environ.setdefault("USE_FLAX", "0")
    from arriba_tpu_torch import cli

    cache = BUILD / "cache"
    out_dir = BUILD / "out" / args.workload
    out_dir.mkdir(parents=True, exist_ok=True)
    threads = int(config["threads"])
    made = time.perf_counter()
    bg, planted, written = samples.make(config, workload["traffic"],
                                        args.seed, cache, threads)
    log(f"sample: {time.perf_counter() - made:.3f} s, {made - started:.3f} s "
        f"after the start")
    run.fragments = planted.fragments
    captures = hooks.Captures(args.seed, args.fault, timed=run.trace)
    for path in (bg.sample, bg.directory / "genome.fa",
                 bg.directory / "genes.gtf"):
        samples.warm_files(path)
    args_ = cli_args(config, bg, out_dir)
    if "control" in args.fault.split(","):
        args_ += ["-u"]   # duplicates taken as already marked: none removed
    # the warm-up: one whole sample of the window's, so that every library
    # loads, every kernel is built and launched at the window's shapes,
    # and the allocator and the page cache hold what a sample needs
    with hooks.installed(captures):
        warm = run_sample(cli, args_, False)
    if warm.status != 0:
        log(f"the warm-up sample exited {warm.status}")
        return 1
    log(f"warm-up: {warm.end - warm.start:.3f} s, launches "
        f"{hooks.launch_counts()}")

    # the window: whole samples back to back; the one in flight at the
    # deadline finishes and counts
    captures.reset()
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    profile = devtrace.Profile(device == "cuda") if run.trace else None
    rss = RssPeak()
    rss.start()
    if profile:
        profile.start()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - started
    first = None
    differing = []
    with hooks.installed(captures):
        while True:
            captures.begin_sample()
            sample = run_sample(cli, args_, run.trace)
            captures.end_sample(out_dir / "fusions.discarded.tsv")
            run.samples.append(sample)
            outputs = None
            if sample.status == 0:
                outputs = ((out_dir / "fusions.tsv").read_bytes(),
                           (out_dir / "fusions.discarded.tsv").read_bytes(),
                           sample.counters)
                first = first or outputs
            if len(run.samples) > 1:
                differing.append(outputs != first)
            gc.collect()
            if time.perf_counter() - run.window_start >= run.seconds:
                break
    run.window_end = run.samples[-1].end
    if profile:
        profile.stop(run)
    run.profile = profile
    run.rss_peak_bytes = rss.stop()
    memory_peak = 0
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_reserved()
    captures.finish()
    run.captures = captures
    completed = run.completed
    log(f"sample seconds: {[round(s.end - s.start, 3) for s in run.samples]}")
    log(f"window: {len(completed)} of {len(run.samples)} samples in "
        f"{run.window_end - run.window_start:.3f} s; {run.fragments} "
        f"chimeric fragments a sample, the port read total="
        f"{run.samples[0].total}; seeded blocks {written} bytes")

    # the comparison with the reference, after the window
    judged = time.perf_counter()
    details: list = []
    checks = reference.check_run(run, planted, bg, first, differing,
                                 details)
    log(f"reference: {time.perf_counter() - judged:.3f} s")
    flags = captures.k2[0] if captures.k2 else []
    log(f"k2 flagged {sum(int(f.sum()) for f in flags)} of "
        f"{sum(len(f) for f in flags)} reads in the first sample")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    modules = metric_modules("metrics" if run.trace else "end_to_end")
    metrics = {}
    for name, module in modules.items():
        value = module.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": module.UNIT}
    result = {"correct": correct, "attempted": len(run.samples),
              "failed": checks["samples_off"]["value"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": device_kind(device), "count":
                         int(run.workload["chips"]),
                         "memory_peak_bytes": memory_peak}}
    if profile:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["checks"] = checks

    from benchmark import blocker
    leaked = blocker.found()
    if leaked:
        log(f"blocked modules were imported: {leaked}")
        return 3
    for line in details[:20]:
        print(f"off: {line[:400]}", file=sys.stderr)
    for name, check in checks.items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def device_kind(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device
