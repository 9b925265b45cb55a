"""What the harness takes from the program while it runs: the inputs and
answers of the layers the comparison judges (K2's low-entropy flags, the
mismapper screen's K5 and K1 verdicts), each K5 launch's arguments for its
roofline, and, in a traced run, the host seconds of the screen's three
calls. Each wrapper calls the program's own function and keeps
references; what the reference needs of them is unpacked and copied once
the window has closed (`Captures.finish`).

A `--fault` other than "none" alters an answer where the wrapper receives
it, so that a test can see the comparison fail.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

# how many accept rows of the first sample the reference re-checks, drawn
# from the seed
ACCEPT_SAMPLE = 256
# the faults a test can plant (harness --fault, comma-separated)
FAULTS = ("none", "control", "k2_flip", "k2_half", "screen_flip",
          "screen_half", "accept_flip", "table_altered", "table_half",
          "later_altered", "event_discard")


class Captures:
    def __init__(self, seed: int, fault: str = "none", timed: bool = False):
        self.faults = set(fault.split(",")) - {"none"}
        if self.faults - set(FAULTS):
            raise SystemExit(f"unknown fault {fault!r}; of {FAULTS}")
        self.seed = seed
        self.timed = timed
        self.reset()

    def reset(self) -> None:
        self.sample = -1
        self.k2: list = []          # a sample: each launch's flags
        self.k2_inputs: list = []   # first sample: (packed, L, meta)
        self.screen: list = []      # a sample: each call's verdicts
        self.screen_inputs: list = []  # first sample: each call's pairs
        self.accept: list = []      # a sample: each call's verdicts
        self.accept_inputs: list = []  # first sample: sampled rows a call
        self.k5_launches: list = []    # first sample: (args, schedule)
        self.op_seconds: dict = {}     # traced: call name -> seconds
        self.open: dict = {}           # id(resident) -> its inputs
        self.held: list = []           # first sample: screen calls to unpack
        self.moved: list = []          # event_discard: rows to move

    def begin_sample(self) -> None:
        self.sample += 1
        for log in (self.k2, self.screen, self.accept):
            log.append([])

    def _time(self, name: str, fn, *args, **kwargs):
        if not self.timed or self.sample < 0:
            return fn(*args, **kwargs)
        import torch
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.op_seconds[name] = (self.op_seconds.get(name, 0.0)
                                 + time.perf_counter() - start)
        return result

    # K2 -----------------------------------------------------------------
    def low_entropy(self, inner, packed, L, meta):
        flags = inner(packed, L, meta)
        if "k2_flip" in self.faults:
            flags = flags.clone()
            flags[0] = ~flags[0]
        if "k2_half" in self.faults:
            flags = flags.clone()
            flags[len(flags) // 2:] = False
        if self.sample >= 0:
            self.k2[self.sample].append(flags)
            if self.sample == 0:
                self.k2_inputs.append((packed, L, meta))
        return flags

    # the mismapper screen --------------------------------------------------
    def resident_pairs(self, inner, read_seqs, window_views, *args, **kwargs):
        resident = self._time("resident_pairs", inner, read_seqs,
                              window_views, *args, **kwargs)
        if self.sample == 0:
            self.open[id(resident)] = (read_seqs, window_views)
        return resident

    @staticmethod
    def _windows(inputs, pairs):
        """(read strings, window index a pair, distinct window bytes) of
        pairs of a resident_pairs call's inputs, copied."""
        read_seqs, views = inputs
        index: dict = {}
        windows = []
        window_of = np.empty(len(pairs), np.int64)
        for k, p in enumerate(pairs):
            view = np.asarray(views[p])
            key = (view.__array_interface__["data"][0], len(view))
            if key not in index:
                index[key] = len(windows)
                windows.append(view.tobytes())
            window_of[k] = index[key]
        return [read_seqs[p] for p in pairs], window_of, windows

    def screen_resident(self, inner, resident, *args, **kwargs):
        verdict = self._time("screen_resident", inner, resident, *args,
                             **kwargs)
        if "screen_flip" in self.faults and len(verdict):
            verdict = verdict.copy()
            verdict[0] = ~verdict[0]
        if "screen_half" in self.faults:
            verdict = verdict.copy()
            verdict[len(verdict) // 2:] = False
        if self.sample >= 0:
            self.screen[self.sample].append(np.array(verdict))
            if self.sample == 0 and id(resident) in self.open:
                self.held.append(("screen", self.open[id(resident)],
                                  np.arange(len(resident.pair_read)), None))
        return verdict

    def accept_resident(self, inner, resident, pairs, min_scores,
                        window_chunk=8192, *args, **kwargs):
        verdict = self._time("accept_resident", inner, resident, pairs,
                             min_scores, window_chunk, *args, **kwargs)
        pairs = np.asarray(pairs, np.int64)
        if "accept_flip" in self.faults and len(verdict):
            verdict = verdict.copy()
            verdict[::97] = ~verdict[::97]
        if self.sample >= 0:
            self.accept[self.sample].append(np.array(verdict))
            if self.sample == 0 and id(resident) in self.open:
                self.held.append(("accept", self.open[id(resident)], pairs,
                                  (min_scores, int(window_chunk))))
        return verdict

    def screen_launches(self, inner, *args, **kwargs):
        for pairs, launch_args, schedule in inner(*args, **kwargs):
            if self.sample == 0 and self.timed:
                self.k5_launches.append((launch_args, schedule))
            yield pairs, launch_args, schedule

    def end_sample(self, discarded_file=None) -> None:
        self.open = {}
        if self.moved and discarded_file is not None:
            with open(discarded_file, "a") as handle:
                handle.write("".join(row + "\n" for row in self.moved))
        self.moved = []

    def finish(self) -> None:
        """Unpack the first sample's screen calls for the reference, once
        the window has closed: every pair of each K5 call, and of each K1
        call every 97th row (which the fault alters, up to 8) and a draw
        from the seed."""
        for kind, inputs, pairs, extra in self.held:
            if kind == "screen":
                reads, window_of, windows = self._windows(inputs, pairs)
                self.screen_inputs.append({"reads": reads, "window_of":
                                           window_of, "windows": windows})
                continue
            min_scores, window_chunk = extra
            read_seqs = inputs[0]
            longest = max(len(read_seqs[p]) for p in pairs)
            rng = np.random.default_rng(
                [self.seed % (1 << 63), len(self.accept_inputs)])
            rows = np.unique(np.concatenate([
                np.arange(0, len(pairs), 97)[:8],
                rng.choice(len(pairs), min(ACCEPT_SAMPLE, len(pairs)),
                           replace=False)]))
            reads, window_of, windows = self._windows(inputs, pairs[rows])
            self.accept_inputs.append({
                "rows": rows, "reads": reads, "window_of": window_of,
                "windows": windows,
                "min_scores": np.asarray(min_scores, np.int64)[rows],
                "window_chunk": window_chunk, "longest": longest})
        self.held = []


@contextlib.contextmanager
def installed(captures: Captures):
    """Route the program's calls through captures while inside; the
    program's own functions are back afterwards."""
    from arriba_tpu_torch.ops import readfilters, realign

    patches = [(readfilters, "_low_entropy_core_packed", captures.low_entropy),
               (realign, "resident_pairs", captures.resident_pairs),
               (realign, "screen_resident", captures.screen_resident),
               (realign, "accept_resident", captures.accept_resident),
               (realign, "screen_launches", captures.screen_launches)]
    saved = []
    for module, name, wrapper in patches:
        inner = getattr(module, name)
        saved.append((module, name, inner))
        setattr(module, name,
                lambda *a, _w=wrapper, _i=inner, **k: _w(_i, *a, **k))
    table_patch = None
    if captures.faults & {"table_altered", "table_half", "later_altered",
                          "event_discard"}:
        table_patch = _alter_tables(captures)
    try:
        yield captures
    finally:
        for module, name, inner in saved:
            setattr(module, name, inner)
        if table_patch:
            table_patch()


def _alter_tables(captures: Captures):
    """Plant a fault where the writer writes fusions.tsv: "table_altered"
    adds one to the first fusion's split_reads2, "later_altered" does so
    from the window's second sample on, "table_half" leaves out the second
    half of the fusions, "event_discard" moves the first fusion to the
    discarded table under an event-level filter (in_vitro), as a filter
    that discarded it would."""
    from arriba_tpu_torch import pipeline

    inner = pipeline.write_fusions_to_file

    def altered(fusions, output_file, *args, **kwargs):
        result = inner(fusions, output_file, *args, **kwargs)
        faults = captures.faults
        alter = "table_altered" in faults or (
            "later_altered" in faults and captures.sample >= 1)
        if not str(output_file).endswith("discarded.tsv"):
            with open(output_file) as handle:
                lines = handle.read().split("\n")
            if "table_half" in faults:
                rows = [line for line in lines[1:] if line]
                lines = lines[:1] + rows[:len(rows) // 2] + [""]
            if "event_discard" in faults and len(lines) > 2:
                rows = [line.split("\t") for line in lines[1:] if line]
                best = max(rows, key=lambda f: sum(map(int, f[9:12])))
                lines.remove("\t".join(best))
                best[26] = "in_vitro"
                captures.moved.append("\t".join(best))
            if alter and len(lines) > 2:
                fields = lines[1].split("\t")
                fields[10] = str(int(fields[10]) + 1)
                lines[1] = "\t".join(fields)
            with open(output_file, "w") as handle:
                handle.write("\n".join(lines))
        return result

    pipeline.write_fusions_to_file = altered

    def restore():
        pipeline.write_fusions_to_file = inner
    return restore


def launch_counts() -> dict:
    from arriba_tpu_torch import kernels
    return {k: v for k, v in kernels.launch_counts.items() if v}
