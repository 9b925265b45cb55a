"""The port's in-memory tracer (arriba_tpu_torch/trace.py): spans nest
inside their parents and share their call's id, nothing is recorded with
the switch off, the buffer keeps the last KEEP calls, a traced CLI run
records each bulk call of the ingest and the read cascade once,
`upload` counts the bytes it copies, and tracing changes no output."""

import collections
import contextlib
import io
import re

import numpy as np
import pytest

from arriba_tpu_torch import cli, pipeline, trace

from . import scenario

BULK_CALLS = ("ingest.scan", "read_cascade.begin", "read_cascade.finish",
              "k2.offload")
STAMP = re.compile(r"^\[\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\] ", re.M)
DONE = re.compile(r"Done \(.*\)")


@pytest.fixture
def buffer(monkeypatch):
    """An empty buffer of finished roots for the test."""
    fresh = collections.deque(maxlen=trace.KEEP)
    monkeypatch.setattr(trace, "_finished", fresh)
    return fresh


def test_spans_nest_and_children_lie_inside_parents(buffer):
    with trace.sample(True) as root:
        trace.stage("first")
        with trace.span("outer") as outer:
            with trace.span("inner") as inner:
                trace.count("things", 2)
            trace.count("things")
        trace.stage("second")
        with trace.span("later") as later:
            pass
    by_id = {s.id: s for s in root.spans}
    by_id[root.id] = root
    first, second = (s for s in root.spans if s.name == "stage")
    assert (first.label, second.label) == ("first", "second")
    assert first.parent == second.parent == root.id
    assert outer.parent == first.id and inner.parent == outer.id
    assert later.parent == second.id
    assert root.counters == {"things": 3}
    assert first.end == second.start
    for span in root.spans:
        parent = by_id[span.parent]
        assert parent.start <= span.start <= span.end <= parent.end, span.name
    assert trace.finished() == [root]


def test_one_sample_spans_share_its_id(buffer):
    roots = []
    for _ in range(2):
        with trace.sample(True) as root:
            trace.stage("a stage")
            with trace.span("work"):
                with trace.span("part"):
                    pass
        roots.append(root)
    assert roots[0].sample != roots[1].sample
    for root in roots:
        assert root.sample == root.id and len(root.spans) == 3
        assert {s.sample for s in root.spans} == {root.id}


def test_switch_off_records_nothing(buffer, monkeypatch, tmp_path):
    with trace.sample(False) as root:
        assert root is None
        assert trace.span("work") is trace.span("other")
        with trace.span("work") as span:
            assert span is None
        trace.count("things")
    assert trace.finished() == []
    # the CLI with the stage log off opens no root either
    monkeypatch.setattr(pipeline, "_STAGE_TIMES", False)
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    args = scenario.translocation_sample(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args + ["-o", str(tmp_path / "fusions.tsv")]) == 0
    assert trace.finished() == [] and len(buffer) == 0


@pytest.mark.parametrize("on", [False, True])
def test_upload_counts_the_bytes_it_copies(buffer, on):
    arrays = [np.arange(10, dtype=np.int64), np.ones((3, 5), np.uint8)]
    with trace.sample(on) as root:
        assert trace.active() is on
        copies = [trace.upload(a, "cpu") for a in arrays]
    for a, t in zip(arrays, copies):
        assert t.device.type == "cpu" and np.array_equal(t.numpy(), a)
    if on:
        assert root.counters == {"h2d_bytes": 80 + 15}
    else:
        assert root is None and trace.finished() == []
    assert not trace.active()


def test_buffer_keeps_the_last_calls(buffer):
    roots = []
    for _ in range(trace.KEEP + 6):
        with trace.sample(True) as root:
            pass
        roots.append(root)
    assert trace.KEEP == 64
    assert trace.finished() == roots[-trace.KEEP:]


def _run(tmp_path, monkeypatch, traced: bool, runs: int = 1):
    """runs in-process calls of the CLI on the translocation sample with
    the offloaded stages on the CPU: (fusions.tsv, fusions.discarded.tsv,
    stdout without its time stamps and resource figures, stderr) of the
    last."""
    monkeypatch.setattr(pipeline, "_STAGE_TIMES", traced)
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    args = scenario.translocation_sample(tmp_path)
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    args += ["-o", str(out / "fusions.tsv"), "-O",
             str(out / "fusions.discarded.tsv")]
    for _ in range(runs):
        stdout, stderr = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            assert cli.main(args) == 0
    text = DONE.sub("Done", STAMP.sub("", stdout.getvalue()))
    return ((out / "fusions.tsv").read_bytes(),
            (out / "fusions.discarded.tsv").read_bytes(), text,
            stderr.getvalue())


def test_traced_cli_records_each_bulk_call_once_a_sample(
        buffer, monkeypatch, tmp_path):
    *_, stderr = _run(tmp_path, monkeypatch, True, runs=2)
    roots = trace.finished()
    assert len(roots) == 2
    for root in roots:
        names = [s.name for s in root.spans]
        for name in BULK_CALLS:
            assert names.count(name) == 1, (name, names)
        assert root.counters["h2d_bytes"] > 0
        stages = {s.id: s.label for s in root.spans if s.name == "stage"}
        parent = {s.name: stages.get(s.parent) for s in root.spans}
        # the native begin runs under the read cascade's first line
        assert parent["read_cascade.begin"].startswith("Filtering duplicates")
        assert parent["ingest.scan"].startswith("Reading chimeric alignments")
        assert parent["k2.offload"].startswith("Estimating fragment length")
    # the stage log is written from the stage spans: each line's message is
    # a span's label, each delta the closed span's seconds
    last = roots[-1]
    labels = [s.label for s in last.spans if s.name == "stage"]
    lines = [line[len("[stage] "):] for line in stderr.splitlines()
             if line.startswith("[stage] ")]
    assert lines == labels
    deltas = [line for line in stderr.splitlines()
              if line.startswith("[stage +")]
    closed = [s for s in last.spans if s.name == "stage"][:-1]
    assert deltas[1:] == [f"[stage +{s.end - s.start:7.3f}s]"
                          for s in closed]


@pytest.mark.parametrize("events", ["native", "device"])
def test_outputs_equal_with_tracing_on_and_off(buffer, monkeypatch,
                                               tmp_path, events):
    if events == "device":
        monkeypatch.setenv("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", "1")
    plain = _run(tmp_path, monkeypatch, False)
    traced = _run(tmp_path, monkeypatch, True)
    assert plain[:3] == traced[:3]
    assert plain[0].count(b"\n") > 1
    assert "[stage]" not in plain[3] and "[stage]" in traced[3]


def test_traced_device_event_path_counts_the_screen(buffer, monkeypatch,
                                                    tmp_path):
    """On the Python event stages the mismapper screen's three calls, the
    host recursion and the screen's verdict counters are recorded once a
    sample; every pair the screen left UNDECIDED is among those it
    screened."""
    monkeypatch.setattr(pipeline, "_STAGE_TIMES", True)
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", "1")
    args = scenario.spliced_homolog_sample(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(args + ["-o", str(tmp_path / "fusions.tsv")]) == 0
    (root,) = trace.finished()
    names = [s.name for s in root.spans]
    for name in ("screen.resident_pairs", "screen.k5", "screen.accept",
                 "screen.host_recursion"):
        assert names.count(name) == 1, (name, names)
    assert 0 < root.counters["screen.undecided"] <= root.counters[
        "screen.pairs"]
    assert root.counters["h2d_bytes"] > 0
