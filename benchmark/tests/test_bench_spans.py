"""The metrics that read the program's own spans and counters (spans.py):
present in a traced run, on the harness's clock, consistent with the stage
log's layers, and silent for a program without the tracer."""

import os
import sys

import pytest

from benchmark import harness, spans
from benchmark.tests import tiny

NEW = ("ingest_scan_s", "read_cascade_native_s", "k2_offload_s", "h2d_mb")
SCREEN = ("mismapper_undecided_share", "mismapper_recursion_s",
          "mismapper_device_screen_s")
DEVICE = "genome150-device-events"


def _traced(name: str, seed: int):
    # the pipeline reads ARRIBA_TPU_TORCH_STAGE_TIMES when it is imported,
    # which another test of this process may have done already; and a run
    # of another configuration leaves its environment in os.environ
    from arriba_tpu_torch import pipeline
    saved = pipeline._STAGE_TIMES, dict(os.environ)
    for key in harness.load_json("configs", DEVICE)["env"]:
        os.environ.pop(key, None)
    pipeline._STAGE_TIMES = True
    try:
        yield tiny.drive(name, seed=seed, trace=1)
    finally:
        pipeline._STAGE_TIMES = saved[0]
        os.environ.clear()
        os.environ.update(saved[1])


@pytest.fixture(scope="module")
def traced():
    yield from _traced("genome150-native", 2400000001)


@pytest.fixture(scope="module")
def traced_device():
    yield from _traced(DEVICE, 2400000002)


def test_bench_span_metrics_are_reported(traced):
    status, result, run = traced
    assert status == 0 and result["correct"]
    for name in NEW:
        assert name in result["metrics"], name
        assert result["metrics"][name]["value"] > 0, name
    # the native event cascade screens no pair
    for name in SCREEN:
        assert name not in result["metrics"], name


def test_bench_root_spans_lie_inside_their_samples(traced):
    _, _, run = traced
    roots = spans.roots(run)
    assert roots and len(roots) == len(run.completed)
    for sample, root in zip(run.completed, roots):
        assert sample.start <= root.start <= root.end <= sample.end
        # the stage lines the harness stamped fall inside the root too
        assert all(root.start <= t <= root.end for t, _ in sample.stages)


def test_bench_span_metrics_fit_inside_their_layers(traced):
    _, result, _ = traced
    value = {name: m["value"] for name, m in result["metrics"].items()}
    assert value["ingest_scan_s"] <= value["ingest_s"]
    assert (value["read_cascade_native_s"] + value["k2_offload_s"]
            <= value["read_cascade_s"])


def test_bench_h2d_counter_is_the_bytes_k2_hands_to_the_device(traced):
    _, _, run = traced
    first = spans.roots(run)[0]
    handed = sum(packed.nbytes + meta.nbytes
                 for packed, _, meta in run.captures.k2_inputs)
    assert handed > 0
    assert first.counters["h2d_bytes"] == handed


def test_bench_span_metrics_are_silent_without_the_tracer(traced,
                                                          monkeypatch):
    _, _, run = traced
    import arriba_tpu_torch
    monkeypatch.delattr(arriba_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "arriba_tpu_torch.trace", None)
    modules = harness.metric_modules("metrics")
    for name in NEW + SCREEN:
        assert modules[name].read(run) is None, name


def test_bench_screen_metrics_read_the_device_event_path(traced_device):
    status, result, _ = traced_device
    assert status == 0 and result["correct"]
    value = {name: m["value"] for name, m in result["metrics"].items()}
    for name in SCREEN:
        assert name in value, name
    assert 0 <= value["mismapper_undecided_share"] <= 100
    # the program's spans lie inside the harness's own timing of the same
    # three calls, which adds a synchronize to each
    assert 0 < value["mismapper_device_screen_s"] <= value[
        "mismapper_screen_s"]
    assert (value["mismapper_device_screen_s"]
            + value["mismapper_recursion_s"] <= value["event_cascade_s"])
