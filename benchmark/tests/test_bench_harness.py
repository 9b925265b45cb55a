"""The harness: files found by name, the import blocker, the rate's
arithmetic and the stage log's layers."""

import importlib
import json
import shutil
import sys

import pytest

from benchmark import blocker, harness
from benchmark.tests import tiny

LAYERS = ("load_s", "ingest_s", "read_cascade_s", "event_cascade_s",
          "writer_s")


def test_bench_new_files_are_found_without_edits(tmp_path):
    base = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    config = json.loads((base / "configs/genome150-native.json").read_text())
    config["name"] = "genome150-native-x"
    (base / "configs/genome150-native-x.json").write_text(json.dumps(config))
    (base / "traffic/short.json").write_text(json.dumps(
        dict(json.loads((base / "traffic/tenth.json").read_text()),
             artifact_split_fragments=1000)))
    (base / "workloads/genome150-native-x.short.json").write_text(json.dumps(
        {"config": "genome150-native-x", "chips": 1, "traffic": "short"}))
    (base / "metrics/samples_seen.py").write_text(
        'UNIT = "samples"\n\n\ndef read(run):\n'
        '    return len(run.completed) or None\n')
    workload = harness.load_json("workloads", "genome150-native-x.short",
                                 base)
    assert harness.load_json("configs", workload["config"], base)[
        "name"] == "genome150-native-x"
    assert harness.load_json("traffic", workload["traffic"], base)[
        "artifact_split_fragments"] == 1000
    modules = harness.metric_modules("metrics", base)
    assert "samples_seen" in modules and set(LAYERS) <= set(modules)
    run = harness.Run({}, {}, 1, 1.0, True)
    assert modules["samples_seen"].read(run) is None


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib",
                                  "arriba_tpu", "arriba_tpu.ops", "flax"])
def test_bench_blocker_refuses(name):
    blocker.install()
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == name.split(".")[0]}
    try:
        with pytest.raises(ImportError):
            importlib.import_module(name)
    finally:
        sys.modules.update(saved)


def test_bench_blocker_lets_the_port_in():
    blocker.install()
    assert importlib.import_module("arriba_tpu_torch.cli")
    assert not blocker.blocked("arriba_tpu_torch")
    assert blocker.blocked("arriba_tpu.ops") and blocker.blocked("jaxlib")
    assert "arriba_tpu_torch" not in blocker.found()


def test_bench_rate_counts_whole_samples_only():
    rate = harness.metric_modules("end_to_end")["chimeric_fragments_per_s"]
    run = harness.Run({}, {}, 1, 10.0, False, fragments=1000)
    run.window_start = 100.0
    run.samples = [harness.Sample(100.0, 104.0), harness.Sample(104.0, 108.0),
                   harness.Sample(108.0, 112.0, status=1)]
    run.window_end = 112.0
    assert rate.read(run) == pytest.approx(2 * 1000 / 12.0)
    run.samples = [harness.Sample(100.0, 0.0)]
    assert rate.read(run) is None


def test_bench_stage_lines_map_to_one_layer_each(monkeypatch):
    # the pipeline reads ARRIBA_TPU_TORCH_STAGE_TIMES when it is imported,
    # which another test of this process may have done already
    from arriba_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "_STAGE_TIMES", True)
    status, result, run = tiny.drive("genome150-native", trace=1)
    assert status == 0 and result["correct"]
    modules = harness.metric_modules("metrics")
    prefixes = {name: modules[name].PREFIXES for name in LAYERS}
    lines = [message for s in run.samples for _, message in s.stages]
    assert lines
    for message in lines:
        owners = [n for n, p in prefixes.items() if message.startswith(p)]
        assert len(owners) == 1, (message, owners)
    for name in LAYERS:
        assert name in result["metrics"]
