"""The port's CLI under every ARRIBA_TPU_TORCH_SHARDED_STATS layout, the
twin of tests/test_sharded_pipeline_e2e.py and test_sharded_stats.py: the
mid-cascade statistics (the e-value model's partner counts and breakpoint
priors, the in-vitro expression quantile) computed unsharded, over 1 and 8
row shards in one process, and across 2 gloo ranks of
parallel/multihost.py, on both engines, with the offloaded stages on the
CPU. Every layout's fusions.tsv, fusions.discarded.tsv and stage counters
must be byte-equal to ``python -m arriba_tpu``'s. The port runs with jax
and the JAX package blocked, in its own process and in its workers. A
failing worker stops the run (no fallback), and a layout without an
offload device is refused before any work."""

import json

import pytest

from . import scenario
from .torch_cli import BLOCKED_IMPORT_WRAPPER, assert_same_outputs, run_cli

ENGINES = {"native": {}, "python": {"NO_NATIVE": "1"}}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """(sample arguments, directory, ``python -m arriba_tpu``'s run) of
    multi_event_sample; the JAX package's engines write the same bytes, so
    its native engine's run is the reference for both of the port's."""
    tmp = tmp_path_factory.mktemp("sharded")
    args = scenario.multi_event_sample(tmp)
    return args, tmp, run_cli("arriba_tpu", args, tmp, "jax", {})


@pytest.mark.parametrize("layout", [None, "1", "8", "2procs"],
                         ids=["unset", "1", "8", "2procs"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_sharded_layout_matches_jax_package(reference_run, engine, layout):
    args, tmp, jax_run = reference_run
    env = {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
           **{f"ARRIBA_TPU_TORCH_{k}": v for k, v in ENGINES[engine].items()}}
    if layout is not None:
        env["ARRIBA_TPU_TORCH_SHARDED_STATS"] = layout
    torch_run = run_cli("arriba_tpu_torch", args, tmp,
                        f"torch_{engine}_{layout}",
                        env, wrapper=BLOCKED_IMPORT_WRAPPER)
    assert_same_outputs(jax_run, torch_run)
    assert jax_run[1].count(b"\n") > 1  # a non-trivial sample
    stderr = torch_run[4]
    assert json.loads(stderr.split("BLOCKED_LOADED ")[1].split("\n")[0]) == []


def test_failing_worker_stops_the_run(tmp_path):
    """A multihost worker that dies makes the run fail with its exit code;
    nothing falls back to the single-process or host statistics."""
    args = scenario.translocation_sample(tmp_path)
    rc, fusions, _, _, stderr = run_cli(
        "arriba_tpu_torch", args, tmp_path, "torch",
        {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
         "ARRIBA_TPU_TORCH_SHARDED_STATS": "2procs",
         "TORCH_CLI_WORKER_EXIT": "3"}, wrapper=BLOCKED_IMPORT_WRAPPER)
    assert rc != 0
    assert "multihost worker" in stderr and "exited 3" in stderr
    assert "falling back" not in stderr
    assert fusions is None


@pytest.mark.parametrize("device,layout,message", [
    ("off", "4", "ARRIBA_TPU_TORCH_DEVICE=off"),
    ("off", "2procs", "ARRIBA_TPU_TORCH_DEVICE=off"),
    ("cpu", "0procs", "is not <n> or <n>procs"),
])
def test_layout_refused_before_any_work(tmp_path, device, layout, message):
    args = scenario.translocation_sample(tmp_path)
    rc, fusions, _, counters, stderr = run_cli(
        "arriba_tpu_torch", args, tmp_path, "torch",
        {"ARRIBA_TPU_TORCH_DEVICE": device,
         "ARRIBA_TPU_TORCH_SHARDED_STATS": layout})
    assert rc != 0
    assert message in stderr
    assert counters == [] and fusions is None
