"""End to end, the port's other device call sites and its device policy:
the blacklist range triage, the pure-Python engine's annotation triage and
writer pileup, a run in which jax and the JAX package cannot be imported,
and the default device (cuda) on a machine without one."""

import pytest
import torch

from . import scenario
from .torch_cli import BLOCKED_IMPORT_WRAPPER, assert_same_outputs, run_cli


def test_blacklist_triage_matches_jax_package(tmp_path):
    """tests/test_pipeline_e2e.py:201-237's blacklist: matching ranges, a
    gene and keyword pair, and decoys the device triage removes."""
    args = scenario.multi_event_sample(tmp_path)
    (tmp_path / "blacklist.tsv").write_text(
        "1:900-3100\t2:4800-8100\n"
        "DELTA\tany\n"
        "1:35000-36000\t2:35000-36000\n"
        "3:25000\t3:26000\n")
    jax_run = run_cli("arriba_tpu", args, tmp_path, "jax",
                      {"ARRIBA_TPU_DEVICE": "1"})
    torch_run = run_cli("arriba_tpu_torch", args, tmp_path, "torch",
                        {"ARRIBA_TPU_TORCH_DEVICE": "cpu"})
    assert_same_outputs(jax_run, torch_run)
    assert b"ALPHA" not in torch_run[1]


def test_pure_python_annotation_triage_and_pileup_match(tmp_path):
    """tests/test_pipeline_e2e.py:239-270: the pure-Python engine routes the
    fallback gene annotation through the interval triage and the writer's
    pileup through the device histogram."""
    args = scenario.multi_event_sample(tmp_path)
    assert_same_outputs(
        run_cli("arriba_tpu", args, tmp_path, "jax",
                {"ARRIBA_TPU_DEVICE": "1", "ARRIBA_TPU_NO_NATIVE": "1"}),
        run_cli("arriba_tpu_torch", args, tmp_path, "torch",
                {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
                 "ARRIBA_TPU_TORCH_NO_NATIVE": "1"}))


def test_port_runs_with_jax_and_jax_package_blocked(tmp_path):
    """The port imports neither jax nor arriba_tpu: with both blocked by a
    meta-path finder, the mismapper scenario still matches the JAX package,
    and the low-entropy scan, the 8-mer screen (its bitmap screen over the
    resident windows) and the accept wavefront (its indexed rows) all
    ran."""
    import json

    args = scenario.spliced_homolog_sample(tmp_path)
    jax_run = run_cli("arriba_tpu", args, tmp_path, "jax",
                      {"ARRIBA_TPU_DEVICE": "1",
                       "ARRIBA_TPU_NO_NATIVE_EVENT": "1"})
    torch_run = run_cli("arriba_tpu_torch", args, tmp_path, "torch",
                        {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
                         "ARRIBA_TPU_TORCH_NO_NATIVE_EVENT": "1"},
                        wrapper=BLOCKED_IMPORT_WRAPPER)
    assert_same_outputs(jax_run, torch_run)
    stderr = torch_run[4]
    calls = json.loads(stderr.split("DEVICE_CALLS ")[1].split("\n")[0])
    assert calls.get("_low_entropy_core_packed", 0) > 0, calls
    assert calls.get("kmer_bitmap_screen", 0) > 0, calls
    assert calls.get("accept_wavefront_indexed", 0) > 0, calls
    assert json.loads(stderr.split("BLOCKED_LOADED ")[1].split("\n")[0]) == []


def test_default_device_raises_without_cuda(tmp_path):
    """ARRIBA_TPU_TORCH_DEVICE defaults to cuda; without a CUDA device the
    run stops with a clear message instead of continuing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs there")
    args = scenario.translocation_sample(tmp_path)
    rc, fusions, _, _, stderr = run_cli("arriba_tpu_torch", args, tmp_path,
                                        "torch", {})
    assert rc != 0
    assert "ARRIBA_TPU_TORCH_DEVICE=cuda" in stderr
    assert "torch.cuda.is_available() is false" in stderr
    assert fusions is None
