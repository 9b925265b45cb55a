"""End to end: ``python -m arriba_tpu_torch`` with its offloaded stages on
the CPU (ARRIBA_TPU_TORCH_DEVICE=cpu) against ``python -m arriba_tpu`` with
JAX offload (ARRIBA_TPU_DEVICE=1, JAX on the CPU). Both output files and
every stage counter must be byte-equal."""

import pytest

from . import scenario
from .torch_cli import assert_same_outputs, run_cli


# (sample, extra environment suffixes for both packages): the native event
# cascade, and the Python event stages whose filter_mismappers runs the
# device screen and single-seed accept
CASES = [
    ("translocation_sample", {}),
    ("multi_event_sample", {}),
    ("spliced_homolog_sample", {}),
    ("spliced_homolog_sample", {"NO_NATIVE_EVENT": "1"}),
]


@pytest.mark.parametrize("sample,suffixes", CASES,
                         ids=["translocation", "multi_event",
                              "spliced_homolog", "spliced_homolog_py_event"])
def test_port_matches_jax_package(tmp_path, sample, suffixes):
    args = getattr(scenario, sample)(tmp_path)
    jax_env = {"ARRIBA_TPU_DEVICE": "1",
               **{f"ARRIBA_TPU_{k}": v for k, v in suffixes.items()}}
    torch_env = {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
                 **{f"ARRIBA_TPU_TORCH_{k}": v for k, v in suffixes.items()}}
    assert_same_outputs(
        run_cli("arriba_tpu", args, tmp_path, "jax", jax_env),
        run_cli("arriba_tpu_torch", args, tmp_path, "torch", torch_env))


@pytest.mark.parametrize("switch", ["NO_NATIVE_EVENT", "NO_NATIVE"])
def test_event_paths_match_the_default(tmp_path, switch):
    """The Python event stages (on the native realignment engine, whose
    Python k-mer table holds no positions) and the pure-Python engine (on
    the full table) write what the native event cascade writes."""
    args = scenario.translocation_sample(tmp_path)
    assert_same_outputs(
        run_cli("arriba_tpu_torch", args, tmp_path, "default",
                {"ARRIBA_TPU_TORCH_DEVICE": "cpu"}),
        run_cli("arriba_tpu_torch", args, tmp_path, "switched",
                {"ARRIBA_TPU_TORCH_DEVICE": "cpu",
                 f"ARRIBA_TPU_TORCH_{switch}": "1"}))
