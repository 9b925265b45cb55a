"""The comparison fails where it must: each fault the cells can have,
planted in the timed path of a tiny run on the CPU (the harness's look
for a chip skipped), and the control, the program's own path that breaks
its duplicate guarantee (-u). A sound run of each engine is correct."""

import pytest

from benchmark.tests import tiny

NATIVE = "genome150-native"
DEVICE = "genome150-device-events"
# at most 4 anchors and 2 gaps a junction, so that it holds duplicates
CROWDED = dict(anchor_min=40, anchor_max=44, mate_gap_min=20,
               mate_gap_max=22)


@pytest.mark.parametrize("name", [NATIVE, DEVICE])
def test_bench_sound_run_is_correct(name):
    status, result, run = tiny.drive(name, **CROWDED)
    assert status == 0 and result["correct"], result["checks"]
    assert run.captures.k2[0]
    # the low-complexity tracts give K2 reads to flag
    assert sum(int(f.sum()) for f in run.captures.k2[0]) > 0
    if name == DEVICE:
        assert run.captures.screen[0] and run.captures.accept[0]


@pytest.mark.parametrize("name,fault,number", [
    (NATIVE, "control", "junction_support_off"),
    (NATIVE, "k2_flip", "low_entropy_flags_off"),
    (NATIVE, "k2_half", "low_entropy_flags_off"),
    (NATIVE, "event_discard", "junction_verdicts_off"),
    (DEVICE, "event_discard", "junction_verdicts_off"),
    (NATIVE, "table_altered", "junction_support_off"),
    (NATIVE, "table_half", "junction_rows_off"),
    (NATIVE, "later_altered", "samples_off"),
    (DEVICE, "screen_flip", "screen_verdicts_off"),
    (DEVICE, "screen_half", "screen_verdicts_off"),
    (DEVICE, "accept_flip", "accept_verdicts_off"),
])
def test_bench_fault_is_caught(name, fault, number):
    # later_altered needs a window of two samples or more (a tiny native
    # sample takes a few seconds on the CPU at most)
    seconds = 20.0 if fault == "later_altered" else 0.01
    status, result, run = tiny.drive(name, fault=fault, seconds=seconds,
                                     **CROWDED)
    assert len(run.samples) >= (2 if fault == "later_altered" else 1)
    assert status == 0
    assert not result["correct"]
    assert result["checks"][number]["value"] > result["checks"][number][
        "limit"], result["checks"]
