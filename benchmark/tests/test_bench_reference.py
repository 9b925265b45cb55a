"""The reference's model of Arriba's mismatch filter: its test, reads it
takes past the -U lists' end, and tiny runs whose base errors make the
filter take many reads."""

import numpy as np
import pytest

from benchmark import reference
from benchmark.tests import tiny

GENOME = 365_288_000


def test_bench_mismatch_test_rejects_from_arribas_threshold():
    mismatches = np.array([2, 3, 5, 6, 0])
    aligned = np.array([41, 41, 150, 150, 41])
    assert reference.mismatch_rejects(mismatches, aligned, GENOME).tolist() \
        == [False, True, False, True, False]


def test_bench_filtered_read_past_the_list_end_leaves_its_key():
    # ten keys, duplicates of the first until the list is full, then an
    # eleventh key whose first fragment the mismatch filter takes
    keys = np.array(list(range(10)) + [0] * 300 + [10, 10])
    removed = np.zeros(len(keys), bool)
    assert reference._counted(keys, removed) == (11, 290, 0)
    removed[310] = True
    assert reference._counted(keys, removed) == (10, 290, 0)
    # taken before the list is full, it is named
    keys = np.array([10, 10] + list(range(10)) + [0] * 300)
    removed = np.zeros(len(keys), bool)
    removed[0] = True
    assert reference._counted(keys, removed) == (10, 289, 1)


@pytest.mark.parametrize("capped", [False, True], ids=["below", "at_cap"])
def test_bench_mismatched_reads_are_judged_exactly(capped, monkeypatch):
    traffic = dict(error_rate=0.04)
    if capped:
        traffic.update(junction_split_min=400, junction_split_max=700,
                       discordant_per_split=1.0)
    status, result, _ = tiny.drive("genome150-native", seed=21, **traffic)
    assert status == 0 and result["correct"], result["checks"]
    # without the model the same rows fail
    monkeypatch.setattr(reference, "mismatch_rejects",
                        lambda m, n, g: np.zeros(len(m), bool))
    status, result, _ = tiny.drive("genome150-native", seed=21, **traffic)
    assert status == 0 and result["checks"]["junction_support_off"][
        "value"] > 0
