"""The Python gene k-mer table of make_kmer_index
(arriba_tpu_torch/filters/mismappers.py). With the native realignment
engine loaded it holds the engine's contigs, each with an empty index, and
the coverage metadata; with the engine off it is the JAX package's table,
position for position; and filter_homologs and filter_mismappers mark the
same fusions and reads on either table."""

import contextlib
import copy
import io

import numpy as np
import pytest

from arriba_tpu.filters import mismappers as jax_mismappers
from arriba_tpu_torch import cli
from arriba_tpu_torch.constants import FILTER_HOMOLOGS, FILTER_MISMAPPERS
from arriba_tpu_torch.filters import homologs, mismappers

from . import scenario

pytestmark = pytest.mark.skipif(mismappers._native is None,
                                reason="the native engine is not built")

# sample: (its scenario function, further CLI arguments, the filters that mark)
SAMPLES = {
    "translocation": ("translocation_sample", [], ()),
    "homolog_tie": ("homolog_tie_sample", [], (FILTER_HOMOLOGS,)),
    # with the earlier filters that take its homolog and its mismapping
    # fusion off, both of the stages mark
    "spliced_homolog": ("spliced_homolog_sample",
                        ["-f", "no_coverage,select_best"],
                        (FILTER_HOMOLOGS, FILTER_MISMAPPERS)),
}


def _marks(fusions, chimeric_alignments=None):
    """The filter of every fusion (and of every read pair)."""
    marks = [(key, f.filter) for key, f in fusions.items()]
    if chimeric_alignments is not None:
        marks += [(name, mates.filter)
                  for name, mates in chimeric_alignments.items()]
    return marks


@pytest.fixture(scope="module", params=list(SAMPLES))
def captured(request, tmp_path_factory):
    """One CLI run of a sample on the Python event stages (offload on the
    CPU). At its index stage: the table with the native engine (the one
    the run goes on with), the table built with the engine off and the JAX
    package's. At its homolog and mismapper stages: the fusions (and read
    pairs) each filter marks on the engine's table, and on the full table,
    which says itself that its positions are not in the engine, each on
    its own copy of the stage's input."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield _capture(*SAMPLES[request.param],
                       tmp_path_factory.mktemp("sample"), monkeypatch)


def _capture(sample, extra, marking, tmp_path, monkeypatch):
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", "1")
    seen = {}
    make = mismappers.make_kmer_index
    filter_homologs = homologs.filter_homologs
    filter_mismappers = mismappers.filter_mismappers

    def make_three(fusions, assembly, genes, padding, kmer_length):
        with monkeypatch.context() as off:
            off.setattr(mismappers, "_native", None)
            seen["full"] = make(fusions, assembly, genes, padding, kmer_length)
        seen["jax"] = jax_mismappers.make_kmer_index(
            fusions, assembly, genes, padding, kmer_length)
        seen["lean"] = make(fusions, assembly, genes, padding, kmer_length)
        assert seen["lean"].in_engine and not seen["full"].in_engine
        return seen["lean"]

    def homologs_twice(fusions, kmer_indices, *rest):
        assert kmer_indices is seen["lean"]
        lean = copy.deepcopy(fusions)
        remaining = filter_homologs(lean, kmer_indices, *rest)
        full = copy.deepcopy(fusions)
        full_remaining = filter_homologs(full, seen["full"], *rest)
        seen["homologs"] = ((remaining, _marks(lean)),
                            (full_remaining, _marks(full)))
        return filter_homologs(fusions, kmer_indices, *rest)

    def mismappers_twice(fusions, chimeric_alignments, kmer_indices, *rest):
        # the read pairs live in the native store: their marks are put back
        # after each run instead of copied
        assert kmer_indices is seen["lean"]
        before = {name: mates.filter
                  for name, mates in chimeric_alignments.items()}

        def once(table):
            copied = copy.deepcopy(fusions)
            remaining = filter_mismappers(copied, chimeric_alignments, table,
                                          *rest)
            marks = _marks(copied, chimeric_alignments)
            for name, mark in before.items():
                chimeric_alignments[name].filter = mark
            return remaining, marks

        lean = once(kmer_indices)
        full = once(seen["full"])
        assert {name: mates.filter
                for name, mates in chimeric_alignments.items()} == before
        seen["mismappers"] = (lean, full)
        return filter_mismappers(fusions, chimeric_alignments, kmer_indices,
                                 *rest)

    monkeypatch.setattr(mismappers, "make_kmer_index", make_three)
    monkeypatch.setattr(homologs, "filter_homologs", homologs_twice)
    monkeypatch.setattr(mismappers, "filter_mismappers", mismappers_twice)
    args = getattr(scenario, sample)(tmp_path) + extra
    args += ["-o", str(tmp_path / "fusions.tsv"),
             "-O", str(tmp_path / "fusions.discarded.tsv")]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(args) == 0
    assert {"full", "jax", "lean", "homologs", "mismappers"} <= set(seen)
    seen["marking"] = marking
    return seen


def test_native_table_keeps_the_contigs_and_the_coverage(captured):
    lean, full = captured["lean"], captured["full"]
    assert full and any(full.values())
    assert list(lean) == list(full)
    assert all(index == {} for index in lean.values())
    assert lean.padding == full.padding
    assert lean.indexed_genes == full.indexed_genes
    # EventCascade passes `table or {}`: a table with a gene indexed is kept
    assert bool(lean) == bool(full.indexed_genes) is True


def test_table_without_the_engine_is_the_jax_packages(captured):
    full, reference = captured["full"], captured["jax"]
    assert list(full) == list(reference)
    assert full.padding == reference.padding
    assert full.indexed_genes == reference.indexed_genes
    for contig, index in reference.items():
        assert list(full[contig]) == list(index)
        for kmer, positions in index.items():
            np.testing.assert_array_equal(full[contig][kmer], positions)
            assert full[contig][kmer].dtype == positions.dtype


@pytest.mark.parametrize("stage,mark", [("homologs", FILTER_HOMOLOGS),
                                        ("mismappers", FILTER_MISMAPPERS)],
                         ids=["homologs", "mismappers"])
def test_filters_mark_the_same_on_either_table(captured, stage, mark):
    (lean_remaining, lean), (full_remaining, full) = captured[stage]
    assert lean and lean == full
    assert lean_remaining == full_remaining
    assert any(m == mark for _, m in lean) == (mark in captured["marking"])
