"""The tracer's spans and counters of the Python event stages
(arriba_tpu_torch/trace.py): on the device event path each of them is
recorded once a sample inside its stage's span, `events.materialized`
counts the Python fusion table's rows, `events.kmer_index_bases` the
padded gene windows indexed and `events.kmer_table_kmers` the Python
k-mer table's keys (none while the native engine holds the positions); on
the native event cascade the stages with a native twin keep their spans
and nothing materializes early; with the switch off nothing is
recorded."""

import collections
import contextlib
import io

import pytest

from arriba_tpu_torch import cli, pipeline, trace
from arriba_tpu_torch.constants import FILTER_NONE
from arriba_tpu_torch.filters import mismappers

from . import scenario

# each span and the stage line it runs under
STAGES = {"events.materialize": "Finding fusions",
          "events.evalue": "Estimating expected number of fusions",
          "events.kmer_index": "Indexing gene sequences",
          "events.homologs": "Filtering genes with",
          "screen.collect": "Re-aligning chimeric reads",
          "writer.discarded": "Writing discarded fusions"}


@pytest.fixture
def buffer(monkeypatch):
    """An empty buffer of finished roots for the test."""
    fresh = collections.deque(maxlen=trace.KEEP)
    monkeypatch.setattr(trace, "_finished", fresh)
    return fresh


def _run(tmp_path, monkeypatch, traced: bool, device_events: bool,
         runs: int = 1) -> list:
    """runs in-process calls of the CLI on the translocation sample with
    the offloaded stages on the CPU; the pipeline state of each."""
    monkeypatch.setattr(pipeline, "_STAGE_TIMES", traced)
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    if device_events:
        monkeypatch.setenv("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", "1")
    else:
        monkeypatch.delenv("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", raising=False)
    states = []
    run = pipeline.run

    def kept(options):
        states.append(run(options))
        return states[-1]

    monkeypatch.setattr(pipeline, "run", kept)
    args = scenario.translocation_sample(tmp_path)
    args += ["-o", str(tmp_path / "fusions.tsv"),
             "-O", str(tmp_path / "fusions.discarded.tsv")]
    for _ in range(runs):
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(args) == 0
    return states


def test_device_event_spans_lie_inside_their_stages(buffer, monkeypatch,
                                                    tmp_path):
    _run(tmp_path, monkeypatch, True, True, runs=2)
    roots = trace.finished()
    assert len(roots) == 2
    for root in roots:
        by_id = {s.id: s for s in root.spans}
        # each span's parent is its stage: none nests in another span, so
        # screen.collect lies outside the screen's three timed calls
        for name, stage in STAGES.items():
            (span,) = [s for s in root.spans if s.name == name]
            parent = by_id[span.parent]
            assert parent.name == "stage" and parent.label.startswith(
                stage), (name, parent.label)
            assert parent.start <= span.start <= span.end <= parent.end
        assert root.counters["screen.pairs"] > 0


def test_materialized_counts_the_python_fusion_table(buffer, monkeypatch,
                                                     tmp_path):
    (state,) = _run(tmp_path, monkeypatch, True, True)
    (root,) = trace.finished()
    assert len(state.fusions) > 0
    assert root.counters["events.materialized"] == len(state.fusions)


def test_kmer_index_bases_count_the_padded_gene_windows(buffer, monkeypatch,
                                                        tmp_path):
    expected = []
    make = mismappers.make_kmer_index

    def counted(fusions, assembly, genes, padding, kmer_length):
        genes_to_filter = {g for f in fusions.values()
                           if f.filter == FILTER_NONE and f.gene1 != f.gene2
                           for g in (f.gene1, f.gene2)}
        bases = 0
        for gene in genes_to_filter:
            sequence = assembly.get(int(genes.contig[gene]))
            if sequence is None:
                continue
            start = max(int(genes.start[gene]) - max(padding, 0), 0)
            end = min(int(genes.end[gene]) + max(padding, 0),
                      len(sequence) - 1)
            bases += max(end - start, 0)
        expected.append(bases)
        return make(fusions, assembly, genes, padding, kmer_length)

    monkeypatch.setattr(mismappers, "make_kmer_index", counted)
    _run(tmp_path, monkeypatch, True, True)
    (root,) = trace.finished()
    assert len(expected) == 1 and expected[0] > 0
    assert root.counters["events.kmer_index_bases"] == expected[0]


def test_kmer_table_kmers_read_zero_where_the_native_engine_holds_them(
        buffer, monkeypatch, tmp_path):
    assert mismappers._native is not None
    _run(tmp_path, monkeypatch, True, True)
    (root,) = trace.finished()
    assert root.counters["events.kmer_index_bases"] > 0
    assert root.counters["events.kmer_table_kmers"] == 0
    buffer.clear()
    _run(tmp_path, monkeypatch, True, False)
    (root,) = trace.finished()
    assert "events.kmer_table_kmers" not in root.counters


def test_native_event_cascade_keeps_the_spans_of_its_native_twins(
        buffer, monkeypatch, tmp_path):
    _run(tmp_path, monkeypatch, True, False)
    (root,) = trace.finished()
    names = [s.name for s in root.spans]
    for name in ("events.evalue", "events.kmer_index", "events.homologs",
                 "writer.discarded"):
        assert names.count(name) == 1, (name, names)
    # the native table never materializes early, and no pair is screened
    for name in ("events.materialize", "screen.collect"):
        assert name not in names, name
    for name in ("events.materialized", "events.kmer_index_bases",
                 "screen.pairs"):
        assert name not in root.counters, name


def test_device_event_path_records_nothing_untraced(buffer, monkeypatch,
                                                    tmp_path):
    states = _run(tmp_path, monkeypatch, False, True)
    assert len(states) == 1 and len(states[0].fusions) > 0
    assert trace.finished() == [] and len(buffer) == 0
