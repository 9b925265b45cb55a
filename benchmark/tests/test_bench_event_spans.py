"""The three metrics of the Python event stages (`event_kmer_index_s`,
`event_evalue_s`, `writer_discarded_s`) read a sample's mean seconds in
their spans from a program's roots, and give nothing for a program
without the spans or a run that screened no pair."""

from types import SimpleNamespace

import pytest

from benchmark import harness, spans

METRICS = {"event_kmer_index_s": "events.kmer_index",
           "event_evalue_s": "events.evalue",
           "writer_discarded_s": "writer.discarded"}


def root(seconds, pairs=10, names=tuple(METRICS.values())):
    kept = [SimpleNamespace(name="stage", start=0.0, end=100.0),
            SimpleNamespace(name="screen.k5", start=1.0, end=1.5)]
    kept += [SimpleNamespace(name=name, start=2.0 * i, end=2.0 * i + seconds)
             for i, name in enumerate(names)]
    return SimpleNamespace(spans=kept, counters={"screen.pairs": pairs})


def read(monkeypatch, roots):
    monkeypatch.setattr(spans, "roots", lambda run: roots)
    modules = harness.metric_modules("metrics")
    return {name: modules[name].read(object()) for name in METRICS}


def test_bench_event_metrics_read_their_spans(monkeypatch):
    got = read(monkeypatch, [root(0.5), root(1.5), root(1.0)])
    for name in METRICS:
        assert got[name] == pytest.approx(1.0), name


@pytest.mark.parametrize("roots", [
    None,                                          # no tracer
    [root(1.0, names=())],                         # a program without them
    [root(1.0), root(1.0, names=())],              # a sample without them
    [root(1.0, pairs=0), root(1.0, pairs=0)],      # no pair screened
], ids=["no_roots", "no_spans", "one_sample_without", "no_pairs"])
def test_bench_event_metrics_are_silent_without_their_spans(monkeypatch,
                                                            roots):
    assert read(monkeypatch, roots) == dict.fromkeys(METRICS)
