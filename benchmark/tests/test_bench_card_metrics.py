"""The card pass's two metrics (`ingest_card_s`, `ingest_card_share`) read
its `ingest.card` span and its record counters from a program's roots, and
give nothing for a program without the pass."""

from types import SimpleNamespace

from benchmark import harness, spans


def root(card_s, card, residue, scan_s=1.0):
    kept = [SimpleNamespace(name="ingest.scan", start=0.0, end=scan_s)]
    counters = {"h2d_bytes": 1000}
    if card_s is not None:
        kept.append(SimpleNamespace(name="ingest.card", start=2.0,
                                    end=2.0 + card_s))
        counters.update({"ingest.card_records": card,
                         "ingest.residue_records": residue})
    return SimpleNamespace(spans=kept, counters=counters)


def read(monkeypatch, roots):
    monkeypatch.setattr(spans, "roots", lambda run: roots)
    modules = harness.metric_modules("metrics")
    return {name: modules[name].read(object())
            for name in ("ingest_card_s", "ingest_card_share")}


def test_bench_card_metrics_read_the_span_and_the_counters(monkeypatch):
    got = read(monkeypatch, [root(0.25, 900, 100), root(0.35, 1800, 200)])
    assert abs(got["ingest_card_s"] - 0.30) < 1e-12
    assert abs(got["ingest_card_share"] - 90.0) < 1e-12


def test_bench_card_metrics_are_silent_without_the_pass(monkeypatch):
    assert read(monkeypatch, [root(None, 0, 0)]) == {
        "ingest_card_s": None, "ingest_card_share": None}
    assert read(monkeypatch, None) == {
        "ingest_card_s": None, "ingest_card_share": None}
