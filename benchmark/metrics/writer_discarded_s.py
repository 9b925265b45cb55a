"""Writer, the discarded table on the device event path: a sample's
seconds in the program's `writer.discarded` span (the write of
`fusions.discarded.tsv`, native or Python). None where the span is absent
or no pair was screened (event_spans.py)."""

from benchmark import event_spans

UNIT = "s"


def read(run):
    return event_spans.mean_seconds(run, "writer.discarded")
