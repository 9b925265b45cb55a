"""Event cascade, the gene k-mer index on the device event path: a
sample's seconds in the program's `events.kmer_index` span
(`EventCascade.make_kmer_index`: the padded windows of the genes of
unfiltered inter-gene fusions indexed in Python and mirrored into the
native realignment engine). None where the span is absent or no pair was
screened (event_spans.py)."""

from benchmark import event_spans

UNIT = "s"


def read(run):
    return event_spans.mean_seconds(run, "events.kmer_index")
