"""Ingest, the card pass over the BAM: a sample's seconds in the program's
`ingest.card` span (ingest/card.py: reading and indexing the BGZF members,
their copy to the card, K6's inflate, framing, pair test and reduction,
the residue's way back and the coverage's merge), beside `ingest.scan`,
which then scans the residue only (spans.py). None where no sample ran
the pass (a program without it)."""

from benchmark import spans

UNIT = "s"


def read(run):
    found = spans.roots(run)
    if not found or not all(any(s.name == "ingest.card" for s in root.spans)
                            for root in found):
        return None
    return sum(spans.seconds(root, "ingest.card")
               for root in found) / len(found)
