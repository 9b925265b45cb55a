"""Ingest, the card pass over the BAM: the share of the sample's records
that the card consumed as boring proper pairs, from the program's
`ingest.card_records` and `ingest.residue_records` counters over the
window (spans.py); the rest went to the native scan. None where no sample
counted either (a program without the pass)."""

from benchmark import spans

UNIT = "%"
COUNTERS = ("ingest.card_records", "ingest.residue_records")


def read(run):
    found = spans.roots(run)
    if not found or not all(any(name in root.counters for name in COUNTERS)
                            for root in found):
        return None
    card = sum(root.counters.get(COUNTERS[0], 0) for root in found)
    residue = sum(root.counters.get(COUNTERS[1], 0) for root in found)
    if card + residue == 0:
        return None
    return 100.0 * card / (card + residue)
