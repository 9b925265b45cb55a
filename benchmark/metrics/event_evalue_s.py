"""Event cascade, the e-value on the device event path: a sample's
seconds in the program's `events.evalue` span
(`EventCascade.estimate_expected_fusions`, the expected number of fusions
by random chance in Python). None where the span is absent or no pair was
screened (event_spans.py)."""

from benchmark import event_spans

UNIT = "s"


def read(run):
    return event_spans.mean_seconds(run, "events.evalue")
