"""Ingest, the native scan: a sample's seconds in the program's
`ingest.scan` spans (`_native.scan_sam`: BGZF, the decode pool, the
extraction and the store), the part of `ingest_s` that no Python runs in
(spans.py)."""

from benchmark import spans

UNIT = "s"


def read(run):
    return spans.mean(run, lambda root: spans.seconds(root, "ingest.scan"))
