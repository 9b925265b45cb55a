"""Ingest layer (io/bam.py, ingest/, the native ingest): a sample's
seconds from "Reading chimeric alignments" through "Annotating
alignments", from the program's stage log."""

from benchmark.harness import stage_seconds

UNIT = "s"
PREFIXES = ("Reading chimeric alignments", "Marking multi-mapping",
            "Detecting strandedness", "Assigning strands",
            "Annotating alignments")


def read(run):
    return stage_seconds(run, PREFIXES)
