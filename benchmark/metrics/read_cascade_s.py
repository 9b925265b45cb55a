"""Read cascade (filters/read_level.py, filters/native_cascade.py,
ops/readfilters.py): a sample's seconds from "Filtering duplicates"
through "Filtering reads with low entropy", from the program's stage log.
The native engine runs these stages in one bulk call at the first line,
so they read as that line's."""

from benchmark.harness import stage_seconds

UNIT = "s"
PREFIXES = ("Filtering duplicates", "Filtering mates which",
            "Filtering viral contigs", "Estimating fragment length",
            "Filtering read-through fragments",
            "Filtering inconsistently clipped", "Filtering breakpoints adjacent",
            "Filtering fragments with small insert size",
            "Filtering alignments with long gaps",
            "Filtering fragments with both mates in the same gene",
            "Filtering fusions arising from hairpin",
            "Filtering reads with a mismatch", "Filtering reads with low entropy")


def read(run):
    return stage_seconds(run, PREFIXES)
