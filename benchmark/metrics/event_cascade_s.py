"""Event cascade (fusions_finder.py, filters/event_level.py,
filters/mismappers.py and the other event filters, ops/realign.py): a
sample's seconds from "Finding fusions" through the last "Assigning
confidence scores", from the program's stage log."""

from benchmark.harness import stage_seconds

UNIT = "s"
PREFIXES = ("Finding fusions", "Marking fusions with support",
            "Merging adjacent", "Filtering multi-mapping fusions",
            "Estimating expected number",
            "Filtering fusions with both breakpoints",
            "Filtering intragenic fusions", "Filtering fusions with <",
            "Filtering fusions with an e-value",
            "Searching for internal tandem", "Searching for known fusions",
            "Filtering in vitro", "Searching for fusions with",
            "Selecting best breakpoints", "Filtering read-through fusions",
            "Assigning confidence scores", "Filtering low-confidence events",
            "Filtering blacklisted", "Filtering fusions with anchors",
            "Filtering end-to-end", "Filtering fusions with no coverage",
            "Indexing gene sequences", "Filtering genes with",
            "Re-aligning chimeric reads", "Searching for additional isoforms")


def read(run):
    return stage_seconds(run, PREFIXES)
