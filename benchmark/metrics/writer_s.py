"""Writer layer (output/): a sample's seconds from "Writing fusions"
through the end of `cli.main`, from the program's stage log."""

from benchmark.harness import stage_seconds

UNIT = "s"
PREFIXES = ("Writing fusions", "Writing discarded fusions",
            "Freeing resources", "Done")


def read(run):
    return stage_seconds(run, PREFIXES)
