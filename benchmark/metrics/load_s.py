"""Load layer (io/fasta.py, io/gtf.py, annotation/): a sample's seconds
from the CLI's launch through loading the assembly, the annotation, tags
and protein domains, from the program's stage log."""

from benchmark.harness import stage_seconds

UNIT = "s"
PREFIXES = ("Launching Arriba-TPU", "Loading assembly", "Loading annotation",
            "Loading tags", "Loading protein domains")


def read(run):
    return stage_seconds(run, PREFIXES)
