"""A tiny cell for the CPU tests: the cell's configuration at a few genes
a contig and short genes, so that the port's plain versions finish in
seconds."""

import argparse
import copy
import time

from benchmark import harness

TRAFFIC = dict(junctions=4, junction_split_min=20, junction_split_max=80,
               discordant_per_split=0.2, artifact_split_fragments=40,
               artifact_discordant_pairs=20, low_complexity_fragments=40,
               viral_fragments=8, keep_every=1, error_rate=0.004,
               anchor_min=40, anchor_max=110, mate_gap_min=20,
               mate_gap_max=150)
SHORT_GENES = dict(genes_per_contig=4, gene_spacing=3000, exon_pitch=250,
                   exon_length=100, contig_margin=5000,
                   background_pairs=4000, threads=2)


def config(name: str) -> dict:
    c = copy.deepcopy(harness.load_json("configs", name))
    c.update(SHORT_GENES)
    return c


def drive(name: str, seed: int = 11, fault: str = "none", trace: int = 0,
          seconds: float = 0.01, **traffic):
    """One run of the tiny cell on the CPU: (exit code, result dict, the
    harness's Run)."""
    workload = {"config": name, "chips": 1,
                "traffic": dict(TRAFFIC, **traffic)}
    args = argparse.Namespace(workload=f"tiny-{name}", seed=seed,
                              seconds=seconds, trace=trace, fault=fault)
    import contextlib
    import io
    import json
    out = io.StringIO()
    runs = []
    with contextlib.redirect_stdout(out):
        status = harness.drive(args, workload, config(name),
                               time.perf_counter(), "cpu", runs)
    lines = out.getvalue().strip().splitlines()
    return status, (json.loads(lines[-1]) if lines else None), runs[-1]
