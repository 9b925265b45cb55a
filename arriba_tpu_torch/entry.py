"""Entry points: the flagship device step and the data-parallel check.

``entry()`` returns (fn, example_args): the fused per-read filter step
(mismatch counting + binomial test + recurrent k-mer content, ops/
readfilters.read_filter_step) over ``random_read_batch(rng, 1024, 152)``,
the embarrassingly-parallel core of the read-level cascade. The arguments
live on ``device`` (default: the one ARRIBA_TPU_TORCH_DEVICE selects).

``sharded_check(state, options, n)`` runs every sharded step of the
data-parallel path (parallel/dp.py, parallel/stats.py) over a pipeline
state's real data at 1 and at n shards and requires equal results, element
for element, and a merged cluster table equal to the host fusion table's
support. ``dryrun_multichip(n, cli_args)`` runs the pipeline on a sample
given by its CLI arguments and then that check.
"""

from __future__ import annotations

import time

import numpy as np


def entry(device=None):
    import torch

    from . import trace
    from .ops.encode import random_read_batch
    from .ops.readfilters import read_filter_step

    if device is None:
        from .device import torch_device
        device = torch_device()
    rng = np.random.default_rng(0)
    batch = random_read_batch(rng, 1024, 152)

    def fn(bases, ref, match_mask, length, aligned_start, aligned_end,
           extra_mismatches):
        return read_filter_step(bases, ref, match_mask, length, aligned_start,
                                aligned_end, extra_mismatches)

    example_args = tuple(trace.upload(x, device) for x in (
        batch.bases, batch.ref, batch.match_mask, batch.length,
        batch.aligned_start, batch.aligned_end)) + (
        torch.zeros(batch.bases.shape[0], dtype=torch.int32, device=device),)
    return fn, example_args


def _require(condition, message: str) -> None:
    if not condition:
        raise RuntimeError(f"sharded check: {message}")


def sharded_steps(batch, fusion_list, state, options, n: int, device=None):
    """Every sharded step on an n-shard mesh over real pipeline data: the
    filter step over the ReadBatch, the realignment step of each read
    against its own reference (``ref[:, :256]``), the cluster step over one
    candidate per supporting read of the fusion table, and the mid-cascade
    statistics. Returns (values, seconds): host values with the padding
    trimmed, and each step's seconds (device work included)."""
    import torch

    from .filters.in_vitro import expression_gene_incidence
    from .ops.cluster import pack_keys
    from .parallel.dp import (make_mesh, shard_batch, sharded_cluster_step,
                              sharded_read_filter_step, sharded_realign_step)
    from .parallel.stats import candidate_cluster_inputs, compute_stats_sharded

    mesh = make_mesh(n, device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    sharded = shard_batch(batch, mesh)
    lap("shard")
    n_rows = sharded.bases.shape[0]
    per_read, globals_ = sharded_read_filter_step(mesh)(
        sharded.bases, sharded.ref, sharded.match_mask, sharded.length,
        sharded.aligned_start, sharded.aligned_end,
        torch.zeros(n_rows, dtype=torch.int32, device=mesh.device))
    per_read = {key: value[:batch.n_reads].cpu().numpy()
                for key, value in per_read.items()}
    globals_ = {key: int(value) for key, value in globals_.items()}
    lap("filter")

    # each read against its own reference window: real sequence pairs, so
    # accepts are genuine alignments
    result, total_alignable = sharded_realign_step(mesh)(
        sharded.bases, sharded.ref[:, :256].contiguous(), sharded.length)
    realigned = {key: value[:batch.n_reads].cpu().numpy()
                 for key, value in result.items()}
    total_alignable = int(total_alignable)
    lap("realign")

    # the sharded analog of fusions.cpp:203-366's hash-map aggregation
    cols, kind, valid = candidate_cluster_inputs(fusion_list, mesh.size)
    words = tuple(mesh.put(word.numpy())
                  for word in pack_keys(*map(torch.from_numpy, cols)))
    clusters = sharded_cluster_step(mesh)(words, mesh.put(kind),
                                          mesh.put(valid))
    n_clusters = int(clusters["n_clusters"])
    cluster_table = {
        "words": tuple(word[:n_clusters].cpu().numpy()
                       for word in clusters["words"]),
        "support": clusters["support"][:n_clusters].cpu().numpy()}
    lap("cluster")

    stats, (expression, threshold) = compute_stats_sharded(
        fusion_list, state.annotation.genes,
        expression_gene_incidence(state.chimeric_alignments),
        options.high_expression_quantile, mesh)
    lap("stats")
    values = {"per_read": per_read, "globals": globals_,
              "realign": realigned, "total_alignable": total_alignable,
              "n_clusters": n_clusters, "clusters": cluster_table,
              "stats": stats, "expression": expression,
              "expression_threshold": threshold}
    return values, seconds


def sharded_check(state, options, n: int, device=None) -> dict:
    """The data-parallel path over a pipeline state (run with the Python
    event stages, so the fusion table is complete): every sharded step at
    1 and at n shards, equal element for element, and the merged cluster
    table equal to the host fusion table's support counts. Raises on any
    difference; returns a summary (rows, counts, each step's seconds)."""
    from .ops.encode import tensorize

    start = time.perf_counter()
    batch = tensorize(state.chimeric_alignments, state.assembly)
    tensorize_seconds = time.perf_counter() - start
    _require(batch.n_reads > 0, "the sample produced no chimeric reads")
    fusion_list = list(state.fusions.values())
    _require(fusion_list, "the sample produced no fusion candidates")

    reference, reference_seconds = sharded_steps(batch, fusion_list, state,
                                                 options, 1, device)
    result, seconds = sharded_steps(batch, fusion_list, state, options, n,
                                    device)

    for part in ("per_read", "realign"):
        for key, value in reference[part].items():
            _require(np.array_equal(value, result[part][key]),
                     f"{part}[{key}] differs between 1 and {n} shards")
    for key in ("globals", "total_alignable", "n_clusters", "stats",
                "expression_threshold"):
        _require(reference[key] == result[key],
                 f"{key} differs between 1 and {n} shards")
    for a, b in zip(reference["clusters"]["words"],
                    result["clusters"]["words"]):
        _require(np.array_equal(a, b), f"cluster keys differ at {n} shards")
    _require(np.array_equal(reference["clusters"]["support"],
                            result["clusters"]["support"]),
             f"cluster support differs at {n} shards")
    _require(np.array_equal(reference["expression"], result["expression"]),
             f"expression differs at {n} shards")

    # the merged cluster table must reproduce the host fusion table
    expected = {}
    for f in fusion_list:
        counts = (len(f.split_read1_list), len(f.split_read2_list),
                  len(f.discordant_mate_list))
        if sum(counts):
            key = (f.gene1, f.gene2, f.contig1, f.contig2, f.breakpoint1,
                   f.breakpoint2, int(f.direction1), int(f.direction2))
            expected[key] = counts
    words, support = result["clusters"]["words"], result["clusters"]["support"]
    got = {}
    for i in range(result["n_clusters"]):
        got[(int(words[0][i]), int(words[1][i]),
             int(words[2][i]) >> 16, int(words[2][i]) & 0xFFFF,
             int(words[3][i]), int(words[4][i]),
             (int(words[5][i]) >> 1) & 1, int(words[5][i]) & 1)] = \
            tuple(int(c) for c in support[i])
    _require(got == expected,
             "the clustered support differs from the host fusion table")
    _require(result["total_alignable"] > 0, "no read realigned")
    _require(result["n_clusters"] > 0, "no candidate clusters")
    return {"shards": n, "rows": int(batch.bases.shape[0]),
            "reads": batch.n_reads, "width": int(batch.bases.shape[1]),
            "tensorize_seconds": tensorize_seconds,
            "seconds": seconds, "reference_seconds": reference_seconds,
            "total_mismatches": result["globals"]["total_mismatches"],
            "total_alignable": result["total_alignable"],
            "n_clusters": result["n_clusters"],
            "partner_edges": int(result["stats"].partner_count.sum()),
            "expression_threshold": result["expression_threshold"]}


def dryrun_multichip(n: int, cli_args, device=None) -> None:
    """Run the port's pipeline on the sample ``cli_args`` names (the CLI's
    arguments without -o), with the Python event stages so the whole
    candidate table is kept, then ``sharded_check`` at n shards on
    ``device`` (default: the one ARRIBA_TPU_TORCH_DEVICE selects)."""
    import os
    import pathlib
    import tempfile

    from .cli import parse_arguments
    from .pipeline import run

    with tempfile.TemporaryDirectory(prefix="arriba_tpu_torch_dryrun_") as tmp:
        options = parse_arguments(
            list(cli_args) + ["-o", str(pathlib.Path(tmp) / "fusions.tsv")])
        saved = os.environ.get("ARRIBA_TPU_TORCH_NO_NATIVE_EVENT")
        os.environ["ARRIBA_TPU_TORCH_NO_NATIVE_EVENT"] = "1"
        try:
            state = run(options)
        finally:
            if saved is None:
                del os.environ["ARRIBA_TPU_TORCH_NO_NATIVE_EVENT"]
            else:
                os.environ["ARRIBA_TPU_TORCH_NO_NATIVE_EVENT"] = saved
        summary = sharded_check(state, options, n, device)
    print(f"dryrun_multichip OK: {n} shards, {summary['reads']} real reads, "
          f"total_mismatches={summary['total_mismatches']}, "
          f"alignable={summary['total_alignable']}, "
          f"clusters={summary['n_clusters']} (= host fusion table), "
          f"partner_edges={summary['partner_edges']}, "
          f"expression_threshold={summary['expression_threshold']}")
