"""Multi-process execution of the sharded candidate merge and the
mid-cascade statistics over torch.distributed.

The single-process mesh (parallel/dp.py, parallel/stats.py) splits the
candidate table into row shards on one device. This module runs the same
steps across worker processes: each rank owns its shards on its own device
(one card per rank over NCCL, or the CPU over gloo), and the psum /
all_gather of the cluster merge and of the statistics cross the process
boundary. The merged cluster table and every statistic are the same on
every rank and bit-identical to the single-process result.

Worker entry point (one per rank; run_multiprocess_stats starts them):

    python -m arriba_tpu_torch.parallel.multihost --store-port PORT \\
        --world-size 2 --rank I --device cpu --input inputs.npz \\
        --output out_I.npz

``inputs.npz`` carries the pre-marshalled arrays
(parallel/stats.py build_stats_host_inputs + candidate_cluster_inputs);
every rank loads the whole file and puts the rows of its own shards on its
device. The rendezvous is a TCPStore the parent opens on port 0 (the
operating system picks a free one) before it starts the workers.
"""

from __future__ import annotations

import argparse
import datetime
import os

import numpy as np

STATS_NAMES = ("spliced_breakpoints", "exonic_breakpoints",
               "intronic_breakpoints", "exonic_intronic_breakpoints",
               "intragenic_duplications", "intragenic_inversions",
               "spliced_same_gene", "spliced_different_genes",
               "genes_with_fusions", "genes_with_read_through")


def run_multiprocess_stats(fusion_list, genes, gene_hits, quantile: float,
                           n_processes: int = 2, shards_per_process: int = 1,
                           device=None, timeout: float = 600.0):
    """The sharded reduction (candidate cluster merge + mid-cascade
    statistics) across ``n_processes`` torch.distributed ranks: NCCL with
    one card per rank when ``device`` (default: the one
    ARRIBA_TPU_TORCH_DEVICE selects) is CUDA, gloo on the CPU. Returns
    (CascadeStats, (dense expression, threshold), n_clusters); raises when
    a worker fails or the ranks disagree."""
    import subprocess
    import sys
    import tempfile

    import torch
    import torch.distributed as dist

    from ..filters.event_level import CascadeStats
    from .stats import build_stats_host_inputs, candidate_cluster_inputs

    if device is None:
        from ..device import torch_device
        device = torch_device()
    kind = torch.device(device).type
    if kind == "cuda" and n_processes > torch.cuda.device_count():
        raise RuntimeError(f"{n_processes} NCCL ranks need {n_processes} "
                           f"CUDA devices, this machine has "
                           f"{torch.cuda.device_count()}")
    n_dp = n_processes * shards_per_process
    inputs = build_stats_host_inputs(fusion_list, genes, gene_hits, n_dp)
    ckey, ckind, cvalid = candidate_cluster_inputs(fusion_list, n_dp)
    inputs.update(cluster_keys=ckey, cluster_kind=ckind, cluster_valid=cvalid,
                  quantile=np.float64(quantile))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    with tempfile.TemporaryDirectory(prefix="arriba_tpu_torch_mh_") as tmp:
        input_path = os.path.join(tmp, "inputs.npz")
        np.savez(input_path, **inputs)
        workers = [subprocess.Popen(
            [sys.executable, "-m", "arriba_tpu_torch.parallel.multihost",
             "--store-port", str(store.port),
             "--world-size", str(n_processes), "--rank", str(rank),
             "--device", kind,
             "--shards-per-process", str(shards_per_process),
             "--timeout", str(timeout),
             "--input", input_path,
             "--output", os.path.join(tmp, f"out_{rank}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(n_processes)]
        try:
            logs = [worker.communicate(timeout=timeout) for worker in workers]
        finally:
            # a hung or failed worker must not outlive the temporary
            # directory or linger as an orphan
            for worker in workers:
                if worker.poll() is None:
                    worker.kill()
                    worker.communicate()
        for rank, worker in enumerate(workers):
            if worker.returncode != 0:
                raise RuntimeError(f"multihost worker {rank} exited "
                                   f"{worker.returncode}: "
                                   f"{logs[rank][1][-2000:]}")
        outs = [dict(np.load(os.path.join(tmp, f"out_{rank}.npz")))
                for rank in range(n_processes)]
    del store
    for key in outs[0]:
        for other in outs[1:]:
            if not np.array_equal(outs[0][key], other[key]):
                raise RuntimeError(f"multihost ranks diverge at {key}")

    out = outs[0]
    stats = CascadeStats(
        partner_count=np.asarray(out["partner_count"], np.int64),
        **{name: int(out[name]) for name in STATS_NAMES})
    expression = (np.asarray(out["expression"], np.int64),
                  int(out["expression_threshold"]))
    return stats, expression, int(out["n_clusters"])


def worker_main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--store-port", type=int, required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), required=True)
    parser.add_argument("--shards-per-process", type=int, default=1)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=args.timeout)
    if args.device == "cuda":
        if args.rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {args.rank} has no CUDA device")
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        backend = "gloo"
    store = dist.TCPStore("127.0.0.1", args.store_port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=args.rank,
                            world_size=args.world_size, timeout=timeout)
    try:
        from ..ops.cluster import pack_keys
        from .dp import Mesh, sharded_cluster_step
        from .stats import run_stats_step, stats_from_outputs

        mesh = Mesh(args.shards_per_process, device, dist.group.WORLD)
        loaded = dict(np.load(args.input))

        # the candidate merge across the process boundary
        ckey = loaded.pop("cluster_keys")
        kind = loaded.pop("cluster_kind")
        valid = loaded.pop("cluster_valid")
        words = tuple(mesh.put(word.numpy()) for word in pack_keys(
            *(torch.from_numpy(column) for column in ckey)))
        clusters = sharded_cluster_step(mesh)(words, mesh.put(kind),
                                              mesh.put(valid))
        n_clusters = int(clusters["n_clusters"])

        # the mid-cascade statistics
        quantile = float(loaded.pop("quantile"))
        stats, (expression, threshold) = stats_from_outputs(
            run_stats_step(mesh, loaded), quantile)

        result = {
            "cluster_words": np.stack([word[:n_clusters].cpu().numpy()
                                       for word in clusters["words"]]),
            "cluster_support":
                clusters["support"][:n_clusters].cpu().numpy(),
            "n_clusters": np.int64(n_clusters),
            "expression": expression,
            "expression_threshold": np.int64(threshold),
            "partner_count": stats.partner_count,
        }
        for name in STATS_NAMES:
            result[name] = np.int64(getattr(stats, name))
        np.savez(args.output, **result)
    finally:
        dist.destroy_process_group()
    print(f"multihost worker {args.rank}/{args.world_size} ({backend}, "
          f"{mesh.size} shards): clusters={n_clusters}, "
          f"threshold={threshold}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(worker_main())
