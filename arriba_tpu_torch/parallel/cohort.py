"""Cohort batch execution: many samples across processes and hosts.

The reference processes one sample per process; scaling to cohorts is left
to the user's scheduler. Here cohort runs are a first-class mode: samples
are embarrassingly parallel, so they shard across worker processes on one
host (and across hosts by partitioning the manifest — each host runs the
slice ``host_index::n_hosts``). Each sample runs as its own
``python -m arriba_tpu_torch`` process, which inherits the environment:
ARRIBA_TPU_TORCH_DEVICE and the other ARRIBA_TPU_TORCH_* variables
configure every worker, so by default each one offloads to the card and
holds its own CUDA context there.

Manifest format (TSV, # comments allowed):
    sample_id <tab> alignments <tab> output_dir [<tab> extra flags...]
Common inputs (-g/-a/-b/...) come from the cohort-level arguments.
"""

from __future__ import annotations

import multiprocessing
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class CohortSample:
    sample_id: str
    alignments: str
    output_dir: str
    extra_args: List[str]


def read_manifest(path: str) -> List[CohortSample]:
    samples = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            if len(fields) < 3:
                raise ValueError(f"manifest line needs >=3 columns: {line}")
            samples.append(CohortSample(fields[0], fields[1], fields[2],
                                        fields[3:]))
    return samples


def _run_sample(sample: CohortSample, common_args: List[str]) -> Tuple[str, int, str]:
    os.makedirs(sample.output_dir, exist_ok=True)
    output = os.path.join(sample.output_dir, "fusions.tsv")
    discarded = os.path.join(sample.output_dir, "fusions.discarded.tsv")
    log_path = os.path.join(sample.output_dir, "run.log")
    command = [sys.executable, "-m", "arriba_tpu_torch",
               "-x", sample.alignments, "-o", output, "-O", discarded] \
        + common_args + sample.extra_args
    with open(log_path, "w") as log:
        result = subprocess.run(command, stdout=log, stderr=subprocess.STDOUT)
    return sample.sample_id, result.returncode, output


def run_cohort(manifest_path: str, common_args: List[str], processes: int = 4,
               host_index: int = 0, n_hosts: int = 1) -> Dict[str, Tuple[int, str]]:
    """Run every sample of the manifest slice for this host; returns
    {sample_id: (returncode, fusions_path)}."""
    samples = read_manifest(manifest_path)[host_index::n_hosts]
    results: Dict[str, Tuple[int, str]] = {}
    # spawn context: a forked child of a process that has created a CUDA
    # context cannot use the card (CUDA does not survive fork), and the
    # caller may have one
    with ProcessPoolExecutor(max_workers=processes,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(_run_sample, sample, common_args): sample
                   for sample in samples}
        for future in as_completed(futures):
            sample_id, returncode, output = future.result()
            results[sample_id] = (returncode, output)
            status = "ok" if returncode == 0 else f"FAILED rc={returncode}"
            print(f"[cohort] {sample_id}: {status}", flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1 or argv[0] in ("-h", "--help"):
        print("Usage: python -m arriba_tpu_torch.parallel.cohort manifest.tsv "
              "[--processes N] [--host-index I --n-hosts H] -- <common flags>",
              file=sys.stderr)
        return 1
    manifest = argv[0]
    processes = 4
    host_index, n_hosts = 0, 1
    rest = argv[1:]
    common: List[str] = []
    i = 0
    while i < len(rest):
        if rest[i] == "--processes":
            processes = int(rest[i + 1]); i += 2
        elif rest[i] == "--host-index":
            host_index = int(rest[i + 1]); i += 2
        elif rest[i] == "--n-hosts":
            n_hosts = int(rest[i + 1]); i += 2
        elif rest[i] == "--":
            common = rest[i + 1:]; break
        else:
            print(f"unknown cohort option: {rest[i]}", file=sys.stderr)
            return 1
    results = run_cohort(manifest, common, processes, host_index, n_hosts)
    return 0 if all(rc == 0 for rc, _ in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
