"""Data-parallel execution over row shards.

The reference is single-threaded (SURVEY §2.7); parallelism is a component
of its own here. The natural axis for a post-aligner is DP over reads:
per-read filter stages are embarrassingly parallel, while the cascade's
global statistics (mapped-read scaling for the e-value model, expression
quantiles, coverage) are cross-shard reductions.

PyTorch has no in-process device mesh, so ``Mesh`` is the port's own: it
holds ``n_local`` row shards on one torch.device, times the ranks of an
optional torch.distributed process group. Global shard s = rank * n_local
+ l owns rows [s * chunk, (s + 1) * chunk) of an array padded to a multiple
of the shard count, so ``all_gather`` results come rank-major and local-
shard-minor: the tiled order of a JAX mesh of the same size. A sharded step
runs its per-shard part on each local shard, then the collectives (a sum
over the local shards, then ``dist.all_reduce``; a concatenation of the
local shards, then ``dist.all_gather``), then the replicated global part.
Every reduced quantity is an integer, so the results are bit-identical for
every shard count and layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..ops import readfilters, realign
from ..ops.encode import PAD_CODE, ReadBatch, round_up


class Mesh:
    """``n_local`` row shards on ``device``; with a process group, the
    shards of every rank of it (NCCL for CUDA devices, gloo for the CPU)."""

    def __init__(self, n_local: int, device, group=None):
        if n_local < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_local}")
        self.n_local = n_local
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.rank, self.world_size = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.n_local * self.world_size

    def put(self, array: np.ndarray) -> torch.Tensor:
        """This process's rows of a host array whose row count is a multiple
        of the shard count, on the mesh's device."""
        if array.shape[0] % self.size:
            raise ValueError(f"{array.shape[0]} rows do not split into "
                             f"{self.size} shards")
        rows = array.shape[0] // self.size * self.n_local
        local = np.ascontiguousarray(array[self.rank * rows:
                                           (self.rank + 1) * rows])
        return trace.upload(local, self.device)

    def shards(self, tensor: torch.Tensor):
        """The local shards of this process's rows."""
        if tensor.shape[0] % self.n_local:
            raise ValueError(f"{tensor.shape[0]} rows do not split into "
                             f"{self.n_local} local shards")
        return tensor.split(tensor.shape[0] // self.n_local)

    def psum(self, parts) -> torch.Tensor:
        """The int64 sum of one partial per local shard over every shard of
        the mesh (gloo reduces no bool, so counts travel as int64)."""
        total = torch.stack([part.to(torch.int64) for part in parts]).sum(0)
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(total, group=self.group)
        return total

    def all_gather(self, parts) -> torch.Tensor:
        """One equal-shaped tensor per local shard, concatenated over every
        shard of the mesh in global shard order."""
        local = torch.cat(parts)
        if self.group is None:
            return local
        import torch.distributed as dist
        is_bool = local.dtype == torch.bool
        if is_bool:
            local = local.to(torch.uint8)
        gathered = [torch.empty_like(local) for _ in range(self.world_size)]
        dist.all_gather(gathered, local, group=self.group)
        out = torch.cat(gathered)
        return out.bool() if is_bool else out


def make_mesh(n_local: int = 1, device=None, group=None) -> Mesh:
    """A mesh of n_local shards on ``device`` (default: the device
    ARRIBA_TPU_TORCH_DEVICE selects), over ``group`` when given."""
    if device is None:
        from ..device import torch_device
        device = torch_device()
    return Mesh(n_local, device, group)


def shard_batch(batch: ReadBatch, mesh: Mesh) -> ReadBatch:
    """Pad the row axis to a multiple of 8 x the shard count and place this
    process's rows on the mesh's device (fields become torch tensors;
    n_reads stays the global count)."""
    N = round_up(batch.bases.shape[0], mesh.size * 8)

    def put(array: np.ndarray, fill) -> torch.Tensor:
        if array.shape[0] != N:
            widths = [(0, N - array.shape[0])] + [(0, 0)] * (array.ndim - 1)
            array = np.pad(array, widths, constant_values=fill)
        return mesh.put(array)

    return ReadBatch(bases=put(batch.bases, PAD_CODE),
                     ref=put(batch.ref, PAD_CODE),
                     match_mask=put(batch.match_mask, False),
                     length=put(batch.length, 0),
                     aligned_start=put(batch.aligned_start, 0),
                     aligned_end=put(batch.aligned_end, 0),
                     n_reads=batch.n_reads)


def per_shard(mesh: Mesh, fn, *tensors):
    """fn on each local shard of the tensors (split alike)."""
    return [fn(*shard) for shard in zip(*(mesh.shards(t) for t in tensors))]


def _cat(parts) -> dict:
    return {key: torch.cat([part[key] for part in parts])
            for key in parts[0]}


def sharded_read_filter_step(mesh: Mesh, mismatch_probability: float = 0.01,
                             pvalue_cutoff: float = 0.01,
                             kmer_content: float = 0.6):
    """The DP filter step over ``mesh``: per-read filter statistics on each
    shard, the global totals (reads, mismatches, aligned bases, discard
    counts) summed over every shard.

    Returns a function (bases, ref, match_mask, length, aligned_start,
    aligned_end, extra_mismatches) -> (per_read dict, globals dict), all
    on this process's rows."""

    def shard_step(bases, ref, match_mask, length, aligned_start,
                   aligned_end, extra_mismatches):
        per_read = readfilters.read_filter_step(
            bases, ref, match_mask, length, aligned_start, aligned_end,
            extra_mismatches, mismatch_probability=mismatch_probability,
            pvalue_cutoff=pvalue_cutoff, kmer_content=kmer_content)
        # the DP analog of the reference's global counters (mapped_reads
        # scaling, filter_relative_support.cpp:140-143)
        valid = length > 0
        partials = {
            "total_reads": valid.sum(),
            "total_mismatches": torch.where(
                valid, per_read["mismatches"], 0).sum(),
            "total_aligned": torch.where(
                valid, per_read["alignment_length"], 0).sum(),
            "discarded_mismatch": (per_read["mismatch_discard"]
                                   & valid).sum(),
            "discarded_entropy": (per_read["low_entropy_discard"]
                                  & valid).sum(),
        }
        return per_read, partials

    def step(*args):
        parts = per_shard(mesh, shard_step, *args)
        per_read = _cat([part[0] for part in parts])
        globals_ = {key: mesh.psum([part[1][key] for part in parts])
                    for key in parts[0][1]}
        return per_read, globals_

    return step


def sharded_realign_step(mesh: Mesh, min_score_fraction: float = 0.8):
    """The DP realignment prefilter and scoring step: each shard runs the
    seed test and the Smith-Waterman scores (K3 on the card) on its rows;
    the accept count is summed over every shard (the reference's
    count_mismappers tally, filter_mismappers.cpp:338-356).

    Returns a function (reads, windows, length) -> (result dict,
    total_alignable)."""

    def step(reads, windows, length):
        parts = per_shard(
            mesh, lambda r, w, n: realign.realign_step(
                r, w, n, min_score_fraction=min_score_fraction),
            reads, windows, length)
        total = mesh.psum([part["can_align"].sum() for part in parts])
        return _cat(parts), total

    return step


def sharded_cluster_step(mesh: Mesh):
    """Distributed fusion-candidate clustering: each shard aggregates its
    candidates (sort + segment-reduce, ops/cluster.py), the compact
    per-shard cluster tables are gathered from every shard, and a second
    aggregation merges them: the DP analog of merging per-host candidate
    tables before the global cascade stages (fusions.cpp:203-366 is the
    single-threaded original).

    Returns a function (words tuple, kind, valid) -> the global cluster
    dict, the same on every rank."""
    from ..ops import cluster

    def step(words, kind, valid):
        local = per_shard(
            mesh, lambda k, v, *w: cluster.cluster_candidates(w, k, v),
            kind, valid, *words)
        # cluster tables, not candidates, cross the shards
        gathered_words = tuple(
            mesh.all_gather([table["words"][i] for table in local])
            for i in range(len(words)))
        gathered_valid = mesh.all_gather(
            [table["cluster_valid"] for table in local])
        gathered_support = mesh.all_gather(
            [table["support"] for table in local])
        return cluster.merge_cluster_tables(gathered_words, gathered_support,
                                            gathered_valid)

    return step
