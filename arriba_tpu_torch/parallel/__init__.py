"""Data-parallel execution: row shards over one device and over processes.

``dp.py`` holds the mesh (``Mesh``: n local row shards on one torch.device,
optionally times the ranks of a torch.distributed process group) and the
sharded read-filter, realignment and candidate-cluster steps; ``stats.py``
the mid-cascade global statistics as psum / all_gather reductions;
``multihost.py`` the same reductions across worker processes (NCCL on the
card, gloo on the CPU); ``cohort.py`` many samples, one
``python -m arriba_tpu_torch`` process each.
"""
