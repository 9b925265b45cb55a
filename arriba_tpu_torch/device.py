"""Where the offloaded stages run: one switch, ARRIBA_TPU_TORCH_DEVICE.

- ``cuda`` (the default): offloaded stages run on ``torch.device("cuda")``
  through the hand-written kernels in ``kernels/``. Without a usable CUDA
  device this raises; it never continues on the CPU.
- ``cpu``: offloaded stages run their plain PyTorch versions on the CPU
  (what the tests use).
- ``off``: the host path, no offload at all.

There is no batch-size crossover and no fallback: every offloaded call site
raises on a device error instead of handing the work to the host.

ARRIBA_TPU_TORCH_SHARDED_STATS=<n> or <n>procs runs the mid-cascade
statistics over n row shards or n torch.distributed ranks of that device
(``sharded_stats``); it needs an offload device, so ``off`` refuses it.
"""

from __future__ import annotations

import os

ENV = "ARRIBA_TPU_TORCH_DEVICE"
MODES = ("cuda", "cpu", "off")


def mode() -> str:
    """The requested mode, validated."""
    value = os.environ.get(ENV, "cuda").strip().lower() or "cuda"
    if value not in MODES:
        raise RuntimeError(f"{ENV}={value!r} is not one of "
                           f"{', '.join(MODES)}")
    return value


def offload_enabled() -> bool:
    """True unless the host path was asked for (ARRIBA_TPU_TORCH_DEVICE=off)."""
    return mode() != "off"


def torch_device():
    """The torch.device offloaded stages run on; raises when the mode is
    ``cuda`` and no CUDA device is usable."""
    import torch

    requested = mode()
    if requested == "off":
        raise RuntimeError(f"{ENV}=off: no offload device")
    if requested == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{ENV}=cuda (the default) needs a CUDA device, and "
            f"torch.cuda.is_available() is false; set {ENV}=cpu to run the "
            f"plain PyTorch versions on the CPU or {ENV}=off for the host path")
    return torch.device("cuda")


SHARDED_STATS_ENV = "ARRIBA_TPU_TORCH_SHARDED_STATS"


def sharded_stats():
    """The layout ARRIBA_TPU_TORCH_SHARDED_STATS asks for: None (unset), or
    (n, procs) for ``<n>`` (n row shards in this process) and ``<n>procs``
    (n torch.distributed ranks; a bare ``procs`` means 2). The sharded
    statistics run on the offload device, so ``off`` refuses them."""
    value = os.environ.get(SHARDED_STATS_ENV, "").strip()
    if not value:
        return None
    procs = value.endswith("procs")
    digits = value[:-len("procs")] if procs else value
    if procs and not digits:
        digits = "2"
    if not digits.isdigit() or int(digits) < 1:
        raise RuntimeError(f"{SHARDED_STATS_ENV}={value!r} is not <n> or "
                           f"<n>procs with n >= 1")
    if mode() == "off":
        raise RuntimeError(f"{SHARDED_STATS_ENV}={value} needs an offload "
                           f"device, and {ENV}=off asks for none")
    return int(digits), procs


def check() -> None:
    """Fail early, before any work, when the requested device is missing or
    the sharded-statistics layout cannot run."""
    if offload_enabled():
        torch_device()
    sharded_stats()
