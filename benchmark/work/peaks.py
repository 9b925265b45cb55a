"""The table of peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
limit, against which the rooflines are read. Frozen from chip_smoke.py at
commit 900208e (lines 176-183).

- MEMORY_BYTES_PER_S: HBM3 bandwidth, 3.35 TB/s (NVIDIA's data sheet).
- INT_OPS_PER_S: the 32-bit integer rate the kernels' work runs at, a
  derived peak and not a published one: 64 integer adds, compares,
  min/max, logic operations or shifts a clock per SM (CUDA C++ Programming
  Guide, arithmetic instruction throughput, compute capability 9.0) x 132
  SMs x the H100 SXM's 1,980 MHz maximum SM clock = 16.73 T/s. (The data
  sheet's 67 TFLOP/s counts float32 fused multiply-adds, four times the
  integer rate.)
"""

MEMORY_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT_PER_CLOCK = 64
SMS = 132
INT_OPS_PER_S = INT_PER_CLOCK * SMS * SM_CLOCK_HZ


def bound_s(n_bytes: float, n_ops: float) -> tuple:
    """The least time the chip could take: (seconds, "bytes" or
    "operations"), the larger of bytes over the memory rate and
    operations over the integer rate."""
    byte_s = n_bytes / MEMORY_BYTES_PER_S
    op_s = n_ops / INT_OPS_PER_S
    return (byte_s, "bytes") if byte_s >= op_s else (op_s, "operations")
