"""The benchmark of arriba_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result (harness.py).
"""

import time

STARTED = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this directory: the benchmark is the
# package `benchmark`, the program `arriba_tpu_torch`
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from benchmark import blocker  # noqa: E402

blocker.install()

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
