"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into ``build/arriba_tpu_torch/lib<name>.so``
(a plain C interface, no PyTorch headers) for ``sm_90a``. Builds happen at
first use, never at import: all stale sources compile in parallel, one nvcc
each, under an exclusive file lock, into temporary files renamed into
place. ``python -m arriba_tpu_torch.kernels.build`` builds them all and
prints what ptxas reports for each kernel (registers, shared memory,
spills).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import shutil
import subprocess
import sys
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
KERNELS = ("accept_wavefront", "low_entropy", "smith_waterman",
           "mxu_kmer_screen")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (argument types); each returns a cudaError_t
_SIGNATURES = {
    "accept_wavefront": ("arriba_accept_wavefront",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p]),
    "low_entropy": ("arriba_low_entropy",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p]),
    "smith_waterman": ("arriba_smith_waterman",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p]),
    "mxu_kmer_screen": ("arriba_mxu_kmer_screen",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p]),
}

_loaded: dict = {}


def build_dir() -> pathlib.Path:
    """``build/arriba_tpu_torch`` beside the package (gitignored)."""
    return CSRC.parent.parent.parent / "build" / "arriba_tpu_torch"


def library_path(name: str) -> pathlib.Path:
    return build_dir() / f"lib{name}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names=KERNELS) -> dict:
    """Compile every stale kernel library among ``names``, all at once.
    Returns {name: (seconds, ptxas report)} for the ones built here."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict = {}
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [name for name in names if _stale(name)]
            if not todo:
                return report
            compiler = nvcc()
            started = time.perf_counter()
            procs = {}
            for name in todo:
                partial = out_dir / f".lib{name}.{os.getpid()}.so"
                procs[name] = (partial, subprocess.Popen(
                    [compiler, *NVCC_FLAGS, "-o", str(partial),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            failures = []
            for name, (partial, proc) in procs.items():
                log = proc.communicate()[0].decode(errors="replace")
                if proc.returncode != 0:
                    failures.append(f"{name}:\n{log[-4000:]}")
                    continue
                os.replace(partial, library_path(name))
                report[name] = (time.perf_counter() - started, log)
            if failures:
                raise RuntimeError("nvcc failed\n" + "\n".join(failures))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return report


def load(name: str):
    """(launch, error_string) of the kernel's C entry points, built on first
    use: launch returns a cudaError_t code, error_string names it."""
    entry = _loaded.get(name)
    if entry is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        symbol, argtypes = _SIGNATURES[name]
        launch = getattr(lib, symbol)
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        error = getattr(lib, symbol + "_error")
        error.argtypes = [ctypes.c_int]
        error.restype = ctypes.c_char_p
        entry = _loaded[name] = (launch,
                                 lambda code: error(code).decode())
    return entry


if __name__ == "__main__":
    for kernel, (seconds, log) in build().items():
        print(f"built {kernel} in {seconds:.1f} s\n{log}", file=sys.stderr)
