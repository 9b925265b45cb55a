"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into ``build/arriba_tpu_torch/lib<name>.so``
(a plain C interface, no PyTorch headers) for ``sm_90a``. Builds happen at
first use, never at import: all stale sources compile in parallel, one nvcc
each, under an exclusive file lock, into temporary files renamed into
place. ``python -m arriba_tpu_torch.kernels.build`` builds them all and
prints what ptxas reports for each kernel (registers, shared memory,
spills); ``--sass NAME`` then prints each kernel of lib<NAME>.so as
``cuobjdump -sass`` disassembles it: its instructions, and each
straight-line block of at least 100 (between two branches) with its
counts of shared-memory atomics, loads and stores.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
KERNELS = ("accept_wavefront", "low_entropy", "smith_waterman",
           "smith_waterman_wide", "mxu_kmer_screen", "kmer_bitmap_screen",
           "bam_ingest")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: name -> (symbol, argument types); each returns a
# cudaError_t. An entry point lives in lib<name>.so unless _LIBRARIES names
# another library.
_SIGNATURES = {
    "accept_wavefront": ("arriba_accept_wavefront",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p]),
    "accept_wavefront_indexed": ("arriba_accept_wavefront_indexed",
                                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                 + [ctypes.c_longlong] * 2
                                 + [ctypes.c_void_p]),
    "kmer_bitmap_build": ("arriba_kmer_bitmap_build",
                          [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                          + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p]),
    "kmer_bitmap_test": ("arriba_kmer_bitmap_test",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p]),
    "low_entropy": ("arriba_low_entropy",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p]),
    "low_entropy_long": ("arriba_low_entropy_long",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p]),
    "smith_waterman": ("arriba_smith_waterman",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p]),
    "smith_waterman_wide": ("arriba_smith_waterman_wide",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p]),
    "smith_waterman_wide16": ("arriba_smith_waterman_wide16",
                              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p]),
    "mxu_kmer_screen": ("arriba_mxu_kmer_screen",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p]),
    "mxu_kmer_screen_any_k": ("arriba_mxu_kmer_screen_any_k",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p]),
    "bgzf_inflate": ("arriba_bgzf_inflate",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 4),
    "bam_frame": ("arriba_bam_frame",
                  [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_void_p] * 8),
    "bam_pairs": ("arriba_bam_pairs",
                  [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                  + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] * 10),
    "bam_residue": ("arriba_bam_residue",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                    + [ctypes.c_void_p] * 9),
    "bam_coverage_finish": ("arriba_bam_coverage_finish",
                            [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                     ctypes.c_void_p]),
}
_LIBRARIES = {"accept_wavefront_indexed": "accept_wavefront",
              "kmer_bitmap_build": "kmer_bitmap_screen",
              "kmer_bitmap_test": "kmer_bitmap_screen",
              "mxu_kmer_screen_any_k": "mxu_kmer_screen",
              "smith_waterman_wide16": "smith_waterman_wide",
              "low_entropy_long": "low_entropy",
              "bgzf_inflate": "bam_ingest", "bam_frame": "bam_ingest",
              "bam_pairs": "bam_ingest", "bam_residue": "bam_ingest",
              "bam_coverage_finish": "bam_ingest"}

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
        library = _LIBRARIES.get(name, name)
        if _stale(library):
            build((library,))
        lib = ctypes.CDLL(str(library_path(library)))
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


def host_function(library: str, symbol: str, argtypes, restype):
    """A host-only C function of lib<library>.so, built on first use."""
    if _stale(library):
        build((library,))
    function = getattr(ctypes.CDLL(str(library_path(library))), symbol)
    function.argtypes, function.restype = argtypes, restype
    return function


def sass_summary(name: str) -> str:
    """Instruction counts of each kernel in lib<name>.so, from
    ``cuobjdump -sass`` (see the module note)."""
    cuobjdump = pathlib.Path(nvcc()).with_name("cuobjdump")
    listing = subprocess.run([str(cuobjdump), "-sass",
                              str(library_path(name))], check=True,
                             capture_output=True, text=True).stdout
    lines = []
    for function in re.split(r"\n\s*Function : ", listing)[1:]:
        title, body = function.split("\n", 1)
        code = re.findall(r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)"
                          r"[^;]*;", body)
        lines.append(f"{title.strip()}: {len(code)} instructions")
        block: collections.Counter = collections.Counter()
        start = 0
        for at, op in enumerate(code):
            block[op] += 1
            if op in ("BRA", "EXIT"):
                if at + 1 - start >= 100:
                    lines.append(
                        f"  block {start}-{at}: {at + 1 - start} "
                        f"instructions, ATOMS {block['ATOMS']}, LDS "
                        f"{block['LDS']}, STS {block['STS']}")
                block, start = collections.Counter(), at + 1
    return "\n".join(lines)


if __name__ == "__main__":
    for kernel, (seconds, log) in build().items():
        print(f"built {kernel} in {seconds:.1f} s\n{log}", file=sys.stderr)
    if sys.argv[1:2] == ["--sass"]:
        for kernel in sys.argv[2:]:
            print(sass_summary(kernel))
