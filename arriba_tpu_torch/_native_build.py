"""Build the native engine for this package, and decide whether it runs.

``engine()`` is the one place that decides: every module that calls the
engine asks it, once a process, and gets the loaded ``_native`` module or
None (the pure-Python engine). The engine is the same ``native/*.cpp`` the
JAX package builds (its init symbol is ``PyInit__native``, so it loads
under either package name); this module compiles it into
``arriba_tpu_torch/_native<EXT_SUFFIX>`` at first import when it is missing
or older than its sources.

The flags are those of ``native/build.sh``. Each source compiles in its own
g++ process, all started together, then one link. Several processes may
reach the first import at once (``pytest -n 6``), so the build runs under
an exclusive ``fcntl`` lock, into a temporary file that is renamed into
place.
"""

from __future__ import annotations

import fcntl
import importlib
import os
import pathlib
import subprocess
import sys
import sysconfig
import tempfile

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCES = ("ingest.cpp", "gtf.cpp", "realign.cpp", "annotate.cpp",
           "filters.cpp", "cascade.cpp", "fusions.cpp", "event.cpp",
           "extract.cpp", "codecs.cpp")
CXXFLAGS = ("-O3", "-g", "-fPIC", "-std=c++17")

# The engine functions the port calls. A build from native/ defines them
# all; a module that lacks any of them is not used at all.
FUNCTIONS = (
    "annotate_bind", "annotate_bulk", "annotate_store_phase1",
    "annotate_store_phase2", "assign_strands_native", "cascade_begin",
    "cascade_begin_retained", "cascade_finish", "cascade_low_entropy_rows",
    "cascade_set_filters", "codec_rans4x8", "codec_rans4x16",
    "coverage_add", "coverage_bind", "detect_strandedness_native",
    "ev_assign_confidence", "ev_bind_transcript_tables", "ev_blacklist",
    "ev_both_intronic", "ev_end_to_end", "ev_estimate_expected",
    "ev_get_transcripts", "ev_homologs", "ev_in_vitro",
    "ev_intragenic_exonic", "ev_known_fusions", "ev_make_kmer_index",
    "ev_marginal_read_through", "ev_merge_adjacent", "ev_min_support",
    "ev_mismappers", "ev_multimappers", "ev_no_coverage",
    "ev_no_genomic_support", "ev_non_coding_neighbors",
    "ev_recover_both_spliced", "ev_recover_genomic_support",
    "ev_recover_isoforms", "ev_recover_itd", "ev_recover_many_spliced",
    "ev_relative_support", "ev_select_best", "ev_short_anchor",
    "ev_transcript_consensus", "ev_transcript_consensus_batch",
    "ev_write_discarded", "event_bind", "event_export", "event_release",
    "extract_cluster_ids", "extract_export_all", "extract_export_fragment",
    "extract_fill_names", "extract_fragment_filters", "extract_release",
    "extract_supporting_reads", "fasta_bodies", "find_fusions_native",
    "gene_index_bind", "gtf_parse", "realign_add_kmers", "realign_align",
    "realign_finalize", "realign_is_homolog", "realign_reset",
    "realign_set_contig", "realign_set_splice_sites", "scan_open",
    "scan_sam", "tandem_scan")

_decided = False
_engine = None


def target() -> pathlib.Path:
    return PACKAGE_DIR / ("_native" + sysconfig.get_config_var("EXT_SUFFIX"))


def _inputs():
    return [NATIVE_DIR / name for name in SOURCES] + sorted(
        NATIVE_DIR.glob("*.h"))


def up_to_date() -> bool:
    out = target()
    if not out.exists():
        return False
    newest = max((p.stat().st_mtime for p in _inputs() if p.exists()),
                 default=0.0)
    return out.stat().st_mtime >= newest


def _compile(workdir: pathlib.Path, output: pathlib.Path) -> None:
    include = sysconfig.get_paths()["include"]
    procs = []
    objects = []
    for name in SOURCES:
        obj = workdir / (name[:-4] + ".o")
        objects.append(str(obj))
        procs.append((name, subprocess.Popen(
            ["g++", *CXXFLAGS, f"-I{include}", "-c",
             str(NATIVE_DIR / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')[-4000:]}")
    if failures:
        raise RuntimeError("native build failed\n" + "\n".join(failures))
    libs = ["-lz"] + (["-ldeflate"] if os.path.exists(
        "/usr/include/libdeflate.h") else [])
    subprocess.run(["g++", *CXXFLAGS, "-shared", *objects, "-o",
                    str(output), *libs], check=True, capture_output=True)


def ensure_built() -> pathlib.Path:
    """Build the engine unless an up-to-date one is in place."""
    out = target()
    if up_to_date():
        return out
    lock_path = PACKAGE_DIR / ".native_build.lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if up_to_date():  # another process built it while we waited
                return out
            with tempfile.TemporaryDirectory(
                    prefix=".native_build_", dir=PACKAGE_DIR) as work:
                work = pathlib.Path(work)
                partial = work / out.name
                _compile(work, partial)
                os.replace(partial, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _pure_python(reason: str) -> None:
    print(f"WARNING: {reason}; using the pure-Python engine", file=sys.stderr)


def checked(module):
    """module when it defines every name of FUNCTIONS, else None (with the
    pure-Python engine's warning)."""
    missing = [name for name in FUNCTIONS if not hasattr(module, name)]
    if missing:
        _pure_python(f"arriba_tpu_torch._native lacks {', '.join(missing)}")
        return None
    return module


def engine():
    """The loaded native engine, or None for the pure-Python engine:
    None under ARRIBA_TPU_TORCH_NO_NATIVE=1, when the build or the import
    fails, or when the module lacks a name of FUNCTIONS. Decided at the
    first call and kept for the life of the process."""
    global _decided, _engine
    if not _decided:
        _decided = True
        if os.environ.get("ARRIBA_TPU_TORCH_NO_NATIVE") != "1":
            try:
                ensure_built()
                module = importlib.import_module(__package__ + "._native")
            except Exception as error:  # noqa: BLE001 - the Python engine runs
                _pure_python(
                    f"could not build arriba_tpu_torch._native ({error})")
            else:
                _engine = checked(module)
    return _engine


if __name__ == "__main__":
    print(ensure_built(), file=sys.stderr)
