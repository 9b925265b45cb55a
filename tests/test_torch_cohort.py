"""The port's cohort runner (arriba_tpu_torch/parallel/cohort.py): every
sample of a manifest through ``python -m arriba_tpu_torch`` in worker
processes, with jax and the JAX package made unimportable in the runner and
in every process it starts; each sample's outputs must be byte-equal to
``python -m arriba_tpu`` on that sample. Also the manifest slicing across
hosts, the manifest's and the command line's errors, and the file locks
that let several workers reach the kernels' and the native engine's first
build at once."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from . import scenario
from .torch_cli import BLOCKER, REPO, run_cli

# the cohort runner's main() with the blocker installed here and, through a
# sitecustomize on PYTHONPATH, in every Python process it starts
BLOCKED_COHORT = BLOCKER + r"""
import shutil
import tempfile

site = tempfile.mkdtemp(prefix="torch_cohort_site_")
with open(os.path.join(site, "sitecustomize.py"), "w") as handle:
    handle.write(BLOCKER_SOURCE)
os.environ["PYTHONPATH"] = os.pathsep.join(
    [site] + [p for p in [os.environ.get("PYTHONPATH")] if p])
from arriba_tpu_torch.parallel import cohort

try:
    status = cohort.main(sys.argv[1:])
finally:
    shutil.rmtree(site, ignore_errors=True)
sys.exit(status)
""".replace("BLOCKER_SOURCE", repr(BLOCKER))


def _run_cohort(argv, env_extra=None):
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("ARRIBA_TPU")}
    env.update(JAX_PLATFORMS="cpu", ARRIBA_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p]),
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", BLOCKED_COHORT]
                          + [str(a) for a in argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _split(args):
    """(alignments, every other flag) of a scenario sample's arguments."""
    i = args.index("-x")
    return args[i + 1], args[:i] + args[i + 2:]


def test_cohort_outputs_match_the_jax_package(tmp_path):
    """Two samples, two worker processes, on the CPU; each sample's own
    -g/-a/-b flags ride in the manifest's extra columns, one common flag
    (-U) on the command line."""
    lines, expected = [], {}
    for sample_id, seed in (("s1", 7), ("s2", 8)):
        sample_dir = tmp_path / sample_id
        sample_dir.mkdir()
        args = scenario.translocation_sample(sample_dir, seed=seed)
        rc, fusions, discarded, _, err = run_cli(
            "arriba_tpu", args + ["-U", "100"], sample_dir, "jax",
            {"ARRIBA_TPU_DEVICE": "1"})
        assert rc == 0, err[-2000:]
        expected[sample_id] = (fusions, discarded)
        alignments, flags = _split(args)
        lines.append("\t".join([sample_id, alignments,
                                str(tmp_path / f"out_{sample_id}")] + flags))
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text("# sample\talignments\toutput\n\n"
                        + "\n".join(lines) + "\n")
    result = _run_cohort([manifest, "--processes", "2", "--", "-U", "100"])
    assert result.returncode == 0, result.stdout + result.stderr[-2000:]
    assert sorted(result.stdout.split("\n")[:2]) == [
        "[cohort] s1: ok", "[cohort] s2: ok"]
    for sample_id, (fusions, discarded) in expected.items():
        out = tmp_path / f"out_{sample_id}"
        assert (out / "fusions.tsv").read_bytes() == fusions
        assert (out / "fusions.discarded.tsv").read_bytes() == discarded
        assert fusions.count(b"\n") == 2          # header and one call
        assert "may not be imported" not in (out / "run.log").read_text()


@pytest.mark.parametrize("n_hosts,host_index", [(2, 0), (2, 1), (3, 2)])
def test_cohort_host_slice(tmp_path, monkeypatch, n_hosts, host_index):
    """Host i of n runs manifest lines i, i + n, ...; a sample that fails
    (here: its alignments do not exist) is reported and fails the run."""
    from arriba_tpu_torch.parallel import cohort

    ids = [f"s{k}" for k in range(5)]
    manifest = tmp_path / "cohort.tsv"
    manifest.write_text("".join(
        f"{sample_id}\t{tmp_path}/missing_{sample_id}.sam\t"
        f"{tmp_path}/out_{sample_id}\n" for sample_id in ids))
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    results = cohort.run_cohort(str(manifest), [], processes=2,
                                host_index=host_index, n_hosts=n_hosts)
    assert sorted(results) == ids[host_index::n_hosts]
    for sample_id, (rc, output) in results.items():
        assert rc != 0
        assert output == f"{tmp_path}/out_{sample_id}/fusions.tsv"
        assert (tmp_path / f"out_{sample_id}" / "run.log").exists()
    ran = sorted(p.name[4:] for p in tmp_path.glob("out_*"))
    assert ran == ids[host_index::n_hosts]
    status = cohort.main([str(manifest), "--processes", "1", "--host-index",
                          str(host_index), "--n-hosts", str(n_hosts)])
    assert status == 1


def test_cohort_manifest_and_option_errors(tmp_path, capsys):
    from arriba_tpu_torch.parallel import cohort

    manifest = tmp_path / "cohort.tsv"
    manifest.write_text("# comment\n\ns1\ta.sam\tout1\t-U\t100\n"
                        "s2\tb.sam\n")
    with pytest.raises(ValueError, match="needs >=3 columns"):
        cohort.read_manifest(str(manifest))
    manifest.write_text("# comment\n\ns1\ta.sam\tout1\t-U\t100\n")
    (sample,) = cohort.read_manifest(str(manifest))
    assert (sample.sample_id, sample.alignments, sample.output_dir,
            sample.extra_args) == ("s1", "a.sam", "out1", ["-U", "100"])
    assert cohort.main([]) == 1
    assert cohort.main(["--help"]) == 1
    assert "Usage: python -m arriba_tpu_torch.parallel.cohort" in \
        capsys.readouterr().err
    assert cohort.main([str(manifest), "--bogus"]) == 1
    assert "unknown cohort option: --bogus" in capsys.readouterr().err


# a stand-in for nvcc or g++: logs its call, sleeps, writes its -o target
FAKE_COMPILER = textwrap.dedent("""\
    #!/usr/bin/env python3
    import os, sys, time
    with open(os.environ["FAKE_COMPILER_LOG"], "a") as log:
        log.write(" ".join(sys.argv[1:]) + "\\n")
    time.sleep(1.0)
    open(sys.argv[sys.argv.index("-o") + 1], "wb").write(b"built")
    """)

# two builds started together in separate processes; each prints what it
# compiled
KERNEL_BUILD = textwrap.dedent("""\
    import json, pathlib, sys
    from arriba_tpu_torch.kernels import build
    build.build_dir = lambda: pathlib.Path(sys.argv[1])
    print(json.dumps(sorted(build.build(("low_entropy", "smith_waterman")))))
    """)

NATIVE_BUILD = textwrap.dedent("""\
    import json, pathlib, subprocess, sys
    from arriba_tpu_torch import _native_build as nb
    nb.PACKAGE_DIR = pathlib.Path(sys.argv[1])
    compiled = []

    def compile_(work, output):
        subprocess.run(["cc-stand-in", "-o", str(output)], check=True)
        compiled.append(output.name)

    nb._compile = compile_
    print(json.dumps([str(nb.ensure_built().relative_to(nb.PACKAGE_DIR)),
                      compiled]))
    """)


@pytest.mark.parametrize("which", ["kernels", "native"])
def test_concurrent_first_builds_compile_once(tmp_path, which):
    """Several cohort workers may find a build stale at once: the second
    waits on the file lock, then finds the first one's result in place and
    compiles nothing (kernels/build.py, _native_build.py)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("nvcc", "cc-stand-in"):
        (bin_dir / name).write_text(FAKE_COMPILER)
        (bin_dir / name).chmod(0o755)
    log = tmp_path / "compiler.log"
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               FAKE_COMPILER_LOG=str(log), ARRIBA_TPU_TORCH_NO_NATIVE="1")
    script = KERNEL_BUILD if which == "kernels" else NATIVE_BUILD
    procs = [subprocess.Popen([sys.executable, "-c", script, str(out_dir)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    reports = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr[-2000:]
        reports.append(json.loads(stdout))
    calls = log.read_text().splitlines()
    if which == "kernels":
        # one nvcc per kernel, all by the first process to take the lock
        assert len(calls) == 2
        assert sorted(reports) == [[], ["low_entropy", "smith_waterman"]]
        for name in ("low_entropy", "smith_waterman"):
            assert (out_dir / f"lib{name}.so").read_bytes() == b"built"
    else:
        assert len(calls) == 1
        targets = {target for target, _ in reports}
        assert len(targets) == 1
        assert sorted(len(compiled) for _, compiled in reports) == [0, 1]
        assert (out_dir / targets.pop()).read_bytes() == b"built"
    assert not list(out_dir.glob(".lib*")) and not list(
        out_dir.glob(".native_build_*"))
