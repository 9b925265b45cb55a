"""Run ``python -m arriba_tpu`` and ``python -m arriba_tpu_torch`` on a
sample as subprocesses and collect what must be byte-equal between them:
fusions.tsv, fusions.discarded.tsv and the stage counters."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNTER = re.compile(r"\((?:remaining|total|marked)=\d+\)")

# A meta-path finder that makes jax, jaxlib and the JAX package unimportable.
BLOCKER = (REPO / "import_blocker.py").read_text()

# The port's CLI with the blocker installed, in its own process and, through
# a sitecustomize on PYTHONPATH, in every Python process it starts (the
# multihost workers); with a count of the calls that reach the port's device
# ops, printed to stderr as one "DEVICE_CALLS {...}" line. With
# TORCH_CLI_WORKER_EXIT=<code> in the environment, every process it starts
# exits at once with that code (a failing worker).
BLOCKED_IMPORT_WRAPPER = BLOCKER + r"""
import json
import shutil
import tempfile

site = tempfile.mkdtemp(prefix="torch_cli_site_")
with open(os.path.join(site, "sitecustomize.py"), "w") as handle:
    handle.write(BLOCKER_SOURCE + "\n"
                 "if os.environ.get('TORCH_CLI_WORKER_EXIT'):\n"
                 "    os._exit(int(os.environ['TORCH_CLI_WORKER_EXIT']))\n")
os.environ["PYTHONPATH"] = os.pathsep.join(
    [site] + [p for p in [os.environ.get("PYTHONPATH")] if p])

from arriba_tpu_torch import cli
from arriba_tpu_torch.ops import readfilters, realign

calls = {}


def count(module, name):
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return inner(*args, **kwargs)

    setattr(module, name, wrapped)


for module, name in ((realign, "kmer_bitmap_screen"),
                     (realign, "accept_wavefront_indexed"),
                     (readfilters, "_low_entropy_core_packed")):
    count(module, name)
try:
    status = cli.main(sys.argv[1:])
finally:
    shutil.rmtree(site, ignore_errors=True)
print("DEVICE_CALLS " + json.dumps(calls), file=sys.stderr)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "arriba_tpu"))
print("BLOCKED_LOADED " + json.dumps(loaded), file=sys.stderr)
sys.exit(status)
""".replace("BLOCKER_SOURCE", repr(BLOCKER))


def run_cli(package, args, out_dir, label, env_extra, wrapper=None):
    """(returncode, fusions bytes, discarded bytes, counters, stderr) of one
    CLI run. Every ARRIBA_TPU* variable of the calling environment is
    dropped first, so only env_extra configures the run."""
    out = pathlib.Path(out_dir) / f"{label}.tsv"
    discarded = pathlib.Path(out_dir) / f"{label}.discarded.tsv"
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("ARRIBA_TPU")}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    command = [sys.executable] + (["-c", wrapper] if wrapper
                                  else ["-m", package])
    result = subprocess.run(
        command + list(args) + ["-o", str(out), "-O", str(discarded)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    read = (lambda p: p.read_bytes() if p.exists() else None)
    return (result.returncode, read(out), read(discarded),
            COUNTER.findall(result.stdout), result.stderr)


def assert_same_outputs(jax_run, torch_run):
    jax_rc, jax_fusions, jax_discarded, jax_counters, jax_err = jax_run
    rc, fusions, discarded, counters, err = torch_run
    assert jax_rc == 0, jax_err[-2000:]
    assert rc == 0, err[-2000:]
    assert counters and counters == jax_counters
    assert fusions == jax_fusions
    assert discarded == jax_discarded
