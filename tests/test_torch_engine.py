"""The one owner of the engine choice (arriba_tpu_torch/_native_build.engine):
it hands every module the same native engine or None, refuses a module that
lacks a function the port calls, and no other module reads the pure-Python
switch or probes the engine for a function."""

import os
import pathlib
import re
import subprocess
import sys
import types

import pytest

from arriba_tpu_torch import _native_build
from arriba_tpu_torch.filters import mismappers
from arriba_tpu_torch.ingest import chimeric

PACKAGE = pathlib.Path(_native_build.__file__).resolve().parent
REPO = PACKAGE.parent
OWNER = PACKAGE / "_native_build.py"
DELETED_SWITCHES = ("ARRIBA_TPU_TORCH_NO_NATIVE_CASCADE",
                    "ARRIBA_TPU_TORCH_NO_NATIVE_EXTRACT",
                    "ARRIBA_TPU_TORCH_NO_NATIVE_RETAIN",
                    "ARRIBA_TPU_TORCH_SHARDS",
                    "ARRIBA_TPU_TORCH_SHARD_TIMING",
                    "ARRIBA_TPU_TORCH_SHARD_STRIPE_KB",
                    "ARRIBA_TPU_TORCH_SHARD_FAIL")


def _sources():
    return sorted(PACKAGE.rglob("*.py"))


def test_every_module_gets_the_owners_engine(monkeypatch):
    native = _native_build.engine()
    if native is None:
        pytest.skip("the native engine is not built")
    assert native.__name__ == "arriba_tpu_torch._native"
    assert chimeric._native is native
    assert mismappers._native is native
    assert _native_build.checked(native) is native
    # decided once: a later switch does not change the answer
    monkeypatch.setenv("ARRIBA_TPU_TORCH_NO_NATIVE", "1")
    assert _native_build.engine() is native


@pytest.mark.parametrize("missing", [_native_build.FUNCTIONS[0], "scan_sam",
                                     _native_build.FUNCTIONS[-1]])
def test_a_module_lacking_a_listed_function_is_not_used(capsys, missing):
    stub = types.ModuleType("stub")
    for name in _native_build.FUNCTIONS:
        if name != missing:
            setattr(stub, name, lambda *args: None)
    assert _native_build.checked(stub) is None
    err = capsys.readouterr().err
    assert "using the pure-Python engine" in err
    assert missing in err


def test_the_switch_gives_every_module_the_pure_python_engine():
    script = ("from arriba_tpu_torch import _native_build\n"
              "from arriba_tpu_torch.filters import mismappers\n"
              "from arriba_tpu_torch.ingest import chimeric\n"
              "print(_native_build.engine(), chimeric._native,"
              " mismappers._native)\n")
    env = dict(os.environ, ARRIBA_TPU_TORCH_NO_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.split() == ["None", "None", "None"]


def test_only_the_owner_reads_the_pure_python_switch():
    switch = re.compile(r"ARRIBA_TPU_TORCH_NO_NATIVE(?![A-Z_])")
    readers = [path.relative_to(PACKAGE) for path in _sources()
               if switch.search(path.read_text())]
    assert readers == [OWNER.relative_to(PACKAGE)]


@pytest.mark.parametrize("switch", DELETED_SWITCHES)
def test_a_deleted_switch_appears_nowhere(switch):
    pattern = re.compile(re.escape(switch) + r"(?![A-Z_])")
    assert [path.relative_to(PACKAGE) for path in _sources()
            if pattern.search(path.read_text())] == []


def test_no_module_probes_the_engine_for_a_function():
    probe = re.compile(r"hasattr\(\s*[\w.]*native|"
                       r"getattr\(\s*[\w.]*native[\w.]*\s*,[^,()]*,")
    probes = [f"{path.relative_to(PACKAGE)}:{number}"
              for path in _sources() if path != OWNER
              for number, line in enumerate(path.read_text().splitlines(), 1)
              if probe.search(line)]
    assert probes == []
