"""A meta-path finder that makes jax, jaxlib and the JAX package
(arriba_tpu) unimportable. It is not imported: the checks that the PyTorch
port imports none of them prepend this file's text to the scripts they run
and write it into a sitecustomize for the processes those start
(tests/torch_cli.py, chip_smoke.py)."""

import importlib.abc
import os
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "arriba_tpu"):
            raise ImportError(name + " may not be imported by the port")
        return None


sys.meta_path.insert(0, Block())
