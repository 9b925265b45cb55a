"""Keep JAX and the JAX package out of the benchmark's process.

The rule is the repository's own (`import_blocker.py`): a module whose
top-level name, the part before the first dot, is one of BLOCKED cannot be
imported. `arriba_tpu_torch`, the port, is another top-level name and is
not blocked. `install` runs before anything else is imported; `found`
checks `sys.modules` the same way once the window has closed.
"""

import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "flax", "arriba_tpu")


def blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"{name} may not be imported by the benchmark")
        return None


def install() -> None:
    if not any(isinstance(f, Block) for f in sys.meta_path):
        sys.meta_path.insert(0, Block())


def found() -> list:
    """The blocked modules that `sys.modules` holds."""
    return sorted(name for name in sys.modules if blocked(name))
