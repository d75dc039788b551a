"""Static analysis and runtime guards: the port's prose invariants,
enforced.  Port of the JAX package's ``analysis/``.

- **graftlint** (``lint.py`` + ``rules/``): an AST analyzer, recast for
  PyTorch, that checks the invariants the port's fast paths rely on: no
  host syncs in the step and decode loops, no library build or load on
  a warm path, no autograd graph kept past a step, every ``RLA_TPU_*``
  knob declared in ``knobs``, every typed exception a worker raises
  rebuildable over the wire (``runtime/wire.py``), and the SPMD pass:
  each collective's process group is a mesh axis's group, the world or
  None, no rank-divergent control flow around collectives, barriers or
  checkpoint commits, no spec constructor off the audited sharding
  surface (``scripts/torch_sharding_audit.py``).  CLI:
  ``scripts/torch_graftlint.py`` (``--format json``).
- **compile-guard** (``compile_guard.py``): a count of this process's
  builds (nvcc, g++), so a test or a probe can assert "this block builds
  nothing" once warm.

``knobs`` is imported eagerly (it is a leaf: stdlib only); the analyzer
and the guard load lazily.
"""

from . import knobs  # noqa: F401  (leaf module: registry + typed getters)

__all__ = ["knobs", "lint", "compile_guard"]


def __getattr__(name):
    if name in ("lint", "compile_guard"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
