"""Compile counts: how many builds this process made, and their seconds.

Port of ``compile_count`` / ``compile_seconds`` from the JAX package's
``analysis/compile_guard.py``.  PyTorch runs eagerly, so the port
compiles no programs; what it does build are its own libraries: the
CUDA kernels (nvcc, ``ops/_build.py``, at the first CUDA use) and the
host C++ (g++, ``native/__init__.py``, at the first use of the shm
store or the batch engine).  Both counts are per process, count only
compiler runs (a library found already built on disk takes none), and
are 0 on a CPU-only machine until a native library is first built.  The
perf observatory's step timeline reads ``compile_seconds`` at step
boundaries to split a first-use build out of the step that triggered
it.  The compile guard itself (a budget over a block) comes with a later
slice.
"""

from __future__ import annotations


def compile_count() -> int:
    """Compiler runs (nvcc and g++) this process made."""
    from .. import native
    from ..ops import _build
    return _build.compile_stats()[0] + native.compile_stats()[0]


def compile_seconds() -> float:
    """Wall seconds of this process's builds that ran a compiler."""
    from .. import native
    from ..ops import _build
    return _build.compile_stats()[1] + native.compile_stats()[1]
