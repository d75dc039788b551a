"""compile-guard: count this process's builds and budget them in blocks.

Port of the JAX package's ``analysis/compile_guard.py``.  There the
count is XLA backend compiles; PyTorch runs eagerly and compiles no
programs, so what the port counts is what it does build: its own
libraries, the CUDA kernels (nvcc, ``ops/_build.py``, at the first CUDA
use) and the host C++ (g++, ``native/__init__.py``, at the first use of
the shm store or the batch engine).  Both counts are per process and
count only compiler runs (a library found already built on disk takes
none).  A guard block turns "nothing builds once warm" into an
assertion:

    with compile_guard(max_new_compiles=0) as g:
        ...warm steps, or a warm engine's decode...
    # raises CompileBudgetExceeded past the budget; g.new_compiles holds
    # the actual count either way

The invariants the JAX package pins as program counts become "0 new
builds": the serve engine once warm, the Trainer after its first step.
The perf observatory's step timeline reads ``compile_seconds`` at step
boundaries to split a first-use build out of the step that triggered
it.  Counting is process-global: a guard sees builds from every thread.
"""

from __future__ import annotations

from typing import Optional


def compile_count() -> int:
    """Compiler runs (nvcc and g++) this process made (monotonic)."""
    from .. import native
    from ..ops import _build
    return _build.compile_stats()[0] + native.compile_stats()[0]


def compile_seconds() -> float:
    """Wall seconds of this process's builds that ran a compiler."""
    from .. import native
    from ..ops import _build
    return _build.compile_stats()[1] + native.compile_stats()[1]


class CompileBudgetExceeded(AssertionError):
    """A guarded block built more libraries than its budget."""


class compile_guard:
    """Context manager asserting a build budget over a block.

    ``max_new_compiles=None`` only records (``.new_compiles`` after
    exit).  On a budget violation raises ``CompileBudgetExceeded`` --
    unless the block is already unwinding with its own exception, which
    must not be masked."""

    def __init__(self, max_new_compiles: Optional[int] = None,
                 label: str = ""):
        self.max_new_compiles = max_new_compiles
        self.label = label
        self.start_count: Optional[int] = None
        self.new_compiles: Optional[int] = None

    def __enter__(self) -> "compile_guard":
        self.start_count = compile_count()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.new_compiles = compile_count() - self.start_count
        if exc_type is None and self.max_new_compiles is not None \
                and self.new_compiles > self.max_new_compiles:
            what = f" [{self.label}]" if self.label else ""
            raise CompileBudgetExceeded(
                f"compile budget exceeded{what}: {self.new_compiles} new "
                f"builds (nvcc / g++) in a block budgeted for "
                f"{self.max_new_compiles} -- something builds a library on "
                "a warm path (see the lint's rebuild rule)")
        return False


def assert_no_new_compiles(label: str = "") -> compile_guard:
    """Sugar for the steady-state invariant: zero builds once warm."""
    return compile_guard(max_new_compiles=0, label=label)


def compile_count_record(probe: str,
                         window_start: Optional[int] = None) -> dict:
    """The line a probe prints beside its metric line, so a build on a
    warm path shows even where nothing asserts.  ``window_start`` (a
    ``compile_count()`` taken after warmup) adds the measured window's
    delta, 0 in a healthy run."""
    total = compile_count()
    rec = {"probe": probe, "kind": "compile_count",
           "total_backend_compiles": total}
    if window_start is not None:
        rec["measured_window_compiles"] = total - window_start
    return rec
