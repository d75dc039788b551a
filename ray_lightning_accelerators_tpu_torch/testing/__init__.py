"""Test support: deterministic fault injection (``testing.chaos``).
Import-light: nothing here imports torch at module scope.  The SPMD
collective sanitizer of the JAX package's ``testing/`` comes with the
analysis slice (5e)."""

from .chaos import (CHAOS_ENV, CHAOS_EXIT_CODE, CHAOS_NS_ENV, ChaosFault,
                    ChaosInjector, parse_chaos)

__all__ = ["CHAOS_ENV", "CHAOS_EXIT_CODE", "CHAOS_NS_ENV", "ChaosFault",
           "ChaosInjector", "parse_chaos"]
