"""Test support: deterministic fault injection (``testing.chaos``) and
the cross-rank collective sanitizer (``testing.spmd_sanitizer``).
Import-light: nothing here imports torch at module scope (the sanitizer
patches ``torch.distributed`` only when ``install()`` runs)."""

from .chaos import (CHAOS_ENV, CHAOS_EXIT_CODE, CHAOS_NS_ENV, ChaosFault,
                    ChaosInjector, parse_chaos)
from .spmd_sanitizer import (SANITIZER_ENV, CollectiveMismatch,
                             SpmdSanitizer, check_collective_sequences)

__all__ = ["CHAOS_ENV", "CHAOS_EXIT_CODE", "CHAOS_NS_ENV", "ChaosFault",
           "ChaosInjector", "parse_chaos", "SANITIZER_ENV",
           "CollectiveMismatch", "SpmdSanitizer",
           "check_collective_sequences"]
