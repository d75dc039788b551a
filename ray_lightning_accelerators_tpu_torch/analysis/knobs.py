"""Environment knobs the port reads, with the JAX package's names and
defaults.

Port of the part of the JAX package's ``analysis/knobs.py``
the serve engine and the trainer read: the two chunked-prefill quanta,
the KV-handoff wave bound, the five SLO knobs and the default
sequence-parallel mode.  Reads go through the registry, so an
unregistered name fails loudly, and a malformed value warns and falls
back to the default, as there.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

log = logging.getLogger("rla_tpu_torch")

# name -> (default, help)
KNOBS: Dict[str, tuple] = {
    "RLA_TPU_SERVE_CHUNK_BLOCKS": (
        8, "big-chunk quantum, in KV blocks, a streaming long-prompt "
           "prefill advances per engine loop while no decode slot is "
           "active (serve/engine.py)"),
    "RLA_TPU_SERVE_CHUNK_MIN_BLOCKS": (
        1, "small-chunk quantum, in KV blocks, a streaming long-prompt "
           "prefill advances between live decode waves (serve/engine.py)"),
    "RLA_TPU_SERVE_HANDOFF_WAVE_BYTES": (
        4 << 20, "per-wave byte bound on the KV block copy a prefill->"
                 "decode handoff ships through the object store "
                 "(parallel/redistribute.py wave_schedule; "
                 "serve/engine.py)"),
    "RLA_TPU_SEQ_PARALLEL_MODE": (
        "ulysses", "default context-parallel attention strategy for "
                   "Trainer(seq_parallel>1) when seq_parallel_mode is not "
                   "passed: 'ulysses' (all_to_all head-scatter; needs "
                   "heads % seq_parallel == 0) or 'ring' (KV rotation) "
                   "(core/trainer.py)"),
    "RLA_TPU_SLO_DEADLINE_S": (
        None, "serve SLO: end-to-end deadline stamped on each request "
              "at admission; expired requests are shed typed "
              "(DeadlineExceeded) before prefill (serve/slo.py)"),
    "RLA_TPU_SLO_TARGET": (
        0.99, "serve SLO target fraction (e.g. 0.99 = '99% of "
              "requests'); burn rate divides the observed violation "
              "fraction by 1 - target (serve/slo.py)"),
    "RLA_TPU_SLO_TOKEN_CADENCE_S": (
        None, "serve SLO: per-token inter-arrival target; decode gaps "
              "above it count as violations (serve/slo.py)"),
    "RLA_TPU_SLO_TTFT_S": (
        None, "serve SLO: time-to-first-token target; prefills landing "
              "above it count as violations (serve/slo.py)"),
    "RLA_TPU_SLO_WINDOW_S": (
        60.0, "rolling window for serve SLO burn-rate accounting "
              "(serve/slo.py)"),
}


def _lookup(name: str) -> Optional[str]:
    """The raw value, None when unset."""
    if name not in KNOBS:
        raise LookupError(f"env knob {name!r} is not registered in "
                          "analysis/knobs.py")
    return os.environ.get(name)


def _parse(name: str, cast, default):
    raw = _lookup(name)
    if raw in (None, ""):
        return default
    try:
        return cast(raw)
    except ValueError:
        log.warning("bad %s=%r; using %r", name, raw, default)
        return default


def get_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``default`` (the registered one when None) when unset or empty;
    the default, with one warning, when set but unparseable."""
    if default is None and name in KNOBS:
        default = KNOBS[name][0]
    return _parse(name, int, default)


def get_float(name: str, default: Optional[float] = None
              ) -> Optional[float]:
    """``default`` when unset or empty (None stays None, as in the JAX
    package's reader); the default, with one warning, when set but
    unparseable."""
    return _parse(name, float, default)


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw value, or ``default`` when unset or empty."""
    raw = _lookup(name)
    return default if raw in (None, "") else raw
