"""Environment knobs the port reads, with the JAX package's names and
defaults.

Port of the part of the JAX package's ``analysis/knobs.py``
the serve engine reads: the two chunked-prefill quanta.  Reads go through
the registry, so an unregistered name fails loudly, and a malformed value
warns and falls back to the default, as there.
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
}


def get_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """``default`` (the registered one when None) when unset or empty;
    the default, with one warning, when set but unparseable."""
    if name not in KNOBS:
        raise LookupError(f"env knob {name!r} is not registered in "
                          "analysis/knobs.py")
    if default is None:
        default = KNOBS[name][0]
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("bad %s=%r; using %r", name, raw, default)
        return default
