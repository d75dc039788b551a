"""Trace ids for serve requests.

Port of ``mint_trace_id`` from the JAX package's
``telemetry/recorder.py``: the batcher stamps one on every admitted
request.  The flight recorder and its event emits come with the
telemetry slice.
"""

from __future__ import annotations

import secrets


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (one logical request / run)."""
    return secrets.token_hex(8)
