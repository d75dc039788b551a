"""NumericAnomaly: the typed failure of the serve engine's decode guard.

Port of the ``NumericAnomaly`` type from the JAX package's
``runtime/guardian.py``.  The serve engine raises it into the one
request whose decode logits came back non-finite, and an MPMD pipeline
stage raises it naming itself (``stage=``) when its loss or gradient
norm is not finite, with the same message format (a structured
postmortem after ``| anomaly=``).  The in-step training
guard, blame taxonomy and quarantine ledger come with the training and
runtime slices.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

BLAME_UNKNOWN = "unknown"


class NumericAnomaly(RuntimeError):
    """A guarded step tripped (a serve decode produced non-finite logits
    for a slot, or a pipeline stage's loss or norm is not finite).  Carries the blame verdict and a diagnosis dict,
    embedded in the message after ``_MARKER``."""

    _MARKER = "| anomaly="

    def __init__(self, message: str, step: Optional[int] = None,
                 blame: str = BLAME_UNKNOWN,
                 diagnosis: Optional[Dict[str, Any]] = None,
                 stage: Optional[int] = None):
        super().__init__(message)
        self.step = step
        self.blame = blame
        self.stage = stage
        self.diagnosis = dict(diagnosis or {})

    @classmethod
    def for_trip(cls, step: int, blame: str,
                 flags: Optional[Dict[str, Any]] = None,
                 stage: Optional[int] = None,
                 detail: str = "") -> "NumericAnomaly":
        diagnosis: Dict[str, Any] = {
            "step": step, "blame": blame, "flags": dict(flags or {}),
        }
        if stage is not None:
            diagnosis["stage"] = stage
        where = f"stage {stage} " if stage is not None else ""
        msg = (f"numeric anomaly at {where}step {step} (blame={blame})"
               f"{': ' + detail if detail else ''} "
               f"{cls._MARKER}"
               f"{json.dumps(diagnosis, sort_keys=True, default=str)}")
        return cls(msg, step=step, blame=blame, diagnosis=diagnosis,
                   stage=stage)
