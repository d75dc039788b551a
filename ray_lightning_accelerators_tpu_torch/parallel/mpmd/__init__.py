"""MPMD pipeline parallelism over the actor runtime.

Port of the JAX package's ``parallel/mpmd``: instead of one program
spanning a ``pipeline`` axis (``parallel/pipeline.py``), training runs
as several worker groups, one program per stage, and microbatch
activations and activation-grads move between neighbor stages through
``runtime/object_store.py`` shm refs.

- :mod:`.schedule`: the deterministic per-stage tick programs (1F1B,
  with GPipe as the all-warmup case) and the cross-stage handoff audit;
- :mod:`.handoff`: the filesystem mailbox of ObjectRefs, the typed
  :class:`~.handoff.PipelineHandoffTimeout`, the wire format of
  activations (bfloat16 and tensors on the card) and the slot barrier;
- :mod:`.stage`: the worker-side :class:`~.stage.StageRunner`;
- :mod:`.driver`: the driver-side :class:`~.driver.PipelineRunner`,
  with per-stage failure budgets and checkpoint replay.
"""

from .driver import (PipelineConfigError, PipelineRunner,
                     PipelineStageFailed)
from .handoff import PipelineHandoffTimeout
from .schedule import (SCHEDULES, PipelineScheduleError,
                       analytic_bubble_fraction, audit_programs,
                       build_programs, program_fingerprint, stage_program)

__all__ = [
    "PipelineConfigError", "PipelineRunner", "PipelineStageFailed",
    "PipelineHandoffTimeout", "PipelineScheduleError", "SCHEDULES",
    "analytic_bubble_fraction", "audit_programs", "build_programs",
    "program_fingerprint", "stage_program",
]
