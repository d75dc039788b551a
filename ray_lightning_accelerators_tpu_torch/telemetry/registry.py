"""The run report: one JSON file that reconstructs a run across ranks.

Port of ``gather_worker_tails``, ``build_run_report`` and
``write_run_report`` from the JAX package's ``telemetry/registry.py``.
The report holds the driver's flight-recorder ring and every worker's
spilled tail (``telemetry/recorder.py``) under one trace id, the typed
error that ended the run (``{type, message, rank, diagnosis}``) and the
caller's ``extra`` block.  The metrics registry (``MetricsRegistry``,
the Prometheus text) comes with the runtime slice, so ``metrics`` is
always None here; ``compile`` counts the kernel builds of this process
(``ops/_build.py``), the port's counterpart of the backend compiles;
``stall_diagnosis`` holds the watchdog's reap record of a wedged run
(``runtime/watchdog.py``) when the caller has one.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Mapping, Optional, Sequence

from ..ops import _build
from . import recorder as recorder_lib

log = logging.getLogger("rla_tpu_torch")

REPORT_SCHEMA = 1
REPORT_BASENAME = "run_report.json"


def gather_worker_tails(workers: Sequence[Any]) -> Dict[str, Dict[str, Any]]:
    """Each worker's spilled flight-recorder snapshot, keyed by rank
    label; a rank that never spilled is absent."""
    out: Dict[str, Dict[str, Any]] = {}
    for w in workers or ():
        tail_fn = getattr(w, "telemetry_tail", None)
        if tail_fn is None:
            continue
        try:
            snap = tail_fn()
        except Exception:
            snap = None
        if snap:
            out[str(getattr(w, "rank", "?"))] = snap
    return out


def build_run_report(*, error: Optional[BaseException] = None,
                     trace_id: Optional[str] = None,
                     rank_events: Optional[Mapping[str, Any]] = None,
                     stall_diagnosis: Optional[Mapping[str, Any]] = None,
                     registry: Any = None,
                     extra: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The ``run_report.json`` payload.  ``rank_events`` maps rank labels
    to spill snapshots (or bare event lists); the driver's own ring is
    added.  ``registry`` must be None until the metrics registry is
    ported."""
    if registry is not None:
        from ..core.module import not_ported
        raise not_ported("the metrics registry in the run report",
                         "runtime")
    rec = recorder_lib.get_recorder()
    ranks: Dict[str, Dict[str, Any]] = {"driver": rec.snapshot()}
    if trace_id is None:
        trace_id = rec.trace_id
    for label, snap in (rank_events or {}).items():
        if str(label) in ranks:
            continue  # the live driver ring beats its own older spill
        if isinstance(snap, (list, tuple)):
            snap = {"events": list(snap)}
        ranks[str(label)] = dict(snap)
    err = None
    if error is not None:
        err = {"type": type(error).__name__,
               "message": str(error)[:2000],
               "rank": getattr(error, "rank", None)}
        diag = getattr(error, "diagnosis", None)
        if diag:
            err["diagnosis"] = dict(diag)
    report: Dict[str, Any] = {
        "schema": REPORT_SCHEMA,
        "kind": "run_report",
        "trace_id": trace_id,
        "written_unix": time.time(),
        "error": err,
        "stall_diagnosis": (dict(stall_diagnosis)
                            if stall_diagnosis else None),
        "compile": {"driver_kernel_builds": _build.build_count()},
        "ranks": ranks,
        "metrics": None,
    }
    if extra:
        report["extra"] = dict(extra)
    return report


def write_run_report(path: str, **kwargs: Any) -> Optional[str]:
    """Write ``build_run_report(**kwargs)`` to ``path`` (a directory gets
    ``run_report.json`` appended), atomically; the final path, or None
    on failure: a postmortem write error is logged, never raised over
    the run's own exception."""
    try:
        report = build_run_report(**kwargs)
        if os.path.isdir(path) or not path.endswith(".json"):
            path = os.path.join(path, REPORT_BASENAME)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, default=str)
        os.replace(tmp, path)
        log.info("run report written: %s", path)
        return path
    except Exception as e:
        log.warning("failed to write run report to %s: %s", path, e)
        return None
