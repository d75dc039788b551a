"""Flight recorder: a bounded per-process ring of typed structured events.

Port of the JAX package's ``telemetry/recorder.py``, with its event
vocabulary ``EVENT_KINDS`` letter for letter.  Every interesting
transition is one event ``(monotonic ts, rank, kind, trace id,
payload)`` appended to a fixed-capacity ring (a ``deque(maxlen=N)``
drops the oldest), host-side only: a payload holds host scalars and
strings, never a tensor.

**Trace ids** correlate one logical operation across processes: the
driver mints one (``mint_trace_id``) and every event carries the
ambient id (``set_trace_id``) unless the emit overrides it.  Workers
inherit it from the ``RLA_TPU_TRACE_ID`` env overlay.

**Spill** makes the recorder crash-observable: with
``RLA_TPU_TELEMETRY_DIR`` set, the ring is snapshotted to
``rank{N}.events.json`` (``driver.events.json`` for the driver) in that
directory, atomically, at most once per ``RLA_TPU_TELEMETRY_SPILL_S``
seconds and always on the first emit, so a rank that dies leaves its
last events on disk for the run report (``telemetry/registry.py``).
``tail`` and ``events_per_second`` are the live plane's reads
(``telemetry/live.py``).
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

from ..analysis import knobs

log = logging.getLogger("rla_tpu_torch")

TELEMETRY_ENV = "RLA_TPU_TELEMETRY"
EVENTS_ENV = "RLA_TPU_TELEMETRY_EVENTS"
DIR_ENV = "RLA_TPU_TELEMETRY_DIR"
SPILL_S_ENV = "RLA_TPU_TELEMETRY_SPILL_S"
TRACE_ENV = "RLA_TPU_TRACE_ID"

DEFAULT_CAPACITY = 256
DEFAULT_SPILL_S = 0.5
# events of a rank's tail embedded into a report or a diagnosis
EMBED_TAIL_N = 16

# the event vocabulary, the JAX package's set.
# Emit sites may add kinds — the recorder is a transport, not a schema
# police — but everything the framework itself emits is declared here so
# dashboards and tests have one name list to key on.
EVENT_KINDS = frozenset({
    # trainer (core/trainer.py)
    "fit_start", "fit_end", "train_step", "epoch_end", "validation",
    "preempt_drain", "emergency_checkpoint",
    # input pipeline (data/prefetch.py)
    "prefetch_starved",
    # sharding resolution (accelerators/base.py): a large param leaf (or
    # the optimizer-state mapping) fell back to REPLICATED under
    # use_fsdp — silent loss of FSDP memory savings, surfaced
    "fsdp_fallback",
    # perf observatory (telemetry/perf.py): the HBM ledger saw placed
    # bytes grow monotonically for a whole leak streak
    "hbm_leak",
    # SPMD sanitizer (the JAX package's testing/spmd_sanitizer.py; not emitted by the port): one traced collective
    # call recorded while the opt-in sanitizer is installed — the
    # unified timeline's view of the per-rank collective sequence (the
    # authoritative diff channel is the sanitizer's own spill file)
    "spmd_collective",
    # worker dispatch loop (runtime/actors.py)
    "dispatch_begin", "dispatch_end",
    # supervision / retry layers (runtime/watchdog.py, runtime/elastic.py)
    "watchdog_transition", "elastic_attempt", "elastic_failure",
    "elastic_preempt_resume", "elastic_shrink", "elastic_grow",
    # numeric anomaly guardian (runtime/guardian.py): a tripped in-step
    # guard (train tier) or non-finite decode logits (serve tier); a
    # blamed data window entering the quarantine ledger; an ElasticRunner
    # resume that rewinds to the last verified checkpoint
    "anomaly_trip", "quarantine", "rewind",
    # live resize (runtime/elastic.py resize_in_memory /
    # core/trainer.py resize_in_memory): the between-attempt in-memory
    # resharding window — old/new world size, redistribution bytes
    # moved, waves and wall seconds
    "resize_begin", "resize_end",
    # MPMD pipeline (parallel/mpmd): one slot of a stage's tick program
    # (worker-side), one optimizer step across all stage groups
    # (driver-side), and one checkpoint-replay recovery — all stamped
    # with the fit's trace id so the cross-stage timeline stitches
    "pipeline_tick", "pipeline_step", "pipeline_replay",
    # serve lifecycle (serve/engine.py)
    "serve_admit", "serve_prefill", "serve_decode_step", "serve_respond",
    # serve SLO engine (serve/slo.py): a request missed its attached
    # SLO — TTFT/token-cadence target exceeded, or the deadline passed
    # while it was still queued (family "deadline" = shed before
    # prefill, typed DeadlineExceeded)
    "slo_violation",
    # serve replica controller (serve/controller.py): per-replica
    # state transitions (ok/slow/open/draining), hedged re-dispatch,
    # circuit-breaker revival, autoscale moves and typed brownout sheds
    "serve_replica_state", "serve_hedge", "serve_revive",
    "serve_scale_up", "serve_scale_down", "serve_brownout_shed",
})



def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (one logical fit / request / run)."""
    return secrets.token_hex(8)


class FlightRecorder:
    """Bounded ring of structured events for one process.

    ``rank`` is stamped on every event (None = the driver process);
    ``spill_path`` (optional) is where snapshots land for other
    processes to read.  Thread-safe."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 rank: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 spill_path: Optional[str] = None,
                 spill_min_s: float = DEFAULT_SPILL_S,
                 enabled: bool = True):
        self.capacity = max(1, int(capacity))
        self.rank = rank
        self.trace_id = trace_id
        self.spill_path = spill_path
        self.spill_min_s = max(0.0, float(spill_min_s))
        self.enabled = enabled
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._spill_lock = threading.Lock()
        self._last_spill = float("-inf")  # the first emit always spills
        self._spill_warned = False

    def emit(self, kind: str, trace: Optional[str] = None,
             **data: Any) -> None:
        """Append one event; ``data`` holds host scalars and strings.
        ``trace`` overrides the ambient trace id for this event only."""
        if not self.enabled:
            return
        evt = (time.monotonic(), self.rank, kind,
               trace if trace is not None else self.trace_id,
               data or None)
        with self._lock:
            self._ring.append(evt)
        if self.spill_path is not None:
            self._maybe_spill()

    def events(self, last_n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The ring's events as JSON-able dicts, oldest first."""
        with self._lock:
            evts = list(self._ring)
        if last_n is not None:
            evts = evts[-last_n:]
        out = []
        for ts, rank, kind, trace, data in evts:
            row: Dict[str, Any] = {"ts": round(ts, 6), "rank": rank,
                                   "kind": kind, "trace": trace}
            if data:
                row["data"] = dict(data)
            out.append(row)
        return out

    def tail(self, n: int = EMBED_TAIL_N,
             kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """The last ``n`` events, optionally only those of one ``kind``;
        ``n <= 0`` is no tail (``evts[-0:]`` would be the whole ring)."""
        if n is None or int(n) <= 0:
            return []
        evts = self.events()
        if kind is not None:
            evts = [e for e in evts if e["kind"] == kind]
        return evts[-int(n):]

    def events_per_second(self, window_s: float = 60.0) -> float:
        """The emit rate over (up to) the trailing ``window_s`` seconds;
        the denominator is floored at 1 s, so one fresh event reads ~1."""
        now = time.monotonic()
        with self._lock:
            stamps = [ts for ts, *_rest in self._ring
                      if now - ts <= window_s]
        if not stamps:
            return 0.0
        return len(stamps) / max(1.0, now - stamps[0])

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
        self._last_spill = float("-inf")

    def snapshot(self, last_n: Optional[int] = None) -> Dict[str, Any]:
        """Spill-shaped record: identity and the recent events."""
        return {"rank": self.rank, "pid": os.getpid(),
                "trace_id": self.trace_id,
                "ts": round(time.monotonic(), 6),
                "events": self.events(last_n)}

    def _maybe_spill(self) -> None:
        if time.monotonic() - self._last_spill < self.spill_min_s:
            return
        # a thread mid-write has a fresh enough snapshot: never block here
        if not self._spill_lock.acquire(blocking=False):
            return
        try:
            if time.monotonic() - self._last_spill < self.spill_min_s:
                return
            self._spill_unlocked()
        finally:
            self._spill_lock.release()

    def spill(self) -> Optional[str]:
        """Snapshot the ring to ``spill_path`` now (atomic).  Never
        raises: a failing disk logs one warning."""
        with self._spill_lock:
            return self._spill_unlocked()

    def _spill_unlocked(self) -> Optional[str]:
        path = self.spill_path
        if path is None:
            return None
        tmp = f"{path}.tmp.{os.getpid()}"
        self._last_spill = time.monotonic()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, path)
            return path
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if not self._spill_warned:
                self._spill_warned = True
                log.warning("telemetry spill to %s failed: %s", path, e)
            return None


# --------------------------------------------------------------------- #
# Process singleton                                                      #
# --------------------------------------------------------------------- #
_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def _build(rank: Optional[int],
           env: Optional[Mapping[str, str]]) -> FlightRecorder:
    return FlightRecorder(
        capacity=knobs.get_int(EVENTS_ENV, DEFAULT_CAPACITY, env=env),
        rank=rank,
        trace_id=knobs.get_str(TRACE_ENV, None, env=env),
        spill_path=spill_path_for(rank, env=env),
        spill_min_s=knobs.get_float(SPILL_S_ENV, DEFAULT_SPILL_S, env=env),
        enabled=knobs.get_bool(TELEMETRY_ENV, True, env=env))


def get_recorder() -> FlightRecorder:
    """This process's recorder (built from the knobs on first use; the
    driver's rank is None)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = _build(None, None)
    return _recorder


def configure(rank: Optional[int] = None,
              env: Optional[Mapping[str, str]] = None,
              trace_id: Optional[str] = None,
              enabled: Optional[bool] = None) -> FlightRecorder:
    """(Re)build the process recorder.  A worker calls this at boot
    (``runtime.actors._worker_main``) with its rank and env overlay, so
    its spill file is rank-keyed and the overlay's trace id holds."""
    global _recorder
    with _recorder_lock:
        rec = _build(rank, env)
        if trace_id is not None:
            rec.trace_id = trace_id
        if enabled is not None:
            rec.enabled = enabled
        _recorder = rec
    return rec


def _reset_for_tests() -> None:
    global _recorder
    with _recorder_lock:
        _recorder = None


def emit(kind: str, trace: Optional[str] = None, **data: Any) -> None:
    get_recorder().emit(kind, trace=trace, **data)


def set_trace_id(trace_id: Optional[str]) -> None:
    get_recorder().trace_id = trace_id


def current_trace_id() -> Optional[str]:
    return get_recorder().trace_id


def current_rank() -> Optional[int]:
    """The configured process rank (None = the driver), which the log
    formatter (utils/logging.py) stamps on every line."""
    rec = _recorder
    return rec.rank if rec is not None else None


# --------------------------------------------------------------------- #
# Cross-process readers (spill files)                                    #
# --------------------------------------------------------------------- #
def spill_path_for(rank: Optional[int],
                   env: Optional[Mapping[str, str]] = None
                   ) -> Optional[str]:
    """Where ``rank``'s recorder spills under ``RLA_TPU_TELEMETRY_DIR``
    (the overlay's first), or None when no directory is set."""
    tdir = knobs.get_str(DIR_ENV, None, env=env)
    if not tdir:
        return None
    label = "driver" if rank is None else f"rank{int(rank)}"
    return os.path.join(tdir, f"{label}.events.json")


def read_spill(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """A spilled snapshot, or None (a missing or torn file is an
    expected state mid-crash, never an error)."""
    if not path:
        return None
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return None
    return snap if isinstance(snap, dict) else None


def tail_events(snapshot: Optional[Dict[str, Any]],
                n: int = EMBED_TAIL_N) -> List[Dict[str, Any]]:
    """The last ``n`` events of a snapshot (empty when None)."""
    if not snapshot:
        return []
    return list((snapshot.get("events") or [])[-n:])
