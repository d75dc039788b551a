"""Serve SLO engine: targets attached at admission, live burn rate out.

Port of the JAX package's ``serve/slo.py``.  Three pieces:

- :class:`SloPolicy`: the declared targets (``ttft_target_s``,
  ``token_cadence_target_s``, ``deadline_s``, ``target_fraction``).
  ``AdmissionController`` stamps the absolute deadline on each
  ``ServeRequest`` at admission, and a KV handoff carries it across the
  hop, so no retry or lane change resets a client's clock;
- **deadline shed**: a request whose deadline passed while it queued is
  failed typed (:class:`DeadlineExceeded`) before prefill, and counted
  under ``slo_deadline_shed``;
- :class:`SloTracker`: rolling-window burn-rate accounting over the
  observations the engine already makes (TTFT at prefill, token cadence
  at decode).  The burn rate, the observed violation fraction over the
  allowed one (``1 - target_fraction``) of the worst enabled family,
  rides every metrics snapshot as ``slo_burn_rate`` (``gauges``).

Every observation is one lock and one deque append of host scalars; a
violation also emits the flight-recorder ``slo_violation`` event (the
request's trace, id, family, value and target in ms).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ..analysis import knobs
from ..telemetry import recorder

TTFT_ENV = "RLA_TPU_SLO_TTFT_S"
CADENCE_ENV = "RLA_TPU_SLO_TOKEN_CADENCE_S"
DEADLINE_ENV = "RLA_TPU_SLO_DEADLINE_S"
WINDOW_ENV = "RLA_TPU_SLO_WINDOW_S"
TARGET_ENV = "RLA_TPU_SLO_TARGET"

DEFAULT_WINDOW_S = 60.0
DEFAULT_TARGET_FRACTION = 0.99
# bound on a family's window: a flood degrades to the newest N
# observations, never unbounded memory
MAX_WINDOW_OBSERVATIONS = 16384

FAMILIES = ("ttft", "token_cadence", "deadline")


class DeadlineExceeded(RuntimeError):
    """Typed load shed: the request's SLO deadline passed while it was
    still queued, so the engine spent no prefill on it."""

    def __init__(self, request_id: int, waited_s: float,
                 deadline_s: float):
        super().__init__(
            f"request {request_id} shed before prefill: queued "
            f"{waited_s:.3f}s past its {deadline_s:.3f}s SLO deadline")
        self.request_id = request_id
        self.waited_s = waited_s
        self.deadline_s = deadline_s


class SloPolicy:
    """Declared service-level targets for one engine.  Any subset may be
    set; ``None`` disables that family.  All are judged at
    ``target_fraction`` (default 0.99)."""

    def __init__(self, ttft_target_s: Optional[float] = None,
                 token_cadence_target_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 target_fraction: float = DEFAULT_TARGET_FRACTION):
        for name, v in (("ttft_target_s", ttft_target_s),
                        ("token_cadence_target_s", token_cadence_target_s),
                        ("deadline_s", deadline_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if not (0.0 < target_fraction < 1.0):
            raise ValueError(
                f"target_fraction must be in (0, 1), got {target_fraction}")
        self.ttft_target_s = ttft_target_s
        self.token_cadence_target_s = token_cadence_target_s
        self.deadline_s = deadline_s
        self.target_fraction = target_fraction

    @property
    def enabled(self) -> bool:
        return any(v is not None for v in
                   (self.ttft_target_s, self.token_cadence_target_s,
                    self.deadline_s))

    @classmethod
    def from_env(cls) -> Optional["SloPolicy"]:
        """The knob-configured policy, or None when none of the SLO
        knobs is set."""
        policy = cls(
            ttft_target_s=knobs.get_float(TTFT_ENV),
            token_cadence_target_s=knobs.get_float(CADENCE_ENV),
            deadline_s=knobs.get_float(DEADLINE_ENV),
            target_fraction=knobs.get_float(TARGET_ENV,
                                            DEFAULT_TARGET_FRACTION))
        return policy if policy.enabled else None

    def describe(self) -> Dict[str, Any]:
        return {"ttft_target_s": self.ttft_target_s,
                "token_cadence_target_s": self.token_cadence_target_s,
                "deadline_s": self.deadline_s,
                "target_fraction": self.target_fraction}


class SloTracker:
    """Rolling-window SLO accounting for one engine: a bounded
    ``(ts, violated)`` window per family; the burn rate is the worst
    enabled family's."""

    def __init__(self, policy: SloPolicy, metrics: Any = None,
                 window_s: Optional[float] = None):
        if window_s is None:
            window_s = knobs.get_float(WINDOW_ENV, DEFAULT_WINDOW_S)
        self.policy = policy
        self.window_s = max(0.1, float(window_s))
        self.metrics = metrics
        self._lock = threading.Lock()
        self._obs: Dict[str, deque] = {
            f: deque(maxlen=MAX_WINDOW_OBSERVATIONS) for f in FAMILIES}

    # -- engine-side observations --------------------------------------- #
    def _observe(self, family: str, violated: bool, req: Any = None,
                 value_s: Optional[float] = None,
                 target_s: Optional[float] = None) -> bool:
        now = time.monotonic()
        with self._lock:
            dq = self._obs[family]
            dq.append((now, violated))
            cutoff = now - self.window_s
            while dq and dq[0][0] < cutoff:
                dq.popleft()
        if violated:
            if self.metrics is not None:
                self.metrics.inc("slo_violations")
            recorder.emit(
                "slo_violation",
                trace=getattr(req, "trace_id", None),
                request=getattr(req, "request_id", None),
                family=family,
                value_ms=(round(value_s * 1e3, 3)
                          if value_s is not None else None),
                target_ms=(round(target_s * 1e3, 3)
                           if target_s is not None else None))
        return violated

    def observe_ttft(self, ttft_s: float, req: Any = None) -> bool:
        """One request's measured TTFT; returns whether it violated."""
        target = self.policy.ttft_target_s
        if target is None:
            return False
        return self._observe("ttft", ttft_s > target, req,
                             value_s=ttft_s, target_s=target)

    def observe_token(self, gap_s: float, req: Any = None) -> bool:
        """One inter-token gap of one request's stream."""
        target = self.policy.token_cadence_target_s
        if target is None:
            return False
        return self._observe("token_cadence", gap_s > target, req,
                             value_s=gap_s, target_s=target)

    def observe_deadline_met(self, req: Any = None) -> None:
        """A request that reached prefill within its deadline: the
        non-violation half of the deadline window.  Called once per
        served request at prefill, never at queue pop (a pool-full head
        request is re-popped every loop iteration)."""
        if self.policy.deadline_s is not None:
            self._observe("deadline", False, req)

    def shed(self, req: Any, waited_s: float) -> DeadlineExceeded:
        """Account one deadline shed and build its typed failure."""
        if self.metrics is not None:
            self.metrics.inc("slo_deadline_shed")
        self._observe("deadline", True, req, value_s=waited_s,
                      target_s=self.policy.deadline_s)
        return DeadlineExceeded(getattr(req, "request_id", -1),
                                waited_s, self.policy.deadline_s or 0.0)

    # -- exports --------------------------------------------------------- #
    def _family_rates(self) -> Dict[str, Dict[str, Any]]:
        cutoff = time.monotonic() - self.window_s
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for family, dq in self._obs.items():
                while dq and dq[0][0] < cutoff:
                    dq.popleft()
                n = len(dq)
                v = sum(1 for _ts, bad in dq if bad)
                out[family] = {"observations": n, "violations": v,
                               "violation_fraction":
                                   round(v / n, 6) if n else 0.0}
        return out

    def _burn_from(self, rates: Dict[str, Dict[str, Any]]) -> float:
        """Observed violation fraction over ``1 - target_fraction``, the
        worst enabled family: 0 is a clean window, 1 spends the error
        budget exactly."""
        allowed = 1.0 - self.policy.target_fraction
        if allowed <= 0:
            return 0.0
        enabled = {"ttft": self.policy.ttft_target_s,
                   "token_cadence": self.policy.token_cadence_target_s,
                   "deadline": self.policy.deadline_s}
        burn = 0.0
        for family, target in enabled.items():
            if target is not None:
                burn = max(burn,
                           rates[family]["violation_fraction"] / allowed)
        return round(burn, 6)

    def family_rates(self) -> Dict[str, Dict[str, Any]]:
        """Per-family windowed rates (observations, violations,
        violation_fraction): the ttft-vs-cadence burn split."""
        return self._family_rates()

    def burn_rate(self) -> float:
        """The observed violation fraction over the allowed one
        (``1 - target_fraction``), the worst enabled family: 0 is a
        clean window, 1 spends the error budget exactly, and it
        saturates at ``1 / allowed`` when every observation violates."""
        return self._burn_from(self._family_rates())

    def gauges(self) -> Dict[str, float]:
        """The live gauges ``ServeMetrics.bind_slo`` merges into every
        snapshot (one window scan a call)."""
        rates = self._family_rates()
        return {"slo_burn_rate": self._burn_from(rates),
                "slo_window_observations": float(sum(
                    r["observations"] for r in rates.values()))}

    def snapshot(self) -> Dict[str, Any]:
        """The policy, the window, the burn rate and each family's
        windowed rates (``/statusz``'s ``slo``)."""
        rates = self._family_rates()
        return {"policy": self.policy.describe(),
                "window_s": self.window_s,
                "burn_rate": self._burn_from(rates),
                "families": rates}
