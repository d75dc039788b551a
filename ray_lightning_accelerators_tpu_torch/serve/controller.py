"""The serve tier's controller: routing, retries, hedging, the circuit
breaker, autoscaling and brownout over ``ServeReplicas``.

Port of the JAX package's ``serve/controller.py``, decision for decision
(the tests hold the two in lock-step on the same event sequences):

- **Health/load-aware routing** (``route``): every dispatch picks the
  live replica with the least in-flight work, skipping replicas the
  watchdog classifies slow, replicas whose engine snapshot (shipped back
  with every chunk result) shows a p99 decode step past the slow
  threshold, and replicas whose circuit is open or that drain.  A slow
  replica takes work only when no healthy one has room.  Prefix
  affinity and the prefill/decode lanes refine the pick (below).
- **Retry budgets with backoff** (``charge_retry``): a request whose
  replica died re-queues head-of-line with a half-jitter exponential
  ``not_before`` (``utils/backoff.py``, the schedule ``ElasticRunner``
  uses), bounded by ``max_retries``.
- **Hedging** (``maybe_hedge``): the oldest in-flight chunk of a slow
  replica is re-dispatched to a healthy one; the ``ServeResponse``
  first-completion-wins contract keeps every response exactly once.
- **Circuit breaker** (``maybe_revive``): an infrastructure failure
  opens the replica's circuit for a backoff that grows once the breaker
  window holds ``breaker_failures`` failures; when it expires the
  breaker goes half-open, restarts the worker, rebuilds its engine and
  sends one probe, and only a probe that answers closes the circuit.
- **Autoscale and brownout** (``autoscale``, ``should_shed``): sustained
  SLO burn (fresh readings only: a reading older than ``burn_stale_s``
  counts as 0) or queue occupancy past the high watermark adds a
  replica up to ``max_replicas``; a sustained idle tier drains one
  (autoscaled first, then the highest rank).  A saturated tier with no
  headroom sheds typed (``BrownoutShed``) at the watermark.
- **Prefix affinity** (``PrefixAffinityRing``): the replica holding the
  longest resident run of a request's chain-hashed prefix keys wins; a
  cold prefix goes to its consistent-hash ring owner (8-byte blake2b
  points, the JAX package's ring key for key).
- **Lanes**: with ``prefill_replicas`` the lowest ranks form a prefill
  lane whose replicas hand their KV blocks to the decode lane; an empty
  lane spills to the other rather than stall.

The controller is host bookkeeping only: host scalars behind one lock,
no device values and no dispatches under the lock (revive and scale-up
block on worker round trips and run in the tick thread with the lock
released).  Its events are the recorder's ``serve_replica_state``,
``serve_hedge``, ``serve_revive``, ``serve_scale_up`` and
``serve_scale_down``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, fields, replace
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..telemetry import recorder as telemetry
from ..utils.backoff import backoff_delay_s
from ..utils.logging import log

MAX_RETRIES_ENV = "RLA_TPU_SERVE_MAX_RETRIES"
RETRY_BACKOFF_ENV = "RLA_TPU_SERVE_RETRY_BACKOFF_S"
RETRY_BACKOFF_CAP_ENV = "RLA_TPU_SERVE_RETRY_BACKOFF_CAP_S"
HEDGE_ENV = "RLA_TPU_SERVE_HEDGE"
SLOW_P99_ENV = "RLA_TPU_SERVE_SLOW_P99_S"
BREAKER_FAILURES_ENV = "RLA_TPU_SERVE_BREAKER_FAILURES"
BREAKER_WINDOW_ENV = "RLA_TPU_SERVE_BREAKER_WINDOW_S"
REVIVE_BACKOFF_ENV = "RLA_TPU_SERVE_REVIVE_BACKOFF_S"
REVIVE_BACKOFF_CAP_ENV = "RLA_TPU_SERVE_REVIVE_BACKOFF_CAP_S"
MAX_REPLICAS_ENV = "RLA_TPU_SERVE_MAX_REPLICAS"
SCALE_UP_BURN_ENV = "RLA_TPU_SERVE_SCALE_UP_BURN"
BROWNOUT_FRAC_ENV = "RLA_TPU_SERVE_BROWNOUT_FRAC"
AFFINITY_ENV = "RLA_TPU_SERVE_AFFINITY"
AFFINITY_VNODES_ENV = "RLA_TPU_SERVE_AFFINITY_VNODES"
AFFINITY_RESIDENCY_ENV = "RLA_TPU_SERVE_AFFINITY_RESIDENCY"
PREFILL_REPLICAS_ENV = "RLA_TPU_SERVE_PREFILL_REPLICAS"
HANDOFF_MIN_BLOCKS_ENV = "RLA_TPU_SERVE_HANDOFF_MIN_BLOCKS"

# replica states (the rla_top table vocabulary)
STATE_OK = "ok"
STATE_SLOW = "slow"
STATE_OPEN = "open"            # circuit open: down, waiting out backoff
STATE_HALF_OPEN = "half-open"  # revival probe in flight
STATE_DRAINING = "draining"    # scale-down: no new chunks, finishing

# disaggregated lanes (the rla_top "lane" column vocabulary)
LANE_PREFILL = "prefill"
LANE_DECODE = "decode"


@dataclass(frozen=True)
class ControllerConfig:
    """Policy knobs for one :class:`ReplicaController`.

    A plain ``ControllerConfig(...)`` is taken LITERALLY (its field
    values are the policy, env knobs ignored);
    ``ControllerConfig.from_env(**overrides)`` builds the env-knob
    policy with explicit overrides winning — use it when both should
    apply.  ``ServeReplicas(controller=None)`` defaults to
    ``from_env()``.  ``None`` thresholds disable their signal."""

    # routing / dispatch
    max_inflight_chunks: int = 2     # per replica, hedges included
    # retry budget (infra failures per request) + backoff schedule
    max_retries: int = 2
    retry_backoff_s: float = 0.02
    retry_backoff_cap_s: float = 1.0
    # hedging
    hedge: bool = True
    hedge_age_s: Optional[float] = None   # None = watchdog slow trigger
    slow_p99_s: Optional[float] = None    # p99 decode-step slow threshold
    # circuit breaker / revival
    breaker_failures: int = 3
    breaker_window_s: float = 30.0
    revive_backoff_s: float = 0.5
    revive_backoff_cap_s: float = 15.0
    auto_revive: bool = True
    probe_timeout_s: float = 60.0
    # autoscale / brownout
    max_replicas: Optional[int] = None    # None = no scale-up
    min_replicas: Optional[int] = None    # None = the initial count
    scale_up_burn: float = 1.0
    occupancy_high: float = 0.5           # queue-depth fraction
    scale_sustain_s: float = 2.0
    idle_sustain_s: float = 10.0
    # burn signals ride chunk COMPLETIONS: once traffic stops they
    # would never refresh, so a reading older than this counts as 0 —
    # without it an idle tier would stay "hot" on its last overloaded
    # chunk forever and never drain
    burn_stale_s: float = 5.0
    brownout: bool = True
    brownout_frac: float = 0.9
    # prefix-affinity routing: route to the replica whose cache holds
    # the longest resident run of the request's chain-hashed prefix
    # keys; health/breaker/drain states always override, hedges count
    # as deliberate misses
    affinity: bool = True
    affinity_vnodes: int = 32
    affinity_residency: int = 4096
    # disaggregated lanes: the lowest `prefill_replicas` ranks form a
    # prefill-heavy lane; prompts with at least `handoff_min_blocks`
    # full KV blocks prefill there and hand their blocks off to a
    # decode-lane replica (0 = lanes disabled, end-to-end serving)
    prefill_replicas: int = 0
    handoff_min_blocks: int = 1
    # tick cadence
    poll_s: float = 0.1

    @classmethod
    def from_env(cls, **overrides: Any) -> "ControllerConfig":
        """Env-knob defaults, overridden by explicit kwargs."""
        cfg = cls(
            max_retries=knobs.get_int(MAX_RETRIES_ENV, cls.max_retries),
            retry_backoff_s=knobs.get_float(RETRY_BACKOFF_ENV,
                                            cls.retry_backoff_s),
            retry_backoff_cap_s=knobs.get_float(RETRY_BACKOFF_CAP_ENV,
                                                cls.retry_backoff_cap_s),
            hedge=knobs.get_bool(HEDGE_ENV, cls.hedge),
            slow_p99_s=knobs.get_float(SLOW_P99_ENV, cls.slow_p99_s),
            breaker_failures=knobs.get_int(BREAKER_FAILURES_ENV,
                                           cls.breaker_failures),
            breaker_window_s=knobs.get_float(BREAKER_WINDOW_ENV,
                                             cls.breaker_window_s),
            revive_backoff_s=knobs.get_float(REVIVE_BACKOFF_ENV,
                                             cls.revive_backoff_s),
            revive_backoff_cap_s=knobs.get_float(
                REVIVE_BACKOFF_CAP_ENV, cls.revive_backoff_cap_s),
            max_replicas=knobs.get_int(MAX_REPLICAS_ENV,
                                       cls.max_replicas),
            scale_up_burn=knobs.get_float(SCALE_UP_BURN_ENV,
                                          cls.scale_up_burn),
            brownout_frac=knobs.get_float(BROWNOUT_FRAC_ENV,
                                          cls.brownout_frac),
            affinity=knobs.get_bool(AFFINITY_ENV, cls.affinity),
            affinity_vnodes=knobs.get_int(AFFINITY_VNODES_ENV,
                                          cls.affinity_vnodes),
            affinity_residency=knobs.get_int(AFFINITY_RESIDENCY_ENV,
                                             cls.affinity_residency),
            prefill_replicas=knobs.get_int(PREFILL_REPLICAS_ENV,
                                           cls.prefill_replicas),
            handoff_min_blocks=knobs.get_int(HANDOFF_MIN_BLOCKS_ENV,
                                             cls.handoff_min_blocks),
        )
        known = {f.name for f in fields(cls)}
        unknown = set(overrides) - known
        if unknown:
            raise TypeError(f"unknown ControllerConfig fields: "
                            f"{sorted(unknown)}")
        return replace(cfg, **overrides) if overrides else cfg


class PrefixAffinityRing:
    """Consistent-hash ring + per-replica prefix-residency tracking.

    Two structures behind one idea — keep a hot shared prefix's KV
    blocks on ONE replica instead of re-prefilling it everywhere:

    - **Residency**: a bounded per-replica LRU of the chain-hashed
      prefix keys (serve/batcher.py ``chain_prefix_keys``) last routed
      there.  ``resident_run`` scores a candidate by the longest
      CONSECUTIVE run of a request's keys it holds — the chain hash
      makes any suffix-after-a-gap unusable, exactly like the
      allocator's ``lookup_run``.  This is the router's MODEL of each
      replica's cache, not the cache itself: it is bounded separately
      (``residency_cap``) and cleared whenever a replica's circuit
      opens, because a restarted engine comes back blank.

    - **Ring**: ``vnodes`` virtual nodes per rank.  A request whose
      keys are resident nowhere places on the ring owner of its FIRST
      key, so repeats of a cold prefix converge on one replica instead
      of spraying least-loaded; rank arrival/departure only moves the
      keyspace the consistent hash says it must.

    Not thread-safe on its own: every method is called with the
    owning controller's lock held."""

    def __init__(self, vnodes: int = 32, residency_cap: int = 4096):
        import hashlib

        self._hashlib = hashlib
        self.vnodes = max(1, int(vnodes))
        self.residency_cap = max(1, int(residency_cap))
        self._ring: List[Tuple[int, int]] = []   # (point, rank) sorted
        self._resident: Dict[int, Any] = {}      # rank -> OrderedDict

    def _point(self, token: str) -> int:
        digest = self._hashlib.blake2b(
            token.encode(), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def add_rank(self, rank: int) -> None:
        if rank in self._resident:
            return
        from collections import OrderedDict
        self._resident[rank] = OrderedDict()
        for v in range(self.vnodes):
            self._ring.append((self._point(f"{rank}:{v}"), rank))
        self._ring.sort()

    def remove_rank(self, rank: int) -> None:
        self._resident.pop(rank, None)
        self._ring = [(p, r) for p, r in self._ring if r != rank]

    def clear_rank(self, rank: int) -> None:
        """Forget a replica's residency (its engine restarted blank)
        without moving its keyspace off the ring."""
        if rank in self._resident:
            self._resident[rank].clear()

    def owner_among(self, key: str, allowed: Any) -> Optional[int]:
        """Ring owner of ``key`` restricted to ``allowed`` ranks: the
        first allowed rank at/after the key's point, wrapping — the
        consistent-hash successor walk, so an unroutable owner's
        keyspace falls to its ring successor, not to a reshuffle."""
        allowed = set(allowed)
        if not self._ring or not allowed:
            return None
        import bisect
        i = bisect.bisect_left(self._ring, (self._point(key), -1))
        for j in range(len(self._ring)):
            rank = self._ring[(i + j) % len(self._ring)][1]
            if rank in allowed:
                return rank
        return None

    def resident_run(self, rank: int, keys: Any) -> int:
        """Longest consecutive run of ``keys`` (from key 0) the rank's
        tracked residency holds."""
        res = self._resident.get(rank)
        if not res:
            return 0
        run = 0
        for key in keys:
            if key not in res:
                break
            run += 1
        return run

    def note(self, rank: int, keys: Any) -> None:
        """MRU-admit ``keys`` into the rank's residency (called at
        route time: the replica is about to prefill-and-register
        exactly these keys)."""
        res = self._resident.get(rank)
        if res is None:
            return
        for key in keys:
            res.pop(key, None)
            res[key] = None
        while len(res) > self.residency_cap:
            res.popitem(last=False)

    def state(self) -> Dict[str, Any]:
        """JSON-able ring view for the controller snapshot."""
        return {
            "vnodes": self.vnodes,
            "residency_cap": self.residency_cap,
            "ranks": sorted(self._resident),
            "residency": {str(rank): len(res)
                          for rank, res in sorted(
                              self._resident.items())},
        }


class _Chunk:
    """One in-flight chunk dispatch (driver-side record)."""

    __slots__ = ("chunk_id", "rank", "items", "t_dispatch", "hedged",
                 "hedge_of")

    def __init__(self, chunk_id: int, rank: int,
                 items: List[Tuple[Any, Any]], hedge_of=None):
        self.chunk_id = chunk_id
        self.rank = rank
        self.items = items          # [(ServeRequest, ServeResponse)]
        self.t_dispatch = time.monotonic()
        self.hedged = False         # a hedge copy was already fired
        self.hedge_of = hedge_of    # (orig rank, orig chunk_id) | None


class ReplicaHealth:
    """Driver-side health/load record of one replica."""

    def __init__(self, rank: int, scaled: bool = False):
        self.rank = rank
        self.state = STATE_OK
        self.scaled = scaled          # added by autoscale: drains first
        self.inflight_chunks = 0
        self.inflight_requests = 0
        self.dispatched_chunks = 0
        self.completed_chunks = 0
        self.app_failures = 0
        self.infra_failures = 0
        self.retries_charged = 0      # requeues this replica caused
        self.hedges = 0               # hedges fired AGAINST this replica
        self.failures: deque = deque()  # breaker window (monotonic ts)
        self.open_until = 0.0
        self.revive_attempts = 0      # consecutive failed revivals
        self.revivals = 0
        self.last_detail = ""
        self.last_stats: Dict[str, Any] = {}
        self.p99_step_s: Optional[float] = None
        self.lane = LANE_DECODE       # disaggregated-lane assignment
        self.prefix_hits = 0          # affinity routes that found a run
        self.prefix_misses = 0        # affinity routes that found none
        self.slo_families: Dict[str, Any] = {}  # per-family SLO rates
        self.slo_burn = 0.0
        self.burn_updated = 0.0       # monotonic ts of the last reading
        self.compile_count: Optional[int] = None
        self.chunks: Dict[int, _Chunk] = {}

    def row(self, now: float) -> Dict[str, Any]:
        """JSON-able snapshot row (the /statusz + rla_top shape)."""
        return {
            "rank": self.rank,
            "state": self.state,
            "scaled": self.scaled,
            "inflight_chunks": self.inflight_chunks,
            "inflight_requests": self.inflight_requests,
            "dispatched_chunks": self.dispatched_chunks,
            "completed_chunks": self.completed_chunks,
            "app_failures": self.app_failures,
            "infra_failures": self.infra_failures,
            "retries": self.retries_charged,
            "hedges": self.hedges,
            "revivals": self.revivals,
            "open_for_s": (round(self.open_until - now, 3)
                           if self.state == STATE_OPEN
                           and self.open_until > now else 0.0),
            "p99_step_ms": (round(self.p99_step_s * 1e3, 3)
                            if self.p99_step_s is not None else None),
            "lane": self.lane,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (
                round(self.prefix_hits
                      / (self.prefix_hits + self.prefix_misses), 4)
                if self.prefix_hits + self.prefix_misses else None),
            "slo_burn": round(float(self.slo_burn), 4),
            "compile_count": self.compile_count,
            "detail": self.last_detail,
        }


class ReplicaController:
    """The policy brain over one ``ServeReplicas`` group.

    The group delegates every routing/recovery/scale decision here and
    provides the mechanics: ``group._worker(rank)``,
    ``group._dispatch(rank, chunk, hedge_of=)``,
    ``group._revive_replica(rank)``, ``group._add_replica()`` and
    ``group._retire_replica(rank)``.  All controller state lives behind
    one lock; blocking worker round-trips (revive probes, scale-up
    spawns) run in the tick thread with the lock released."""

    def __init__(self, group: Any, config: Optional[ControllerConfig]
                 = None):
        self.group = group
        self.cfg = config or ControllerConfig.from_env()
        self.metrics = group.metrics
        self._lock = threading.RLock()
        self._replicas: Dict[int, ReplicaHealth] = {
            w.rank: ReplicaHealth(w.rank) for w in group.pool.workers}
        self.affinity = PrefixAffinityRing(self.cfg.affinity_vnodes,
                                           self.cfg.affinity_residency)
        # lane assignment: the lowest `prefill_replicas` ranks form the
        # prefill lane (deterministic, so a restart reproduces it)
        for i, rank in enumerate(sorted(self._replicas)):
            self.affinity.add_rank(rank)
            if self.cfg.prefill_replicas > 0 \
                    and i < self.cfg.prefill_replicas:
                self._replicas[rank].lane = LANE_PREFILL
        self._chunk_ids = itertools.count()
        self._min_replicas = (self.cfg.min_replicas
                              if self.cfg.min_replicas is not None
                              else len(self._replicas))
        self._hot_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # Lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def start(self) -> "ReplicaController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="rla-torch-serve-controller")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            try:
                self.tick()
            except Exception as e:  # policy must never kill the tier
                log.warning("serve controller tick failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # ------------------------------------------------------------------ #
    # Routing                                                            #
    # ------------------------------------------------------------------ #
    def route(self, exclude: Any = (),
              prefix_keys: Optional[Any] = None,
              lane: Optional[str] = None) -> Optional[int]:
        """The replica the next chunk should go to, or None when no
        replica can take work right now.

        Health always wins: open/half-open/draining circuits, dead
        processes, full in-flight budgets and the exclude set are
        filtered BEFORE affinity ever looks — a resident prefix on a
        broken replica is not a destination.  ``lane`` restricts to
        one disaggregated lane when lanes are enabled, spilling to any
        lane rather than returning None (availability beats
        disaggregation).  Within the survivors: the longest resident
        run of ``prefix_keys`` wins (tier + per-replica hit counted),
        a cold prefix places on its consistent-hash ring owner so
        repeats converge (counted as a miss), and with affinity off or
        no keys it is least-loaded first (in-flight requests, then
        chunks, then p99).  ``slow`` replicas are used only when no
        healthy replica has capacity."""
        skip = set(exclude)
        opened: List[Dict[str, Any]] = []
        counted: Optional[str] = None
        pick_rank: Optional[int] = None
        with self._lock:
            cands: List[Tuple[Tuple[Any, ...], ReplicaHealth]] = []
            for r in self._replicas.values():
                if r.rank in skip or r.state in (STATE_OPEN,
                                                 STATE_HALF_OPEN,
                                                 STATE_DRAINING):
                    continue
                w = self.group._worker(r.rank)
                if w is None or not w.is_alive:
                    opened.append(self._open_locked(r, "process dead"))
                    continue
                if r.inflight_chunks >= self.cfg.max_inflight_chunks:
                    continue
                key = (r.inflight_requests, r.inflight_chunks,
                       r.p99_step_s or 0.0)
                cands.append((key, r))
            if lane is not None and self.cfg.prefill_replicas > 0:
                in_lane = [c for c in cands if c[1].lane == lane]
                if in_lane:  # an empty/down lane spills cross-lane
                    cands = in_lane
            healthy = [c for c in cands if c[1].state != STATE_SLOW]
            tier = healthy or cands
            pick: Optional[ReplicaHealth] = None
            hit = False
            if tier and self.cfg.affinity and prefix_keys:
                best_run, best = 0, None
                for key, r in tier:
                    run = self.affinity.resident_run(r.rank,
                                                     prefix_keys)
                    if run > best_run or (run == best_run > 0
                                          and key < best[0]):
                        best_run, best = run, (key, r)
                if best is not None:
                    pick, hit = best[1], True
                else:
                    owner = self.affinity.owner_among(
                        prefix_keys[0], [r.rank for _, r in tier])
                    if owner is not None:
                        pick = next(r for _, r in tier
                                    if r.rank == owner)
            if pick is None and tier:
                pick = min(tier, key=lambda c: c[0])[1]
            if pick is not None:
                pick_rank = pick.rank
                if self.cfg.affinity and prefix_keys:
                    if hit:
                        pick.prefix_hits += 1
                        counted = "prefix_route_hits"
                    else:
                        pick.prefix_misses += 1
                        counted = "prefix_route_misses"
                    self.affinity.note(pick.rank, prefix_keys)
        self._emit_opened(opened)
        if counted is not None:  # metrics lock outside the controller's
            self.metrics.inc(counted)
        return pick_rank

    def note_import(self, rank: int, prefix_keys: Optional[Any]) -> None:
        """Record prefix residency a KV IMPORT just landed on ``rank``
        (the decode replica registered the shipped blocks under their
        chain keys), WITHOUT counting a route: the request's hit/miss
        was already accounted where the prefill routed.  Keeps the ring
        truthful so future same-prefix requests route to the replica
        that actually holds the KV now."""
        if not self.cfg.affinity or not prefix_keys:
            return
        with self._lock:
            if rank in self._replicas:
                self.affinity.note(rank, list(prefix_keys))

    def serving_possible(self) -> bool:
        """False only when NO replica can ever take work again: every
        circuit is open/draining and auto-revive is off (with revival
        on, a fully-down tier is a transient the queue waits out)."""
        with self._lock:
            if any(r.state in (STATE_OK, STATE_SLOW, STATE_HALF_OPEN)
                   for r in self._replicas.values()):
                return True
            return self.cfg.auto_revive and bool(self._replicas)

    # ------------------------------------------------------------------ #
    # Dispatch accounting                                                #
    # ------------------------------------------------------------------ #
    def on_dispatch(self, rank: int, items: List[Tuple[Any, Any]],
                    hedge_of=None) -> int:
        with self._lock:
            chunk_id = next(self._chunk_ids)
            r = self._replicas.get(rank)
            if r is not None:
                c = _Chunk(chunk_id, rank, list(items), hedge_of)
                r.chunks[chunk_id] = c
                r.inflight_chunks += 1
                r.inflight_requests += len(items)
                r.dispatched_chunks += 1
            return chunk_id

    def _finish_chunk_locked(self, rank: int,
                             chunk_id: int) -> Optional[_Chunk]:
        r = self._replicas.get(rank)
        if r is None:
            return None
        c = r.chunks.pop(chunk_id, None)
        if c is not None:
            r.inflight_chunks = max(0, r.inflight_chunks - 1)
            r.inflight_requests = max(
                0, r.inflight_requests - len(c.items))
        return c

    def note_success(self, rank: int, chunk_id: int,
                     stats: Optional[Dict[str, Any]] = None) -> None:
        """A chunk completed; ``stats`` is the replica engine's own
        snapshot shipped back with the result — the load/SLO signal
        routing and autoscaling consume (no extra dispatches)."""
        with self._lock:
            self._finish_chunk_locked(rank, chunk_id)
            r = self._replicas.get(rank)
            if r is None:
                return
            r.completed_chunks += 1
            if stats:
                r.last_stats = dict(stats)
                step = stats.get("decode_step_s") or {}
                r.p99_step_s = step.get("p99_s")
                burn = stats.get("slo_burn_rate")
                r.slo_burn = float(burn) if isinstance(
                    burn, (int, float)) else 0.0
                fam = stats.get("slo_families")
                if isinstance(fam, dict):
                    # the ttft-vs-cadence split lane autoscaling reads
                    r.slo_families = fam
                r.burn_updated = time.monotonic()
                cc = stats.get("compile_count")
                if isinstance(cc, int):
                    r.compile_count = cc
            # a replica answering chunks with a healthy p99 is not slow
            if r.state == STATE_SLOW and not self._p99_slow(r):
                r.state = STATE_OK
                r.last_detail = ""

    def note_app_failure(self, rank: int, chunk_id: int) -> None:
        """Deterministic application failure: the requests fail typed,
        the replica keeps serving and the breaker does NOT count it."""
        with self._lock:
            self._finish_chunk_locked(rank, chunk_id)
            r = self._replicas.get(rank)
            if r is not None:
                r.app_failures += 1

    def note_infra_failure(self, rank: int, chunk_id: int,
                           exc: BaseException) -> None:
        """Replica died or was reaped wedged: open its circuit.  The
        reopen backoff starts at the base delay and grows exponentially
        once the breaker window holds ``breaker_failures`` failures —
        N failures in window ⇒ exponentially longer open period."""
        opened = None
        with self._lock:
            self._finish_chunk_locked(rank, chunk_id)
            r = self._replicas.get(rank)
            if r is not None:
                r.infra_failures += 1
                opened = self._open_locked(
                    r, f"{type(exc).__name__}: {str(exc)[:120]}")
        self._emit_opened([opened] if opened else [])

    def charge_retry(self, rank: Optional[int], req: Any) -> float:
        """Account one requeue against ``rank`` and return the retry
        backoff delay for this request's next dispatch (half-jitter
        exponential in its requeue count — the elastic schedule)."""
        with self._lock:
            r = self._replicas.get(rank) if rank is not None else None
            if r is not None:
                r.retries_charged += 1
        return backoff_delay_s(req.requeues + 1,
                               self.cfg.retry_backoff_s,
                               self.cfg.retry_backoff_cap_s)

    def _reopen_attempt_locked(self, r: ReplicaHealth) -> int:
        """The reopen-backoff exponent: 1 (base delay) until the
        breaker window holds ``breaker_failures`` failures, then
        growing with the excess — the breaker's "N failures in window
        ⇒ exponentially longer open" — and never below what the
        consecutive failed-revival count already earned."""
        over = len(r.failures) - max(1, self.cfg.breaker_failures) + 1
        return max(1, 1 + over, r.revive_attempts + 1)

    def _open_locked(self, r: ReplicaHealth,
                     detail: str) -> Optional[Dict[str, Any]]:
        """Transition ``r`` to circuit-open (no-op if already open: one
        replica death must count ONE breaker failure, not one per
        in-flight chunk callback).  Returns the transition event for
        the caller to emit OUTSIDE the controller lock — a recorder
        spill is disk I/O, and route()/note_* must not stall on it."""
        if r.state == STATE_OPEN:
            return None
        now = time.monotonic()
        r.failures.append(now)
        cutoff = now - self.cfg.breaker_window_s
        while r.failures and r.failures[0] < cutoff:
            r.failures.popleft()
        prev = r.state
        r.state = STATE_OPEN
        r.last_detail = detail
        # the revive path rebuilds the engine blank: the router's
        # residency model must forget, or post-revival affinity would
        # "hit" a cache that no longer exists
        self.affinity.clear_rank(r.rank)
        r.open_until = now + backoff_delay_s(
            self._reopen_attempt_locked(r), self.cfg.revive_backoff_s,
            self.cfg.revive_backoff_cap_s)
        return {"replica": r.rank, "prev": prev, "detail": detail,
                "reopen_s": round(r.open_until - now, 3)}

    def _emit_opened(self, opened: List[Optional[Dict[str, Any]]]
                     ) -> None:
        for ev in opened:
            if not ev:
                continue
            telemetry.emit("serve_replica_state", replica=ev["replica"],
                           prev=ev["prev"], state=STATE_OPEN,
                           detail=ev["detail"])
            log.warning("serve replica %d circuit OPEN (%s); reopen in "
                        "%.2fs", ev["replica"], ev["detail"],
                        ev["reopen_s"])

    # ------------------------------------------------------------------ #
    # Tick: health refresh, hedging, revival, autoscale                  #
    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        now = time.monotonic()
        self._refresh_health(now)
        if self.cfg.hedge:
            self.maybe_hedge(now)
        if self.cfg.auto_revive:
            self.maybe_revive(now)
        self.autoscale(now)

    def _p99_slow(self, r: ReplicaHealth) -> bool:
        return (self.cfg.slow_p99_s is not None
                and r.p99_step_s is not None
                and r.p99_step_s > self.cfg.slow_p99_s)

    def _refresh_health(self, now: float) -> None:
        wd = getattr(self.group, "watchdog", None)
        wd_states = wd.states() if wd is not None else {}
        slowed: List[Tuple[int, str]] = []
        with self._lock:
            for r in self._replicas.values():
                if r.state in (STATE_OPEN, STATE_HALF_OPEN,
                               STATE_DRAINING):
                    continue
                wd_state = wd_states.get(r.rank)
                slow = wd_state == "slow" or self._p99_slow(r)
                if slow and r.state == STATE_OK:
                    r.state = STATE_SLOW
                    r.last_detail = ("watchdog straggler"
                                     if wd_state == "slow" else
                                     f"p99 {r.p99_step_s:.3f}s > "
                                     f"{self.cfg.slow_p99_s:.3f}s")
                    slowed.append((r.rank, r.last_detail))
                elif not slow and r.state == STATE_SLOW \
                        and not r.chunks:
                    # stale chunks keep it slow until hedge/failure
                    r.state = STATE_OK
                    r.last_detail = ""
        # emitted outside the lock: recorder spills are disk I/O and
        # the dispatcher's route() must not stall behind them
        for rank, detail in slowed:
            telemetry.emit("serve_replica_state", replica=rank,
                           prev=STATE_OK, state=STATE_SLOW,
                           detail=detail)

    def _hedge_age_s(self) -> float:
        if self.cfg.hedge_age_s is not None:
            return self.cfg.hedge_age_s
        wd = getattr(self.group, "watchdog", None)
        if wd is not None:
            return max(0.25, float(wd.slow_after_s))
        return 1.0

    def maybe_hedge(self, now: Optional[float] = None) -> int:
        """Re-dispatch the oldest unhedged in-flight chunk of every
        slow replica to a healthy one.  Returns hedges fired."""
        now = time.monotonic() if now is None else now
        age_bar = self._hedge_age_s()
        to_hedge: List[Tuple[int, _Chunk]] = []
        with self._lock:
            for r in self._replicas.values():
                if r.state != STATE_SLOW or not r.chunks:
                    continue
                oldest = min(r.chunks.values(),
                             key=lambda c: c.t_dispatch)
                if oldest.hedged or oldest.hedge_of is not None:
                    continue
                if now - oldest.t_dispatch < age_bar:
                    continue
                to_hedge.append((r.rank, oldest))
        fired = 0
        for rank, chunk in to_hedge:
            target = self.route(exclude=(rank,))
            if target is None:
                continue  # nowhere healthy to hedge to right now
            items = [(req, resp) for req, resp in chunk.items
                     if not resp.done()]
            if not items:
                continue
            with self._lock:
                chunk.hedged = True
                r = self._replicas.get(rank)
                if r is not None:
                    r.hedges += 1
                if self.cfg.affinity:
                    # a hedge deliberately abandons prefix locality —
                    # latency rescue outranks cache reuse — so it is
                    # accounted as a miss on the target, keeping the
                    # hit-rate honest about re-prefill cost
                    t = self._replicas.get(target)
                    if t is not None:
                        t.prefix_misses += 1
            self.metrics.inc("hedged")
            if self.cfg.affinity:
                self.metrics.inc("prefix_route_misses")
            telemetry.emit("serve_hedge", slow_replica=rank,
                           target=target, requests=len(items),
                           chunk_age_ms=round(
                               (now - chunk.t_dispatch) * 1e3, 1))
            log.warning("hedging %d request(s) of slow replica %d "
                        "onto replica %d", len(items), rank, target)
            self.group._dispatch(target, items,
                                 hedge_of=(rank, chunk.chunk_id))
            fired += 1
        return fired

    def maybe_revive(self, now: Optional[float] = None) -> int:
        """Half-open probe for every open circuit whose backoff
        expired (one replica per call — revival blocks on a worker
        restart round-trip).  Returns successful revivals."""
        now = time.monotonic() if now is None else now
        candidate: Optional[int] = None
        with self._lock:
            for r in self._replicas.values():
                if r.state == STATE_OPEN and now >= r.open_until:
                    r.state = STATE_HALF_OPEN
                    candidate = r.rank
                    break
        if candidate is None:
            return 0
        ok = False
        try:
            # blocking: restart + engine init + one probe dispatch
            self.group._revive_replica(candidate)
            ok = True
        except Exception as e:
            log.warning("half-open probe of replica %d failed: %s",
                        candidate, e)
        with self._lock:
            r = self._replicas.get(candidate)
            if r is None:
                return 0
            if ok:
                r.state = STATE_OK
                r.last_detail = ""
                r.revive_attempts = 0
                r.revivals += 1
                self.metrics.inc("revived")
                telemetry.emit("serve_revive", replica=candidate)
                log.warning("serve replica %d revived (circuit closed)",
                            candidate)
            else:
                r.revive_attempts += 1
                r.state = STATE_OPEN
                r.open_until = time.monotonic() + backoff_delay_s(
                    self._reopen_attempt_locked(r),
                    self.cfg.revive_backoff_s,
                    self.cfg.revive_backoff_cap_s)
        return 1 if ok else 0

    def note_revived(self, rank: int) -> None:
        """Manual ``revive(rank)`` succeeded outside the breaker."""
        with self._lock:
            r = self._replicas.get(rank)
            if r is None:
                return
            r.state = STATE_OK
            r.last_detail = ""
            r.revive_attempts = 0
            r.revivals += 1
        self.metrics.inc("revived")

    # ------------------------------------------------------------------ #
    # Autoscale / brownout                                               #
    # ------------------------------------------------------------------ #
    def _can_grow_locked(self) -> bool:
        return (self.cfg.max_replicas is not None
                and len(self._replicas) < self.cfg.max_replicas)

    def _overload_signals(self, now: float) -> Tuple[float, float, int]:
        """(max FRESH burn over live replicas, queue occupancy,
        in-flight requests).  Burn readings older than ``burn_stale_s``
        count as 0 — they only refresh with chunk completions."""
        depth = self.group.batcher.depth
        cap = max(1, self.group.queue_depth)
        with self._lock:
            burn = max((r.slo_burn for r in self._replicas.values()
                        if r.state in (STATE_OK, STATE_SLOW)
                        and now - r.burn_updated
                        <= self.cfg.burn_stale_s),
                       default=0.0)
            inflight = sum(r.inflight_requests
                           for r in self._replicas.values())
        return burn, depth / cap, inflight

    def _lane_for_growth_locked(self, now: float) -> str:
        """Which lane a scale-up replica joins: the ttft-vs-cadence
        burn split the SloTracker ships per chunk decides.  TTFT
        violations dominating means prefill is the bottleneck — grow
        the prefill lane; cadence dominating (or no fresh signal)
        grows decode.  Only meaningful with lanes enabled."""
        ttft = cadence = 0.0
        for r in self._replicas.values():
            if r.state not in (STATE_OK, STATE_SLOW):
                continue
            if now - r.burn_updated > self.cfg.burn_stale_s:
                continue
            fam = r.slo_families or {}
            ttft = max(ttft, float((fam.get("ttft") or {}).get(
                "violation_fraction") or 0.0))
            cadence = max(cadence, float(
                (fam.get("token_cadence") or {}).get(
                    "violation_fraction") or 0.0))
        return LANE_PREFILL if ttft > cadence else LANE_DECODE

    def autoscale(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        burn, occupancy, inflight = self._overload_signals(now)
        hot = (burn >= self.cfg.scale_up_burn
               or occupancy >= self.cfg.occupancy_high)
        # idle = the occupancy watermark at zero with nothing in
        # flight; sustained over idle_sustain_s before any drain
        idle = (occupancy == 0.0 and inflight == 0)
        # -- scale up ---------------------------------------------------- #
        if hot:
            self._idle_since = None
            if self._hot_since is None:
                self._hot_since = now
            elif now - self._hot_since >= self.cfg.scale_sustain_s:
                grow = False
                with self._lock:
                    grow = self._can_grow_locked()
                if grow:
                    self._hot_since = None  # re-arm the sustain window
                    try:
                        # blocking spawn+init in the tick thread
                        rank = self.group._add_replica()
                    except Exception as e:
                        log.warning("serve scale-up failed: %s", e)
                        return
                    with self._lock:
                        health = ReplicaHealth(rank, scaled=True)
                        if self.cfg.prefill_replicas > 0:
                            health.lane = self._lane_for_growth_locked(
                                now)
                        self._replicas[rank] = health
                        self.affinity.add_rank(rank)
                        lane = health.lane
                    self.metrics.inc("scale_ups")
                    telemetry.emit("serve_scale_up", replica=rank,
                                   lane=lane,
                                   burn=round(burn, 3),
                                   occupancy=round(occupancy, 3))
                    log.warning("serve scale-UP: added replica %d "
                                "to %s lane (burn %.2f, occupancy "
                                "%.2f)", rank, lane, burn, occupancy)
            return
        self._hot_since = None
        # -- scale down (graceful drain) --------------------------------- #
        retire: Optional[int] = None
        drained: Optional[Tuple[int, str]] = None
        with self._lock:
            serving = [r for r in self._replicas.values()
                       if r.state != STATE_DRAINING]
            if idle and len(serving) > self._min_replicas:
                if self._idle_since is None:
                    self._idle_since = now
                elif now - self._idle_since >= self.cfg.idle_sustain_s:
                    self._idle_since = None
                    # drain preference: autoscaled first, then highest
                    # rank; never a replica with work in flight
                    cands = [r for r in serving
                             if r.state in (STATE_OK, STATE_SLOW)
                             and not r.chunks]
                    if self.cfg.prefill_replicas > 0:
                        # lanes enabled: never drain a lane to zero —
                        # an empty lane forces every request cross-lane
                        # and silently undoes the disaggregation
                        lane_counts: Dict[str, int] = {}
                        for r in serving:
                            lane_counts[r.lane] = lane_counts.get(
                                r.lane, 0) + 1
                        cands = [r for r in cands
                                 if lane_counts.get(r.lane, 0) > 1]
                    if cands:
                        victim = sorted(
                            cands, key=lambda r: (not r.scaled,
                                                  -r.rank))[0]
                        prev = victim.state
                        victim.state = STATE_DRAINING
                        victim.last_detail = "scale-down drain"
                        drained = (victim.rank, prev)
            elif not idle:
                self._idle_since = None
            # drained and empty => retire now (one per tick)
            for r in self._replicas.values():
                if r.state == STATE_DRAINING and not r.chunks:
                    retire = r.rank
                    break
        if drained is not None:  # emit outside the lock (disk I/O)
            telemetry.emit("serve_replica_state", replica=drained[0],
                           prev=drained[1], state=STATE_DRAINING,
                           detail="scale-down")
        if retire is not None:
            try:
                self.group._retire_replica(retire)
            except Exception as e:
                log.warning("retiring drained replica %d failed: %s",
                            retire, e)
            with self._lock:
                self._replicas.pop(retire, None)
                self.affinity.remove_rank(retire)
            self.metrics.inc("scale_downs")
            telemetry.emit("serve_scale_down", replica=retire)
            log.warning("serve scale-DOWN: drained and retired "
                        "replica %d", retire)

    def should_shed(self) -> Optional[Tuple[int, int, int]]:
        """Brownout decision at admission: ``(depth, watermark, cap)``
        when the tier must shed this request typed, else None.  Sheds
        only when the queue is past the watermark AND no scale-up
        headroom remains — a tier that can still grow queues instead."""
        if not self.cfg.brownout:
            return None
        depth = self.group.batcher.depth
        cap = self.group.queue_depth
        watermark = max(1, int(self.cfg.brownout_frac * cap))
        if depth < watermark:
            return None
        with self._lock:
            if self._can_grow_locked():
                return None
        return depth, watermark, cap

    # ------------------------------------------------------------------ #
    # Export                                                             #
    # ------------------------------------------------------------------ #
    def states(self) -> Dict[int, str]:
        with self._lock:
            return {r.rank: r.state for r in self._replicas.values()}

    def lane_gauges(self) -> Dict[str, float]:
        """Per-lane occupancy gauges ``ServeMetrics`` merges into every
        snapshot (``bind_lanes``): replica count and in-flight requests
        per disaggregated lane.  With lanes disabled every replica
        reports under decode — the gauges stay live, not absent."""
        with self._lock:
            out = {"lane_prefill_replicas": 0.0,
                   "lane_decode_replicas": 0.0,
                   "lane_prefill_inflight": 0.0,
                   "lane_decode_inflight": 0.0}
            for r in self._replicas.values():
                lane = (r.lane if r.lane in (LANE_PREFILL, LANE_DECODE)
                        else LANE_DECODE)
                out[f"lane_{lane}_replicas"] += 1.0
                out[f"lane_{lane}_inflight"] += float(
                    r.inflight_requests)
        return out

    def down_ranks(self) -> List[int]:
        """Ranks currently out of rotation (open/half-open circuits) —
        the ``replicas_down`` compatibility view."""
        with self._lock:
            return sorted(r.rank for r in self._replicas.values()
                          if r.state in (STATE_OPEN, STATE_HALF_OPEN))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able controller view: per-replica rows + tier-level
        gauges (what /statusz embeds and rla_top renders)."""
        now = time.monotonic()
        depth = self.group.batcher.depth
        cap = self.group.queue_depth
        with self._lock:
            rows = {str(r.rank): r.row(now)
                    for r in self._replicas.values()}
            burn = max((r.slo_burn for r in self._replicas.values()),
                       default=0.0)
            affinity = self.affinity.state()
            affinity["enabled"] = self.cfg.affinity
        return {
            "replicas": rows,
            "affinity": affinity,
            "queue_depth": depth,
            "queue_cap": cap,
            "brownout_watermark": max(1, int(self.cfg.brownout_frac
                                             * cap)),
            "max_burn": round(burn, 4),
            "max_replicas": self.cfg.max_replicas,
            "min_replicas": self._min_replicas,
            "config": {
                "max_retries": self.cfg.max_retries,
                "hedge": self.cfg.hedge,
                "auto_revive": self.cfg.auto_revive,
                "scale_up_burn": self.cfg.scale_up_burn,
                "occupancy_high": self.cfg.occupancy_high,
                "brownout_frac": self.cfg.brownout_frac,
                "affinity": self.cfg.affinity,
                "prefill_replicas": self.cfg.prefill_replicas,
                "handoff_min_blocks": self.cfg.handoff_min_blocks,
            },
        }
