"""N serve-engine replicas on the actor runtime, watchdog-supervised,
with the self-healing controller (serve/controller.py).

Port of the JAX package's ``serve/replicas.py``.  Each replica is a
``runtime.actors.Worker`` process, forked from the port's preloaded
forkserver (``runtime/actors.py`` ``worker_context``), that owns a whole
``ServeEngine`` (weights, KV pool, driver loop): the driver is a thin
router, not a participant in the math, and holds no tensor.  Requests
flow to a replica as CHUNKS (one dispatch carries several requests,
submitted to its engine together so it batches them); responses come
back on the worker future with the engine's own metrics snapshot, the
load and SLO signal the controller routes and scales on.

The replica builds its engine in the worker through ``engine_factory``,
which travels by the standard ``pickle``: a module-level function or a
``functools.partial`` of one (``gpt_engine`` is such a function; a
closure or a lambda is refused by name).  The engine's model takes
``device=None`` as the card and raises without one; every replica of
one machine shares ``cuda:0``.  The worker's forkserver never touches
CUDA, so each replica creates its own context when its factory runs.

Failure model:

- a replica that DIES fails its chunk future with "worker died";
- a replica that WEDGES never fails anything on its own: the pool's
  ``Watchdog`` reaps it from heartbeat staleness and the chunk future
  fails ``WorkerWedged``;
- either way the chunk's unanswered requests re-queue head-of-line
  (with a backoff ``not_before``, bounded by a per-request retry budget)
  and complete on a surviving replica.  Responses are exactly-once by
  the ``ServeResponse`` first-completion-wins contract, so a request is
  never lost and never answered twice (``metrics`` proves the
  accounting), the same contract that makes hedging safe;
- a worker-side exception (the engine itself raised, a CUDA error
  included) is an APPLICATION failure: the requests fail typed and the
  replica keeps serving.  Nothing falls back to the CPU or to a plain
  kernel.

A replica that went down rejoins through the controller's circuit
breaker (``revive(rank)`` is the manual path).  Sustained SLO burn or
queue occupancy adds replicas up to ``max_replicas``, sustained idle
drains them, and a saturated tier with no headroom sheds typed
(``BrownoutShed``).  With ``prefill_replicas`` the tier splits into a
prefill lane, whose replicas answer with KV handoff descriptors, and a
decode lane that imports them (``ServeEngine.submit_handoff`` /
``submit_import`` / ``release_handoff``).

Differences from the JAX package: the engine factory must pickle with
the standard ``pickle`` (the JAX package ships a cloudpickled closure);
and a chunk's ``compile_count`` is this port's count of nvcc and g++ runs
in the replica process (``analysis/compile_guard.py``), 0 once its
libraries exist.
"""

from __future__ import annotations

import itertools
import pickle
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..runtime.actors import WAIT_S, ActorPool, RemoteError
from ..runtime.object_store import ObjectStoreError
from ..runtime.watchdog import WorkerWedged
from ..utils.logging import log
from .batcher import (AdmissionController, BrownoutShed, QueueFull,
                      RequestRejected, ServeCancelled, ServeRequest,
                      ServeResponse, chain_prefix_keys)
from .controller import (LANE_DECODE, LANE_PREFILL, ControllerConfig,
                         ReplicaController)
from .metrics import ServeMetrics

# affinity routing hashes at most this many chain keys per prompt: the
# router only needs enough of the chain to discriminate prefixes
_AFFINITY_KEY_LIMIT = 32

# live-plane labels for groups sharing one process (telemetry/live.py)
_GROUP_SEQ = itertools.count()

# worker-process side: one engine per replica process, installed by
# _replica_init (module-global so chunk dispatches find it); the chaos
# injector for replica-layer faults resolves lazily on the first chunk
_ENGINE = None
_CHAOS: Any = None  # None = unresolved, False = no replica faults


def gpt_engine(config: Dict[str, Any], *, seed: int = 0,
               device: Any = None, compute_dtype: Any = None,
               weight_dtype: Any = None, quantize: bool = False,
               **engine_kwargs: Any) -> Any:
    """An unstarted ``ServeEngine`` over a ``GPT`` of ``config`` (the
    ``TransformerConfig`` fields), the engine factory of a replica:
    ``functools.partial(gpt_engine, cfg, seed=0, max_slots=16)``.

    The weights are built where the factory runs, by
    ``GPT.init_params(seed)`` on the model's device (``device`` None is
    the card); ``weight_dtype`` casts the floating ones (the storage
    type of a bf16 deployment), ``quantize`` then makes them int8
    (``GPT.quantize_weights``).  The rest goes to ``ServeEngine``."""
    import torch

    from ..models.transformer import GPT, TransformerConfig
    from .engine import ServeEngine

    model = GPT(TransformerConfig(**config), device=device,
                compute_dtype=compute_dtype or torch.float32)
    params = model.init_params(seed=seed)
    if weight_dtype is not None:
        params = _cast_floats(params, weight_dtype)
    if quantize:
        params = GPT.quantize_weights(params)
    return ServeEngine(model, params, **engine_kwargs)


def _cast_floats(tree: Any, dtype: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _replica_init(engine_factory: Callable[[], Any]) -> bool:
    """Build and start this replica's engine (runs IN the worker); a
    revived or re-initialised replica stops its old engine first."""
    global _ENGINE
    if _ENGINE is not None:
        _ENGINE.stop(cancel_active=True)
    _ENGINE = engine_factory()
    _ENGINE.start()
    return True


def _replica_chaos(rank: int):
    """Replica-layer chaos injector (testing/chaos.py), resolved once
    per worker process.  ``hang`` freezes this process's heartbeat so
    the pool watchdog sees a frozen process, as a worker-layer hang."""
    global _CHAOS
    if _CHAOS is None:
        from ..analysis import knobs
        inj = False
        if knobs.get_raw("RLA_TPU_CHAOS"):
            from ..runtime.actors import freeze_current_heartbeat
            from ..testing.chaos import ChaosInjector
            inj = ChaosInjector.from_env(
                rank, freeze_heartbeat=freeze_current_heartbeat,
                layer="replica") or False
        _CHAOS = inj
    return _CHAOS or None


def _engine_stats_snapshot() -> Dict[str, Any]:
    from ..analysis import compile_guard
    snap = _ENGINE.stats()
    snap["compile_count"] = compile_guard.compile_count()
    return snap


def _replica_serve(rank: int, items: List[Tuple[int, Any, int]]
                   ) -> Tuple[List[Tuple[int, Any]], Dict[str, Any]]:
    """Serve one chunk (runs IN the worker).  Every request is submitted
    before any is waited on, so the engine batches them.  Returns
    ``(results, engine stats snapshot)``: the stats ride every chunk
    home, so the controller's signals stay fresh without extra
    dispatches (which would also shift the chaos chunk numbering)."""
    if _ENGINE is None:
        raise RuntimeError("replica engine not initialized")
    chaos = _replica_chaos(rank)
    if chaos is not None:
        chaos.on_dispatch()  # may crash/hang/slow THIS chunk
    handles = [(rid, _ENGINE.submit(np.asarray(prompt, np.int32), n))
               for rid, prompt, n in items]
    results = [(rid, np.asarray(h.result())) for rid, h in handles]
    return results, _engine_stats_snapshot()


def _replica_prefill(rank: int,
                     items: List[Tuple[int, Any, int, float, Any, Any]]
                     ) -> Tuple[List[Tuple[int, Any]], Dict[str, Any]]:
    """Prefill-lane chunk (runs IN the worker): each request resolves to
    a KV handoff descriptor, its blocks pinned until the driver releases
    them (``_replica_release``).  Items carry the client's original
    ``t_submit`` / ``deadline`` / ``trace_id``: monotonic clocks are
    system-wide on one host, so a deadline survives the process hop."""
    if _ENGINE is None:
        raise RuntimeError("replica engine not initialized")
    chaos = _replica_chaos(rank)
    if chaos is not None:
        chaos.on_dispatch()
    handles = [(rid, _ENGINE.submit_handoff(
        np.asarray(prompt, np.int32), n, t_submit=t_submit,
        deadline=deadline, trace_id=trace_id))
        for rid, prompt, n, t_submit, deadline, trace_id in items]
    results = [(rid, h.result()) for rid, h in handles]
    return results, _engine_stats_snapshot()


def _replica_import(rank: int, descs: List[Tuple[int, Dict[str, Any]]]
                    ) -> Tuple[List[Tuple[int, Any]], Dict[str, Any]]:
    """Decode-lane chunk (runs IN the worker): each handoff descriptor
    becomes a live mid-decode slot.  A stale object-store ref (its
    source died and the segments were unlinked) surfaces typed, and the
    driver re-queues the request for a full prefill."""
    if _ENGINE is None:
        raise RuntimeError("replica engine not initialized")
    chaos = _replica_chaos(rank)
    if chaos is not None:
        chaos.on_dispatch()
    handles = [(rid, _ENGINE.submit_import(desc)) for rid, desc in descs]
    results = [(rid, np.asarray(h.result())) for rid, h in handles]
    return results, _engine_stats_snapshot()


def _replica_release(rank: int, handoff_ids: List[int]) -> int:
    """Drop export holds on this prefill replica (runs IN the worker).
    Not a chaos dispatch: release is bookkeeping, and counting it would
    shift the chunk numbers chaos faults name."""
    if _ENGINE is None:
        return 0
    n = 0
    for hid in handoff_ids:
        n += bool(_ENGINE.release_handoff(hid))
    return n


def _replica_stats() -> Dict[str, Any]:
    """Engine metrics snapshot (runs IN the worker); also the circuit
    breaker's half-open probe."""
    if _ENGINE is None:
        raise RuntimeError("replica engine not initialized")
    return _engine_stats_snapshot()


def _replica_stop() -> bool:
    """Graceful engine stop (runs IN the worker): the scale-down drain.
    Admission is already fenced on the driver; in-flight slots finish."""
    global _ENGINE
    if _ENGINE is not None:
        _ENGINE.stop(cancel_active=False)
        _ENGINE = None
    return True


def _is_application_failure(exc: BaseException) -> bool:
    """Failure triage of a chunk dispatch: True when the dispatched code
    failed deterministically (fail those requests, keep the replica),
    False for infrastructure death (open the circuit, requeue onto
    survivors).  Application = a ``RemoteError``, or a typed exception
    ``runtime/wire.py`` rebuilt from a worker-raised payload
    (``remote_typed``, e.g. an ``ObjectStoreError`` of a stale ref).  A
    ``WorkerWedged`` stays infrastructure even when the worker raised
    it."""
    if isinstance(exc, RemoteError):
        return True
    return (getattr(exc, "remote_typed", False)
            and not isinstance(exc, WorkerWedged))


def _check_factory(engine_factory: Callable[[], Any]) -> None:
    """The factory travels to every replica by the standard ``pickle``:
    one that cannot is refused here, by name."""
    try:
        pickle.dumps(engine_factory)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"engine_factory {engine_factory!r} cannot be sent to the "
            f"replicas ({e}); the port ships work with the standard "
            "pickle: make it a module-level function or a "
            "functools.partial of one") from e


class ServeReplicas:
    """Self-healing router over ``num_replicas`` engine replicas.

    ``engine_factory``: zero-argument callable building a startable
    ``ServeEngine`` inside each worker (a module-level function or a
    ``functools.partial`` of one, e.g. of ``gpt_engine``).
    ``chunk_size``: max requests per dispatch (the replica's engine
    batches the chunk).  ``wedge_timeout_s`` / ``heartbeat_s``: watchdog
    knobs, see runtime/watchdog.py.  ``max_requeues``: infra-failure
    retries per request before it fails typed (None = the
    ``RLA_TPU_SERVE_MAX_RETRIES`` knob, default 2).

    ``controller``: a :class:`~.controller.ControllerConfig` (None = the
    knob-backed default) for routing, hedging, the circuit breaker,
    autoscaling and brownout.  ``scale_env``: env overlay of autoscaled
    replicas (by default the heartbeat knob only: the chaos and port
    overlays of the initial replicas are not inherited).
    ``affinity_block_len`` must equal the engines' ``block_len``, or the
    router's chain keys never match what the replicas register."""

    def __init__(self, engine_factory: Callable[[], Any],
                 num_replicas: int = 2, *, queue_depth: int = 256,
                 max_total_len: Optional[int] = None,
                 chunk_size: int = 4,
                 max_requeues: Optional[int] = None,
                 heartbeat_s: Optional[float] = None,
                 wedge_timeout_s: Optional[float] = None,
                 supervise: bool = True,
                 env_per_worker: Optional[List[Dict[str, str]]] = None,
                 idle_poll_s: float = 0.02,
                 controller: Optional[ControllerConfig] = None,
                 scale_env: Optional[Dict[str, str]] = None,
                 affinity_block_len: int = 16):
        _check_factory(engine_factory)
        envs = [dict(e) for e in (env_per_worker
                                  or [{} for _ in range(num_replicas)])]
        if heartbeat_s is not None:
            for e in envs:
                e.setdefault("RLA_TPU_WORKER_HEARTBEAT_S",
                             str(heartbeat_s))
        self.chunk_size = max(1, chunk_size)
        self.queue_depth = queue_depth
        self.affinity_block_len = max(1, affinity_block_len)
        # handoff descriptors awaiting a decode-lane dispatch, appended
        # by prefill-done callbacks (collector threads) and drained by
        # the dispatch loop; deque append/popleft are atomic
        self._pending_imports: deque = deque()
        self.metrics = ServeMetrics()
        self.batcher = AdmissionController(queue_depth=queue_depth,
                                           max_total_len=max_total_len)
        self.metrics.bind_queue(lambda: self.batcher.depth)
        self._idle_poll_s = idle_poll_s
        self._stop = threading.Event()
        self._engine_factory = engine_factory
        self._scale_env = dict(scale_env or {})
        if heartbeat_s is not None:
            self._scale_env.setdefault("RLA_TPU_WORKER_HEARTBEAT_S",
                                       str(heartbeat_s))
        self._live_label: Optional[str] = None
        self.pool = ActorPool(num_replicas, env_per_worker=envs)
        try:
            for f in self.pool.execute_all(_replica_init, engine_factory):
                f.result(timeout=WAIT_S)
            self.watchdog = (self.pool.watch(
                wedge_timeout_s=wedge_timeout_s) if supervise else None)
        except BaseException:
            self.pool.kill()
            raise
        cfg = controller or ControllerConfig.from_env()
        self.controller = ReplicaController(self, cfg)
        self.max_requeues = (max_requeues if max_requeues is not None
                             else cfg.max_retries)
        # per-lane occupancy gauges ride every tier snapshot; the merge
        # happens outside the metrics lock (ServeMetrics.snapshot), so
        # taking the controller lock inside lane_gauges cannot invert
        self.metrics.bind_lanes(self.controller.lane_gauges)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="rla-torch-serve-dispatch")
        self._dispatcher.start()
        self.controller.start()
        # the live plane (telemetry/live.py): with RLA_TPU_METRICS_PORT
        # set, the tier's metrics and the controller's per-replica table
        # are on the driver's /metrics and /statusz while it serves
        from ..telemetry import live as live_lib
        srv = live_lib.maybe_start_from_env()
        if srv is not None:
            self._live_label = f"replicas{next(_GROUP_SEQ)}"
            srv.sources.add_serve(self._live_label, self.metrics)
            srv.sources.bind_replica_controller(self.controller)

    # ------------------------------------------------------------------ #
    # Client surface                                                     #
    # ------------------------------------------------------------------ #
    def submit(self, prompt: Any, max_new_tokens: int) -> ServeResponse:
        """Admit a request to the tier (typed ``BrownoutShed`` /
        ``QueueFull`` / ``RequestRejected``); the response resolves to
        prompt + greedily generated tokens."""
        shed = self.controller.should_shed()
        if shed is not None:
            depth, watermark, cap = shed
            self.metrics.inc("rejected")
            self.metrics.inc("brownout_shed")
            from ..telemetry import recorder
            recorder.emit("serve_brownout_shed", depth=depth,
                           watermark=watermark)
            raise BrownoutShed(depth, watermark, cap)
        try:
            resp = self.batcher.submit(prompt, max_new_tokens)
        except (QueueFull, RequestRejected):
            # admission rejections only -- shutdown's ServeCancelled must
            # not read as overload
            self.metrics.inc("rejected")
            raise
        self.metrics.inc("submitted")
        return resp

    def stats(self) -> Dict[str, Any]:
        out = self.metrics.snapshot()
        out["replicas"] = len(self.pool)
        out["replicas_down"] = self.controller.down_ranks()
        out["controller"] = self.controller.snapshot()
        if self.watchdog is not None:
            out["supervision"] = self.watchdog.report()
        return out

    def replica_stats(self, rank: int) -> Dict[str, Any]:
        """A live replica's own engine metrics (its ``steps_batch_gt1``
        counts shared decode steps; ``compile_count`` its builds)."""
        w = self._worker(rank)
        if w is None:
            raise RuntimeError(
                f"replica {rank} is not in the pool (retired by a "
                "scale-down, or never existed)")
        return w.execute(_replica_stats).result()

    def revive(self, rank: int) -> None:
        """Restart a replica and re-initialise its engine now: the manual
        path of what the circuit breaker does after its backoff."""
        self._revive_replica(rank)
        self.controller.note_revived(rank)

    def shutdown(self) -> None:
        self._stop.set()
        self.controller.stop()
        self.batcher.kick()
        self._dispatcher.join(timeout=30)
        n = self.batcher.shutdown()
        if n:
            self.metrics.inc("cancelled", n)
        # handoffs prefixed but never imported: cancel typed (their
        # source holds die with the replica engines at pool shutdown)
        while self._pending_imports:
            _src, req, resp, _desc = self._pending_imports.popleft()
            if resp._fail(ServeCancelled(
                    f"request {req.request_id} cancelled: tier shut "
                    "down with its KV handoff awaiting a decode "
                    "replica")):
                self.metrics.inc("cancelled")
        if self.watchdog is not None:
            self.watchdog.stop()
        if self._live_label is not None:
            from ..telemetry import live as live_lib
            srv = live_lib.get_server()
            if srv is not None:
                srv.sources.remove_serve(self._live_label)
                # only OUR controller: a sibling group that bound after
                # us must keep its table on the export
                srv.sources.unbind_replica_controller(self.controller)
            self._live_label = None
        self.pool.shutdown()

    def __enter__(self) -> "ServeReplicas":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------ #
    # Replica mechanics (the controller's hands)                         #
    # ------------------------------------------------------------------ #
    def _worker(self, rank: int) -> Any:
        """Rank-keyed lookup: after scale-downs the workers list is no
        longer index-aligned with ranks."""
        for w in self.pool.workers:
            if w.rank == rank:
                return w
        return None

    def _revive_replica(self, rank: int) -> Dict[str, Any]:
        """Restart and re-initialise one replica and probe it (one stats
        round trip) before it may rejoin rotation; raises on any
        failure.  Each worker generation publishes its telemetry
        portfile and heartbeat channel at boot (``runtime/actors.py``,
        ``telemetry/live.py``), so a revived replica reappears in the
        ClusterView as it is."""
        w = self._worker(rank)
        if w is None:
            raise RuntimeError(f"replica {rank} is not in the pool")
        w.restart()
        w.execute(_replica_init, self._engine_factory).result(
            timeout=self.controller.cfg.probe_timeout_s)
        return w.execute(_replica_stats).result(
            timeout=self.controller.cfg.probe_timeout_s)

    def _add_replica(self) -> int:
        """Scale-up: spawn one more replica worker and init its engine
        (blocking; runs in the controller tick thread)."""
        w = self.pool.add_worker(env=dict(self._scale_env))
        try:
            w.execute(_replica_init, self._engine_factory).result(
                timeout=self.controller.cfg.probe_timeout_s)
        except BaseException:
            try:
                self.pool.drop([w.rank])
            except Exception as e:
                log.warning("dropping the failed scale-up replica %d "
                            "failed: %s", w.rank, e)
            raise
        return w.rank

    def _retire_replica(self, rank: int) -> None:
        """Scale-down of a DRAINED replica: stop its engine gracefully,
        then the worker, then forget the rank (survivors keep their
        rank identity — ``ActorPool.drop`` semantics)."""
        w = self._worker(rank)
        if w is None:
            return
        try:
            w.execute(_replica_stop).result(timeout=30)
        except Exception as e:
            log.warning("graceful engine stop of replica %d failed: %s",
                        rank, e)
        self.pool.drop([rank])

    # ------------------------------------------------------------------ #
    # Dispatch                                                           #
    # ------------------------------------------------------------------ #
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._dispatch_once()
            except Exception as e:  # a policy bug must not kill dispatch
                log.error("serve dispatch iteration failed: %s", e)
                time.sleep(self._idle_poll_s)

    def _dispatch_once(self) -> None:
        # handoff descriptors first: their prefill already happened, so
        # every tick they wait is pure added TTFB on a finished prefill
        self._dispatch_imports()
        if not self.batcher.wait_for_work(self._idle_poll_s):
            return
        if not self.controller.serving_possible():
            # no capacity will ever come back on its own (every
            # circuit open and auto-revive disabled): fail the
            # queue typed rather than hang every caller forever
            for req, resp in iter(self.batcher.pop, None):
                if resp._fail(ServeCancelled(
                        f"request {req.request_id}: every replica is "
                        "down and auto-revive is disabled")):
                    self.metrics.inc("failed")
            while self._pending_imports:
                _src, req, resp, _desc = self._pending_imports.popleft()
                if resp._fail(ServeCancelled(
                        f"request {req.request_id}: every replica is "
                        "down and auto-revive is disabled")):
                    self.metrics.inc("failed")
            time.sleep(self._idle_poll_s)
            return
        batch: List[Tuple[ServeRequest, ServeResponse]] = []
        while len(batch) < self.chunk_size:
            item = self.batcher.pop()
            if item is None:
                break
            if item[1].done():
                # a requeued request a hedge copy already answered:
                # nothing left to serve — dropping it here saves a
                # whole wasted prefill+decode on a replica
                continue
            batch.append(item)
        if not batch:
            # nothing dispatchable right now (empty queue race or a
            # requeue-lane head still inside its retry backoff)
            time.sleep(self._idle_poll_s / 2)
            return
        # route PER REQUEST (prefix affinity is a property of the
        # prompt, not the chunk), then regroup by destination so one
        # dispatch still carries everything the replica can batch
        cfg = self.controller.cfg
        lanes_on = cfg.prefill_replicas > 0
        bl = self.affinity_block_len
        groups: Dict[Tuple[int, bool], List[
            Tuple[ServeRequest, ServeResponse]]] = {}
        unrouted: List[Tuple[ServeRequest, ServeResponse]] = []
        for req, resp in batch:
            keys = (chain_prefix_keys(req.prompt, bl,
                                      limit=_AFFINITY_KEY_LIMIT)
                    if cfg.affinity else None) or None
            handoff = (lanes_on and req.max_new_tokens > 1
                       and int(req.prompt.size) // bl
                       >= cfg.handoff_min_blocks)
            lane = ((LANE_PREFILL if handoff else LANE_DECODE)
                    if lanes_on else None)
            rank = self.controller.route(prefix_keys=keys, lane=lane)
            if rank is None:
                unrouted.append((req, resp))
                continue
            groups.setdefault((rank, handoff), []).append((req, resp))
        for item in reversed(unrouted):  # keep FIFO order at the head
            self.batcher.push_front(item)
        if not groups:
            time.sleep(self._idle_poll_s)
            return
        for (rank, handoff), chunk in groups.items():
            if handoff:
                self._dispatch_prefill(rank, chunk)
            else:
                self._dispatch(rank, chunk)

    def _dispatch(self, rank: int,
                  chunk: List[Tuple[ServeRequest, ServeResponse]],
                  hedge_of: Optional[Tuple[int, int]] = None) -> None:
        """Ship one chunk to ``rank`` (primary dispatch, or a HEDGE
        copy when ``hedge_of`` names the slow original)."""
        chunk_id = self.controller.on_dispatch(rank, chunk,
                                               hedge_of=hedge_of)
        items = [(req.request_id, req.prompt, req.max_new_tokens)
                 for req, _ in chunk]
        w = self._worker(rank)
        if w is None:
            fut = None
        else:
            fut = w.execute(_replica_serve, rank, items)
        if fut is None:
            exc = RuntimeError(f"replica {rank} left the pool before "
                               "dispatch")
            self.controller.note_infra_failure(rank, chunk_id, exc)
            for req, resp in chunk:
                self._requeue_or_fail(req, resp, exc, rank)
            return
        fut.add_done_callback(
            lambda f, r=rank, cid=chunk_id, c=chunk, h=hedge_of:
            self._on_chunk_done(r, cid, c, h, f))

    def _on_chunk_done(self, rank: int, chunk_id: int,
                       chunk: List[Tuple[ServeRequest, ServeResponse]],
                       hedge_of: Optional[Tuple[int, int]],
                       fut) -> None:
        """Runs on the worker's collector thread: settle or re-queue."""
        exc = fut.exception()
        if exc is None:
            results, stats = fut.result()
            self.controller.note_success(rank, chunk_id, stats)
            results = dict(results)
            now = time.monotonic()
            hedge_won = False
            for req, resp in chunk:
                tokens = results.get(req.request_id)
                if tokens is None:
                    self._requeue_or_fail(req, resp, RuntimeError(
                        f"replica {rank} returned no result for request "
                        f"{req.request_id}"), rank)
                elif resp._complete(tokens):
                    self.metrics.inc("completed")
                    # tier-level TTFT: a chunk returns the FULL
                    # sequence, so submit -> response is the finest
                    # first-token signal the driver can observe (it
                    # upper-bounds the replica's own TTFT and is what
                    # a tier client actually waits)
                    if resp.ttft_s is None:
                        resp.ttft_s = now - req.t_submit
                        self.metrics.observe_ttft(resp.ttft_s)
                    hedge_won = True
            if hedge_of is not None and hedge_won:
                # the hedge copy answered before the slow original —
                # first-completion-wins proves each response still
                # resolved exactly once.  Counted per hedge CHUNK, the
                # same unit as "hedged", so hedge_wins/hedged is a rate
                self.metrics.inc("hedge_wins")
            return
        if _is_application_failure(exc):
            # application failure: deterministic, don't poison survivors
            self.controller.note_app_failure(rank, chunk_id)
            log.error("replica %d failed a chunk application-side: %s",
                      rank, exc)
            for req, resp in chunk:
                if resp._fail(exc):
                    self.metrics.inc("failed")
            return
        # infra failure: wedged (watchdog reap) or died — open the
        # circuit and requeue; the breaker revives it later
        self.controller.note_infra_failure(rank, chunk_id, exc)
        if isinstance(exc, WorkerWedged):
            self.metrics.inc("wedge_events")
        log.warning("replica %d lost mid-chunk (%s); recovering %d "
                    "request(s) (requeue unless a hedge already "
                    "answered)", rank, type(exc).__name__, len(chunk))
        for req, resp in chunk:
            self._requeue_or_fail(req, resp, exc, rank)

    def _requeue_or_fail(self, req: ServeRequest, resp: ServeResponse,
                         exc: BaseException,
                         rank: Optional[int] = None) -> None:
        if resp.done():
            return
        if req.requeues >= self.max_requeues:
            if resp._fail(exc):
                self.metrics.inc("failed")
            return
        delay = self.controller.charge_retry(rank, req)
        if self.batcher.requeue(req, resp, delay_s=delay):
            self.metrics.inc("requeued")

    # ------------------------------------------------------------------ #
    # Disaggregated prefill/decode lanes (KV handoff)                    #
    # ------------------------------------------------------------------ #
    def _dispatch_prefill(self, rank: int,
                          chunk: List[Tuple[ServeRequest,
                                            ServeResponse]]) -> None:
        """Ship one prefill-lane chunk: the replica prefills and returns
        handoff DESCRIPTORS; `_on_prefill_done` queues them for a
        decode-lane import.  The chunk stays a first-class controller
        chunk — hedging sees it age like any other, and a hedge fires
        the normal full-serve path (first-completion-wins keeps that
        race exactly-once)."""
        chunk_id = self.controller.on_dispatch(rank, chunk)
        items = [(req.request_id, req.prompt, req.max_new_tokens,
                  req.t_submit, req.deadline, req.trace_id)
                 for req, _ in chunk]
        w = self._worker(rank)
        if w is None:
            exc = RuntimeError(f"replica {rank} left the pool before "
                               "prefill dispatch")
            self.controller.note_infra_failure(rank, chunk_id, exc)
            for req, resp in chunk:
                self._requeue_or_fail(req, resp, exc, rank)
            return
        fut = w.execute(_replica_prefill, rank, items)
        fut.add_done_callback(
            lambda f, r=rank, cid=chunk_id, c=chunk:
            self._on_prefill_done(r, cid, c, f))

    def _on_prefill_done(self, rank: int, chunk_id: int,
                         chunk: List[Tuple[ServeRequest, ServeResponse]],
                         fut) -> None:
        """Collector-thread callback for a prefill-lane chunk: hand each
        descriptor to the import queue (or clean up after a hedge that
        answered first)."""
        exc = fut.exception()
        if exc is not None:
            if _is_application_failure(exc):
                self.controller.note_app_failure(rank, chunk_id)
                log.error("replica %d failed a prefill chunk "
                          "application-side: %s", rank, exc)
                for req, resp in chunk:
                    if resp._fail(exc):
                        self.metrics.inc("failed")
                return
            self.controller.note_infra_failure(rank, chunk_id, exc)
            if isinstance(exc, WorkerWedged):
                self.metrics.inc("wedge_events")
            log.warning("prefill replica %d lost mid-chunk (%s); "
                        "recovering %d request(s)", rank,
                        type(exc).__name__, len(chunk))
            for req, resp in chunk:
                self._requeue_or_fail(req, resp, exc, rank)
            return
        results, stats = fut.result()
        self.controller.note_success(rank, chunk_id, stats)
        results = dict(results)
        now = time.monotonic()
        queued = False
        for req, resp in chunk:
            desc = results.get(req.request_id)
            if desc is None:
                self._requeue_or_fail(req, resp, RuntimeError(
                    f"replica {rank} returned no handoff for request "
                    f"{req.request_id}"), rank)
                continue
            if resp.done():
                # a hedge (full serve) answered while the lane worked:
                # nothing to import, just drop the source hold
                self._release_source(rank, [desc["handoff_id"]])
                continue
            self.metrics.inc("kv_handoffs")
            self.metrics.inc("kv_handoff_bytes",
                             int(desc.get("bytes", 0)))
            # tier-level TTFT: the first token exists the moment the
            # prefill lane returns, not when decode finishes
            if resp.ttft_s is None:
                resp.ttft_s = now - req.t_submit
                self.metrics.observe_ttft(resp.ttft_s)
            self._pending_imports.append((rank, req, resp, desc))
            queued = True
        if queued:
            self.batcher.kick()  # wake the dispatcher for the imports

    def _dispatch_imports(self) -> None:
        """Drain queued handoff descriptors onto decode-lane replicas
        (runs at the top of every dispatch iteration)."""
        batch = []
        while self._pending_imports and len(batch) < self.chunk_size:
            batch.append(self._pending_imports.popleft())
        if not batch:
            return
        groups: Dict[int, List[Tuple[int, ServeRequest, ServeResponse,
                                     Dict[str, Any]]]] = {}
        back = []
        for entry in batch:
            src_rank, req, resp, desc = entry
            if resp.done():
                # hedge/requeue answered while the descriptor queued
                self._release_source(src_rank, [desc["handoff_id"]])
                continue
            rank = self.controller.route(lane=LANE_DECODE)
            if rank is None:
                back.append(entry)
                continue
            groups.setdefault(rank, []).append(entry)
        for entry in reversed(back):
            self._pending_imports.appendleft(entry)
        for rank, entries in groups.items():
            self._dispatch_import(rank, entries)

    def _dispatch_import(self, rank: int,
                         entries: List[Tuple[int, ServeRequest,
                                             ServeResponse,
                                             Dict[str, Any]]]) -> None:
        chunk = [(req, resp) for _src, req, resp, _d in entries]
        chunk_id = self.controller.on_dispatch(rank, chunk)
        descs = [(req.request_id, desc)
                 for _src, req, _resp, desc in entries]
        w = self._worker(rank)
        if w is None:
            exc = RuntimeError(f"replica {rank} left the pool before "
                               "import dispatch")
            self.controller.note_infra_failure(rank, chunk_id, exc)
            self._recover_import_entries(entries, exc, rank)
            return
        fut = w.execute(_replica_import, rank, descs)
        fut.add_done_callback(
            lambda f, r=rank, cid=chunk_id, e=entries:
            self._on_import_done(r, cid, e, f))

    def _on_import_done(self, rank: int, chunk_id: int,
                        entries: List[Tuple[int, ServeRequest,
                                            ServeResponse,
                                            Dict[str, Any]]],
                        fut) -> None:
        """Settle a decode-lane import chunk.  Every terminal path
        releases the source holds exactly once: a released source keeps
        the prompt blocks LRU-cached in its prefix index, so even the
        requeue-for-re-prefill path lands back on a warm cache."""
        exc = fut.exception()
        if exc is None:
            results, stats = fut.result()
            self.controller.note_success(rank, chunk_id, stats)
            results = dict(results)
            for _src, req, resp, desc in entries:
                tokens = results.get(req.request_id)
                if tokens is None:
                    self._requeue_or_fail(req, resp, RuntimeError(
                        f"replica {rank} returned no result for "
                        f"imported request {req.request_id}"), rank)
                elif resp._complete(tokens):
                    self.metrics.inc("completed")
                    # residency truth: the KV now lives on the decode
                    # replica — future same-prefix routes go there
                    self.controller.note_import(rank,
                                                desc.get("keys"))
            self._release_entries(entries)
            return
        if _is_application_failure(exc):
            self.controller.note_app_failure(rank, chunk_id)
            if isinstance(exc, ObjectStoreError):
                # the shipped payload is gone (source died and its
                # segments were unlinked): deterministic for THIS
                # descriptor but not for the request — requeue it for
                # a full re-prefill instead of failing typed
                log.warning("import on replica %d hit a stale handoff "
                            "payload (%s); re-queueing %d request(s) "
                            "for full re-prefill", rank, exc,
                            len(entries))
                for _src, req, resp, _d in entries:
                    self._requeue_or_fail(req, resp, exc, rank)
            else:
                log.error("replica %d failed an import chunk "
                          "application-side: %s", rank, exc)
                for _src, req, resp, _d in entries:
                    if resp._fail(exc):
                        self.metrics.inc("failed")
            self._release_entries(entries)
            return
        self.controller.note_infra_failure(rank, chunk_id, exc)
        if isinstance(exc, WorkerWedged):
            self.metrics.inc("wedge_events")
        log.warning("decode replica %d lost mid-import (%s); "
                    "recovering %d request(s)", rank,
                    type(exc).__name__, len(entries))
        self._recover_import_entries(entries, exc, rank)

    def _recover_import_entries(self, entries, exc,
                                rank: Optional[int]) -> None:
        """Requeue an import chunk's originals (full re-prefill on a
        survivor) and release their source holds — the sources' prefix
        caches make the retry's prefill a block-table hit, not a
        recompute."""
        for _src, req, resp, _d in entries:
            self._requeue_or_fail(req, resp, exc, rank)
        self._release_entries(entries)

    def _release_entries(self, entries) -> None:
        by_src: Dict[int, List[int]] = {}
        for src, _req, _resp, desc in entries:
            by_src.setdefault(src, []).append(desc["handoff_id"])
        for src, hids in by_src.items():
            self._release_source(src, hids)

    def _release_source(self, src_rank: int,
                        handoff_ids: List[int]) -> None:
        """Fire-and-forget release of export holds on the prefill
        replica.  Best-effort by design: if the source is gone, its
        engine (and shm segments) died with it — there is nothing left
        to release."""
        w = self._worker(src_rank)
        if w is None or not w.is_alive:
            return
        try:
            fut = w.execute(_replica_release, src_rank,
                            list(handoff_ids))
            fut.add_done_callback(lambda f: f.exception())  # swallow
        except Exception:
            pass
