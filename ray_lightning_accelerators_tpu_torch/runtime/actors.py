"""Actor runtime: persistent worker processes with remote-execute futures.

Port of the JAX package's ``runtime/actors.py`` (``Worker``,
``ActorPool``, ``RemoteError``) for workers on this host:

- each ``Worker`` is a long-lived subprocess running a request loop,
  forked from a forkserver that imported the port once (and with it
  torch): a worker starts without an interpreter of its own and its
  imports (``worker_context``; the JAX package spawns).  It takes the
  driver's environment as it is when the worker starts, then its
  overlay, as a spawned process would; work arrives as a pickled ``(fn,
  args, kwargs)``;
- ``execute()`` returns a ``concurrent.futures.Future`` that a
  driver-side collector thread resolves; a worker-side exception fails
  it with ``RemoteError``, which carries the worker's traceback, and a
  worker that dies fails every future it still owed;
- a worker's env overlay is applied when it starts, before it runs any
  work (and so before CUDA initialises in it);
- every worker of an ``ActorPool`` holds the pool's channel, a
  ``multiprocessing`` queue that ``runtime.session.put_queue`` writes
  and the driver's ``runtime.queue.process_results`` drains.

- a top-level ``ObjectRef`` argument of shipped work is resolved from
  the shared-memory store in the worker before the call (Ray's
  call-site deref);
- ``Worker.restart()`` and ``ActorPool.restart_all()`` respawn workers
  with the same rank and env (SIGTERM, escalating to SIGKILL); the old
  process's pending futures fail with "worker N died";
- a worker that was killed, restarted or ended without its exit handlers
  leaves no shm segments: ``restart`` and ``kill`` unlink what its
  object store still owned;
- each worker configures its flight recorder (``telemetry/recorder.py``)
  with its rank and overlay at boot and brackets every dispatch with
  ``dispatch_begin`` / ``dispatch_end`` events (the count ``n``, ``ok``),
  and ``Worker.telemetry_tail()`` reads its spill from the driver, also
  after the worker died;
- with ``RLA_TPU_METRICS_PORT`` in its environment a worker starts its
  live telemetry server (``telemetry/live.py``) after the fork, and
  ``Worker.live_snapshot()`` scrapes it for the driver's ClusterView.

The recovery layer (the JAX file's ``:57-206``, ``:277-283``,
``:420-428`` and ``:545-709``):

- every worker stamps a ``runtime/watchdog.py`` ``HeartbeatChannel``
  (``RLA_TPU_WORKER_HEARTBEAT_S``, of its overlay or of this process;
  ``<= 0`` turns it off) and brackets each call with the busy marker
  and the dispatch count; ``ActorPool.watch()`` starts a ``Watchdog``,
  and ``Worker.reap`` kills a wedged worker so that its futures fail
  with ``WorkerWedged`` carrying the diagnosis;
- a worker's typed exception comes home typed: ``Worker._collect``
  rebuilds through ``runtime/wire.py`` (``Preempted``,
  ``WorkerWedged``, ``NumericAnomaly``, ``PipelineHandoffTimeout``, ...),
  anything else as ``RemoteError``;
- with ``RLA_TPU_PREEMPT_GRACE_S`` in its env a worker installs the
  preemption notice (``runtime/preemption.py``): SIGTERM then means
  "drain", so ``restart``, ``kill`` and ``reap`` send it SIGKILL at
  once (a SIGTERM would cost the 10 s join and leave a false flag);
- ``RLA_TPU_CHAOS`` arms ``testing/chaos.py``'s injector at boot, and it
  runs before every call (``freeze_current_heartbeat`` lets a hang
  freeze the beat);
- ``ActorPool``: ``add_worker``, ``restart_dead``, ``find_lost``
  (``classify=True`` tells a revivable rank from a gone one), ``drop``
  (the elastic scale-down: survivors keep their rank), ``dropped_ranks``
  and ``revive``.

Work and results ship with the standard ``pickle`` (the card's machine
has no cloudpickle): a function is sent by its import path, so it must
be defined at module level (a lambda or a closure raises
``PicklingError`` at ``execute``), and the worker must be able to import
it.  ``ActorPool(agents=)`` places the workers on host agents
(``runtime/agent.py`` ``RemoteWorker``); ``add_worker`` and ``revive``
refuse or return None on such a pool, as the JAX package's.

A script that creates a pool guards it with ``if __name__ ==
"__main__":``: spawned children import the main module again.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import struct
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..analysis import knobs
from ..utils.logging import log
from .watchdog import (HeartbeatChannel, WorkerBeat, WorkerWedged,
                       heartbeat_interval_s)

_SENTINEL = b"__shutdown__"
# how long a pool waits for a census, an env update or a graceful exit
WAIT_S = 300.0

# worker side: the pool's channel to the driver, set when the worker starts
_channel: Optional[Any] = None
# worker side: this process's beat thread, so a layer above the dispatch
# loop can freeze it
_CURRENT_BEAT: Optional[WorkerBeat] = None


def worker_channel() -> Optional[Any]:
    """Inside a worker: its pool's channel to the driver (None elsewhere)."""
    return _channel


def freeze_current_heartbeat() -> None:
    """Freeze this worker's heartbeat thread (a no-op on the driver or
    with heartbeats off): a hang injected above the dispatch loop then
    reads as a frozen process to the watchdog."""
    if _CURRENT_BEAT is not None:
        _CURRENT_BEAT.freeze()


_READ_CHUNK = 1 << 20


def _read_exact(f, n: int) -> bytes:
    out = b""
    while len(out) < n:
        part = f.read(n - len(out))
        if not part:
            raise EOFError
        out += part
    return out


def _recv_blob(conn) -> bytearray:
    """One message of ``conn`` (``Connection.send_bytes``'s framing: a
    4-byte size, or -1 and an 8-byte size), read into one buffer.
    ``Connection.recv_bytes`` asks ``os.read`` for the whole remaining
    size on every pipe-sized read, one allocation of the message's size
    each time: on the H100 machine a rank's 0.5 GB result took 86 s to
    reach a driver that had used the card, and under 2 s this way."""
    with io.FileIO(conn.fileno(), "rb", closefd=False) as f:
        size, = struct.unpack("!i", _read_exact(f, 4))
        if size == -1:
            size, = struct.unpack("!Q", _read_exact(f, 8))
        buf = bytearray(size)
        view = memoryview(buf)
        got = 0
        while got < size:
            n = f.readinto(view[got:got + _READ_CHUNK])
            if not n:
                raise EOFError
            got += n
    return buf


def worker_context():
    """The start method of workers: a forkserver that preloaded this
    module (and with it torch and the port).  The forkserver's own
    environment is the driver's when it started, so each worker is sent
    the driver's environment of its start (``_worker_main``)."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


def _worker_main(conn, env: Dict[str, str], channel, rank: int = 0,
                 heartbeat: Optional[HeartbeatChannel] = None,
                 heartbeat_s: float = 0.0,
                 base_env: Optional[Dict[str, str]] = None) -> None:
    global _channel, _CURRENT_BEAT
    if base_env is not None:
        os.environ.clear()
        os.environ.update(base_env)
    os.environ.update(env)
    _channel = channel
    # the flight recorder, rank-keyed, with the overlay's trace id and
    # spill directory; telemetry observes and never takes a worker down
    telemetry = None
    try:
        from ..telemetry import recorder
        recorder.configure(rank=rank, env=env)
        telemetry = recorder
    except Exception:
        pass
    # the live plane (telemetry/live.py): with RLA_TPU_METRICS_PORT in
    # the environment this rank serves /metrics, /statusz, /healthz and
    # /snapshot on an ephemeral loopback port named in its portfile,
    # started here, after the fork (a server made before it would be
    # inherited dead).  /healthz reads this rank's own heartbeat, so a
    # hung call reads wedged before the watchdog reaps it.  It observes
    # and never takes a worker down: a failure is logged
    try:
        from ..telemetry import live
        live.maybe_start_from_env(
            rank=rank, env=env,
            beat_snapshot_fn=(heartbeat.snapshot
                              if heartbeat is not None else None))
    except Exception as e:
        log.warning("worker %d: live telemetry not started: %s", rank, e)
    beat = None
    if heartbeat is not None and heartbeat_s > 0:
        beat = WorkerBeat(heartbeat, heartbeat_s)
        beat.start()
        _CURRENT_BEAT = beat
    # the preemption notice, only with a grace budget: SIGTERM then
    # drains a busy worker at its body's next boundary and ends an idle
    # one at once
    notice = None
    try:
        from .preemption import install_from_env
        notice = install_from_env(worker_mode=True)
    except Exception:
        pass
    # fault injection, imported only when asked for; a malformed spec
    # fails the first dispatch's future instead of vanishing
    chaos = chaos_error = None
    if knobs.get_raw("RLA_TPU_CHAOS"):
        try:
            from ..testing.chaos import ChaosInjector
            chaos = ChaosInjector.from_env(
                rank, freeze_heartbeat=beat.freeze if beat else None)
        except Exception as e:
            chaos_error = e
    from .object_store import ObjectRef, resolve
    n_dispatch = 0
    while True:
        try:
            blob = _recv_blob(conn)
        except EOFError:
            return
        if blob == _SENTINEL:
            conn.close()
            return
        n_dispatch += 1
        if telemetry is not None:
            # before any chaos or user code, and the first emit spills: a
            # rank that hangs or dies in this dispatch leaves "it entered
            # dispatch N" on disk for the watchdog's diagnosis
            telemetry.emit("dispatch_begin", n=n_dispatch)
        try:
            if chaos_error is not None:
                raise chaos_error
            fn, args, kwargs = pickle.loads(blob)
            if any(isinstance(a, ObjectRef)
                   for a in (*args, *kwargs.values())):
                # Ray-style call-site deref of top-level refs
                args = tuple(resolve(a) for a in args)
                kwargs = {k: resolve(v) for k, v in kwargs.items()}
            # the busy marker brackets the user's call only: unpickling
            # imports its modules, a cold cost that must not count
            # against a dispatch deadline
            if beat is not None:
                beat.begin_dispatch()
            if notice is not None:
                notice.busy = True
            if chaos is not None:
                chaos.on_dispatch()
            payload = ("ok", pickle.dumps(fn(*args, **kwargs)))
        except Exception as e:  # ship the traceback home
            payload = ("err", (type(e).__name__, str(e),
                               traceback.format_exc()))
        if notice is not None:
            notice.busy = False
        if beat is not None:
            beat.end_dispatch()
        if telemetry is not None:
            telemetry.emit("dispatch_end", n=n_dispatch,
                           ok=payload[0] == "ok")
        conn.send_bytes(pickle.dumps(payload))


class RemoteError(RuntimeError):
    """A worker-side exception: its type name (``remote_type``), message
    (``remote_message``) and traceback."""

    def __init__(self, name: str, message: str, remote_traceback: str):
        super().__init__(f"{name}: {message}\n--- remote traceback ---\n"
                         f"{remote_traceback}")
        self.remote_type = name
        self.remote_message = message
        self.remote_traceback = remote_traceback


class Worker:
    """One persistent subprocess executing shipped callables in order."""

    def __init__(self, rank: int, env: Optional[Dict[str, str]] = None,
                 ctx: Optional[Any] = None, channel: Optional[Any] = None,
                 daemon: bool = True, heartbeat_s: Optional[float] = None):
        self.rank = rank
        self._env = dict(env or {})  # kept for restart()
        # with a grace budget the worker takes SIGTERM as a drain notice:
        # the driver's kill, restart and reap go straight to SIGKILL
        from .preemption import PREEMPT_GRACE_ENV
        self._sigterm_is_notice = bool(
            knobs.get_raw(PREEMPT_GRACE_ENV, env=self._env))
        # the liveness channel's interval: the argument, else the
        # overlay's or this process's knob; <= 0 turns it off
        self._heartbeat_s = (heartbeat_s if heartbeat_s is not None
                             else heartbeat_interval_s(self._env))
        # a daemonic process may not start children: a tune process
        # trial whose fit spawns ranks runs in a non-daemon worker, which
        # its owner kills (and reaps at exit)
        self._daemon = daemon
        self._ctx = ctx or worker_context()
        self._channel = channel
        # _state_lock guards the pending lists and is held only for list
        # operations, so a collector can always drain its pipe while a
        # sender blocks on a full pipe buffer; _send_lock keeps a pending
        # list in wire order and serialises restart() with senders
        self._state_lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._spawn()

    def _spawn(self) -> None:
        self._conn, child_conn = self._ctx.Pipe()
        # a fresh channel each generation: a restarted worker starts with
        # a clean beat
        self.heartbeat = (HeartbeatChannel(self._ctx)
                          if self._heartbeat_s > 0 else None)
        self._proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self._env, self._channel, self.rank,
                  self.heartbeat, self._heartbeat_s, dict(os.environ)),
            daemon=self._daemon, name=f"rla-torch-worker-{self.rank}")
        self._proc.start()
        child_conn.close()
        # (future, raw) in wire order
        self._pending: List[tuple] = []
        # this generation's reap record: the collector fails its futures
        # with WorkerWedged, not "died", when the watchdog killed it
        self._meta: Dict[str, Any] = {"wedge": None, "eof": False}
        # the collector binds its generation's pipe, process and pending
        # list: after restart() swaps them, the old thread drains the old
        # pipe and fails the old futures
        self._collector = threading.Thread(
            target=self._collect,
            args=(self._conn, self._proc, self._pending, self._meta),
            daemon=True)
        self._collector.start()

    @property
    def is_alive(self) -> bool:
        """The process runs and its pipe is open: an exiting process
        closes its pipe before the OS reports it ended, and a
        ``restart_dead`` right after its futures failed must see it
        dead."""
        return self._proc.is_alive() and not self._meta["eof"]

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    @property
    def exitcode(self) -> Optional[int]:
        return self._proc.exitcode

    def _end(self) -> None:
        """SIGTERM (SIGKILL where SIGTERM is a drain notice)."""
        if self._sigterm_is_notice:
            self._proc.kill()
        else:
            self._proc.terminate()

    def restart(self) -> None:
        """Respawn this worker with the same rank and env: SIGTERM (SIGKILL
        where SIGTERM is a drain notice), then SIGKILL if the process
        outlives 10 s.  The old process's pending futures fail with
        "worker N died"; callers dispatch again."""
        with self._send_lock:
            if self._proc.is_alive():
                self._end()
            self._proc.join(timeout=10)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=10)
            self._unlink_segments()
            # the old pipe is left open: its collector reads EOF from the
            # dead process, and the pipe closes once nothing holds it
            # (closing it here could hand its file descriptor to the new
            # pipe under a read in flight)
            self._spawn()

    def execute(self, fn: Callable, *args, **kwargs) -> Future:
        """Ship ``fn(*args, **kwargs)`` to the worker; returns a Future."""
        return self.execute_blob(pickle.dumps((fn, args, kwargs)))

    def execute_blob(self, blob: bytes, raw: bool = False) -> Future:
        """Ship an already pickled ``(fn, args, kwargs)``.  ``raw=True``
        resolves the Future with the wire pair ``(status, payload)``
        without unpickling the result: a host agent relays it to its
        driver, so classes only the driver can import never unpickle on
        the agent."""
        fut: Future = Future()
        with self._send_lock:
            if not self.is_alive:
                fut.set_exception(RuntimeError(
                    f"worker {self.rank} is dead "
                    f"(exitcode={self._proc.exitcode})"))
                return fut
            with self._state_lock:
                self._pending.append((fut, raw))
            try:
                self._conn.send_bytes(blob)
            except OSError as e:
                with self._state_lock:
                    if (fut, raw) in self._pending:
                        self._pending.remove((fut, raw))
                fut.set_exception(RuntimeError(
                    f"worker {self.rank} died before accepting work: {e}"))
        return fut

    def _collect(self, conn, proc, pending_list: List[tuple],
                 meta: Dict[str, Any]) -> None:
        from .wire import rebuild_remote

        while True:
            try:
                blob = _recv_blob(conn)
            except (EOFError, OSError):
                with self._state_lock:
                    meta["eof"] = True
                    pending = list(pending_list)
                    pending_list.clear()
                    wedge = meta.get("wedge")
                # no join here: two threads waiting on one process race in
                # multiprocessing, and the loser sees it alive once reaped
                for fut, _raw in pending:
                    if fut.done():
                        continue
                    if wedge is not None:
                        # the watchdog killed a live but stuck process:
                        # callers see a wedge, not a death
                        fut.set_exception(
                            WorkerWedged.for_rank(self.rank, wedge))
                    else:
                        fut.set_exception(RuntimeError(
                            f"worker {self.rank} died "
                            f"(exitcode={proc.exitcode})"))
                return
            with self._state_lock:
                fut, raw = pending_list.pop(0)
            try:
                status, payload = pickle.loads(blob)
                if raw:
                    fut.set_result((status, payload))
                elif status == "ok":
                    fut.set_result(pickle.loads(payload))
                else:
                    # the registered types come home typed
                    fut.set_exception(rebuild_remote(*payload))
            except Exception as e:
                # a result the driver cannot unpickle fails its own future,
                # not the collector and every later future
                fut.set_exception(RuntimeError(
                    f"failed to deserialize result from worker "
                    f"{self.rank}: {type(e).__name__}: {e}"))

    def telemetry_tail(self) -> Optional[Dict[str, Any]]:
        """This rank's spilled flight-recorder snapshot, read from the
        ``RLA_TPU_TELEMETRY_DIR`` of its overlay (or of this process):
        readable after the worker died.  None when no directory is set
        or the rank never spilled."""
        from ..telemetry.recorder import read_spill, spill_path_for
        path = spill_path_for(self.rank, env=self._env)
        return read_spill(path) if path else None

    def live_snapshot(self) -> Optional[Dict[str, Any]]:
        """This rank's live telemetry ``/snapshot`` (``telemetry/
        live.py``), scraped from the loopback endpoint its portfile
        names: the ClusterView's read.  None when the plane is off, the
        rank never bound, or it stopped answering (the ClusterView keeps
        a wedged rank's last snapshot)."""
        from ..telemetry.live import scrape_rank
        try:
            return scrape_rank(self.rank, env=self._env)
        except Exception:
            return None

    def set_env_var(self, key: str, value: str) -> Future:
        return self.execute(_set_env, key, value)

    def reap(self, diagnosis: Optional[Dict[str, Any]] = None) -> None:
        """The watchdog's kill of a live but stuck worker: its pending
        futures fail with ``WorkerWedged`` carrying ``diagnosis``.  The
        worker stays restartable."""
        with self._state_lock:
            self._meta["wedge"] = dict(diagnosis or {})
        self.kill()

    def kill(self) -> None:
        """SIGTERM (SIGKILL where SIGTERM is a drain notice), then SIGKILL
        if the process outlives 5 s."""
        if self._proc.is_alive():
            self._end()
            self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=5)
        self._unlink_segments()

    def _unlink_segments(self) -> None:
        """Unlink the shm segments the ended process still owned: a
        signal or ``os._exit`` skips its store's exit handler, and no
        one else owns them."""
        if self._proc.is_alive() or self._proc.pid is None:
            return
        from .object_store import unlink_segments_of
        unlink_segments_of(self._proc.pid)

    def shutdown(self, timeout: float = 10.0) -> None:
        """Ask the request loop to end; kill the process if it has not
        ended within ``timeout``."""
        try:
            with self._send_lock:
                self._conn.send_bytes(_SENTINEL)
            self._proc.join(timeout=timeout)
        except OSError:
            pass
        self.kill()


def _set_env(key: str, value: str) -> None:
    os.environ[key] = value


def _node_ip() -> str:
    from .net import node_ip
    return node_ip()


def _probe_ok() -> bool:
    return True


class ActorPool:
    """N workers and the fan-out helpers.  ``agents``: HostAgent
    addresses ("host:port", "host:port*N"): the workers are
    ``runtime/agent.py`` ``RemoteWorker``s placed in contiguous blocks
    over the agents (``assign_agents``); None = processes on this
    host."""

    def __init__(self, num_workers: int,
                 env_per_worker: Optional[Sequence[Dict[str, str]]] = None,
                 agents: Optional[Sequence[str]] = None):
        envs = env_per_worker or [{} for _ in range(num_workers)]
        if len(envs) != num_workers:
            raise ValueError(f"{len(envs)} env overlays for {num_workers} "
                             "workers")
        self.agents = list(agents) if agents else None
        ctx = worker_context()
        # the trampoline channel: written by the ranks' sessions, drained
        # by the driver (runtime.queue.process_results); an agent's
        # worker has none (its session queue is the TCP QueueClient)
        self.channel = ctx.SimpleQueue()
        self.workers: List[Any] = []
        # the env overlays of ranks drop() removed, so revive() can place
        # a host that came back
        self._dropped_envs: Dict[int, Dict[str, str]] = {}
        try:
            if self.agents:
                from .agent import RemoteWorker, assign_agents
                for i, addr in enumerate(assign_agents(self.agents,
                                                       num_workers)):
                    self.workers.append(RemoteWorker(addr, i, envs[i]))
            else:
                for i in range(num_workers):
                    self.workers.append(Worker(i, envs[i], ctx,
                                               self.channel))
        except BaseException:
            # one unreachable agent must not orphan the workers already
            # placed on the others
            self.kill()
            raise

    def __len__(self) -> int:
        return len(self.workers)

    def execute_all(self, fn: Callable, *args, **kwargs) -> List[Future]:
        return [w.execute(fn, *args, **kwargs) for w in self.workers]

    def execute_per_worker(self, fn: Callable,
                           args_per_worker: Sequence[tuple]) -> List[Future]:
        return [w.execute(fn, *args)
                for w, args in zip(self.workers, args_per_worker)]

    def set_env_vars(self, env: Dict[str, str]) -> None:
        futs = []
        for k, v in env.items():
            futs += [w.set_env_var(k, str(v)) for w in self.workers]
        for f in futs:
            f.result(timeout=WAIT_S)

    def node_ips(self) -> List[str]:
        """Each worker's host IP (an agent answers for its workers)."""
        if self.agents:
            return [w.get_node_ip() for w in self.workers]
        return [f.result(timeout=WAIT_S)
                for f in self.execute_all(_node_ip)]

    def local_ranks(self) -> List[int]:
        """Each worker's rank among the workers on its node, from the
        node-IP census."""
        counts: Dict[str, int] = {}
        ranks = []
        for ip in self.node_ips():
            ranks.append(counts.get(ip, 0))
            counts[ip] = counts.get(ip, 0) + 1
        return ranks

    def health_check(self) -> List[bool]:
        """Liveness per rank, from the OS process state; a wedged rank
        needs ``watch()``."""
        return [w.is_alive for w in self.workers]

    def watch(self, **kwargs) -> Any:
        """A started ``runtime.watchdog.Watchdog`` over this pool."""
        from .watchdog import Watchdog
        return Watchdog(self, **kwargs).start()

    def _new_worker(self, rank: int, env: Dict[str, str]) -> Worker:
        return Worker(rank, env, worker_context(), self.channel)

    def add_worker(self, env: Optional[Dict[str, str]] = None,
                   rank: Optional[int] = None) -> Worker:
        """Grow the pool by one local worker, at the next free rank (max +
        1: a rank freed by ``drop`` is not reused) with its own overlay.
        An agent-backed pool refuses: placing a new remote worker needs a
        host the agent protocol does not name."""
        if self.agents:
            raise RuntimeError(
                "add_worker supports local subprocess pools only "
                "(agent-backed pools cannot place new workers)")
        if rank is None:
            rank = max((w.rank for w in self.workers), default=-1) + 1
        w = self._new_worker(rank, dict(env or {}))
        self.workers.append(w)
        log.warning("added worker rank %d; pool now %d rank(s) %s",
                    rank, len(self.workers),
                    [x.rank for x in self.workers])
        return w

    def _run_hook(self, workers: Sequence[Worker],
                  init_hook: Optional[Callable[[], None]]) -> None:
        if init_hook is not None:
            for f in [w.execute(init_hook) for w in workers]:
                f.result(timeout=WAIT_S)

    def restart_dead(self, init_hook: Optional[Callable[[], None]] = None
                     ) -> List[int]:
        """Respawn every dead worker (and run ``init_hook`` on it);
        returns the restarted ranks."""
        dead = [w for w in self.workers if not w.is_alive]
        for w in dead:
            w.restart()
        self._run_hook(dead, init_hook)
        if dead:
            log.warning("restarted dead workers: %s", [w.rank for w in dead])
        return [w.rank for w in dead]

    def _probe_sweep(self, workers: Sequence[Worker],
                     timeout_s: float) -> List[int]:
        """Round-trip probes in parallel, one shared timeout; the ranks
        that failed."""
        futs = [(w.rank, w.execute(_probe_ok)) for w in workers]
        deadline = time.monotonic() + timeout_s
        lost = []
        for rank, f in futs:
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except BaseException as e:
                log.warning("probe of worker %d failed: %s", rank, e)
                lost.append(rank)
        return lost

    def find_lost(self, timeout_s: float = 120.0, classify: bool = False):
        """The ranks that fail a trivial round trip within ``timeout_s``
        (a gone host's respawn dies at boot and fails fast).  With
        ``classify`` each failed rank gets one restart and one probe more:
        ``{"gone": [...], "revived": [...]}``."""
        lost = self._probe_sweep(self.workers, timeout_s)
        if not classify:
            return lost
        if not lost:
            return {"gone": [], "revived": []}
        retry = [w for w in self.workers if w.rank in set(lost)]
        for w in retry:
            try:
                w.restart()
            except BaseException as e:
                log.warning("classify restart of worker %d failed: %s",
                            w.rank, e)
        still_lost = set(self._probe_sweep(retry, timeout_s))
        revived = sorted(set(lost) - still_lost)
        if revived:
            log.warning("lost rank(s) %s answered their re-probe; keeping "
                        "them in the pool", revived)
        return {"gone": sorted(still_lost), "revived": revived}

    def drop(self, ranks: Sequence[int]) -> List[int]:
        """Remove ``ranks`` (the elastic scale-down): the workers are
        killed and forgotten; survivors keep their rank (rank is
        placement, not position: callers dispatch by list position)."""
        gone = set(ranks)
        dropping = [w for w in self.workers if w.rank in gone]
        for w in dropping:
            self._dropped_envs[w.rank] = dict(getattr(w, "_env", {}) or {})
            try:
                w.kill()
            except BaseException:
                pass
        self.workers = [w for w in self.workers if w.rank not in gone]
        dropped = [w.rank for w in dropping]
        if dropped:
            log.warning("dropped lost workers %s; pool now %d rank(s) %s",
                        dropped, len(self.workers),
                        [w.rank for w in self.workers])
        return dropped

    def dropped_ranks(self) -> List[int]:
        """The ranks ``drop`` removed: the candidates of ``revive``."""
        return sorted(self._dropped_envs)

    def revive(self, rank: int,
               probe_timeout_s: float = 30.0) -> Optional[Worker]:
        """Place a dropped rank again (the elastic grow): a fresh worker
        at the same rank with its remembered overlay, probed.  The worker
        (back in the pool, in rank order) on success; None when the rank
        was never dropped or its host is still gone (the spawn is
        killed, the rank stays dropped)."""
        env = self._dropped_envs.get(rank)
        if env is None:
            return None
        if self.agents:
            log.warning("revive(%d): agent-backed pools cannot re-place "
                        "workers", rank)
            return None
        w = self._new_worker(rank, dict(env))
        if self._probe_sweep([w], probe_timeout_s):
            try:
                w.kill()
            except BaseException:
                pass
            log.warning("revive(%d): host still gone (probe failed)", rank)
            return None
        del self._dropped_envs[rank]
        self.workers.append(w)
        self.workers.sort(key=lambda x: x.rank)
        log.warning("revived worker rank %d; pool now %d rank(s) %s",
                    rank, len(self.workers), [x.rank for x in self.workers])
        return w

    def restart_all(self, init_hook: Optional[Callable[[], None]] = None
                    ) -> List[int]:
        """Respawn every worker, alive or not (and run ``init_hook`` on
        each): when one rank dies in collective work its peers wait on
        it, so all restart together.  Returns the ranks."""
        for w in self.workers:
            w.restart()
        self._run_hook(self.workers, init_hook)
        return [w.rank for w in self.workers]

    def shutdown(self) -> None:
        for w in reversed(self.workers):
            w.shutdown()

    def kill(self) -> None:
        for w in reversed(self.workers):
            w.kill()

    def __enter__(self) -> "ActorPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
