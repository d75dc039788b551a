"""Process-group bootstrap: a coordinator address, ``init_process_group``
in every worker, and the persistent world the Trainer runs its entry
points in.

Port of the JAX package's ``runtime/bootstrap.py``.  Where the JAX
workers call ``jax.distributed.initialize`` and XLA derives the
collectives, the port's workers form a ``torch.distributed`` process
group (NCCL between CUDA ranks, gloo between CPU ranks, or gloo over
CUDA tensors when the caller asks for it) and the trainer calls the
collectives itself.

- ``pick_coordinator_address``: a loopback ``ip:port`` from a fresh bind.
  Every world lives on one host; agents on other hosts come with the
  runtime slice 5c-ii.
- ``initialize_worker``: runs in each worker before its first CUDA
  tensor: ``torch.cuda.set_device`` on the card (a rank with no card
  raises; it never moves to the CPU), ``torch.set_num_threads(cpus //
  N)`` on the CPU, then ``init_process_group`` with an explicit
  ``timeout``, which also bounds every later collective.
- ``DistributedWorld``: spawned workers with a formed group, kept across
  fit -> validate -> test -> predict.  A bind race on the coordinator's
  port retries with a fresh port; a failed run kills the world (its
  collectives are poisoned) and a drained preemption comes back as the
  typed ``Preempted``; an atexit reaper kills workers that a script
  forgot; ``shutdown`` destroys each process group first.
- Supervision (the JAX ``run`` ``:334-406``): with ``deadline_s``,
  ``wedge_timeout_s`` or ``RLA_TPU_WEDGE_TIMEOUT_S`` a
  ``runtime/watchdog.py`` ``Watchdog`` watches the run; a rank that stops
  making progress is reaped and the run fails with ``WorkerWedged``, its
  reap records in ``last_stall``.  The ``process_results`` backstop is
  padded past the watchdog's trigger, so the typed wedge wins.
- ``launch_distributed``: one run over a fresh world.
- The query channel: a run inside a tune trial opens a ``QueueServer``
  whose handler answers the ranks' ``query`` ("should_stop", the
  synchronous "report" and "checkpoint") from the trial session of the
  thread that called ``run`` (captured at each run: the server's reader
  threads have no trial session of their own), or forwards it one level
  up through this process's own session queue when this process is a
  tune process trial (``_nested_query_handler``).
- ``world_scope``: the worlds formed on this thread inside the scope are
  shut when it ends (a tune trial's worlds end with the trial).
- The ship-once cache: ``DistributedWorld.ship_value(obj)`` pickles
  ``obj`` (the standard ``pickle``, as the rest of the port's wire),
  keys it by the blob's sha256 and stores it once under this host's
  temporary directory for the world; a later entry point shipping the
  same bytes sends only the key (``ShippedRef``; ``ship_stats`` counts
  ``sent``, ``reused`` and the ``bytes`` stored).  A rank's
  ``resolve_shipped`` unpickles a fresh copy on every run, so one run's
  changes to a loader never reach the next.  The store goes with the
  world (``shutdown`` and ``kill``).
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import functools
import hashlib
import os
import pickle
import shutil
import socket
import tempfile
import threading
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from . import session as session_lib
from .actors import WAIT_S, ActorPool, worker_channel
from .queue import QueueServer, RankQueue, TrampolineQueue, process_results

# the rendezvous and every collective of a world fail past this
DEFAULT_TIMEOUT_S = 300.0


def pick_coordinator_address(port: Optional[int] = None) -> str:
    """``127.0.0.1:port``, the port from a fresh bind when not given."""
    if port is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    return f"127.0.0.1:{port}"


def default_backend(device: str) -> str:
    return "nccl" if str(device).startswith("cuda") else "gloo"


def initialize_worker(coordinator_address: str, world_size: int, rank: int,
                      device: str, backend: str,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this worker to the world's process group, placed on
    ``device`` ("cpu", "cuda" or "cuda:i")."""
    import torch
    import torch.distributed as dist

    from ..core.module import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _destroy_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _nested_query_handler() -> Optional[Callable[[str, Any], Any]]:
    """The query handler of a run started on this thread: the ranks'
    tune queries ("should_stop", synchronous "report" / "checkpoint")
    are answered from the trial session bound to this thread (a thread
    trial), or forwarded up through this process's session queue with
    the rank replaced by this process's trial rank (a process trial).
    None when there is nothing to answer from here."""
    from ..tune.run import _current_session, dispatch_trial_query
    trial = _current_session()
    if trial is not None:
        return functools.partial(dispatch_trial_query,
                                 lookup=lambda _rank: trial)
    if not session_lib.session_exists():
        return None
    sess = session_lib.get_session()
    q = getattr(sess, "_queue", None)
    if not hasattr(q, "query"):
        return None

    def forward(name: str, payload: Any) -> Any:
        if name in ("report", "checkpoint"):
            return q.query(name, (sess.rank,) + tuple(payload[1:]))
        return q.query(name, sess.rank)
    return forward


def _run_world_body(rank: int, trainable, with_queue: bool,
                    query_address: Optional[str] = None):
    """One entry-point run inside a persistent worker: a fresh session
    (with the pool's channel when the driver pumps a queue, and the run's
    query channel when it has one), then the trainable."""
    queue = worker_channel() if with_queue else None
    if queue is not None and query_address is not None:
        queue = RankQueue(queue, query_address)
    session_lib.shutdown_session()
    session_lib.init_session(rank, queue)
    try:
        return trainable(rank)
    finally:
        session_lib.shutdown_session()
        if isinstance(queue, RankQueue):
            queue.shutdown()


# --------------------------------------------------------------------- #
# Ship-once store: content-keyed pickled blobs in this host's temporary  #
# directory (one copy per machine, shared by every rank on it), one      #
# namespace a world.                                                     #
# --------------------------------------------------------------------- #
def _ship_dir(ns: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"rla_ship_{ns}")


class ShippedRef:
    """Handle to a payload cached on the host of a ``DistributedWorld``
    (``DistributedWorld.ship_value``)."""

    __slots__ = ("ns", "key")

    def __init__(self, ns: str, key: str):
        self.ns = ns
        self.key = key


def _store_shipped(ns: str, key: str, blob: bytes) -> None:
    d = _ship_dir(ns)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{key}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, os.path.join(d, key))  # atomic: readers see all or none


def _cleanup_shipped(ns: str) -> None:
    shutil.rmtree(_ship_dir(ns), ignore_errors=True)


def _reap(pool: ActorPool, ns: str) -> None:
    """A world left open at interpreter exit: kill its workers, drop
    its store."""
    pool.kill()
    _cleanup_shipped(ns)


def resolve_shipped(obj: Any) -> Any:
    """A fresh copy of a ``ShippedRef``'s payload from this host's
    store; anything else passes through."""
    if not isinstance(obj, ShippedRef):
        return obj
    path = os.path.join(_ship_dir(obj.ns), obj.key)
    try:
        with open(path, "rb") as f:
            return pickle.loads(f.read())
    except FileNotFoundError:
        raise KeyError(f"shipped payload {obj.key[:12]} is not cached on "
                       f"this host (world store {obj.ns})") from None


_scope = threading.local()


@contextlib.contextmanager
def world_scope() -> Iterator[List["DistributedWorld"]]:
    """Collect the worlds formed on this thread inside the block, and shut
    each one still open when it ends."""
    outer = getattr(_scope, "worlds", None)
    worlds: List[DistributedWorld] = []
    _scope.worlds = worlds
    try:
        yield worlds
    finally:
        _scope.worlds = outer
        for w in worlds:
            w.shutdown()


class DistributedWorld:
    """Spawned workers with a formed ``torch.distributed`` group, reusable
    across entry points without respawning or re-forming the group.

    ``devices`` places the ranks, one entry each ("cpu", "cuda:i"; default:
    rank i on ``cuda:i``).  ``backend`` defaults to NCCL for CUDA ranks
    and gloo for CPU ranks; gloo over CUDA ranks is what several ranks
    sharing one card need (NCCL refuses two ranks on one device)."""

    def __init__(self, num_processes: int,
                 devices: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        devices = [str(d) for d in (devices or [
            f"cuda:{i}" for i in range(num_processes)])]
        if len(devices) != num_processes:
            raise ValueError(f"{len(devices)} devices for {num_processes} "
                             "ranks")
        self.num_processes = num_processes
        self.devices = devices
        self.backend = backend or default_backend(devices[0])
        self.pool: Optional[ActorPool] = None
        # the watchdog's reap records of the last run
        self.last_stall: List[Dict[str, Any]] = []
        # the ship-once store of this world
        self._ship_ns = f"{os.getpid()}-{uuid.uuid4().hex[:12]}"
        self._shipped: set = set()
        self.ship_stats = {"sent": 0, "reused": 0, "bytes": 0}
        # the pick-then-close port choice leaves a window in which another
        # process can take the port before rank 0 binds it: such a bind
        # failure retries with a fresh port
        for attempt in range(3):
            coord = pick_coordinator_address()
            pool = ActorPool(num_processes)
            try:
                process_results(
                    pool.execute_per_worker(initialize_worker, [
                        (coord, num_processes, i, devices[i], self.backend,
                         timeout_s) for i in range(num_processes)]),
                    None, deadline_s=timeout_s + WAIT_S)
            except BaseException as e:
                pool.kill()
                # classified by the text, whatever type the rank's error
                # came home as
                bindy = isinstance(e, Exception) and any(
                    tok in str(e).lower() for tok in (
                        "address already in use", "eaddrinuse"))
                if not (bindy and attempt < 2):
                    raise
                continue
            self.pool = pool
            # a world left open at interpreter exit is killed before
            # multiprocessing joins its children
            self._reaper = functools.partial(_reap, pool, self._ship_ns)
            atexit.register(self._reaper)
            scope = getattr(_scope, "worlds", None)
            if scope is not None:
                scope.append(self)
            return

    def alive(self) -> bool:
        return (self.pool is not None
                and all(w.is_alive for w in self.pool.workers))

    def ship_value(self, obj: Any) -> Any:
        """Store ``obj`` once on this world's host, keyed by its pickled
        bytes, and return a ``ShippedRef`` the runs carry instead of the
        bytes; the same bytes again reuse the stored copy.  Ranks resolve a
        fresh copy per run (``resolve_shipped``).  None passes through."""
        if obj is None:
            return None
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        key = hashlib.sha256(blob).hexdigest()
        if key in self._shipped:
            self.ship_stats["reused"] += 1
        else:
            # every rank of a world runs on this host: one copy serves all
            _store_shipped(self._ship_ns, key, blob)
            self._shipped.add(key)
            self.ship_stats["sent"] += 1
            self.ship_stats["bytes"] += len(blob)
        return ShippedRef(self._ship_ns, key)

    def ship_dir(self) -> str:
        """Where this world's shipped payloads are stored."""
        return _ship_dir(self._ship_ns)

    def run(self, trainable: Callable[[int], Any],
            queue: Optional[TrampolineQueue] = None,
            deadline_s: Optional[float] = None,
            wedge_timeout_s: Optional[float] = None) -> List[Any]:
        """``trainable(rank)`` on every rank; per-rank results, rank 0
        first.  With a ``queue``, each rank's ``put_queue`` reaches this
        process and runs here while the ranks work; inside a tune trial
        the ranks' ``query`` reaches the trial's session too
        (``_nested_query_handler``).  A failed rank fails the run at once
        and kills the world; a drain raises the typed ``Preempted``.

        ``deadline_s`` (this run's dispatch budget), ``wedge_timeout_s``
        (the stale-heartbeat threshold) or ``RLA_TPU_WEDGE_TIMEOUT_S``
        start a watchdog: a rank that stops making progress is reaped
        and the run fails with ``WorkerWedged``; ``last_stall`` holds the
        reap records."""
        if self.pool is None:
            raise RuntimeError("DistributedWorld is not alive (a prior run "
                               "failed or it was shut down)")
        from .watchdog import Watchdog, wedge_timeout_from_env
        if wedge_timeout_s is None:
            wedge_timeout_s = wedge_timeout_from_env()
        watchdog: Optional[Watchdog] = None
        self.last_stall = []
        server = None
        handler = _nested_query_handler() if queue is not None else None
        if handler is not None:
            server = QueueServer(queue, query_handler=handler)
        address = server.address if server is not None else None
        try:
            futures = self.pool.execute_per_worker(
                _run_world_body, [(i, trainable, queue is not None, address)
                                  for i in range(self.num_processes)])
            if deadline_s is not None or wedge_timeout_s is not None:
                watchdog = Watchdog(self.pool,
                                    wedge_timeout_s=wedge_timeout_s,
                                    dispatch_deadline_s=deadline_s).start()
            # the backstop, padded past the watchdog's trigger so the
            # typed WorkerWedged (with its diagnosis) wins
            hard = (deadline_s + max(30.0, wedge_timeout_s or 0.0)
                    if deadline_s is not None else None)
            return process_results(futures, queue, deadline_s=hard,
                                   channel=self.pool.channel)
        except BaseException as e:
            # a failed rank leaves its peers in a collective: the whole
            # world goes (callers form a fresh one)
            self.kill()
            from .preemption import as_preempted, is_preemption
            if is_preemption(e):
                raise as_preempted(e) from e
            raise
        finally:
            if watchdog is not None:
                watchdog.stop()
                self.last_stall = list(watchdog.reaped)
            if server is not None:
                server.close()

    def _drop_reaper(self) -> None:
        if getattr(self, "_reaper", None) is not None:
            atexit.unregister(self._reaper)
            self._reaper = None

    def _drop_shipped(self) -> None:
        if self._shipped:
            _cleanup_shipped(self._ship_ns)
            self._shipped = set()

    def kill(self) -> None:
        self._drop_reaper()
        self._drop_shipped()
        if self.pool is not None:
            self.pool.kill()
            self.pool = None

    def shutdown(self) -> None:
        """Destroy each rank's process group (NCCL needs it before the
        process exits), then end the workers."""
        self._drop_reaper()
        self._drop_shipped()
        if self.pool is None:
            return
        try:
            for f in self.pool.execute_all(_destroy_group):
                f.result(timeout=WAIT_S)
        except Exception:
            self.pool.kill()  # a rank that cannot leave its group dies
        self.pool.shutdown()
        self.pool = None

    def __enter__(self) -> "DistributedWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def launch_distributed(trainable: Callable[[int], Any], num_processes: int,
                       devices: Optional[Sequence[str]] = None,
                       backend: Optional[str] = None,
                       queue: Optional[TrampolineQueue] = None,
                       deadline_s: Optional[float] = None) -> List[Any]:
    """``trainable(rank)`` over ``num_processes`` fresh workers with a
    formed group; per-rank results, rank 0 first."""
    world = DistributedWorld(num_processes, devices, backend)
    try:
        return world.run(trainable, queue=queue, deadline_s=deadline_s)
    finally:
        world.shutdown()
