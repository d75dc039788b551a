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
  A world placed on host agents (``agents=``, ``runtime/agent.py``)
  meets on agent 0's host instead (``coordinator_address_on``), its
  query channel binds as ``queue_bind_for_agents`` says, and its ranks
  reach the driver's queue over TCP (an agent's worker holds no pool
  channel).
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
  world (``shutdown`` and ``kill``).  A world on this host stores from
  the driver; a world on agents stores through one worker per host,
  grouped by the workers' node IPs (``ship_stats["via"]`` says which,
  ``ship_stats["hosts"]`` on how many hosts).
- ``DistributedWorld.resize(n, devices)``: every rank leaves its group,
  the world keeps its first ``n`` ranks' processes (a shrink shuts the
  rest down; a grow spawns the new ranks, through the agents where the
  world has them) and forms its group again at ``n`` (a fresh
  rendezvous).  ``Trainer.resize_in_memory`` moves the live state
  around it.
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
from .queue import (QueueClient, QueueServer, RankQueue, TrampolineQueue,
                    process_results)

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
    query channel when it has one; a worker an agent spawned has no
    channel and puts over TCP), then the trainable."""
    queue = worker_channel() if with_queue else None
    client = None
    if with_queue and queue is None and query_address is not None:
        queue = client = QueueClient(query_address)
    elif queue is not None and query_address is not None:
        queue = RankQueue(queue, query_address)
    session_lib.shutdown_session()
    session_lib.init_session(rank, queue)
    try:
        return trainable(rank)
    finally:
        session_lib.shutdown_session()
        if client is not None:
            # the result travels the agent's wire and could outrun the
            # last puts: flush first; a dead driver must not mask the
            # body's own exception
            try:
                client.flush()
            except (ConnectionError, OSError):
                pass
            client.shutdown()
        elif isinstance(queue, RankQueue):
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
    rank i on ``cuda:i``, or on its index among its agent's ranks).
    ``backend`` defaults to NCCL for CUDA ranks and gloo for CPU ranks;
    gloo over CUDA ranks is what several ranks sharing one card need
    (NCCL refuses two ranks on one device).  ``agents`` places the ranks
    on host agents in contiguous blocks (``runtime/agent.py``
    ``assign_agents``)."""

    def __init__(self, num_processes: int,
                 devices: Optional[Sequence[str]] = None,
                 backend: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 agents: Optional[Sequence[str]] = None):
        self.agents = list(agents) if agents else None
        # each rank's agent (contiguous blocks)
        self.placement: Optional[List[str]] = None
        if self.agents:
            from .agent import assign_agents
            self.placement = assign_agents(self.agents, num_processes)
        if devices is None:
            if self.agents:
                from .agent import local_indices
                devices = [f"cuda:{i}"
                           for i in local_indices(self.placement)]
            else:
                devices = [f"cuda:{i}" for i in range(num_processes)]
        devices = [str(d) for d in devices]
        if len(devices) != num_processes:
            raise ValueError(f"{len(devices)} devices for {num_processes} "
                             "ranks")
        self.num_processes = num_processes
        self.devices = devices
        self.backend = backend or default_backend(devices[0])
        self.timeout_s = timeout_s
        self.pool: Optional[ActorPool] = None
        # the watchdog's reap records of the last run
        self.last_stall: List[Dict[str, Any]] = []
        # the ship-once store of this world
        self._ship_ns = f"{os.getpid()}-{uuid.uuid4().hex[:12]}"
        self._shipped: set = set()
        self._ship_reps: Optional[List[Any]] = None
        self.ship_stats = {"sent": 0, "reused": 0, "bytes": 0,
                           "via": "workers" if self.agents else "driver",
                           "hosts": 0}
        # the pick-then-close port choice leaves a window in which another
        # process can take the port before rank 0 binds it: such a bind
        # failure retries with fresh workers on a fresh port (asked of
        # agent 0 where the world has agents)
        for attempt in range(3):
            pool = ActorPool(num_processes, agents=self.agents)
            try:
                self._rendezvous(pool)
                break
            except BaseException as e:
                pool.kill()
                # classified by the text, whatever type the rank's error
                # came home as
                bindy = isinstance(e, Exception) and any(
                    tok in str(e).lower() for tok in (
                        "address already in use", "eaddrinuse"))
                if not (bindy and attempt < 2):
                    raise
        self.pool = pool
        # a world left open at interpreter exit is killed before
        # multiprocessing joins its children
        self._reaper = functools.partial(_reap, pool, self._ship_ns)
        atexit.register(self._reaper)
        scope = getattr(_scope, "worlds", None)
        if scope is not None:
            scope.append(self)

    def _coordinator(self) -> str:
        if not self.agents:
            return pick_coordinator_address()
        from .agent import (coordinator_address_on, parse_agent_spec,
                            queue_bind_for_agents)
        return coordinator_address_on(
            parse_agent_spec(self.agents[0])[0],
            loopback=queue_bind_for_agents(self.agents) is None)

    def _rendezvous(self, pool: ActorPool) -> None:
        """Form the group over ``pool``'s workers on a fresh port."""
        n = len(pool.workers)
        coord = self._coordinator()
        process_results(
            pool.execute_per_worker(initialize_worker, [
                (coord, n, i, self.devices[i], self.backend,
                 self.timeout_s) for i in range(n)]),
            None, deadline_s=self.timeout_s + WAIT_S)

    def plan_placement(self, num_processes: int) -> Optional[List[str]]:
        """Each rank's agent after a resize to ``num_processes``: the
        survivors stay where they are, a new rank goes where the
        contiguous blocks put it.  None without agents."""
        if not self.agents:
            return None
        from .agent import assign_agents
        blocks = assign_agents(self.agents, num_processes)
        return (self.placement + blocks[len(self.placement):]
                )[:num_processes]

    def resize(self, num_processes: int,
               devices: Optional[Sequence[str]] = None) -> None:
        """Form the group again at ``num_processes`` ranks: every rank
        leaves its group; ranks ``0..num_processes-1`` keep their
        processes (and whatever they hold in memory), the others shut
        down, and a grow spawns the new ranks (through the agents where
        the world has them).  A failure kills the world."""
        if self.pool is None:
            raise RuntimeError("DistributedWorld is not alive")
        pool, old = self.pool, self.num_processes
        placement = self.plan_placement(num_processes)
        if devices is None:
            if placement is not None:
                from .agent import local_indices
                devices = [f"cuda:{i}" for i in local_indices(placement)]
            else:
                devices = [f"cuda:{i}" for i in range(num_processes)]
        if len(devices) != num_processes:
            raise ValueError(f"{len(devices)} devices for {num_processes} "
                             "ranks")
        try:
            for f in pool.execute_all(_destroy_group):
                f.result(timeout=WAIT_S)
            for w in pool.workers[num_processes:]:
                w.shutdown()
            del pool.workers[num_processes:]
            if num_processes > old:
                if self.agents:
                    from .agent import RemoteWorker
                    for i in range(old, num_processes):
                        pool.workers.append(RemoteWorker(placement[i], i))
                else:
                    for i in range(old, num_processes):
                        pool.workers.append(pool._new_worker(i, {}))
            self.num_processes = num_processes
            self.devices = [str(d) for d in devices]
            self.placement = placement
            self._ship_reps = None
            if num_processes > old and self.agents:
                # a new host holds none of the stored payloads yet
                self._shipped = set()
            self._rendezvous(pool)
        except BaseException:
            self.kill()
            raise

    def alive(self) -> bool:
        return (self.pool is not None
                and all(w.is_alive for w in self.pool.workers))

    def _one_worker_per_host(self) -> List[Any]:
        """One worker of each host, by the workers' node IPs (a census
        taken once a formation): the store is shared by a host's ranks,
        so a payload crosses the wire once a machine."""
        if self._ship_reps is None:
            reps: Dict[str, Any] = {}
            for w, ip in zip(self.pool.workers, self.pool.node_ips()):
                reps.setdefault(ip, w)
            self._ship_reps = list(reps.values())
        return self._ship_reps

    def ship_value(self, obj: Any) -> Any:
        """Store ``obj`` once on each host of this world, keyed by its
        pickled bytes, and return a ``ShippedRef`` the runs carry instead
        of the bytes; the same bytes again reuse the stored copies.  Ranks
        resolve a fresh copy per run (``resolve_shipped``).  None passes
        through."""
        if obj is None:
            return None
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        key = hashlib.sha256(blob).hexdigest()
        if key in self._shipped:
            self.ship_stats["reused"] += 1
            return ShippedRef(self._ship_ns, key)
        if self.agents:
            # the ranks' hosts are the agents': store through a worker of
            # each
            reps = self._one_worker_per_host()
            for f in [w.execute(_store_shipped, self._ship_ns, key, blob)
                      for w in reps]:
                f.result(timeout=WAIT_S)
            self.ship_stats["hosts"] = len(reps)
        else:
            # every rank of a world without agents runs on this host
            _store_shipped(self._ship_ns, key, blob)
            self.ship_stats["hosts"] = 1
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
        if queue is not None and (handler is not None or self.agents):
            # an agent's workers put over TCP too; loopback unless a
            # worker lives on another machine
            from .agent import queue_bind_for_agents
            server = QueueServer(queue,
                                 bind=queue_bind_for_agents(self.agents),
                                 query_handler=handler)
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
        if self.ship_stats["sent"]:
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
        if self.pool is not None and self.agents and self.ship_stats["sent"]:
            # the hosts' stores go while their workers live
            try:
                for f in [w.execute(_cleanup_shipped, self._ship_ns)
                          for w in self._one_worker_per_host()]:
                    f.result(timeout=10)
            except Exception:
                pass
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
                       deadline_s: Optional[float] = None,
                       agents: Optional[Sequence[str]] = None) -> List[Any]:
    """``trainable(rank)`` over ``num_processes`` fresh workers with a
    formed group (placed on ``agents`` when given); per-rank results,
    rank 0 first."""
    world = DistributedWorld(num_processes, devices, backend, agents=agents)
    try:
        return world.run(trainable, queue=queue, deadline_s=deadline_s)
    finally:
        world.shutdown()
