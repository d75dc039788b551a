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
  Every world of this slice lives on one host; agents on other hosts
  come with the runtime slice.
- ``initialize_worker``: runs in each worker before its first CUDA
  tensor: ``torch.cuda.set_device`` on the card (a rank with no card
  raises; it never moves to the CPU), ``torch.set_num_threads(cpus //
  N)`` on the CPU, then ``init_process_group`` with an explicit
  ``timeout``, which also bounds every later collective.
- ``DistributedWorld``: spawned workers with a formed group, kept across
  fit -> validate -> test -> predict.  A bind race on the coordinator's
  port retries with a fresh port; a failed run kills the world (its
  collectives are poisoned); an atexit reaper kills workers that a
  script forgot; ``shutdown`` destroys each process group first.
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
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import functools
import os
import socket
import threading
from typing import Any, Callable, Iterator, List, Optional, Sequence

from . import session as session_lib
from .actors import WAIT_S, ActorPool, RemoteError, worker_channel
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
            except RemoteError as e:
                pool.kill()
                bindy = any(tok in str(e).lower() for tok in (
                    "address already in use", "eaddrinuse"))
                if not (bindy and attempt < 2):
                    raise
                continue
            except BaseException:
                pool.kill()
                raise
            self.pool = pool
            # a world left open at interpreter exit is killed before
            # multiprocessing joins its children
            self._reaper = pool.kill
            atexit.register(self._reaper)
            scope = getattr(_scope, "worlds", None)
            if scope is not None:
                scope.append(self)
            return

    def alive(self) -> bool:
        return (self.pool is not None
                and all(w.is_alive for w in self.pool.workers))

    def run(self, trainable: Callable[[int], Any],
            queue: Optional[TrampolineQueue] = None,
            deadline_s: Optional[float] = None) -> List[Any]:
        """``trainable(rank)`` on every rank; per-rank results, rank 0
        first.  With a ``queue``, each rank's ``put_queue`` reaches this
        process and runs here while the ranks work; inside a tune trial
        the ranks' ``query`` reaches the trial's session too
        (``_nested_query_handler``).  A failed rank fails the run at once
        and kills the world."""
        if self.pool is None:
            raise RuntimeError("DistributedWorld is not alive (a prior run "
                               "failed or it was shut down)")
        server = None
        handler = _nested_query_handler() if queue is not None else None
        if handler is not None:
            server = QueueServer(queue, query_handler=handler)
        address = server.address if server is not None else None
        try:
            futures = self.pool.execute_per_worker(
                _run_world_body, [(i, trainable, queue is not None, address)
                                  for i in range(self.num_processes)])
            return process_results(futures, queue, deadline_s=deadline_s,
                                   channel=self.pool.channel)
        except BaseException:
            self.kill()
            raise
        finally:
            if server is not None:
                server.close()

    def _drop_reaper(self) -> None:
        if getattr(self, "_reaper", None) is not None:
            atexit.unregister(self._reaper)
            self._reaper = None

    def kill(self) -> None:
        self._drop_reaper()
        if self.pool is not None:
            self.pool.kill()
            self.pool = None

    def shutdown(self) -> None:
        """Destroy each rank's process group (NCCL needs it before the
        process exits), then end the workers."""
        self._drop_reaper()
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
