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
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
from typing import Any, Callable, List, Optional, Sequence

from . import session as session_lib
from .actors import WAIT_S, ActorPool, RemoteError, worker_channel
from .queue import TrampolineQueue, process_results

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


def _run_world_body(rank: int, trainable, with_queue: bool):
    """One entry-point run inside a persistent worker: a fresh session
    (with the pool's channel when the driver pumps a queue), then the
    trainable."""
    session_lib.shutdown_session()
    session_lib.init_session(rank, worker_channel() if with_queue else None)
    try:
        return trainable(rank)
    finally:
        session_lib.shutdown_session()


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
            return

    def alive(self) -> bool:
        return (self.pool is not None
                and all(w.is_alive for w in self.pool.workers))

    def run(self, trainable: Callable[[int], Any],
            queue: Optional[TrampolineQueue] = None,
            deadline_s: Optional[float] = None) -> List[Any]:
        """``trainable(rank)`` on every rank; per-rank results, rank 0
        first.  With a ``queue``, each rank's ``put_queue`` reaches this
        process and runs here while the ranks work.  A failed rank fails
        the run at once and kills the world."""
        if self.pool is None:
            raise RuntimeError("DistributedWorld is not alive (a prior run "
                               "failed or it was shut down)")
        try:
            futures = self.pool.execute_per_worker(
                _run_world_body, [(i, trainable, queue is not None)
                                  for i in range(self.num_processes)])
            return process_results(futures, queue, deadline_s=deadline_s,
                                   channel=self.pool.channel)
        except BaseException:
            self.kill()
            raise

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
