"""Actor runtime: persistent worker processes with remote-execute futures.

Port of the JAX package's ``runtime/actors.py`` (``Worker``,
``ActorPool``, ``RemoteError``) for workers on this host:

- each ``Worker`` is a long-lived subprocess from
  ``multiprocessing.get_context("spawn")`` running a request loop; work
  arrives as a pickled ``(fn, args, kwargs)``;
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
  with its rank and overlay at boot, and ``Worker.telemetry_tail()``
  reads its spill from the driver, also after the worker died.

Work and results ship with the standard ``pickle`` (the card's machine
has no cloudpickle): a function is sent by its import path, so it must
be defined at module level (a lambda or a closure raises
``PicklingError`` at ``execute``), and the worker must be able to import
it.  Agents on other hosts, the watchdog, chaos injection, ``drop``,
``revive`` and ``find_lost`` come with the runtime slice.

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
import traceback
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

_SENTINEL = b"__shutdown__"
# how long a pool waits for a census, an env update or a graceful exit
WAIT_S = 300.0

# worker side: the pool's channel to the driver, set when the worker starts
_channel: Optional[Any] = None


def worker_channel() -> Optional[Any]:
    """Inside a worker: its pool's channel to the driver (None elsewhere)."""
    return _channel


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


def _worker_main(conn, env: Dict[str, str], channel, rank: int = 0) -> None:
    global _channel
    os.environ.update(env)
    _channel = channel
    # the flight recorder, rank-keyed, with the overlay's trace id and
    # spill directory; telemetry observes and never takes a worker down
    try:
        from ..telemetry import recorder
        recorder.configure(rank=rank, env=env)
    except Exception:
        pass
    from .object_store import ObjectRef, resolve
    while True:
        try:
            blob = _recv_blob(conn)
        except EOFError:
            return
        if blob == _SENTINEL:
            conn.close()
            return
        try:
            fn, args, kwargs = pickle.loads(blob)
            if any(isinstance(a, ObjectRef)
                   for a in (*args, *kwargs.values())):
                # Ray-style call-site deref of top-level refs
                args = tuple(resolve(a) for a in args)
                kwargs = {k: resolve(v) for k, v in kwargs.items()}
            payload = ("ok", pickle.dumps(fn(*args, **kwargs)))
        except Exception as e:  # ship the traceback home
            payload = ("err", (type(e).__name__, str(e),
                               traceback.format_exc()))
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
                 daemon: bool = True):
        self.rank = rank
        self._env = dict(env or {})  # kept for restart()
        # a daemonic process may not start children: a tune process
        # trial whose fit spawns ranks runs in a non-daemon worker, which
        # its owner kills (and reaps at exit)
        self._daemon = daemon
        self._ctx = ctx or mp.get_context("spawn")
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
        self._proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self._env, self._channel, self.rank),
            daemon=self._daemon, name=f"rla-torch-worker-{self.rank}")
        self._proc.start()
        child_conn.close()
        self._pending: List[Future] = []
        # the collector binds its generation's pipe, process and pending
        # list: after restart() swaps them, the old thread drains the old
        # pipe and fails the old futures
        self._collector = threading.Thread(
            target=self._collect,
            args=(self._conn, self._proc, self._pending), daemon=True)
        self._collector.start()

    @property
    def is_alive(self) -> bool:
        return self._proc.is_alive()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def restart(self) -> None:
        """Respawn this worker with the same rank and env: SIGTERM, then
        SIGKILL if the process outlives 10 s.  The old process's pending
        futures fail with "worker N died"; callers dispatch again."""
        with self._send_lock:
            if self._proc.is_alive():
                self._proc.terminate()
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
        blob = pickle.dumps((fn, args, kwargs))
        fut: Future = Future()
        with self._send_lock:
            if not self._proc.is_alive():
                fut.set_exception(RuntimeError(
                    f"worker {self.rank} is dead "
                    f"(exitcode={self._proc.exitcode})"))
                return fut
            with self._state_lock:
                self._pending.append(fut)
            try:
                self._conn.send_bytes(blob)
            except OSError as e:
                with self._state_lock:
                    if fut in self._pending:
                        self._pending.remove(fut)
                fut.set_exception(RuntimeError(
                    f"worker {self.rank} died before accepting work: {e}"))
        return fut

    def _collect(self, conn, proc, pending_list: List[Future]) -> None:
        while True:
            try:
                blob = _recv_blob(conn)
            except (EOFError, OSError):
                with self._state_lock:
                    pending = list(pending_list)
                    pending_list.clear()
                # no join here: two threads waiting on one process race in
                # multiprocessing, and the loser sees it alive once reaped
                for fut in pending:
                    if not fut.done():
                        fut.set_exception(RuntimeError(
                            f"worker {self.rank} died "
                            f"(exitcode={proc.exitcode})"))
                return
            with self._state_lock:
                fut = pending_list.pop(0)
            try:
                status, payload = pickle.loads(blob)
                if status == "ok":
                    fut.set_result(pickle.loads(payload))
                else:
                    fut.set_exception(RemoteError(*payload))
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

    def set_env_var(self, key: str, value: str) -> Future:
        return self.execute(_set_env, key, value)

    def kill(self) -> None:
        """SIGTERM, then SIGKILL if the process outlives 5 s."""
        if self._proc.is_alive():
            self._proc.terminate()
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


class ActorPool:
    """N workers on this host and the fan-out helpers."""

    def __init__(self, num_workers: int,
                 env_per_worker: Optional[Sequence[Dict[str, str]]] = None):
        envs = env_per_worker or [{} for _ in range(num_workers)]
        if len(envs) != num_workers:
            raise ValueError(f"{len(envs)} env overlays for {num_workers} "
                             "workers")
        ctx = mp.get_context("spawn")
        # the trampoline channel: written by the ranks' sessions, drained
        # by the driver (runtime.queue.process_results)
        self.channel = ctx.SimpleQueue()
        self.workers: List[Worker] = []
        try:
            for i in range(num_workers):
                self.workers.append(Worker(i, envs[i], ctx, self.channel))
        except BaseException:
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
        """Liveness per rank, from the OS process state."""
        return [w.is_alive for w in self.workers]

    def restart_all(self) -> List[int]:
        """Respawn every worker, alive or not: when one rank dies in
        collective work its peers wait on it, so all restart together.
        Returns the ranks."""
        for w in self.workers:
            w.restart()
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
