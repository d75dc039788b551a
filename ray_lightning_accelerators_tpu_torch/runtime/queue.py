"""TrampolineQueue and the driver's result pump.

Port of the JAX package's ``runtime/queue.py``: ``TrampolineQueue`` (the
thread-safe queue the serve batcher stores requests in, and the driver
side of the workers' ``put_queue``) and ``process_results``, which polls
the workers' futures while it runs the callables the workers ship home.
``shutdown()`` is an idempotent close that drains what is still enqueued
WITHOUT executing it, so the batcher can cancel each drained request
typed; a ``put`` after shutdown raises ``QueueShutdown`` instead of
silently losing the item.

The workers of an ``ActorPool`` reach the driver through the pool's
``multiprocessing`` channel (``runtime/actors.py``); ``process_results``
moves what arrives there into the queue and runs it.

``QueueServer`` / ``QueueClient`` are the TCP path: a process that is no
child of the driver's pool (a tune process trial) streams ``(rank,
callable)`` frames into the driver's queue, and asks the driver
something over the same socket with ``query`` (a synchronous
request / response: "was my trial stopped?", a report, a checkpoint).
The server binds loopback by default; its first frame from each
connection is checked against ``RLA_TPU_AGENT_TOKEN`` before anything
is unpickled.  Frames use the standard ``pickle``.  A rank of a
``DistributedWorld`` keeps ``put`` on the pool's channel and gets
``query`` from a ``RankQueue``, whose connection to the world's server
opens at its first query.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from ..utils.logging import log
from . import agent


class QueueShutdown(RuntimeError):
    """Typed rejection for ``put()`` on a shut-down queue: the item would
    never be drained or executed, so silently accepting it loses work."""


class TrampolineQueue:
    """Thread-safe FIFO with an idempotent draining shutdown."""

    def __init__(self):
        self._q = queue_mod.Queue()
        self._lock = threading.Lock()
        self._closed = False

    def put(self, item: Any) -> None:
        with self._lock:
            if self._closed:
                raise QueueShutdown(
                    "TrampolineQueue is shut down; the item would never "
                    "be drained")
            self._q.put(item)

    def get_nowait(self):
        try:
            return self._q.get_nowait()
        except queue_mod.Empty:
            return None

    def shutdown(self) -> List[Any]:
        """Mark closed and drain everything still enqueued without
        executing it; later calls return []."""
        with self._lock:
            first, self._closed = not self._closed, True
        drained: List[Any] = []
        if first:
            while True:
                item = self.get_nowait()
                if item is None:
                    break
                drained.append(item)
        return drained


_ACK = "__rla_ack__"
_QUERY = "__rla_query__"


class QueueServer:
    """Driver-side TCP endpoint feeding ``queue`` from workers in other
    processes.  A reader thread per connection unpickles each frame and
    enqueues it; a flush frame is acknowledged once everything before it
    is enqueued; a query frame is answered by ``query_handler(name,
    payload)`` on the reader thread."""

    def __init__(self, queue: TrampolineQueue, bind: Optional[str] = None,
                 query_handler: Optional[Callable[[str, Any], Any]] = None):
        """``bind=None`` binds loopback: the frames are unpickled and run
        in this process, so the port is opened to the network only when
        asked for (``bind="0.0.0.0"``, with ``RLA_TPU_AGENT_TOKEN``)."""
        self._queue = queue
        self._token = agent._token_from_env()
        self._query_handler = query_handler
        loopback = bind is None or agent.is_loopback(bind)
        if bind is None:
            bind = "127.0.0.1"
        agent.check_tokenless_wide_bind("QueueServer", bind, self._token)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind, 0))
        self._srv.listen(128)
        if loopback:
            host = "127.0.0.1"
        else:
            from .net import node_ip
            host = node_ip()
        self.address = f"{host}:{self._srv.getsockname()[1]}"
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="rla-queue-accept").start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return  # closed
            agent.no_delay(conn)
            threading.Thread(target=self._reader, args=(conn,), daemon=True,
                             name="rla-queue-reader").start()

    def _answer(self, name: str, payload: Any) -> Any:
        if self._query_handler is None:
            return None
        try:
            return self._query_handler(name, payload)
        except Exception as e:
            # a broken handler must not kill the reader, but a silent
            # None reads as "keep going" downstream: say so
            log.warning("queue query handler failed for %r: %s", name, e)
            return None

    def _reader(self, conn: socket.socket) -> None:
        first = True
        while True:
            try:
                raw = agent.recv_raw(conn)
            except (ConnectionError, OSError):
                break
            if first:
                first = False
                verdict = agent.check_auth_frame(raw, self._token)
                if verdict is True:
                    continue   # the auth frame, consumed
                if verdict is False:
                    break
            try:
                item = pickle.loads(raw)
            except Exception:
                break   # a malformed frame drops the connection
            del raw   # a checkpoint's frame is GBs: free it before handling
            try:
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == _ACK:
                    # everything this client sent earlier is enqueued (one
                    # reader thread, in order)
                    agent.send_msg(conn, item)
                elif isinstance(item, tuple) and len(item) == 3 \
                        and item[0] == _QUERY:
                    agent.send_msg(conn, (_QUERY,
                                          self._answer(item[1], item[2])))
                else:
                    self._queue.put(item)
            except (OSError, QueueShutdown):
                break
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Stop accepting (a connection ends when its client does)."""
        try:
            self._srv.close()
        except OSError:
            pass


class QueueClient:
    """Worker-side stand-in for the driver's queue: ``put`` ships a
    ``(rank, callable)`` to the ``QueueServer`` at ``address``."""

    def __init__(self, address: str):
        host, _, port = address.rpartition(":")
        self._sock = agent.no_delay(
            socket.create_connection((host, int(port)), timeout=30))
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        token = agent._token_from_env()
        if token is not None:
            agent.send_raw(self._sock, agent.auth_frame(token))

    def put(self, item) -> None:
        with self._lock:
            agent.send_msg(self._sock, item)

    def flush(self) -> None:
        """Block until everything ``put`` so far is enqueued driver-side
        (a worker's result travels another channel and could outrun its
        last puts)."""
        with self._lock:
            agent.send_msg(self._sock, (_ACK, 0))
            agent.recv_msg(self._sock)

    def query(self, name: str, payload: Any = None) -> Any:
        """Ask the driver's query handler; blocks for the answer.  The lock
        keeps queries, puts and flushes in order, so the next frame read
        is this query's answer."""
        with self._lock:
            agent.send_msg(self._sock, (_QUERY, name, payload))
            _tag, result = agent.recv_msg(self._sock)
            return result

    def shutdown(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class RankQueue:
    """A rank's session queue inside a ``DistributedWorld`` run: ``put``
    over the pool's channel, ``query`` over a ``QueueClient`` to the
    run's ``QueueServer`` (connected at the first query)."""

    def __init__(self, channel: Any, query_address: str):
        self._channel = channel
        self._address = query_address
        self._client: Optional[QueueClient] = None

    def put(self, item) -> None:
        self._channel.put(item)

    def query(self, name: str, payload: Any = None) -> Any:
        if self._client is None:
            self._client = QueueClient(self._address)
        return self._client.query(name, payload)

    def shutdown(self) -> None:
        if self._client is not None:
            self._client.shutdown()
            self._client = None


def drain_queue(q: Optional[TrampolineQueue], channel: Any = None) -> int:
    """Move what the workers wrote to ``channel`` into ``q``, then run
    every queued ``(rank, callable)`` in this process; returns how many
    ran."""
    if q is None:
        return 0
    while channel is not None and not channel.empty():
        q.put(channel.get())
    n = 0
    while True:
        item = q.get_nowait()
        if item is None:
            return n
        _rank, fn = item
        fn()
        n += 1


def process_results(futures: List[Future], q: Optional[TrampolineQueue],
                    poll_s: float = 0.01,
                    deadline_s: Optional[float] = None,
                    channel: Any = None) -> List[Any]:
    """Poll the workers' futures while running what they ship home; a
    final drain after the last future closes the race between a
    worker's last ``put_queue`` and its result.

    Fails fast on the first future that failed: in a collective job one
    crashed rank leaves its peers blocked in a collective, so waiting for
    every future would hang with the failure already in hand.
    ``deadline_s`` bounds the whole set: past it, ``TimeoutError`` (the
    futures stay unresolved; the caller kills the workers)."""
    pending = list(futures)
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    while pending:
        drain_queue(q, channel)
        still = []
        for f in pending:
            if not f.done():
                still.append(f)
            elif f.exception() is not None:
                drain_queue(q, channel)
                f.result()  # re-raise
        pending = still
        if pending and deadline is not None \
                and time.monotonic() >= deadline:
            drain_queue(q, channel)
            raise TimeoutError(
                f"process_results: {len(pending)} of {len(futures)} "
                f"futures unresolved past the {deadline_s:.1f} s deadline")
        if pending:
            time.sleep(poll_s)
    drain_queue(q, channel)
    return [f.result() for f in futures]
