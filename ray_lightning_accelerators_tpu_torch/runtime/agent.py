"""Per-host worker agents: the multi-machine launch path.

Port of the JAX package's ``runtime/agent.py``.  Without Ray this is a
control plane of its own:

- a ``HostAgent`` runs on every machine (``rla-tpu-torch agent --port
  7777``): a TCP server that spawns one ``runtime/actors.py`` ``Worker``
  per driver connection and relays pickled work and results;
- a driver-side ``RemoteWorker`` speaks that protocol behind the local
  ``Worker``'s interface (``execute`` -> Future, ``restart``, ``reap``,
  ``kill``, ``heartbeat``, ``telemetry_tail``), so an ``ActorPool``
  places its ranks through agents (``assign_agents``: contiguous
  blocks, one host's ranks adjacent);
- the ``node_ip`` and ``free_port`` ops let the driver put a world's
  rendezvous on agent 0's host (``coordinator_address_on``).

Wire: a frame is an 8-byte big-endian length and the payload; driver ->
agent ``(req_id, op, payload)``, agent -> driver ``(req_id, status,
payload)``, each pickled with the standard ``pickle`` (the card's
machine has no cloudpickle): a function sent to an agent's worker must
be importable there by name.  ``execute`` replies when the worker
finishes; the agent relays the worker's result bytes without
unpickling them ("raw-ok"), so a class only the driver can import never
unpickles on the agent.  The heartbeat snapshot is taken on the agent,
so only clock-free ages cross the wire.  A connection that drops takes
its worker with it (killed, its shm segments unlinked).

Security: an agent runs what it is sent, as a Ray worker does.  It binds
loopback by default; a wider bind needs the shared secret of
``RLA_TPU_AGENT_TOKEN`` on both ends (``check_tokenless_wide_bind``
refuses one without it unless ``RLA_TPU_ALLOW_TOKENLESS_BIND=1``).  The
auth frame is raw bytes, ``AUTH_MAGIC`` and the token, compared before
anything is unpickled: unpickling an unauthenticated frame would itself
run the sender's code.  ``is_loopback`` decides with ``ipaddress`` (a
hostname counts when every address it resolves to is loopback).

The ``live`` op (a worker's live telemetry snapshot) comes with the
telemetry slice 5d and answers with a typed ``NotImplementedError``.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis import knobs
from ..utils.logging import log

_LEN = struct.Struct(">Q")
DEFAULT_PORT = 7777
TOKEN_ENV = "RLA_TPU_AGENT_TOKEN"
AUTH_MAGIC = b"RLA-TPU-AUTH1:"
# a frame is read in pieces of at most this many bytes
_RECV_CHUNK = 1 << 20


def _token_from_env() -> Optional[str]:
    return knobs.get_str(TOKEN_ENV, None)


def check_auth_frame(raw: bytes, token: Optional[str]) -> Optional[bool]:
    """Classify a connection's first raw frame: True (an auth frame to
    skip: the token matches, or none is required), False (refuse: a bad
    token, or a token is required and this is not an auth frame), None
    (no token required and this is a data frame: process it)."""
    import hmac
    if bytes(raw[:len(AUTH_MAGIC)]) == AUTH_MAGIC:
        if token is None:
            return True
        return hmac.compare_digest(bytes(raw[len(AUTH_MAGIC):]),
                                   token.encode())
    return False if token is not None else None


def auth_frame(token: str) -> bytes:
    return AUTH_MAGIC + token.encode()


def send_raw(sock: socket.socket, blob) -> None:
    if len(blob) < _RECV_CHUNK:
        # one segment: a query and its answer are each one write
        sock.sendall(_LEN.pack(len(blob)) + bytes(blob))
    else:
        sock.sendall(_LEN.pack(len(blob)))
        sock.sendall(blob)


def no_delay(sock: socket.socket) -> socket.socket:
    """Send small frames at once (no Nagle wait for the peer's ack: a
    query is a write, then a read)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def send_msg(sock: socket.socket, obj) -> None:
    send_raw(sock, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes into one buffer, read in place (a checkpoint payload
    is a GB frame); ConnectionError at EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:got + _RECV_CHUNK])
        if not k:
            raise ConnectionError("connection closed")
        got += k
    return buf


def recv_raw(sock: socket.socket) -> bytearray:
    """One frame's raw bytes; ConnectionError at EOF."""
    (n,) = _LEN.unpack(bytes(_recv_exact(sock, _LEN.size)))
    return _recv_exact(sock, n)


def recv_msg(sock: socket.socket):
    return pickle.loads(recv_raw(sock))


def is_loopback(host: str) -> bool:
    """True only when ``host`` names the loopback interface: a literal
    address by ``ipaddress``, a hostname when every address it resolves
    to is loopback (unresolvable: not loopback)."""
    import ipaddress
    host = host.strip().strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        pass
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror:
        return False
    addrs = {info[4][0] for info in infos}
    try:
        return bool(addrs) and all(
            ipaddress.ip_address(a.split("%")[0]).is_loopback
            for a in addrs)
    except ValueError:
        return False


def check_tokenless_wide_bind(what: str, bind: str,
                              token: Optional[str]) -> None:
    """An endpoint that runs what it receives refuses a tokenless bind
    the network can reach, unless RLA_TPU_ALLOW_TOKENLESS_BIND=1 accepts
    the risk (logged on every start)."""
    if token is not None or is_loopback(bind):
        return
    if not knobs.get_bool("RLA_TPU_ALLOW_TOKENLESS_BIND"):
        raise RuntimeError(
            f"{what} refuses to bind {bind} without {TOKEN_ENV}: any "
            "host that can reach this port can execute code as this "
            "user.  Set the token on every machine (recommended), or "
            "set RLA_TPU_ALLOW_TOKENLESS_BIND=1 to accept the risk on "
            "a trusted network.")
    log.warning(
        "%s binding %s without %s (RLA_TPU_ALLOW_TOKENLESS_BIND=1): any "
        "host that can reach this port can execute code as this user",
        what, bind, TOKEN_ENV)


def _node_ip() -> str:
    from .net import node_ip
    return node_ip()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def parse_address(address: str) -> Tuple[str, int]:
    host, _, port = address.partition(":")
    return host, int(port) if port else DEFAULT_PORT


def _error(e: BaseException) -> Tuple[str, str, str]:
    return (type(e).__name__, str(e), "")


# --------------------------------------------------------------------- #
# Agent (server) side                                                    #
# --------------------------------------------------------------------- #
class HostAgent:
    """One per machine.  Each accepted connection owns at most one worker
    process (the driver opens one connection per remote worker)."""

    def __init__(self, port: int = DEFAULT_PORT, bind: str = "127.0.0.1",
                 token: Optional[str] = None):
        # None + a loopback bind = open; the token defaults to
        # $RLA_TPU_AGENT_TOKEN, as the driver's does
        self._token = token if token is not None else _token_from_env()
        check_tokenless_wide_bind("HostAgent", bind, self._token)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind, port))
        self._srv.listen(128)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        # every worker process ever spawned: a driver whose world
        # persists across entry points spawns each rank once
        self.spawn_count = 0

    def serve_forever(self) -> None:
        log.warning("rla-tpu-torch agent listening on %s:%d", _node_ip(),
                    self.port)
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return  # closed by shutdown()
            threading.Thread(target=self._serve_conn, args=(conn, addr),
                             daemon=True, name="rla-agent-conn").start()

    def serve_in_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="rla-agent")
        t.start()
        return t

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    # ------------------------------------------------------------------ #
    def _serve_conn(self, conn: socket.socket, addr) -> None:
        from .actors import Worker

        no_delay(conn)
        worker: Optional[Worker] = None
        first_frame = True
        send_lock = threading.Lock()  # execute replies come from callbacks

        def reply(req_id, status, payload) -> None:
            try:
                with send_lock:
                    send_msg(conn, (req_id, status, payload))
            except OSError:
                pass  # the driver went away: nothing to tell it

        def relay(fut, req_id) -> None:
            e = fut.exception()
            if e is not None:
                # the worker died: it never produced wire bytes
                reply(req_id, "err", _error(e))
                return
            status, payload = fut.result()
            # an "ok" payload is still the worker's pickled bytes
            reply(req_id, "raw-ok" if status == "ok" else "err", payload)

        try:
            while True:
                try:
                    raw = recv_raw(conn)
                except (ConnectionError, OSError):
                    return
                if first_frame:
                    # the token is checked on raw bytes, before anything
                    # is unpickled; a refusal closes silently (a reply
                    # would need the frame's req_id, which only unpickling
                    # could give)
                    first_frame = False
                    verdict = check_auth_frame(raw, self._token)
                    if verdict is True:
                        continue  # the auth frame, consumed
                    if verdict is False:
                        log.warning("refused unauthenticated connection "
                                    "from %s (%s required)", addr,
                                    TOKEN_ENV)
                        return
                try:
                    req_id, op, payload = pickle.loads(raw)
                except Exception:
                    return  # a malformed frame drops the connection
                del raw
                try:
                    if op == "spawn":
                        rank, env, opts = (tuple(payload) + ({},))[:3]
                        if worker is not None:
                            raise RuntimeError(
                                "this connection already owns worker "
                                f"{worker.rank}")
                        worker = Worker(rank, env,
                                        daemon=opts.get("daemon", True))
                        self.spawn_count += 1
                        log.info("agent spawned worker rank %d (spawn_count "
                                 "%d)", rank, self.spawn_count)
                        reply(req_id, "ok", None)
                    elif op == "execute":
                        worker.execute_blob(payload, raw=True) \
                            .add_done_callback(
                                lambda f, r=req_id: relay(f, r))
                    elif op == "alive":
                        reply(req_id, "ok",
                              worker is not None and worker.is_alive)
                    elif op == "heartbeat":
                        # taken here: only clock-free ages cross the wire
                        hb = getattr(worker, "heartbeat", None)
                        reply(req_id, "ok",
                              None if hb is None else hb.snapshot())
                    elif op == "telemetry":
                        # the spill file lives on this host; readable
                        # after the worker died
                        reply(req_id, "ok", None if worker is None
                              else worker.telemetry_tail())
                    elif op == "live":
                        from ..core.module import not_ported
                        raise not_ported("a worker's live telemetry "
                                         "snapshot (the agent's live op)",
                                         "runtime 5d")
                    elif op == "reap":
                        if worker is not None:
                            worker.reap(payload)
                        reply(req_id, "ok", None)
                    elif op == "restart":
                        worker.restart()
                        reply(req_id, "ok", None)
                    elif op == "kill":
                        if worker is not None:
                            worker.kill()
                        reply(req_id, "ok", None)
                    elif op == "worker_shutdown":
                        if worker is not None:
                            worker.shutdown()
                            worker = None
                        reply(req_id, "ok", None)
                    elif op == "node_ip":
                        reply(req_id, "ok", _node_ip())
                    elif op == "free_port":
                        reply(req_id, "ok", free_port())
                    elif op == "ping":
                        reply(req_id, "ok", "pong")
                    else:
                        raise ValueError(f"unknown op {op!r}")
                except BaseException as e:  # the loop outlives any op
                    reply(req_id, "err", _error(e))
        finally:
            # a dropped connection takes its worker (and, through kill,
            # the worker's shm segments) with it
            if worker is not None:
                worker.kill()
            try:
                conn.close()
            except OSError:
                pass


# --------------------------------------------------------------------- #
# Driver side                                                            #
# --------------------------------------------------------------------- #
class AgentConnection:
    """One multiplexed request / response connection to a HostAgent."""

    def __init__(self, address: str, timeout: Optional[float] = None,
                 token: Optional[str] = None):
        self.address = address
        if timeout is None:
            # how long to keep retrying an agent that is still booting
            timeout = knobs.get_float("RLA_TPU_AGENT_CONNECT_TIMEOUT", 30.0)
        token = token if token is not None else _token_from_env()
        host, port = parse_address(address)
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout)
                break
            except ConnectionRefusedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)
        self._sock.settimeout(None)
        no_delay(self._sock)
        self._token_sent = token is not None
        if token is not None:
            # fire and forget: a mismatch closes the connection, which
            # the first op sees as a ConnectionError
            send_raw(self._sock, auth_frame(token))
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._next_id = 0
        self._closed = False
        threading.Thread(target=self._recv_loop, daemon=True,
                         name="rla-agent-recv").start()

    def request(self, op: str, payload: Any = None) -> Future:
        fut: Future = Future()
        with self._state_lock:
            if self._closed:
                fut.set_exception(ConnectionError(
                    f"agent {self.address} connection closed"))
                return fut
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = fut
        try:
            with self._send_lock:
                send_msg(self._sock, (req_id, op, payload))
        except OSError as e:
            with self._state_lock:
                self._pending.pop(req_id, None)
            if not fut.done():  # the receive loop may have failed it
                fut.set_exception(ConnectionError(
                    f"agent {self.address} unreachable: {e}"))
        return fut

    def call(self, op: str, payload: Any = None, timeout: float = 60.0):
        return self.request(op, payload).result(timeout=timeout)

    def _recv_loop(self) -> None:
        from .wire import rebuild_remote

        while True:
            try:
                req_id, status, payload = recv_msg(self._sock)
            except (ConnectionError, OSError, EOFError,
                    pickle.UnpicklingError):
                with self._state_lock:
                    self._closed = True
                    pending = list(self._pending.values())
                    self._pending.clear()
                hint = ("" if self._token_sent else
                        f" (if the agent requires {TOKEN_ENV}, export it "
                        f"on the driver too)")
                for fut in pending:
                    if not fut.done():
                        fut.set_exception(ConnectionError(
                            f"lost connection to agent "
                            f"{self.address}{hint}"))
                return
            with self._state_lock:
                fut = self._pending.pop(req_id, None)
            if fut is None or fut.done():
                continue
            try:
                if status == "ok":
                    fut.set_result(payload)
                elif status == "raw-ok":
                    fut.set_result(pickle.loads(payload))
                else:
                    # typed outcomes (WorkerWedged, Preempted, ...) come
                    # home typed, anything else as RemoteError
                    fut.set_exception(rebuild_remote(*payload))
            except BaseException as e:
                fut.set_exception(RuntimeError(
                    f"failed to deserialize result from agent "
                    f"{self.address}: {type(e).__name__}: {e}"))

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteWorker:
    """Driver-side handle to a worker process on a HostAgent, with the
    local ``runtime/actors.py`` ``Worker``'s interface."""

    def __init__(self, address: str, rank: int,
                 env: Optional[Dict[str, str]] = None, daemon: bool = True):
        self.rank = rank
        self.address = address
        self._env = dict(env or {})
        self._conn = AgentConnection(address)
        try:
            self._conn.call("spawn", (rank, self._env, {"daemon": daemon}))
        except BaseException:
            self._conn.close()
            raise
        # snapshots are taken on the agent (ages only); an unreachable
        # agent leaves the watchdog liveness alone
        self.heartbeat = _RemoteHeartbeat(self._conn)

    def execute(self, fn, *args, **kwargs) -> Future:
        # the remote host cannot see this host's shared memory: a
        # top-level ObjectRef is resolved here first
        from .object_store import ObjectRef, resolve
        if any(isinstance(a, ObjectRef) for a in (*args, *kwargs.values())):
            args = tuple(resolve(a) for a in args)
            kwargs = {k: resolve(v) for k, v in kwargs.items()}
        blob = pickle.dumps((fn, args, kwargs),
                            protocol=pickle.HIGHEST_PROTOCOL)
        return self._conn.request("execute", blob)

    @property
    def is_alive(self) -> bool:
        try:
            return bool(self._conn.call("alive", timeout=10))
        except BaseException:
            return False

    @property
    def exitcode(self) -> Optional[int]:
        return None if self.is_alive else -1

    def restart(self) -> None:
        """Respawn the worker on its agent (SIGKILL there, as a local
        restart); its pending futures fail."""
        self._conn.call("restart", timeout=60)

    def reap(self, diagnosis: Optional[Dict[str, Any]] = None) -> None:
        """The watchdog's kill of a wedged remote worker; the connection
        stays open, so the rank stays restartable through its agent."""
        try:
            self._conn.call("reap", diagnosis, timeout=30)
        except BaseException:
            pass  # the agent is gone: its futures failed already

    def telemetry_tail(self) -> Optional[Dict[str, Any]]:
        """This rank's spilled flight-recorder snapshot, read on its host
        by the agent; None on any failure."""
        try:
            return self._conn.call("telemetry", timeout=10)
        except BaseException:
            return None

    def set_env_var(self, key: str, value: str) -> Future:
        return self.execute(_set_env_remote, key, value)

    def get_node_ip(self) -> str:
        return self._conn.call("node_ip")

    def kill(self) -> None:
        try:
            self._conn.call("kill", timeout=10)
        except BaseException:
            pass
        self._conn.close()

    def shutdown(self, timeout: float = 10.0) -> None:
        try:
            self._conn.call("worker_shutdown", timeout=timeout + 5)
        except BaseException:
            pass
        self._conn.close()


class _RemoteHeartbeat:
    """The watchdog's view of a remote worker's heartbeat: the agent takes
    the snapshot; a failure gives None (liveness-only supervision, never
    a false kill over a slow network)."""

    def __init__(self, conn: AgentConnection):
        self._conn = conn

    def snapshot(self) -> Optional[Dict[str, Any]]:
        try:
            # short: the watchdog polls every rank in turn
            return self._conn.call("heartbeat", timeout=2)
        except BaseException:
            return None


def _set_env_remote(key: str, value: str) -> None:
    os.environ[key] = value


# --------------------------------------------------------------------- #
# Topology                                                               #
# --------------------------------------------------------------------- #
def agents_from_env() -> Optional[List[str]]:
    """Agent addresses from ``RLA_TPU_AGENTS`` (comma-separated), set by
    ``rla-tpu-torch launch`` or the user."""
    raw = (knobs.get_str("RLA_TPU_AGENTS", "") or "").strip()
    return [a.strip() for a in raw.split(",") if a.strip()] or None


def parse_agent_spec(spec: str) -> Tuple[str, Optional[int]]:
    """``"host:port*3"`` -> ``("host:port", 3)``; a bare address has no
    count (the balanced split decides)."""
    addr, star, count = spec.partition("*")
    return addr.strip(), int(count) if star else None


def queue_bind_for_agents(agents: Optional[Sequence[str]]) -> Optional[str]:
    """The bind a driver's ``QueueServer`` needs so these agents' workers
    reach it: None (loopback) when every agent is on this host's
    loopback, else ``"0.0.0.0"``."""
    if not agents:
        return None
    for spec in agents:
        if not is_loopback(parse_agent_spec(spec)[0].rsplit(":", 1)[0]):
            return "0.0.0.0"
    return None


def assign_agents(agents: Sequence[str], num_workers: int) -> List[str]:
    """Worker i's agent, in contiguous blocks (a host's ranks adjacent).
    A balanced split gives the first ``num_workers % len(agents)`` hosts
    one extra (3 over 2 -> 2 + 1); ``host:port*N`` specs pin each host's
    count, and then the counts must sum to ``num_workers``."""
    n_agents = len(agents)
    if n_agents == 0 or num_workers < 1:
        raise ValueError("need at least one agent and one worker")
    parsed = [parse_agent_spec(a) for a in agents]
    addrs = [a for a, _ in parsed]
    counts = [c for _, c in parsed]
    if any(c is not None for c in counts):
        if any(c is None for c in counts):
            raise ValueError(
                "mix of explicit (host:port*N) and bare agent specs; "
                "give every agent a count or none")
        if any(c < 0 for c in counts):
            raise ValueError(f"negative worker count in agent specs: "
                             f"{list(agents)}")
        if sum(counts) != num_workers:
            raise ValueError(
                f"explicit agent worker counts {counts} sum to "
                f"{sum(counts)}, but num_workers={num_workers}")
    else:
        base, extra = divmod(num_workers, n_agents)
        counts = [base + (1 if i < extra else 0) for i in range(n_agents)]
    assignment: List[str] = []
    for addr, count in zip(addrs, counts):
        assignment.extend([addr] * count)
    return assignment


def local_indices(assignment: Sequence[str]) -> List[int]:
    """Each rank's index among the ranks its agent holds (rank i's card
    on its host: ``cuda:<index>``)."""
    seen: Dict[str, int] = {}
    out = []
    for addr in assignment:
        out.append(seen.get(addr, 0))
        seen[addr] = out[-1] + 1
    return out


def coordinator_address_on(agent_address: str,
                           loopback: bool = False) -> str:
    """A rendezvous address on the given agent's host (rank 0's): its
    node IP and a port free there.  ``loopback`` (every agent of the
    world is on this host's loopback) names ``127.0.0.1`` instead."""
    conn = AgentConnection(agent_address)
    try:
        ip = "127.0.0.1" if loopback else conn.call("node_ip")
        return f"{ip}:{conn.call('free_port')}"
    finally:
        conn.close()
