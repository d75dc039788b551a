"""Wire helpers of the host-agent protocol that the queue server needs.

Port of the framing, the shared-secret check and the bind checks of the
JAX package's ``runtime/agent.py``; the agents themselves (``HostAgent``,
``RemoteWorker``, ``agents_from_env``, ``queue_bind_for_agents``) come
with the runtime slice 5c-ii.

- A frame is an 8-byte big-endian length and the payload; ``send_msg``
  / ``recv_msg`` carry one object pickled with the standard ``pickle``
  (the card's machine has no cloudpickle).
- The auth frame is raw bytes, ``AUTH_MAGIC`` and the token of
  ``RLA_TPU_AGENT_TOKEN``, compared before anything is unpickled:
  unpickling an unauthenticated frame would itself run the sender's
  code.
- ``is_loopback`` decides with ``ipaddress`` (a hostname counts when
  every address it resolves to is loopback), and
  ``check_tokenless_wide_bind`` refuses a tokenless bind that the
  network can reach unless ``RLA_TPU_ALLOW_TOKENLESS_BIND=1``.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Optional

from ..analysis import knobs
from ..utils.logging import log

_LEN = struct.Struct(">Q")
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
