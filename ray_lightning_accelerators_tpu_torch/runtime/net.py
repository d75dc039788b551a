"""This host's IP address, for the workers' node census.

Port of the JAX package's ``runtime/net.py`` ``node_ip``.  The JAX
version asks the routing table with a UDP ``connect`` to a public
address; this one reads the addresses of the host's own interfaces
(``SIOCGIFADDR``), so it sends nothing and resolves no name.  A host
with no address but loopback answers ``127.0.0.1``.
"""

from __future__ import annotations

import fcntl
import socket
import struct

_SIOCGIFADDR = 0x8915


def _interface_ip(sock: socket.socket, name: str):
    try:
        packed = fcntl.ioctl(sock.fileno(), _SIOCGIFADDR,
                             struct.pack("256s", name.encode()[:15]))
    except OSError:
        return None  # no IPv4 address on this interface
    return socket.inet_ntoa(packed[20:24])


def node_ip() -> str:
    """This host's first non-loopback IPv4 address."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        for _index, name in socket.if_nameindex():
            ip = _interface_ip(sock, name)
            if ip is not None and not ip.startswith("127."):
                return ip
    return "127.0.0.1"
