"""Minimal client of the control plane's RPC (own copy of the frame of
``tony_tpu/cluster/rpc.py``).

Wire format: a 4-byte big-endian length, then a UTF-8 JSON object.
Request ``{"method", "params", "auth"}``; response ``{"ok": true,
"result"}`` or ``{"ok": false, "error"}``. The serving replica makes one
call (``register_task_url``), so there is no retry loop, reconnect or
client-side metrics here.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024


class RpcError(RuntimeError):
    """The remote method raised, or the peer broke the protocol."""


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode("utf-8")
    if len(payload) > MAX_FRAME:
        raise RpcError(f"frame too large: {len(payload)}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    return json.loads(_recv_exact(sock, length))


class RpcClient:
    """Blocking client over one connection, opened by the first call."""

    def __init__(self, host: str, port: int, secret: str = "", timeout_s: float = 10.0):
        self.host, self.port, self.secret = host, int(port), secret
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def call(self, method: str, **params: Any) -> Any:
        with self._lock:
            if self._sock is None:
                self._sock = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
                self._sock.settimeout(self.timeout_s)
            _send_frame(self._sock, {"method": method, "params": params, "auth": self.secret})
            resp = _recv_frame(self._sock)
        if not isinstance(resp, dict):
            raise RpcError("malformed response")
        if not resp.get("ok"):
            raise RpcError(str(resp.get("error")))
        return resp.get("result")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None


def own_host(am_host: str) -> str:
    """This container's reachable address (the executor's rule): loopback
    deployments stay on loopback; otherwise the host's resolved address."""
    if am_host.startswith("127.") or am_host == "localhost":
        return "127.0.0.1"
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return socket.gethostname()
