"""Client for the port's sampler service (one JSON line per request;
``psld_tpu/serve/client.py``)."""

from __future__ import annotations

import json
import socket


def request(socket_path: str, obj: dict, timeout: float = 600.0) -> dict:
    """Send one request to a running server and return its reply."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(obj) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
