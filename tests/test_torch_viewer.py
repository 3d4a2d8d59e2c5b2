"""The port's SIBR viewer stub (dgmesh_torch/viewer.py) against the JAX
package's (dgmesh_tpu/viewer.py) on a loopback socket: the same message
read from the same bytes, the same bytes sent for the same frame, and None
once the viewer has gone."""

import json
import socket
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import viewer as TV  # noqa: E402
from dgmesh_tpu import viewer as JV  # noqa: E402

MESSAGE = {"resolution_x": 800, "resolution_y": 600, "train": True, "fov_y": 0.69,
           "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0, "shs_python": False,
           "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
           "view_matrix": [float(i) for i in range(16)],
           "view_projection_matrix": [0.5 * i for i in range(16)], "time": 0.25}


@pytest.fixture
def connected(monkeypatch):
    """Each stub listening on a free loopback port (port 0), with a viewer
    connected to it: {module: the viewer's socket}; the modules' globals
    are put back after the test."""
    clients = {}
    for m in (TV, JV):
        for name in ("host", "port", "conn", "addr", "listener"):
            monkeypatch.setattr(m, name, getattr(m, name))
        m.init("127.0.0.1", 0)
        c = socket.create_connection(m.listener.getsockname(), timeout=10)
        for _ in range(1000):
            m.try_connect()
            if m.conn is not None:
                break
        assert m.conn is not None
        clients[m] = c
    yield clients
    for m, c in clients.items():
        c.close()
        for s in (m.conn, m.listener):
            if s is not None:
                s.close()


def _recv(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk
        out += chunk
    return out


def test_read_gives_jax_message(connected):
    """One length-prefixed JSON message, sent in two pieces: the port's read
    returns the dict JAX's read returns."""
    payload = json.dumps(MESSAGE).encode()
    got = {}
    for m, c in connected.items():
        c.sendall(struct.pack("<I", len(payload)) + payload[:50])
        c.sendall(payload[50:])
        got[m] = m.read()
    assert got[TV] == got[JV] == MESSAGE


def test_send_writes_jax_bytes(connected):
    """A 3x5 RGB frame and a source path: the same bytes as JAX's send, the
    frame's raw bytes, then the path's 4-byte little-endian length and the
    path."""
    img = np.random.default_rng(0).integers(0, 256, (3, 5, 3), dtype=np.uint8)
    path = "data/scene"
    n = img.nbytes + 4 + len(path)
    got = {}
    for m, c in connected.items():
        m.send(img[:, ::-1], path)
        got[m] = _recv(c, n)
    assert got[TV] == got[JV] == (np.ascontiguousarray(img[:, ::-1]).tobytes()
                                   + struct.pack("<I", len(path)) + path.encode())


def test_read_after_the_viewer_closes_is_none(connected):
    """The viewer closes its end: read returns None, as JAX's does; without
    a connection read returns None and send does nothing."""
    for m, c in connected.items():
        c.close()
        assert m.read() is None
        m.conn.close()
        m.conn = None
        assert m.read() is None
        m.send(np.zeros((1, 1, 3), np.uint8), "x")
