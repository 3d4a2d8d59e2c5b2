"""SIBR remote-viewer protocol stub (the port's copy of dgmesh_tpu/viewer.py).

reference: gaussian_renderer/network_gui.py :27-91 — a TCP socket protocol for
the SIBR interactive viewer (init / try_connect / read / send).  Neither the
reference's train.py nor either package calls it (legacy from 3DGS); it is
kept for API parity.  Wire format: in, a 4-byte little-endian length, then
that many bytes of JSON (resolution, camera matrices, toggles); out, the
frame's raw RGB bytes, then a 4-byte little-endian length and the source
path.  Sockets, json and numpy only.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback
from typing import Optional

import numpy as np

host = "127.0.0.1"
port = 6009

conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None


def init(wish_host: str = host, wish_port: int = port):
    """Listen on (wish_host, wish_port), without blocking on accept."""
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect():
    """Accept a waiting viewer, if there is one."""
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def read() -> Optional[dict]:
    """Receive one camera/settings message; returns None when disconnected."""
    global conn
    if conn is None:
        return None
    try:
        raw = conn.recv(4)
        if len(raw) < 4:
            return None
        (length,) = struct.unpack("<I", raw)
        payload = b""
        while len(payload) < length:
            chunk = conn.recv(length - len(payload))
            if not chunk:
                return None
            payload += chunk
        return json.loads(payload.decode())
    except Exception:
        conn = None
        traceback.print_exc()
        return None


def send(image: Optional[np.ndarray], source_path: str = ""):
    """Send one rendered frame (H,W,3 uint8) back to the viewer."""
    global conn
    if conn is None:
        return
    try:
        if image is not None:
            conn.sendall(np.ascontiguousarray(image).tobytes())
        conn.sendall(len(source_path).to_bytes(4, "little"))
        conn.sendall(source_path.encode())
    except Exception:
        conn = None
