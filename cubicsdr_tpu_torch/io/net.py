"""Network IQ transport — the SoapyRemote role (the port's copy of
``cubicsdr_tpu/io/net.py``).

The reference streams remote SDRs through SoapyRemote (an external SoapySDR
module; ref: src/CubicSDR.cpp:614-622 remote management, SDREnumerator.cpp:
179+ remote enumeration). Here: a simple length-prefixed TCP protocol
carrying planar float32 IQ blocks plus a JSON header — enough to feed a TPU
host pipeline from a capture machine, and trivially testable loopback.

Frame format: [u32 magic 'CSDR'][u32 header_len][header JSON]
              [u64 payload_len][payload: re f32[n] | im f32[n]]
"""

from __future__ import annotations

import json
import socket
import struct
import threading

import numpy as np

MAGIC = 0x43534452


def _send_frame(sock: socket.socket, header: dict, re: np.ndarray,
                im: np.ndarray):
    h = json.dumps(header).encode()
    payload = re.astype(np.float32).tobytes() + im.astype(
        np.float32).tobytes()
    sock.sendall(struct.pack(">II", MAGIC, len(h)) + h
                 + struct.pack(">Q", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    magic, hlen = struct.unpack(">II", _recv_exact(sock, 8))
    if magic != MAGIC:
        raise ValueError("bad magic")
    header = json.loads(_recv_exact(sock, hlen))
    (plen,) = struct.unpack(">Q", _recv_exact(sock, 8))
    payload = _recv_exact(sock, plen)
    n = plen // 8
    re = np.frombuffer(payload[: 4 * n], np.float32)
    im = np.frombuffer(payload[4 * n:], np.float32)
    return header, re, im


class IQServer:
    """Serves an IQ source (any block iterator) to one client at a time."""

    def __init__(self, source, sample_rate: float, frequency: float = 0.0,
                 host: str = "127.0.0.1", port: int = 0):
        self.source = source
        self.sample_rate = sample_rate
        self.frequency = frequency
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._thread = None
        self._stop = threading.Event()

    def serve_background(self):
        self._thread = threading.Thread(target=self._serve_once, daemon=True)
        self._thread.start()
        return self.port

    def _serve_once(self):
        conn, _ = self._srv.accept()
        try:
            with conn:
                seq = 0
                for blk in self.source:
                    if self._stop.is_set():
                        break
                    blk = np.asarray(blk)
                    _send_frame(conn, {
                        "seq": seq, "sample_rate": self.sample_rate,
                        "frequency": self.frequency, "n": len(blk)},
                        np.ascontiguousarray(blk.real),
                        np.ascontiguousarray(blk.imag))
                    seq += 1
        except (ConnectionError, OSError):
            pass
        finally:
            self._srv.close()

    def close(self):
        self._stop.set()


class SocketIQSource:
    """Client side: iterate complex64 blocks from an IQServer peer."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sample_rate = None
        self.frequency = None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        try:
            header, re, im = _recv_frame(self.sock)
        except (ConnectionError, OSError):
            self.sock.close()
            raise StopIteration
        self.sample_rate = header.get("sample_rate")
        self.frequency = header.get("frequency")
        return (re + 1j * im).astype(np.complex64)

    def close(self):
        self.sock.close()
