"""Native ingest runtime (the port's copy of ``cubicsdr_tpu/native``):
builds the C++ library from this package's ``ingest.cpp`` with ``g++`` at
first use into the git-ignored ``cubicsdr_tpu_torch/_build/``, under a
name that hashes the source, and loads it with ctypes. A host with no
compiler takes the numpy path (host code either way; nothing here touches
the card).

API:
  deinterleave(raw_bytes_or_array, fmt) -> (re, im) float32 numpy planes
  float_to_pcm16(audio) -> int16 numpy
  SampleRing(capacity, dtype, frame, storage) -> bounded planar ring with
      try-push shedding, in frames; acquire/release hand a frame out in
      place; wait_readable sleeps until a write makes a block readable
  backend() -> "native" or "numpy"
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("ingest.cpp")
BUILD_DIR = _SRC.parents[1] / "_build"
_GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libcubicsdr_ingest_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib or None
        so = library_path()
        if not so.exists() and not _build(so):
            _lib = False
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _lib = False
            return None
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        lib.cs_deinterleave_cf32.argtypes = [c_f32p, ctypes.c_int64,
                                             c_f32p, c_f32p]
        lib.cs_convert_cs16.argtypes = [c_i16p, ctypes.c_int64,
                                        c_f32p, c_f32p]
        lib.cs_convert_cs8.argtypes = [ctypes.POINTER(ctypes.c_int8),
                                       ctypes.c_int64, c_f32p, c_f32p]
        lib.cs_convert_cu8.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int64, c_f32p, c_f32p]
        lib.cs_float_to_pcm16.argtypes = [c_f32p, ctypes.c_int64, c_i16p]
        lib.cs_ring_create.restype = ctypes.c_void_p
        lib.cs_ring_create.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int64]
        lib.cs_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.cs_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int64]
        lib.cs_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int64]
        lib.cs_ring_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.cs_ring_wait.restype = ctypes.c_int32
        lib.cs_ring_wake.argtypes = [ctypes.c_void_p]
        lib.cs_ring_wake.restype = None
        lib.cs_ring_acquire.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.cs_ring_acquire.restype = ctypes.c_int64
        lib.cs_ring_release.argtypes = [ctypes.c_void_p]
        lib.cs_ring_release.restype = ctypes.c_int32
        lib.cs_ring_fill.argtypes = [ctypes.c_void_p]
        lib.cs_ring_fill.restype = ctypes.c_int64
        lib.cs_ring_readable.argtypes = [ctypes.c_void_p]
        lib.cs_ring_readable.restype = ctypes.c_int64
        lib.cs_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.cs_ring_dropped.restype = ctypes.c_int64
        _lib = lib
        return lib


def backend() -> str:
    """Which ring and conversion code runs: "native" or "numpy"."""
    return "native" if get_lib() is not None else "numpy"


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def deinterleave(raw: np.ndarray, fmt: str = "cf32"):
    """Interleaved wire samples -> planar (re, im) float32.

    fmt: cf32 | cs16 | cs8 | cu8. Uses the native loops when available.
    """
    lib = get_lib()
    dt = {"cf32": np.float32, "cs16": np.int16,
          "cs8": np.int8, "cu8": np.uint8}[fmt]
    raw = np.ascontiguousarray(np.asarray(raw).view(dt).ravel())
    n = raw.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if lib is not None:
        fn = {"cf32": lib.cs_deinterleave_cf32,
              "cs16": lib.cs_convert_cs16,
              "cs8": lib.cs_convert_cs8,
              "cu8": lib.cs_convert_cu8}[fmt]
        ct = {"cf32": ctypes.c_float, "cs16": ctypes.c_int16,
              "cs8": ctypes.c_int8, "cu8": ctypes.c_uint8}[fmt]
        fn(_ptr(raw, ct), n, _ptr(re, ctypes.c_float),
           _ptr(im, ctypes.c_float))
        return re, im
    f = raw.astype(np.float32)
    if fmt == "cs16":
        f /= 32768.0
    elif fmt == "cs8":
        f /= 128.0
    elif fmt == "cu8":
        f = (f - 127.5) / 127.5
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


def float_to_pcm16(audio: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(np.asarray(audio, np.float32).ravel())
    if lib is not None:
        out = np.empty(a.size, np.int16)
        lib.cs_float_to_pcm16(_ptr(a, ctypes.c_float), a.size,
                              _ptr(out, ctypes.c_int16))
        return out
    return (np.clip(a, -1, 1) * 32767.0).astype(np.int16)


class SampleRing:
    """Bounded planar ring with try-push shedding (native when available).

    ``dtype`` sets the stored sample format: float32 (default) or a wire
    format (int16/int8) for native-format ingest — fewer bytes through
    host memory and over the host->device link, converted on the card.

    The storage is laid out in frames of ``frame`` samples (default: the
    whole capacity, two planes): sample s of plane p is element
    ``((s // frame) * 2 + p) * frame + s % frame`` of the flat storage, so
    a frame is one contiguous ``[2, frame]`` span. ``storage``, when given,
    is the caller's: 2 * capacity samples of ``dtype`` that ``np.asarray``
    views in place (a numpy array, or a CPU torch tensor such as a pinned
    ``[capacity // frame, 2, frame]`` one, which the live loop copies to
    the card a frame at a time); the ring keeps it as ``storage``.

    ``read(n)`` copies n samples out. ``acquire(n)`` hands out the next
    block in place instead, as its frame number in the storage, when n is
    one frame and the read position starts a frame; its samples count in
    ``fill`` (so writes shed while held spans fill the ring) but not in
    ``readable`` until ``release()`` frees the oldest held span.

    ``wait_readable(n, timeout)`` sleeps until n samples are readable, an
    accepted write waking it; ``wake()`` releases every such wait early.
    The native wait runs with the interpreter lock released."""

    def __init__(self, capacity: int, dtype=np.float32,
                 frame: Optional[int] = None, storage=None):
        self.capacity = int(capacity)
        self.dtype = np.dtype(dtype)
        self.frame = self.capacity if frame is None else int(frame)
        if self.frame <= 0 or self.capacity % self.frame:
            raise ValueError(f"frame {self.frame} does not divide the "
                             f"capacity {self.capacity}")
        self.storage = storage
        buf = None
        if storage is not None:
            buf = np.asarray(storage)
            if (buf.dtype != self.dtype or buf.size != 2 * self.capacity
                    or not buf.flags.c_contiguous
                    or not buf.flags.writeable):
                raise ValueError(
                    f"storage must be {2 * self.capacity} writable "
                    f"contiguous samples of {self.dtype}, got "
                    f"{buf.size} of {buf.dtype}")
        self._lib = get_lib()
        if self._lib is not None:
            self._buf = buf              # the pointer stays valid
            self._h = self._lib.cs_ring_create(
                None if buf is None else ctypes.c_void_p(buf.ctypes.data),
                self.capacity, self.dtype.itemsize, self.frame)
            return
        if buf is None:
            buf = np.zeros(2 * self.capacity, self.dtype)
        self._frames = buf.reshape(-1, 2, self.frame)
        self._tail = 0          # oldest sample not yet freed
        self._busy = 0          # tail to the read position: held or read
        self._size = 0          # tail to the write position (the fill)
        self._held: collections.deque = collections.deque()
        self.dropped = 0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._wakes = 0

    def _vp(self, a: np.ndarray):
        # The caller must keep ``a`` alive and contiguous for the C call:
        # a silent ascontiguousarray copy here would be a temporary whose
        # pointer can dangle before the callee consumes it.
        assert a.flags.c_contiguous, "pass a C-contiguous array to _vp"
        return ctypes.c_void_p(a.ctypes.data)

    def _segments(self, pos: int, n: int):
        """(frame, offset in it, offset in the block, length) of each
        segment of n samples from ``pos``; a frame never crosses the
        wrap."""
        done, F = 0, self.frame
        while done < n:
            off = pos % F
            seg = min(n - done, F - off)
            yield pos // F, off, done, seg
            done += seg
            pos = (pos + seg) % self.capacity

    def write(self, re: np.ndarray, im: np.ndarray) -> bool:
        n = len(re)
        if self._lib is not None:
            re = np.ascontiguousarray(re, self.dtype)
            im = np.ascontiguousarray(im, self.dtype)
            return bool(self._lib.cs_ring_write(
                self._h, self._vp(re), self._vp(im), n))
        with self._mu:
            if self._size + n > self.capacity:
                self.dropped += n
                return False
            w = (self._tail + self._size) % self.capacity
            for f, off, d, seg in self._segments(w, n):
                self._frames[f, 0, off:off + seg] = re[d:d + seg]
                self._frames[f, 1, off:off + seg] = im[d:d + seg]
            self._size += n
            self._cv.notify_all()
            return True

    def read(self, n: int):
        if self._lib is not None:
            re = np.empty(n, self.dtype)
            im = np.empty(n, self.dtype)
            ok = self._lib.cs_ring_read(self._h, self._vp(re),
                                        self._vp(im), n)
            return (re, im) if ok else None
        with self._mu:
            if self._size - self._busy < n:
                return None
            re, im = np.empty(n, self.dtype), np.empty(n, self.dtype)
            pos = (self._tail + self._busy) % self.capacity
            for f, off, d, seg in self._segments(pos, n):
                re[d:d + seg] = self._frames[f, 0, off:off + seg]
                im[d:d + seg] = self._frames[f, 1, off:off + seg]
            if self._held:
                self._busy += n      # freed with the held span before it
            else:
                self._tail = (self._tail + n) % self.capacity
                self._size -= n
            return re, im

    def wait_readable(self, n: int, timeout: float) -> bool:
        """Sleep until n samples are readable, ``timeout`` seconds pass or
        ``wake()`` is called; whether n samples are readable then."""
        if self._lib is not None:
            return bool(self._lib.cs_ring_wait(self._h, n,
                                               int(timeout * 1e6)))
        with self._cv:
            wakes = self._wakes
            self._cv.wait_for(lambda: self._size - self._busy >= n
                              or self._wakes != wakes, max(timeout, 0.0))
            return self._size - self._busy >= n

    def wake(self) -> None:
        """Release every ``wait_readable`` in progress."""
        if self._lib is not None:
            self._lib.cs_ring_wake(self._h)
            return
        with self._cv:
            self._wakes += 1
            self._cv.notify_all()

    def acquire(self, n: int) -> Optional[int]:
        """The frame number of the next n readable samples, held in place
        until ``release``; None unless n is one frame, the read position
        starts a frame and n samples are readable."""
        if self._lib is not None:
            k = int(self._lib.cs_ring_acquire(self._h, n))
            return None if k < 0 else k
        with self._mu:
            pos = (self._tail + self._busy) % self.capacity
            if (n != self.frame or pos % self.frame
                    or self._size - self._busy < n):
                return None
            self._held.append(pos // self.frame)
            self._busy += n
            return pos // self.frame

    def release(self) -> bool:
        """Free the oldest held span (and reads behind it); False if none
        is held."""
        if self._lib is not None:
            return bool(self._lib.cs_ring_release(self._h))
        with self._mu:
            if not self._held:
                return False
            self._held.popleft()
            freed = (self._busy if not self._held else
                     (self._held[0] * self.frame - self._tail)
                     % self.capacity)
            self._tail = (self._tail + freed) % self.capacity
            self._busy -= freed
            self._size -= freed
            return True

    @property
    def fill(self) -> int:
        """Samples written and not yet freed, held spans included."""
        if self._lib is not None:
            return int(self._lib.cs_ring_fill(self._h))
        with self._mu:
            return self._size

    @property
    def readable(self) -> int:
        """Samples written and not yet read or acquired."""
        if self._lib is not None:
            return int(self._lib.cs_ring_readable(self._h))
        with self._mu:
            return self._size - self._busy

    @property
    def dropped_samples(self) -> int:
        if self._lib is not None:
            return int(self._lib.cs_ring_dropped(self._h))
        return self.dropped

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            try:
                self._lib.cs_ring_destroy(self._h)
            except Exception:
                pass
