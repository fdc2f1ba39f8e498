"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All ``csrc/*.cu`` sources compile into ONE shared library with a plain C
interface (no PyTorch headers: seconds, not minutes, of nvcc), at first
use, into ``cubicsdr_tpu_torch/_build/`` under a name that hashes the
sources and flags: one nvcc per source, all started together, then one
link. Pointers are passed from ``tensor.data_ptr()`` and the
stream from ``torch.cuda.current_stream().cuda_stream``; each launch
function returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# extern "C" entry points: name -> argtypes (restype int = cudaError_t).
_SIGNATURES = {
    "pfbch2_planar_launch": [_P, _P, _L, _P, _P, _P, _P, _P, _P, _I, _P,
                             _P, _P, _I, _I, _I, _I, _P],
    "routed_shifted_resample_launch": [_P, _P, _L, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcubicsdr_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library; the build log
    (ptxas register/shared-memory report) is kept as ``lib.build_log``."""
    so = library_path()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for obj, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{out}")
        tmp = so.with_name(f"{tag}.so.tmp")
        objs = [str(obj) for obj, _ in jobs]
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *objs], capture_output=True, text=True)
        for obj in objs:
            os.remove(obj)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cubicsdr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cubicsdr_cuda_error_string.restype = ctypes.c_char_p
    lib.build_log = log
    return lib


def check_launch(lib, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.cubicsdr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, device, dtype, shape=None, align: int = 0) -> None:
    """Validate a kernel operand: device, dtype, shape, contiguity and,
    for operands read with 16-byte copies, the address alignment."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")
