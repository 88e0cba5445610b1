"""ctypes bindings for the native host library (port of
``tol_tpu/io/native.py``).

The library is the committed ``native/libtolnative.so`` (source
``native/tolnative.cpp``), read where it lies: a fast ``.param`` reader,
the ``TOLWGRID`` binary wind-grid cache and a buffered telemetry logger.
Where the library is missing, each function takes a pure-Python path that
reads and writes the same bytes.  This is host file IO only.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libtolnative.so")


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, or None where it is missing (tried once)."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.tol_read_params.restype = ctypes.c_int
    lib.tol_read_params.argtypes = [ctypes.c_char_p, _F64P, ctypes.c_int]
    lib.tol_write_wind_grid.restype = ctypes.c_int
    lib.tol_write_wind_grid.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        _F64P, _F64P, _F32P, _F32P, _F32P]
    lib.tol_read_wind_grid_header.restype = ctypes.c_int
    lib.tol_read_wind_grid_header.argtypes = [
        ctypes.c_char_p, _U32P, _U32P, _U32P, _F64P, _F64P]
    lib.tol_read_wind_grid_data.restype = ctypes.c_int
    lib.tol_read_wind_grid_data.argtypes = [ctypes.c_char_p, _F32P, _F32P,
                                            _F32P]
    lib.tol_logger_open.restype = ctypes.c_void_p
    lib.tol_logger_open.argtypes = [ctypes.c_char_p]
    lib.tol_logger_append.restype = ctypes.c_int
    lib.tol_logger_append.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                      _F64P, ctypes.c_uint32]
    lib.tol_logger_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def read_params_native(path: str) -> Optional[list]:
    """Native .param reader; None if the library is missing."""
    lib = load_library()
    if lib is None:
        return None
    buf = (ctypes.c_double * 256)()
    n = lib.tol_read_params(path.encode(), buf, 256)
    if n < 0:
        raise IOError(f"tol_read_params failed for {path}")
    return [buf[i] for i in range(n)]


def write_wind_grid(path: str, origin, spacing, u, v, w) -> None:
    """Write a ``TOLWGRID`` file: magic, uint32 (version 1, nx, ny, nz),
    float64 origin and spacing, then float32 u, v, w."""
    u = np.ascontiguousarray(u, dtype=np.float32)
    v = np.ascontiguousarray(v, dtype=np.float32)
    w = np.ascontiguousarray(w, dtype=np.float32)
    nx, ny, nz = u.shape
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    spacing = np.ascontiguousarray(spacing, dtype=np.float64)
    lib = load_library()
    if lib is None:
        with open(path, "wb") as f:
            f.write(b"TOLWGRID")
            f.write(np.array([1, nx, ny, nz], dtype=np.uint32).tobytes())
            f.write(origin.tobytes())
            f.write(spacing.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
            f.write(w.tobytes())
        return
    rc = lib.tol_write_wind_grid(
        path.encode(), nx, ny, nz,
        origin.ctypes.data_as(_F64P), spacing.ctypes.data_as(_F64P),
        u.ctypes.data_as(_F32P), v.ctypes.data_as(_F32P),
        w.ctypes.data_as(_F32P))
    if rc != 0:
        raise IOError(f"tol_write_wind_grid failed for {path}")


def read_wind_grid(path: str, dtype=torch.float64, device=None):
    """Load a ``TOLWGRID`` file as a WindGrid on ``device`` (default: CUDA;
    raises without a GPU), v component live as the reference has it."""
    from tol_tpu_torch.models.wind import WindGrid
    from tol_tpu_torch.problems.base import resolve_device

    device = resolve_device(device)
    lib = load_library()
    if lib is None:
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:8] != b"TOLWGRID":
            raise IOError(f"bad wind grid file {path}")
        _, nx, ny, nz = (int(x) for x in np.frombuffer(raw[8:24], np.uint32))
        origin = np.frombuffer(raw[24:48], dtype=np.float64)
        spacing = np.frombuffer(raw[48:72], dtype=np.float64)
        cells = nx * ny * nz
        u, v, w = (np.frombuffer(raw[72 + 4 * k * cells:72 + 4 * (k + 1) * cells],
                                 dtype=np.float32) for k in range(3))
    else:
        n3 = [ctypes.c_uint32() for _ in range(3)]
        origin, spacing = np.zeros(3), np.zeros(3)
        rc = lib.tol_read_wind_grid_header(
            path.encode(), *[ctypes.byref(x) for x in n3],
            origin.ctypes.data_as(_F64P), spacing.ctypes.data_as(_F64P))
        if rc != 0:
            raise IOError(f"bad wind grid file {path}")
        nx, ny, nz = (x.value for x in n3)
        cells = nx * ny * nz
        u, v, w = (np.zeros(cells, dtype=np.float32) for _ in range(3))
        rc = lib.tol_read_wind_grid_data(
            path.encode(), u.ctypes.data_as(_F32P), v.ctypes.data_as(_F32P),
            w.ctypes.data_as(_F32P))
        if rc != 0:
            raise IOError(f"bad wind grid data {path}")
    shape = (nx, ny, nz)
    field = lambda a: torch.as_tensor(np.array(a).reshape(shape),
                                      dtype=torch.float32, device=device)
    vec = lambda a, dt: torch.as_tensor(np.array(a, dtype=np.float64),
                                        dtype=dt, device=device)
    return WindGrid(origin=vec(origin, dtype), spacing=vec(spacing, dtype),
                    u=field(u), v=field(v), w=field(w),
                    live=vec([0.0, 1.0, 0.0], torch.float32))


class TelemetryLogger:
    """Buffered binary logger: records of (uint32 tag, uint32 count,
    count float64 values)."""

    def __init__(self, path: str):
        self._lib = load_library()
        self._handle = None
        self._pyfile = None
        if self._lib is not None:
            self._handle = self._lib.tol_logger_open(path.encode())
        if self._handle is None:
            self._pyfile = open(path, "wb")

    def append(self, tag: int, values) -> None:
        arr = np.ascontiguousarray(values, dtype=np.float64).ravel()
        if self._handle is not None:
            self._lib.tol_logger_append(self._handle, tag,
                                        arr.ctypes.data_as(_F64P), arr.size)
        else:
            self._pyfile.write(np.array([tag, arr.size],
                                        dtype=np.uint32).tobytes())
            self._pyfile.write(arr.tobytes())

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tol_logger_close(self._handle)
            self._handle = None
        if self._pyfile is not None:
            self._pyfile.close()
            self._pyfile = None


def read_telemetry(path: str):
    """Parse a telemetry log into [(tag, np.ndarray), ...]."""
    out = []
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    while off + 8 <= len(raw):
        tag, count = np.frombuffer(raw[off:off + 8], dtype=np.uint32)
        off += 8
        vals = np.frombuffer(raw[off:off + 8 * int(count)], dtype=np.float64)
        off += 8 * int(count)
        out.append((int(tag), vals))
    return out
