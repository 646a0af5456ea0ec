"""ctypes bindings to the native host runtime (native/nenhost.cpp): the
port's own copy of nenbody_tpu/utils/native.py, which it cannot import
(importing any module of the JAX package runs its __init__, which imports
jax).

The C++ side owns a background worker draining a job ring: PNG frame
encoding, trajectory recording and step-time stats run off the Python
thread. The port builds its own library from the repo's native/nenhost.cpp
with the flags of native/Makefile (g++, zlib) into
build/nenbody_tpu_torch/libnenhost_<hash of source and flags>.so, a
directory .gitignore lists; it never writes native/libnenhost.so. The
.nentraj format is the JAX package's, so a recording of either package
reads in the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "nenhost.cpp"
_BUILD_DIR = _ROOT / "build" / "nenbody_tpu_torch"
# native/Makefile's CXXFLAGS, LDFLAGS and LIBS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
LIBS = ("-lz",)

_lib = None
_host = None
_lock = threading.Lock()


def lib_path() -> Optional[Path]:
    """Where the library of this source and these flags is built; None when
    the checkout has no native/nenhost.cpp."""
    if not _SOURCE.exists():
        return None
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + _SOURCE.read_bytes())
    return _BUILD_DIR / f"libnenhost_{digest.hexdigest()[:16]}.so"


def build(quiet: bool = True) -> bool:
    """Compile the library with g++ (atomically, through a temporary name);
    returns success."""
    out = lib_path()
    if out is None:
        return False
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SOURCE), *LIBS, "-o", str(tmp)],
            check=True, capture_output=quiet,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if path is None or not path.exists():
            return None
        lib = ctypes.CDLL(str(path))
        lib.nen_host_create.restype = ctypes.c_void_p
        lib.nen_host_create.argtypes = [ctypes.c_longlong]
        lib.nen_host_destroy.argtypes = [ctypes.c_void_p]
        lib.nen_host_flush.argtypes = [ctypes.c_void_p]
        lib.nen_host_jobs_done.restype = ctypes.c_longlong
        lib.nen_host_jobs_done.argtypes = [ctypes.c_void_p]
        lib.nen_host_errors.restype = ctypes.c_longlong
        lib.nen_host_errors.argtypes = [ctypes.c_void_p]
        lib.nen_write_image_async.restype = ctypes.c_int
        lib.nen_write_image_async.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nen_encode_png.restype = ctypes.c_longlong
        lib.nen_encode_png.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.nen_recorder_create.restype = ctypes.c_void_p
        lib.nen_recorder_create.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.nen_recorder_append.restype = ctypes.c_int
        lib.nen_recorder_append.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.nen_recorder_frames.restype = ctypes.c_longlong
        lib.nen_recorder_frames.argtypes = [ctypes.c_void_p]
        lib.nen_recorder_close.argtypes = [ctypes.c_void_p]
        lib.nen_stats_record_ms.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.nen_stats_ema_ms.restype = ctypes.c_double
        lib.nen_stats_ema_ms.argtypes = [ctypes.c_void_p]
        lib.nen_stats_samples.restype = ctypes.c_longlong
        lib.nen_stats_samples.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _get_host():
    global _host
    lib = _load()
    if lib is None:
        return None, None
    with _lock:
        if _host is None:
            _host = lib.nen_host_create(256)
    return lib, _host


def available() -> bool:
    return _load() is not None


def write_image_async(path: str, img: np.ndarray) -> bool:
    """Queue a uint8 [H, W, C] (or [H, W]) image for PNG encoding+write."""
    lib, host = _get_host()
    if lib is None:
        raise RuntimeError("libnenhost not built (run utils.native.build())")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    ok = lib.nen_write_image_async(
        host, path.encode(), w, h, c, img.ctypes.data_as(ctypes.c_void_p)
    )
    return bool(ok)


def encode_png(img: np.ndarray) -> bytes:
    """Synchronous in-memory PNG encode (for tests / streaming)."""
    lib, _ = _get_host()
    if lib is None:
        raise RuntimeError("libnenhost not built")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    cap = w * h * c + (1 << 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.nen_encode_png(
        w, h, c, img.ctypes.data_as(ctypes.c_void_p), buf, cap
    )
    if n < 0:
        raise RuntimeError("PNG encode failed")
    return buf.raw[:n]


def flush() -> None:
    lib, host = _get_host()
    if lib is not None:
        lib.nen_host_flush(host)


def stats_record_ms(ms: float) -> None:
    lib, host = _get_host()
    if lib is not None:
        lib.nen_stats_record_ms(host, float(ms))


def stats_ema_ms() -> float:
    lib, host = _get_host()
    return float(lib.nen_stats_ema_ms(host)) if lib is not None else 0.0


class TrajectoryRecorder:
    """Async binary trajectory log (.nentraj): header (magic 'NENTRJ01',
    uint32 n, uint32 dim) then frames of (int64 t, pos[n*dim] f32,
    vel[n*dim] f32). The caller's thread only memcpy's; encoding and IO
    happen on the native worker."""

    def __init__(self, path: str, n: int, dim: int = 2):
        lib, host = _get_host()
        if lib is None:
            raise RuntimeError("libnenhost not built")
        self._lib = lib
        self.n, self.dim = n, dim
        self._rec = lib.nen_recorder_create(host, path.encode(), n, dim)
        if not self._rec:
            raise OSError(f"cannot open {path}")

    def append(self, t: int, pos: np.ndarray, vel: np.ndarray) -> bool:
        if self._rec is None:
            raise ValueError("recorder closed")
        pos = np.ascontiguousarray(pos, dtype=np.float32)
        vel = np.ascontiguousarray(vel, dtype=np.float32)
        assert pos.shape == (self.n, self.dim) and vel.shape == (self.n, self.dim)
        return bool(
            self._lib.nen_recorder_append(
                self._rec,
                int(t),
                pos.ctypes.data_as(ctypes.c_void_p),
                vel.ctypes.data_as(ctypes.c_void_p),
            )
        )

    @property
    def frames(self) -> int:
        if self._rec is None:
            raise ValueError("recorder closed")
        return int(self._lib.nen_recorder_frames(self._rec))

    def close(self) -> None:
        if self._rec:
            self._lib.nen_recorder_close(self._rec)
            self._rec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_trajectory(path: str):
    """Read a .nentraj file -> (ts [T], pos [T, n, dim], vel [T, n, dim])."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != b"NENTRJ01":
            raise ValueError(f"not a .nentraj file: {magic!r}")
        n, dim = np.frombuffer(f.read(8), np.uint32)
        frame_bytes = 8 + 2 * 4 * int(n) * int(dim)
        body = f.read()
    t_frames = len(body) // frame_bytes
    ts = np.empty(t_frames, np.int64)
    pos = np.empty((t_frames, n, dim), np.float32)
    vel = np.empty((t_frames, n, dim), np.float32)
    for i in range(t_frames):
        off = i * frame_bytes
        ts[i] = np.frombuffer(body, np.int64, 1, off)[0]
        pos[i] = np.frombuffer(body, np.float32, n * dim, off + 8).reshape(n, dim)
        vel[i] = np.frombuffer(
            body, np.float32, n * dim, off + 8 + 4 * n * dim
        ).reshape(n, dim)
    return ts, pos, vel
