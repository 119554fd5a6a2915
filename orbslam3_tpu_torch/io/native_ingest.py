"""ctypes wrapper for the native C++ ingest runtime: threaded PNG decode ->
bilinear remap (undistort / rectify) -> resize -> CLAHE, in frame order.

The port of `orbslam3_tpu/io/native_ingest.py`.  The source is the port's
own copy, `csrc/ingest.cpp`; it is compiled at first use with the flags of
`orbslam3_tpu/native/build.sh` into `orbslam3_tpu_torch/build/`, under a
name keyed by the source, the flags and the machine (`-march=native` code
runs only where it was built).  Building needs g++ and the libpng headers.

Where the library cannot be built, `available()` is False and
`build_error()` says why; callers that take the host path instead
(`io/euroc.py`'s `load_image` + `apply_undistort`, which has no CLAHE) say
which decoder ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lpng", "-lz", "-lpthread"]

_LIB = None
_ERROR: str | None = None


def build() -> Path:
    """Compile `csrc/ingest.cpp` unless a library built from the same
    source, flags and machine exists.  Raises RuntimeError with the
    compiler's message when it fails."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
                         + " ".join(os.uname()).encode())
    lib = BUILD_DIR / f"ingest_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ did not run: {e}") from e
    if proc.returncode != 0:
        # the compiler's first error line, with the source named as in the repo
        lines = proc.stderr.replace(str(SOURCE), "csrc/ingest.cpp").splitlines() or [""]
        first = next((ln for ln in lines if "error" in ln), lines[-1])
        raise RuntimeError(f"g++ failed ({proc.returncode}): {first.strip()}")
    os.replace(tmp, lib)
    return lib


def _lib():
    global _LIB, _ERROR
    if _LIB is None:
        if _ERROR is not None:
            raise RuntimeError(_ERROR)
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _ERROR = f"native ingest library unavailable: {e}"
            raise RuntimeError(_ERROR) from e
        lib.ingest_create.restype = ctypes.c_void_p
        lib.ingest_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ingest_create2.restype = ctypes.c_void_p
        lib.ingest_create2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ingest_next.restype = ctypes.c_int
        lib.ingest_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.ingest_destroy.argtypes = [ctypes.c_void_p]
        lib.ingest_failed_count.restype = ctypes.c_int
        lib.ingest_failed_count.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except RuntimeError:
        return False


def build_error() -> str | None:
    """Why the library is unavailable (None if it loaded or was not tried)."""
    return _ERROR


class NativeIngest:
    """Ordered, prefetching frame stream."""

    def __init__(self, paths: list[str], out_hw: tuple[int, int],
                 remap: np.ndarray | None = None,
                 src_hw: tuple[int, int] | None = None,
                 resize_hw: tuple[int, int] | None = None,
                 clahe_clip: float = 0.0, clahe_grid: int = 8,
                 n_threads: int = 4, queue_cap: int = 8):
        """Pipeline per frame: PNG decode -> bilinear `remap` (undistort /
        rectify, shape (rh, rw, 2) source coords) -> resize to `resize_hw`
        -> CLAHE (if clahe_clip > 0).  `out_hw` is the remap output size;
        the emitted frame size is resize_hw or out_hw.  Mirrors the
        reference grabber (image_grabber.hpp:96-110)."""
        self._h = None
        lib = _lib()
        self._lib = lib
        rh, rw = out_hw
        self.h, self.w = resize_hw if resize_hw is not None else out_hw
        sh, sw = src_hw if src_hw is not None else out_hw
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if remap is not None:
            remap_f = np.ascontiguousarray(remap, np.float32)
            assert remap_f.shape == (rh, rw, 2)
            rptr = remap_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            self._remap_keepalive = remap_f
        else:
            rptr = None
        self._h = lib.ingest_create2(
            arr, len(paths), rptr, rh, rw, self.h, self.w, sh, sw,
            float(clahe_clip), int(clahe_grid), n_threads, queue_cap)
        self.n = len(paths)
        self._emitted = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._emitted >= self.n:
            raise StopIteration
        out = np.empty((self.h, self.w), np.float32)
        idx = ctypes.c_int(-1)
        ok = self._lib.ingest_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(idx))
        if not ok:
            raise StopIteration
        self._emitted += 1
        return out

    @property
    def failed(self) -> int:
        return self._lib.ingest_failed_count(self._h)

    def close(self):
        if self._h:
            self._lib.ingest_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
