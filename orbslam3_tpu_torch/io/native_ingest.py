"""ctypes wrapper for the native C++ ingest runtime: threaded PNG decode ->
bilinear remap (undistort / rectify) -> resize -> CLAHE, in frame order.

The port of `orbslam3_tpu/io/native_ingest.py`.  The source is the port's
own copy, `csrc/ingest.cpp`; it is compiled at first use with the flags of
`orbslam3_tpu/native/build.sh` into `orbslam3_tpu_torch/build/`, under a
name keyed by the source, the flags and the machine (`-march=native` code
runs only where it was built).  Building needs g++.

Two decoders feed the pool, and `decoder()` says which:

- ``"libpng"`` where g++ finds `png.h`: the library is built with
  `-DINGEST_WITH_LIBPNG` and linked with libpng, and its workers decode the
  files (the JAX package's library, bit for bit);
- ``"pil"`` elsewhere, and where the libpng build fails (headers without a
  library that links): the library is built without libpng; a small pool of
  Python threads decodes each file with PIL (which releases the GIL in its
  decoder) and pushes its raw pixels, and the C++ workers convert them to
  gray exactly as the libpng build does, then run the same stages.

Where no library builds (no g++), `available()` is False and
`build_error()` says why; callers that take the host path instead
(`io/euroc.py`'s `load_image` + `apply_undistort`) say which decoder ran.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
# (defines, libraries) of each build
BUILDS = {"libpng": (["-DINGEST_WITH_LIBPNG"], ["-lpng", "-lz", "-lpthread"]),
          "pil": ([], ["-lpthread"])}
# PIL's mode of a decoded PNG -> (samples per pixel, bits per sample) as the
# pool takes it.  PIL hands a palette expanded to RGB, and 16-bit color and
# 16-bit gray+alpha as 8-bit samples; it reads a file's 1-bit gray as mode
# "1", which is not taken (a failed frame), and its 2- and 4-bit gray as "L"
# scaled to 8 bits, where the libpng build reads packed bytes.
PIL_LAYOUTS = {"L": (1, 8), "LA": (2, 8), "I;16": (1, 16), "RGB": (3, 8), "RGBA": (4, 8)}
SRGB_GAMMA = 45455          # libpng's PNG_GAMMA_sRGB_INVERSE
# what PIL raises for a file it cannot open or decode
UNREADABLE = (OSError, SyntaxError, ValueError, EOFError)

_LIB = None
_ERROR: str | None = None
_PASSED_OVER: str | None = None     # why the libpng build was not taken
_LOCK = threading.Lock()


def has_png_h() -> bool:
    """Whether g++ finds the libpng headers."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                              input="#include <png.h>\n", capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def build(decoder: str | None = None) -> Path:
    """Compile `csrc/ingest.cpp` for `decoder` ("libpng", "pil"; None: libpng
    where `png.h` is found, else pil) unless a library built from the same
    source, flags and machine exists.  Raises RuntimeError with the
    compiler's message when it fails."""
    decoder = decoder or ("libpng" if has_png_h() else "pil")
    defines, libs = BUILDS[decoder]
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + defines + libs).encode()
                         + " ".join(os.uname()).encode())
    lib = BUILD_DIR / f"ingest_{decoder}_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, *defines, str(SOURCE), *libs, "-o", str(tmp)],
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


def load(decoder: str) -> ctypes.CDLL:
    """The library for `decoder` ("libpng" or "pil"), built if needed."""
    return _bind(ctypes.CDLL(str(build(decoder))))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with its functions' types declared."""
    common = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
              ctypes.c_int, ctypes.c_int]
    lib.ingest_has_libpng.restype = ctypes.c_int
    lib.ingest_has_libpng.argtypes = []
    if lib.ingest_has_libpng():
        lib.ingest_create.restype = ctypes.c_void_p
        lib.ingest_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ingest_create2.restype = ctypes.c_void_p
        lib.ingest_create2.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, *common]
    lib.ingest_create_pushed.restype = ctypes.c_void_p
    lib.ingest_create_pushed.argtypes = [ctypes.c_int, *common]
    lib.ingest_push.restype = ctypes.c_int
    lib.ingest_push.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ingest_next.restype = ctypes.c_int
    lib.ingest_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int)]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_failed_count.restype = ctypes.c_int
    lib.ingest_failed_count.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    """The library `build()` picks; where that is the libpng build and it
    fails (headers without a library that links), the build without
    libpng, with the libpng build's failure kept in `build_error()`."""
    global _LIB, _ERROR, _PASSED_OVER
    with _LOCK:
        if _LIB is None:
            if _ERROR is not None:
                raise RuntimeError(_ERROR)
            failures = []
            for decoder in (["libpng", "pil"] if has_png_h() else ["pil"]):
                try:
                    _LIB = load(decoder)
                    break
                except (RuntimeError, OSError) as e:
                    failures.append(f"the {decoder} build: {e}")
            if _LIB is None:
                _ERROR = "native ingest library unavailable: " + "; ".join(failures)
                raise RuntimeError(_ERROR)
            _PASSED_OVER = failures[0] if failures else None
        return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except RuntimeError:
        return False


def build_error() -> str | None:
    """Why the library is unavailable, or, where the build without libpng
    was taken because the libpng build failed, why that failed (None if
    the library `build()` picks loaded, or none was tried)."""
    return _ERROR or _PASSED_OVER


def decoder() -> str | None:
    """Which decoder feeds the pool: "libpng" or "pil" (None where no
    library builds)."""
    if not available():
        return None
    return "libpng" if _lib().ingest_has_libpng() else "pil"


def read_png(path: str) -> tuple[np.ndarray, int, int, int]:
    """A PNG decoded by PIL as the pushed pool takes it: (pixels (H, W) or
    (H, W, C), samples per pixel, bits per sample, the file's gamma in
    libpng's fixed point, 0 where it has none).  The gamma is read only for
    color, where libpng's conversion to gray uses it: sRGB's where the file
    has an sRGB chunk (libpng lets it override gAMA), else gAMA's where
    libpng takes it (16 to 625,000,000).  A cHRM or iCCP chunk, which can
    move libpng's coefficients, is not read.  Raises one of `UNREADABLE`
    for a file PIL cannot decode or a layout the pool does not take."""
    from PIL import Image
    with Image.open(path) as im:
        im.load()
        info = im.info
        if im.mode == "P":
            im = im.convert("RGB")
        if im.mode not in PIL_LAYOUTS:
            raise ValueError(f"{path}: PIL mode {im.mode} is not taken")
        channels, depth = PIL_LAYOUTS[im.mode]
        pixels = np.ascontiguousarray(np.asarray(im), np.uint16 if depth == 16 else np.uint8)
    gamma = 0
    if channels >= 3:
        if "srgb" in info:
            gamma = SRGB_GAMMA
        elif "gamma" in info:
            g = round(info["gamma"] * 100000)
            gamma = g if 16 <= g <= 625_000_000 else 0
    return pixels, channels, depth, gamma


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
        reference grabber (image_grabber.hpp:96-110).  `decoder` says
        whether libpng or PIL decodes the files."""
        self._h = None
        self._pool = None
        lib = _lib()
        self._lib = lib
        self.decoder = "libpng" if lib.ingest_has_libpng() else "pil"
        rh, rw = out_hw
        self.h, self.w = resize_hw if resize_hw is not None else out_hw
        sh, sw = src_hw if src_hw is not None else out_hw
        if remap is not None:
            remap_f = np.ascontiguousarray(remap, np.float32)
            assert remap_f.shape == (rh, rw, 2)
            rptr = remap_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            self._remap_keepalive = remap_f
        else:
            rptr = None
        stages = (rptr, rh, rw, self.h, self.w, sh, sw, float(clahe_clip), int(clahe_grid),
                  n_threads, queue_cap)
        self.n = len(paths)
        self._emitted = 0
        if self.decoder == "libpng":
            arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._h = lib.ingest_create2(arr, len(paths), *stages)
            return
        self._h = lib.ingest_create_pushed(len(paths), *stages)
        # frames in flight stay within the pool's ordered queue (the C++
        # takes queue_cap < 2 as 2), so no worker waits for room in it
        self._paths = list(paths)
        self._window = max(queue_cap, 2)
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(2, n_threads)), thread_name_prefix="ingest-pil")
        for i in range(min(self.n, self._window)):
            self._futures[i] = self._pool.submit(self._decode, i)

    def _decode(self, i: int) -> None:
        """Decodes frame i with PIL and pushes it; a file PIL cannot read is
        pushed as a failed frame, and so is any other error, which is then
        raised to the consumer."""
        pushed = False
        try:
            try:
                pixels, channels, depth, gamma = read_png(self._paths[i])
            except UNREADABLE:
                return
            ok = self._lib.ingest_push(self._h, i, pixels.ctypes.data, pixels.shape[0],
                                       pixels.shape[1], channels, depth, gamma)
            pushed = True
            if not ok:
                raise RuntimeError(f"native ingest: frame {i} was not taken")
        finally:
            if not pushed:
                self._lib.ingest_push(self._h, i, None, 0, 0, 0, 0, 0)

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
        if self._pool is not None:
            self._futures.pop(idx.value).result()
            nxt = self._emitted + self._window
            if nxt < self.n:
                self._futures[nxt] = self._pool.submit(self._decode, nxt)
        self._emitted += 1
        return out

    @property
    def failed(self) -> int:
        return self._lib.ingest_failed_count(self._h)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._h:
            self._lib.ingest_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
