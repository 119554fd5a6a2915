"""The ORB patch kernels: IC-angle moments (K1), fused binned rBRIEF (K2),
and `orb_describe`, which does K1, the angle and K2 in one launch.

Counterpart of `orbslam3_tpu/ops/pallas_patches.py`, whose two Pallas TPU
kernels (`_win_kernel`, :58-74 and :76-88) become CUDA kernels for Hopper
in `csrc/orb_patches.cu` (see the note at its top for what bounds them and
how they are laid out).  The extractor calls `ic_angle_and_descriptors`,
which takes the one-launch kernel; `ic_moments` and `brief_descriptors`
stay as the two kernels on their own, and `orb_describe_warp` as the
one-launch kernel's design before its Hopper redesign (one warp per
keypoint, every pixel read from the atlas), to be timed beside it.

Each kernel has three parts here:

  * a plain PyTorch twin (`orient.ic_moments`, `brief.compute_descriptors`,
    and `describe_plain`, their composition through
    `orient.angle_from_moments`) that defines what is correct;
  * a wrapper (`ic_moments`, `brief_descriptors`, `orb_describe`,
    `orb_describe_warp`) that dispatches on the tensor's device: a CPU
    tensor goes to the twin, a CUDA tensor to the kernel, anything else
    raises.  There is no fallback: a kernel that does not build or does not
    launch raises;
  * a launch counter (`ic_moments_launches`, `brief_desc_launches`,
    `orb_describe_launches`, `orb_describe_warp_launches`), raised by one
    exactly where the wrapper launches the kernel.

`orb_describe` runs on a persistent grid whose shape `launch_geometry`
computes from the keypoint count and the card's SM count; the C entry
refuses a geometry that disagrees with the kernel's shared-memory layout.
`empty_kernel` launches a kernel that does nothing: the floor that the
others' device times are read against.

The kernels are built on first use with nvcc (C interface, bound with
ctypes) into `orbslam3_tpu_torch/build/`, keyed by a hash of the source and
the flags, so a fresh checkout builds them from its own sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import brief, orient

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "orb_patches.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

S_MOM = 2 * orient.HALF_PATCH_SIZE + 1    # 31
S_BRF = 2 * brief._PATCH_R + 1            # 39

# orb_describe's shared-memory layout (csrc/orb_patches.cu: kTableBytes,
# kSlotBytes, kMaxWarps): the bin table (one char4 per pair) and umax once
# per block, then per warp the raw window's 31 rows at a stride of 36 floats
# and the blurred window's 39 rows at 44 (each row staged from the 16-byte
# aligned column at or left of the window)
TABLE_BYTES = brief.N_ANGLE_BINS * 256 * 4 + (orient.HALF_PATCH_SIZE + 1) * 4
SLOT_BYTES = (S_MOM * 36 + S_BRF * 44) * 4
WARPS_MAX = 10
SMEM_LIMIT = 232_448      # a Hopper block's shared memory
BRIEF_REACH = 18          # |dx|, |dy| of every rotated pattern point (kBriefReach)

ic_moments_launches = 0
brief_desc_launches = 0
orb_describe_launches = 0
orb_describe_warp_launches = 0

_lib = None
_F32 = torch.float32


def reset_counters() -> None:
    global ic_moments_launches, brief_desc_launches, orb_describe_launches
    global orb_describe_warp_launches
    ic_moments_launches = 0
    brief_desc_launches = 0
    orb_describe_launches = 0
    orb_describe_warp_launches = 0


def launch_counts() -> dict:
    return {"ic_moments": ic_moments_launches, "brief_desc": brief_desc_launches,
            "orb_describe_warp": orb_describe_warp_launches,
            "orb_describe": orb_describe_launches}


def path_counts(n_extract: int) -> dict:
    """The launch counts of a path that ran `extract` n_extract times: one
    `orb_describe` each, and no other kernel of this module."""
    return {"ic_moments": 0, "brief_desc": 0, "orb_describe_warp": 0,
            "orb_describe": n_extract}


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, n_sm: int) -> tuple[int, int, int]:
    """(blocks, warps per block, dynamic shared-memory bytes) of
    `orb_describe` for n keypoints on a card with n_sm SMs: K =
    min(WARPS_MAX, ceil(n / n_sm)) warps a block, min(n_sm, ceil(n / K))
    blocks, so up to WARPS_MAX x n_sm keypoints take one round."""
    if n < 1 or n_sm < 1:
        raise ValueError(f"need n >= 1 and n_sm >= 1, got {n}, {n_sm}")
    warps = min(WARPS_MAX, -(-n // n_sm))
    return min(n_sm, -(-n // warps)), warps, TABLE_BYTES + warps * SLOT_BYTES


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the ORB patch kernels cannot be built")
    return found


def build() -> tuple[Path, str]:
    """Compile `csrc/orb_patches.cu` unless a library built from the same
    source and flags exists.  Returns (library path, compiler log; empty
    when the library was already there)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"orb_patches_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.orb_ic_moments.argtypes = [i32, ptr, i32, i32, ptr, i32, ptr, ptr, ptr]
        lib.orb_brief_desc.argtypes = [i32, ptr, i32, i32, ptr, ptr, i32, ptr,
                                       f32, i32, ptr, ptr]
        lib.orb_describe_warp.argtypes = [i32, ptr, ptr, i32, i32, ptr, i32, ptr, ptr,
                                          f32, i32, ptr, ptr, ptr, ptr]
        lib.orb_describe.argtypes = [i32, ptr, ptr, i32, i32, ptr, i32, ptr, f32,
                                     i32, i32, i32, ptr, ptr, ptr, ptr]
        lib.orb_empty.argtypes = [i32, ptr]
        for fn in (lib.orb_ic_moments, lib.orb_brief_desc, lib.orb_describe_warp,
                   lib.orb_describe, lib.orb_empty):
            fn.restype = i32
        lib.orb_error_string.argtypes = [i32]
        lib.orb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _table_bytes() -> np.ndarray:
    """The bin table, (n_bins, 512, 2) offsets as int8 (every offset lies in
    [-18, 18]: one char4 per pair), followed by the umax table as int32:
    TABLE_BYTES bytes, the layout `orb_describe` copies into shared memory."""
    off = brief._binned_offsets()
    assert np.abs(off).max() <= BRIEF_REACH
    out = np.concatenate([off.astype(np.int8).reshape(-1).view(np.uint8),
                          orient._umax_table().astype(np.int32).view(np.uint8)])
    assert out.size == TABLE_BYTES
    return out


class _Device(NamedTuple):
    """What every launch on one card needs, built once: the library, the
    tables on the card (kept alive here) and their addresses, the bin scale
    as a ready ctypes float, the SM count and the current-stream reader."""
    lib: ctypes.CDLL
    index: int
    table: torch.Tensor
    pairs_ptr: int
    umax_ptr: int
    bin_scale: ctypes.c_float
    n_sm: int
    stream: object


_devices: dict = {}


def _device(index: int) -> _Device:
    d = _devices.get(index)
    if d is None:
        lib = _load()
        table = torch.from_numpy(_table_bytes()).to(torch.device("cuda", index))
        d = _devices[index] = _Device(
            lib, index, table, table.data_ptr(),
            table.data_ptr() + brief.N_ANGLE_BINS * 256 * 4,
            ctypes.c_float(np.float32(brief.N_ANGLE_BINS / 360.0)),
            torch.cuda.get_device_properties(index).multi_processor_count,
            # the current stream's handle as an int: PyTorch's own raw reader
            # (torch.cuda.current_stream builds a Stream object per call)
            torch._C._cuda_getCurrentRawStream)
    return d


def _check(img: torch.Tensor, xy: torch.Tensor, s: int) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"ORB patch kernels run on CUDA tensors, got {img.device}")
    for name, t in (("image", img), ("xy", xy)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != img.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {img.device}")
    if img.dim() != 2 or img.shape[0] < s or img.shape[1] < s:
        raise ValueError(f"image must be 2-D and at least {s}x{s}, got {tuple(img.shape)}")
    if xy.dim() != 2 or xy.shape[1] != 2 or xy.shape[0] == 0:
        raise ValueError(f"xy must be (N>0, 2), got {tuple(xy.shape)}")


def _check_pair(atlas: torch.Tensor, atlas_blur: torch.Tensor, xy: torch.Tensor) -> None:
    """The checks of `_check` for both atlases and xy, in the fewest tensor
    calls (`orb_describe` runs once per frame on every path)."""
    dev = atlas.get_device()
    if (dev < 0 or atlas.dtype is not _F32 or atlas_blur.dtype is not _F32
            or xy.dtype is not _F32 or atlas_blur.get_device() != dev
            or xy.get_device() != dev or not atlas.is_contiguous()
            or not atlas_blur.is_contiguous() or not xy.is_contiguous()):
        raise ValueError("the atlases and xy must be contiguous float32 tensors on one "
                         f"CUDA device, got {atlas.device} / {atlas_blur.device} / "
                         f"{xy.device}, {atlas.dtype} / {atlas_blur.dtype} / {xy.dtype}")
    shape = atlas.shape
    if len(shape) != 2 or shape[0] < S_BRF or shape[1] < S_BRF or atlas_blur.shape != shape:
        raise ValueError(f"the atlases must be 2-D, equal and at least {S_BRF}x{S_BRF}, "
                         f"got {tuple(shape)} and {tuple(atlas_blur.shape)}")
    if len(xy.shape) != 2 or xy.shape[1] != 2 or xy.shape[0] == 0:
        raise ValueError(f"xy must be (N>0, 2), got {tuple(xy.shape)}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.orb_error_string(rc).decode()}")


def ic_moments(atlas: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """K1: (N, 2) [m10, m01] of the 31x31 raw windows at floor(xy) - 15."""
    global ic_moments_launches
    if atlas.device.type == "cpu":
        return orient.ic_moments(atlas, xy)
    _check(atlas, xy, S_MOM)
    d = _device(atlas.device.index)
    n = xy.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=atlas.device)
    rc = d.lib.orb_ic_moments(
        d.index, atlas.data_ptr(), atlas.shape[0], atlas.shape[1],
        xy.data_ptr(), n, d.umax_ptr, out.data_ptr(), d.stream(d.index))
    _raise_on(d.lib, rc, "ic_moments")
    ic_moments_launches += 1
    return out


def brief_descriptors(atlas_blur: torch.Tensor, xy: torch.Tensor,
                      angle_deg: torch.Tensor) -> torch.Tensor:
    """K2: (N, 8) int32 binned-rBRIEF bit patterns from the blurred,
    integer-rounded atlas, windows at round(xy) - 19."""
    global brief_desc_launches
    if atlas_blur.device.type == "cpu":
        return brief.compute_descriptors(atlas_blur, xy, angle_deg)
    _check(atlas_blur, xy, S_BRF)
    n = xy.shape[0]
    if (angle_deg.dtype != torch.float32 or not angle_deg.is_contiguous()
            or angle_deg.shape != (n,) or angle_deg.device != atlas_blur.device):
        raise ValueError("angle must be a contiguous float32 (N,) tensor on "
                         f"{atlas_blur.device}")
    d = _device(atlas_blur.device.index)
    out = torch.empty((n, 8), dtype=torch.int32, device=atlas_blur.device)
    rc = d.lib.orb_brief_desc(
        d.index, atlas_blur.data_ptr(), atlas_blur.shape[0], atlas_blur.shape[1],
        xy.data_ptr(), angle_deg.data_ptr(), n, d.pairs_ptr, d.bin_scale,
        brief.N_ANGLE_BINS, out.data_ptr(), d.stream(d.index))
    _raise_on(d.lib, rc, "brief_desc")
    brief_desc_launches += 1
    return out


def describe_plain(atlas: torch.Tensor, atlas_blur: torch.Tensor,
                   xy: torch.Tensor):
    """The plain version of `orb_describe`: the moments' twin, atan2 ->
    wrap -> degrees in plain torch (as pallas_patches.py:186-188 does in
    jnp), then the descriptors' twin."""
    angle = orient.angle_from_moments(orient.ic_moments(atlas, xy))
    return angle, brief.compute_descriptors(atlas_blur, xy, angle)


def _outputs(n: int, device: torch.device, with_moments: bool):
    """The angles, the descriptors and, for tests, the moments.  Two
    allocations: on the card one `torch.empty` costs less host time than the
    slice and the view that one shared buffer would need for each output."""
    mom = torch.empty((n, 2), dtype=_F32, device=device) if with_moments else None
    return (torch.empty(n, dtype=_F32, device=device),
            torch.empty((n, 8), dtype=torch.int32, device=device), mom)


def orb_describe(atlas: torch.Tensor, atlas_blur: torch.Tensor, xy: torch.Tensor,
                 with_moments: bool = False):
    """K1, the angle and K2 in one launch: (angle (N,) f32 degrees in
    [0, 360), desc (N, 8) int32) for keypoints at atlas coordinates xy, the
    moments from `atlas`, the descriptors from `atlas_blur` (same shape).
    `with_moments` also returns the kernel's (N, 2) moments, for tests."""
    global orb_describe_launches
    if atlas.device.type == "cpu":
        if with_moments:
            raise ValueError("with_moments reads the CUDA kernel's moments")
        return describe_plain(atlas, atlas_blur, xy)
    _check_pair(atlas, atlas_blur, xy)
    d = _device(atlas.get_device())
    n = xy.shape[0]
    h, w = atlas.shape
    blocks, warps, smem = launch_geometry(n, d.n_sm)
    angle, desc, mom = _outputs(n, atlas.device, with_moments)
    rc = d.lib.orb_describe(
        d.index, atlas.data_ptr(), atlas_blur.data_ptr(), h, w, xy.data_ptr(), n,
        d.pairs_ptr, d.bin_scale, blocks, warps, smem, angle.data_ptr(), desc.data_ptr(),
        None if mom is None else mom.data_ptr(), d.stream(d.index))
    _raise_on(d.lib, rc, "orb_describe")
    orb_describe_launches += 1
    return (angle, desc, mom) if with_moments else (angle, desc)


def orb_describe_warp(atlas: torch.Tensor, atlas_blur: torch.Tensor, xy: torch.Tensor,
                      with_moments: bool = False):
    """`orb_describe` through its design before the Hopper redesign (one
    warp per keypoint, four a block, every pixel and table entry read from
    global memory).  No path runs it: it is timed and checked beside
    `orb_describe`."""
    global orb_describe_warp_launches
    if atlas.device.type == "cpu":
        if with_moments:
            raise ValueError("with_moments reads the CUDA kernel's moments")
        return describe_plain(atlas, atlas_blur, xy)
    _check_pair(atlas, atlas_blur, xy)
    d = _device(atlas.get_device())
    n = xy.shape[0]
    h, w = atlas.shape
    angle, desc, mom = _outputs(n, atlas.device, with_moments)
    rc = d.lib.orb_describe_warp(
        d.index, atlas.data_ptr(), atlas_blur.data_ptr(), h, w, xy.data_ptr(), n,
        d.umax_ptr, d.pairs_ptr, d.bin_scale, brief.N_ANGLE_BINS, angle.data_ptr(),
        desc.data_ptr(),
        None if mom is None else mom.data_ptr(), d.stream(d.index))
    _raise_on(d.lib, rc, "orb_describe_warp")
    orb_describe_warp_launches += 1
    return (angle, desc, mom) if with_moments else (angle, desc)


def empty_kernel(device: torch.device) -> None:
    """Launch a kernel that does nothing on `device`'s current stream: the
    floor of a launch's device duration (not counted: no path runs it)."""
    d = _device(torch.device(device).index or 0)
    _raise_on(d.lib, d.lib.orb_empty(d.index, d.stream(d.index)), "orb_empty")


def ic_angle_and_descriptors(atlas: torch.Tensor, atlas_blur: torch.Tensor,
                             xy: torch.Tensor):
    """Angles (N,) in degrees and descriptors (N, 8) int32 for keypoints
    at atlas coordinates xy: one launch of `orb_describe` on CUDA tensors,
    the plain versions on CPU tensors."""
    return orb_describe(atlas, atlas_blur, xy)
