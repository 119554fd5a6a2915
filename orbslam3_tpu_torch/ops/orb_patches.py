"""The ORB patch kernels: IC-angle moments (K1), fused binned rBRIEF (K2),
and `orb_describe`, which does K1, the angle and K2 in one launch.

Counterpart of `orbslam3_tpu/ops/pallas_patches.py`, whose two Pallas TPU
kernels (`_win_kernel`, :58-74 and :76-88) become CUDA kernels for Hopper
in `csrc/orb_patches.cu` (see the note at its top for what bounds them and
how they are laid out).  The extractor calls `ic_angle_and_descriptors`,
which takes the one-launch kernel; `ic_moments` and `brief_descriptors`
stay as the two kernels on their own.

Each kernel has three parts here:

  * a plain PyTorch twin (`orient.ic_moments`, `brief.compute_descriptors`,
    and `describe_plain`, their composition through
    `orient.angle_from_moments`) that defines what is correct;
  * a wrapper (`ic_moments`, `brief_descriptors`, `orb_describe`) that
    dispatches on the tensor's device: a CPU tensor goes to the twin, a
    CUDA tensor to the kernel, anything else raises.  There is no fallback:
    a kernel that does not build or does not launch raises;
  * a launch counter (`ic_moments_launches`, `brief_desc_launches`,
    `orb_describe_launches`), raised by one exactly where the wrapper
    launches the kernel.

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

ic_moments_launches = 0
brief_desc_launches = 0
orb_describe_launches = 0

_lib = None


def reset_counters() -> None:
    global ic_moments_launches, brief_desc_launches, orb_describe_launches
    ic_moments_launches = 0
    brief_desc_launches = 0
    orb_describe_launches = 0


def launch_counts() -> dict:
    return {"ic_moments": ic_moments_launches, "brief_desc": brief_desc_launches,
            "orb_describe": orb_describe_launches}


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
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.orb_ic_moments.argtypes = [i32, ptr, i32, i32, ptr, i32, ptr, ptr, ptr]
        lib.orb_ic_moments.restype = i32
        lib.orb_brief_desc.argtypes = [i32, ptr, i32, i32, ptr, ptr, i32, ptr,
                                       ctypes.c_float, i32, ptr, ptr]
        lib.orb_brief_desc.restype = i32
        lib.orb_describe.argtypes = [i32, ptr, ptr, i32, i32, ptr, i32, ptr, ptr,
                                     ctypes.c_float, i32, ptr, ptr, ptr, ptr]
        lib.orb_describe.restype = i32
        lib.orb_error_string.argtypes = [i32]
        lib.orb_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _umax_on(device: str) -> torch.Tensor:
    return torch.from_numpy(orient._umax_table().astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _pairs_on(device: str) -> torch.Tensor:
    """(n_bins, 512, 2) offsets as int8 (every offset lies in [-19, 19]):
    32 KB, read through the read-only cache as one char4 per pair."""
    off = brief._binned_offsets()
    assert np.abs(off).max() <= brief._PATCH_R
    return torch.from_numpy(off.astype(np.int8)).to(device)


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


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.orb_error_string(rc).decode()}")


def ic_moments(atlas: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """K1: (N, 2) [m10, m01] of the 31x31 raw windows at floor(xy) - 15."""
    global ic_moments_launches
    if atlas.device.type == "cpu":
        return orient.ic_moments(atlas, xy)
    _check(atlas, xy, S_MOM)
    lib = _load()
    n = xy.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=atlas.device)
    rc = lib.orb_ic_moments(
        atlas.device.index, atlas.data_ptr(), atlas.shape[0], atlas.shape[1],
        xy.data_ptr(), n, _umax_on(str(atlas.device)).data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(atlas.device).cuda_stream)
    _raise_on(lib, rc, "ic_moments")
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
    lib = _load()
    out = torch.empty((n, 8), dtype=torch.int32, device=atlas_blur.device)
    rc = lib.orb_brief_desc(
        atlas_blur.device.index, atlas_blur.data_ptr(), atlas_blur.shape[0],
        atlas_blur.shape[1], xy.data_ptr(), angle_deg.data_ptr(), n,
        _pairs_on(str(atlas_blur.device)).data_ptr(),
        float(np.float32(brief.N_ANGLE_BINS / 360.0)), brief.N_ANGLE_BINS,
        out.data_ptr(), torch.cuda.current_stream(atlas_blur.device).cuda_stream)
    _raise_on(lib, rc, "brief_desc")
    brief_desc_launches += 1
    return out


def describe_plain(atlas: torch.Tensor, atlas_blur: torch.Tensor,
                   xy: torch.Tensor):
    """The plain version of `orb_describe`: the moments' twin, atan2 ->
    wrap -> degrees in plain torch (as pallas_patches.py:186-188 does in
    jnp), then the descriptors' twin."""
    angle = orient.angle_from_moments(orient.ic_moments(atlas, xy))
    return angle, brief.compute_descriptors(atlas_blur, xy, angle)


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
    _check(atlas, xy, S_BRF)
    if (atlas_blur.shape != atlas.shape or atlas_blur.dtype != torch.float32
            or not atlas_blur.is_contiguous() or atlas_blur.device != atlas.device):
        raise ValueError("the blurred atlas must be a contiguous float32 tensor of "
                         f"shape {tuple(atlas.shape)} on {atlas.device}")
    lib = _load()
    n = xy.shape[0]
    dev = atlas.device
    angle = torch.empty((n,), dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    mom = torch.empty((n, 2), dtype=torch.float32, device=dev) if with_moments else None
    rc = lib.orb_describe(
        dev.index, atlas.data_ptr(), atlas_blur.data_ptr(), atlas.shape[0],
        atlas.shape[1], xy.data_ptr(), n, _umax_on(str(dev)).data_ptr(),
        _pairs_on(str(dev)).data_ptr(),
        float(np.float32(brief.N_ANGLE_BINS / 360.0)), brief.N_ANGLE_BINS,
        angle.data_ptr(), desc.data_ptr(), None if mom is None else mom.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "orb_describe")
    orb_describe_launches += 1
    return (angle, desc, mom) if with_moments else (angle, desc)


def ic_angle_and_descriptors(atlas: torch.Tensor, atlas_blur: torch.Tensor,
                             xy: torch.Tensor):
    """Angles (N,) in degrees and descriptors (N, 8) int32 for keypoints
    at atlas coordinates xy: one launch of `orb_describe` on CUDA tensors,
    the plain versions on CPU tensors."""
    return orb_describe(atlas, atlas_blur, xy)
