"""EuRoC MAV (ASL layout) and TUM-VI dataset loaders, calibrations and the
host-side image remap.

The port's copy of `orbslam3_tpu/io/euroc.py` (importing the JAX package's
module would import JAX).  The reference ingests a ROS 2 bag (SURVEY L9);
for the benchmark sequences (EuRoC MH01-05, TUM-VI rooms) the standard ASL
directory layout is read directly:

    <root>/mav0/cam0/data.csv        timestamp [ns], filename
    <root>/mav0/cam0/data/*.png      grayscale images
    <root>/mav0/imu0/data.csv        timestamp, wx, wy, wz, ax, ay, az
    <root>/mav0/state_groundtruth_estimate0/data.csv  (EuRoC GT)

Timestamps are Python floats in seconds (`int(ns) * 1e-9`, float64): EuRoC
stamps are ~1.4e9 s, where a float32 ulp is 128 s.  Images load lazily
(PIL) as float32 (0..255) arrays.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

EUROC_CAM0 = dict(
    model="pinhole",
    params=(458.654, 457.296, 367.215, 248.375),
    distortion=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    resolution=(480, 752),  # (h, w)
    rate_hz=20,
    # T_BS (body <- sensor), mav0/cam0/sensor.yaml
    T_BS=np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0]], dtype=np.float64),
)
EUROC_CAM1 = dict(
    model="pinhole",
    params=(457.587, 456.134, 379.999, 255.238),
    distortion=(-0.28368365, 0.07451284, -0.00010473, -3.555907e-05),
    resolution=(480, 752),
    rate_hz=20,
    # T_BS (body <- sensor), mav0/cam1/sensor.yaml
    T_BS=np.array([
        [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
        [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
        [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
        [0.0, 0.0, 0.0, 1.0]], dtype=np.float64),
)
EUROC_IMU = dict(
    noise_gyro=1.6968e-04, noise_acc=2.0000e-3,
    walk_gyro=1.9393e-05, walk_acc=3.0000e-3, rate_hz=200,
    # T_BS for cam0 (body <- sensor / camera), EuRoC calibration
    Tbc=np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0]], dtype=np.float64),
)

# TUM-VI 512x512 fisheye rig.  Calibration values are the published
# dataset calibration as shipped in upstream ORB-SLAM3's TUM-VI configs
# (Examples/*/TUM-VI.yaml — Tbc block + Stereo T_c1_c2); re-verify against
# the sequence's own camchain when real data is mounted.
_TUMVI_T_B_C0 = np.array([
    [-0.99952504, 0.00750192, -0.02989013, 0.04557484],
    [0.02961534, -0.03439736, -0.99896935, -0.07116180],
    [-0.00852233, -0.99938008, 0.03415885, -0.04468125],
    [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)
# right(cam1) camera coords -> left(cam0) camera coords ("Tlr")
_TUMVI_T_C0_C1 = np.array([
    [0.99999575, 0.00231713, -0.00180912, 0.10106110],
    [-0.00231067, 0.99999099, 0.00356612, -0.00199883],
    [0.00181737, -0.00356193, 0.99999200, -0.00145671],
    [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)

TUMVI_CAM0 = dict(
    model="kb8",
    params=(190.97847715128717, 190.9733070521226,
            254.93170605935475, 256.8974428996504,
            0.0034823894022493434, 0.0007150348452162257,
            -0.0020532361418706202, 0.00020293673591811182),
    resolution=(512, 512),
    rate_hz=20,
    T_BS=_TUMVI_T_B_C0,
)
TUMVI_CAM1 = dict(
    model="kb8",
    params=(190.44236969414825, 190.4344384721956,
            252.59949716835982, 254.91723064636983,
            0.0034003170790442797, 0.001766278153469831,
            -0.00266312569781606, 0.0003299517423931039),
    resolution=(512, 512),
    rate_hz=20,
    T_BS=_TUMVI_T_B_C0 @ _TUMVI_T_C0_C1,
)
TUMVI_IMU = dict(
    # BMI160 continuous-time noise densities (TUM-VI dataset sheet)
    noise_gyro=8.0e-5, noise_acc=1.4e-3,
    walk_gyro=1.0e-6, walk_acc=8.6e-5, rate_hz=200,
    Tbc=_TUMVI_T_B_C0,
)


@dataclasses.dataclass
class ImageRecord:
    ts: float
    path: str


@dataclasses.dataclass
class ImuRecord:
    ts: float
    gyro: np.ndarray
    acc: np.ndarray


class EurocSequence:
    """Lazy loader for one ASL-layout sequence directory."""

    def __init__(self, root: str, cam: str = "cam0"):
        self.root = root
        mav = os.path.join(root, "mav0")
        if not os.path.isdir(mav):
            mav = root  # allow pointing directly at mav0
        self.cam_dir = os.path.join(mav, cam)
        self.imu_csv = os.path.join(mav, "imu0", "data.csv")
        self.gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.images = self._read_cam_csv()
        self.imu = self._read_imu_csv() if os.path.exists(self.imu_csv) else []

    def _read_cam_csv(self) -> list[ImageRecord]:
        path = os.path.join(self.cam_dir, "data.csv")
        out = []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts = int(row[0]) * 1e-9
                out.append(ImageRecord(ts, os.path.join(self.cam_dir, "data", row[1].strip())))
        return out

    def _read_imu_csv(self) -> list[ImuRecord]:
        out = []
        with open(self.imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                v = [float(x) for x in row]
                out.append(ImuRecord(v[0] * 1e-9, np.asarray(v[1:4], np.float32),
                                     np.asarray(v[4:7], np.float32)))
        return out

    def load_image(self, rec: ImageRecord) -> np.ndarray:
        from PIL import Image
        img = Image.open(rec.path)
        if img.mode != "L":
            img = img.convert("L")
        return np.asarray(img, dtype=np.float32)

    def read_groundtruth(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (N,), positions (N,3)) from the EuRoC GT csv."""
        ts, pos = [], []
        with open(self.gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                pos.append([float(row[1]), float(row[2]), float(row[3])])
        return np.asarray(ts), np.asarray(pos)

    def frames(self) -> Iterator[tuple[float, np.ndarray]]:
        for rec in self.images:
            yield rec.ts, self.load_image(rec)

    def imu_between(self, t0: float, t1: float) -> list[ImuRecord]:
        return [r for r in self.imu if t0 < r.ts <= t1]


def undistort_map(params: tuple, distortion: tuple, hw: tuple,
                  new_params: Optional[tuple] = None) -> np.ndarray:
    """Per-pixel source-coordinate map for the radtan undistortion of EuRoC
    pinhole images (the reference undistorts in the ROS node,
    image_grabber.hpp:96-110; here it is one gather per frame).

    Returns an (h, w, 2) float32 map of source (x, y) per output pixel.
    """
    fx, fy, cx, cy = params[:4]
    k1, k2, p1, p2 = distortion
    h, w = hw
    nfx, nfy, ncx, ncy = new_params if new_params is not None else params[:4]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (xs - ncx) / nfx
    y = (ys - ncy) / nfy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    mapx = fx * xd + cx
    mapy = fy * yd + cy
    return np.stack([mapx, mapy], axis=-1).astype(np.float32)


def apply_undistort(img: np.ndarray, umap: np.ndarray) -> np.ndarray:
    """Bilinear remap of an (H, W) image through a (H, W, 2) map of source
    (x, y) per output pixel (numpy, on the host)."""
    h, w = img.shape
    mx = np.clip(umap[..., 0], 0, w - 1.001)
    my = np.clip(umap[..., 1], 0, h - 1.001)
    x0 = mx.astype(np.int32)
    y0 = my.astype(np.int32)
    fx = mx - x0
    fy = my - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy) +
            (v10 * (1 - fx) + v11 * fx) * fy).astype(np.float32)
