"""A synthetic EuRoC-layout (ASL) sequence written to disk, for the dataset
runner (`tools/run_euroc.py`).

The port's copy of the fixture of `tests/test_euroc_tool.py`: the same
seed, path, renders and files.  The sequence is written exactly as EuRoC
ships it: mav0/cam0 and cam1 data.csv + data/*.png (PNG-encoded,
radtan-distorted renders at the EuRoC cameras' 480x752, so that the tool's
undistortion and rectification remaps matter), mav0/depth0 (16-bit metric
depth at 5000 units per meter, aligned to the undistorted cam0),
mav0/imu0/data.csv at 200 Hz consistent with the camera path, and the
ground-truth csv.  The camera flies a low pass (1.2 m/s at 2.5 m) over a
textured plane with the JAX renderer's default mesas (`DEFAULT_MESAS`, as
the fixture renders them); the depth images are the plane's, as the
fixture writes them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io import euroc
from . import synth_render as sr

FPS = 20.0
IMU_HZ = 200.0
N_FRAMES = 60
G_W = np.array([0.0, 0.0, -9.81])


def radtan_rays(params, dist, hw):
    """(H, W, 3) camera rays whose pinhole projection and then radtan
    distortion lands on each pixel: rendering with these rays produces a
    radtan-distorted image (the cv::undistortPoints iteration)."""
    fx, fy, cx, cy = params[:4]
    k1, k2, p1, p2 = dist
    h, w = hw
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xd = (u - cx) / fx
    yd = (v - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)


def cam_path(t):
    """Camera pose (R_cw, t_cw) at time t: a constant look-down
    orientation, 1.2 m/s along x at 2.5 m over the plane."""
    x = 1.20 * t
    y = 0.20 * np.sin(0.8 * t)
    return sr.look_down_pose(x, y, 2.5)


def cam_center(t):
    return np.array([1.20 * t, 0.20 * np.sin(0.8 * t), -2.5])


def cam_accel(t):
    return np.array([0.0, -0.20 * 0.8 * 0.8 * np.sin(0.8 * t), 0.0])


def span(n_frames: int = N_FRAMES) -> float:
    """Distance between the path's first and last camera centres."""
    return float(np.linalg.norm(cam_center(n_frames / FPS) - cam_center(0.0)))


def write_tree(root: str, n_frames: int = N_FRAMES) -> str:
    """Write the sequence under `root` (created) and return `root`."""
    from PIL import Image
    mav = os.path.join(root, "mav0")
    cam_dir = os.path.join(mav, "cam0", "data")
    cam1_dir = os.path.join(mav, "cam1", "data")
    depth_dir = os.path.join(mav, "depth0", "data")
    imu_dir = os.path.join(mav, "imu0")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    for d in (cam_dir, cam1_dir, depth_dir, imu_dir, gt_dir):
        os.makedirs(d)

    cam = euroc.EUROC_CAM0
    cam1 = euroc.EUROC_CAM1
    rng = np.random.default_rng(3)
    tex = sr.block_texture(rng, block=10)
    rays = radtan_rays(cam["params"], cam["distortion"], cam["resolution"])
    rays1 = radtan_rays(cam1["params"], cam1["distortion"], cam1["resolution"])
    # cam1 <- cam0 from the factory body extrinsics (T_BS = body<-sensor)
    T_c1_c0 = np.linalg.inv(cam1["T_BS"]) @ cam["T_BS"]
    # undistorted-pinhole pixel rays for the aligned depth images
    h, w = cam["resolution"]
    fx, fy, cx, cy = cam["params"]
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays_ud = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)

    def render(job):
        i, right = job
        R_cw, t_cw = cam_path(i / FPS)
        if not right:
            return sr.render_plane(R_cw, t_cw, np.asarray(cam["params"]),
                                   cam["resolution"], tex, tex_scale=80.0, rays=rays)
        # right camera: the same world plane through T_c1_w = T_c1_c0 T_c0_w
        R1_cw = T_c1_c0[:3, :3] @ R_cw
        t1_cw = T_c1_c0[:3, :3] @ t_cw + T_c1_c0[:3, 3]
        return sr.render_plane(R1_cw.astype(np.float32), t1_cw.astype(np.float32),
                               np.asarray(cam1["params"]), cam1["resolution"], tex,
                               tex_scale=80.0, rays=rays1)

    def depth(i):
        # aligned metric depth (undistorted pinhole frame, like the RGB
        # the tool undistorts): ray-plane intersection with z = 0, the
        # mesas left out as the fixture leaves them out
        R_cw, t_cw = cam_path(i / FPS)
        Rwc = np.asarray(R_cw).T
        twc = -Rwc @ np.asarray(t_cw)
        d_w = rays_ud @ Rwc.T                 # (H, W, 3) world dirs
        s = -twc[2] / np.maximum(d_w[..., 2], 1e-6)
        return np.clip(s * 5000.0, 0, 65535).astype(np.uint16)

    ts_ns = [int(round(i / FPS * 1e9)) for i in range(n_frames)]
    # renders, depths and PNG files in threads (numpy and zlib release the
    # GIL); the noise drawn in the fixture's order, left then right of each
    # frame
    with ThreadPoolExecutor(8) as ex:
        images = list(ex.map(render, [(i, r) for i in range(n_frames) for r in (False, True)]))
        images = [np.clip(img + rng.normal(0, 1.0, img.shape), 0, 255).astype(np.uint8)
                  for img in images]
        files = [(Image.fromarray(img, "L"), (cam_dir, cam1_dir)[k % 2], ts_ns[k // 2])
                 for k, img in enumerate(images)]
        files += [(Image.fromarray(d), depth_dir, ns)
                  for d, ns in zip(ex.map(depth, range(n_frames)), ts_ns)]
        list(ex.map(lambda f: f[0].save(os.path.join(f[1], f"{f[2]}.png")), files))
    cam_rows = [f"{ns},{ns}.png" for ns in ts_ns]
    gt_rows = []
    for i, ns in enumerate(ts_ns):
        c = cam_center(i / FPS)
        gt_rows.append(f"{ns},{c[0]},{c[1]},{c[2]},1,0,0,0")
    header = "#timestamp [ns],filename\n"
    for sub in ("cam0", "cam1", "depth0"):
        with open(os.path.join(mav, sub, "data.csv"), "w") as f:
            f.write(header + "\n".join(cam_rows) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_x, p_y, p_z, qw, qx, qy, qz\n" + "\n".join(gt_rows) + "\n")

    # IMU at 200 Hz consistent with the path: constant orientation
    # (gyro = 0), accelerometer = R_bw (a_w - g_w)
    Rbc = euroc.EUROC_IMU["Tbc"][:3, :3]
    R_cw0, _ = cam_path(0.0)
    Rbw = Rbc @ R_cw0
    imu_rows = []
    n_imu = int(n_frames / FPS * IMU_HZ) + 1
    for k in range(n_imu):
        t = k / IMU_HZ
        a_body = Rbw @ (cam_accel(t) - G_W)
        imu_rows.append(f"{int(round(t * 1e9))},0,0,0,"
                        f"{a_body[0]},{a_body[1]},{a_body[2]}")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n" + "\n".join(imu_rows) + "\n")
    return root
