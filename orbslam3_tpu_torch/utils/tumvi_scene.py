"""A synthetic TUM-VI-layout (ASL) sequence written to disk, for the dataset
runner's `--dataset tumvi` arms (`tools/run_euroc.py`).

`utils/euroc_scene.py` writes the EuRoC fixture; this writes its TUM-VI
counterpart, as TUM-VI ships a sequence: mav0/cam0 and cam1 data.csv +
data/*.png (raw Kannala-Brandt fisheye renders at the TUM-VI cameras'
512x512, through `synth_render.kb8_rays` with `io.euroc.TUMVI_CAM0` /
`TUMVI_CAM1`, the right camera placed by the pair's `T_BS`), mav0/imu0/data.csv
at 200 Hz in the body frame (`TUMVI_IMU["Tbc"]` is body <- cam0) and the
ground-truth csv (the cam0 centre and an identity quaternion, as
`euroc_scene` writes it and the runner reads it).

The world and the path are scenario J's (`utils/acceptance.py`,
tests/test_fisheye_stereo_inertial.py): the block texture of seed 12 and its
ten shallow mesas, cam0 looking straight at the plane from 3 m along the
smooth accelerating path, its attitude fixed (gyro 0), at TUM-VI's 20 Hz.
Each image gets noise of sigma 1 graylevel before it is rounded to uint8.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..io import euroc
from . import acceptance as acc
from . import synth_render as sr

FPS = 20.0
IMU_HZ = 200.0
N_FRAMES = 60
G_W = acc.J_G                # +z is "down", toward the plane
TEX_SCALE = 60.0


def span(n_frames: int = N_FRAMES) -> float:
    """Distance between the path's first and last camera centres."""
    return float(np.linalg.norm(acc.j_pos(n_frames / FPS) - acc.j_pos(0.0)))


def write_tree(root: str, n_frames: int = N_FRAMES) -> str:
    """Write the sequence under `root` (created) and return `root`."""
    from PIL import Image
    mav = os.path.join(root, "mav0")
    cam_dirs = [os.path.join(mav, c, "data") for c in ("cam0", "cam1")]
    imu_dir = os.path.join(mav, "imu0")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    for d in cam_dirs + [imu_dir, gt_dir]:
        os.makedirs(d)

    cams = (euroc.TUMVI_CAM0, euroc.TUMVI_CAM1)
    rng = np.random.default_rng(12)
    tex, mesas = acc.j_world(rng)
    rays = [sr.kb8_rays(c["params"], c["resolution"]) for c in cams]
    T = np.linalg.inv(cams[1]["T_BS"]) @ cams[0]["T_BS"]     # cam1 <- cam0 (T_BS: body <- sensor)
    R_cw = np.eye(3)                                         # cam0's attitude is the world's

    def render(job):
        R, tt, side = job
        return sr.render_plane(R, tt, np.asarray(cams[side]["params"][:4]),
                               cams[side]["resolution"], tex, tex_scale=TEX_SCALE, mesas=mesas,
                               rays=rays[side])

    ts_ns = [int(round(i / FPS * 1e9)) for i in range(n_frames)]
    jobs = []
    for i in range(n_frames):
        t_cw = -R_cw @ acc.j_pos(i / FPS)
        jobs += [(R_cw, t_cw, 0), (T[:3, :3] @ R_cw, T[:3, :3] @ t_cw + T[:3, 3], 1)]
    # renders and PNG files in threads (numpy and zlib release the GIL); the
    # noise drawn in order, left then right of each frame
    with ThreadPoolExecutor(8) as ex:
        images = list(ex.map(render, jobs))
        images = [np.clip(img + rng.normal(0, 1.0, img.shape), 0, 255).astype(np.uint8)
                  for img in images]
        list(ex.map(lambda k: Image.fromarray(images[k], "L").save(
            os.path.join(cam_dirs[k % 2], f"{ts_ns[k // 2]}.png")), range(len(images))))
    cam_rows = [f"{ns},{ns}.png" for ns in ts_ns]
    gt_rows = [f"{ns},{c[0]},{c[1]},{c[2]},1,0,0,0"
               for ns, c in zip(ts_ns, (acc.j_pos(i / FPS) for i in range(n_frames)))]
    for sub in ("cam0", "cam1"):
        with open(os.path.join(mav, sub, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(cam_rows) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_x, p_y, p_z, qw, qx, qy, qz\n" + "\n".join(gt_rows) + "\n")
    # the IMU over the frames' time: gyro 0, accelerometer R_bw (a_w - g_w)
    R_bw = euroc.TUMVI_IMU["Tbc"][:3, :3] @ R_cw
    rows = []
    for k in range(int(n_frames / FPS * IMU_HZ) + 1):
        t = k / IMU_HZ
        a = R_bw @ (acc.j_acc_w(t) - G_W)
        rows.append(f"{int(round(t * 1e9))},0,0,0,{a[0]},{a[1]},{a[2]}")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n" + "\n".join(rows) + "\n")
    return root
