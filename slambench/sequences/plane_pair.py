"""A rectified stereo pair's path over the textured plane with mesas: the
left camera on the traffic's path (`scene.Sequence`, the IMU with it where
the configuration has one) and the right camera beside it at the
configuration's baseline (`preset_numbers.stereo.baseline`) along the
rectified x axis, both rendered on the device with the configuration's
rectified pinhole intrinsics, as a runner hands the System a pair after its
rectifying remap.  The seed draws one texture for both images and
independent pixel noise for each."""

from __future__ import annotations

import numpy as np
import torch

from slambench import scene

# the right image's noise stream: the seed moved by a fixed odd constant
_RIGHT_STREAM = 0x2545F4914F6CDD1D


def make(traffic: dict, config: dict, seed: int, device):
    num = config["preset_numbers"]
    imu = num.get("imu")
    seq = scene.Sequence(traffic, num, seed, device, imu_noise=imu,
                         Tbc=imu["Tbc"] if imu else None)
    seq.right = render_right(seq, traffic, num, seed, device)
    return seq


def render_right(seq, traffic: dict, num: dict, seed: int, device, batch: int = 32):
    """(n, H, W) uint8 right images in host memory: the left images' texture
    (drawn first from the same seed, as `scene.Sequence` draws it) seen from
    the left camera's pose moved by the baseline along its x axis."""
    hw = tuple(num["image_hw"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tex = traffic["texture"]
    texture = scene.block_texture(gen, tex["size"], tex["block"], device)
    gen.manual_seed((int(seed) + _RIGHT_STREAM) % (2 ** 63))
    rays = scene.pinhole_rays(num["cam_params"], hw, device)
    # x_right = x_left - (b, 0, 0) in camera coordinates
    shift = np.array([float(num["stereo"]["baseline"]), 0.0, 0.0], np.float32)
    sigma = float(traffic["pixel_noise"])
    out = torch.empty((seq.n, *hw), dtype=torch.uint8)
    for b0 in range(0, seq.n, batch):
        poses = [seq.path.pose_cw(t) for t in seq.ts[b0:b0 + batch]]
        R = torch.from_numpy(np.stack([p[0] for p in poses])).to(device)
        t = torch.from_numpy(np.stack([p[1] - shift for p in poses])).to(device)
        img = scene.render_batch(R, t, rays, texture, float(tex["tex_scale"]))
        img = img + sigma * torch.randn(img.shape, generator=gen, device=device)
        out[b0:b0 + batch] = img.clamp_(0, 255).to(torch.uint8).cpu()
    return out.numpy()
