"""The port's keyframe step against the JAX package and against ground truth.

1. One keyframe step (`system.kf_step`, then `kf_pose_refresh` and
   `post_ba_stages`) on a map the JAX package seeded and tracked, at
   `torch_parity_helpers.SMALL` with the window BA cut to (8, 1024, 4096)
   and a budget of 256 new points: the same new points, slots and bindings
   as `System._kf_step`, poses and points within the stated tolerances.
2. The seeded keyframe drive (`seeded_scene.track_with_keyframes`, the
   drive of `chip_smoke.py`'s phase 5) through both packages: both within
   the gates, and agreeing with each other.  A full-size version is marked
   slow.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity_helpers as H
from orbslam3_tpu_torch.pipeline import system as tsys
from orbslam3_tpu_torch.slam_map import convert
from orbslam3_tpu_torch.slam_map import state as tstate
from orbslam3_tpu_torch.utils import seeded_scene as ss

torch.set_num_threads(2)

# SMALL's 240x376 crop has half the field of view of the default camera and
# 500 features: rotation and translation separate less well, and both
# packages track it to 0.06 units / 0.6 degrees (default size: 0.005 / 0.05).
# The gates of the small drive are widened to 0.1 units / 1 degree for that.
SMALL_KF = dataclasses.replace(
    H.SMALL, track_frames=tuple(range(19, 49)), ba_caps=(8, 1024, 4096),
    new_pt_budget=256, max_center_err=0.1, max_rot_err_deg=1.0)


def _np(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _t(a):
    return torch.from_numpy(_np(a).copy())


@pytest.fixture(scope="module")
def first_step():
    """The JAX state before the first keyframe step (seeded map, 6 tracked
    frames) and the JAX System's own results of the step."""
    cfg = SMALL_KF
    frames = ss.render_frames(cfg)
    m, bank, view = H.seed_map_jax(cfg, frames)
    step = H._jax_frame_step(cfg)
    f0 = cfg.track_frames[0]
    R_prev, t_prev = H._pose(f0 - 2)
    R_cur, t_cur = H._pose(f0 - 1)
    for fi in cfg.track_frames[:cfg.kf_every]:
        m, ff, R, t, kp_pt, _ = step(m, view, jnp.asarray(frames[fi]),
                                     R_prev, t_prev, R_cur, t_cur)
        R_prev, t_prev, R_cur, t_cur = R_cur, t_cur, R, t
    ki = len(cfg.seed_frames)
    pre = dict(m=m, bank=bank, ff=ff, kp_pt=kp_pt, R_prev=R_prev, t_prev=t_prev,
               R=R, t=t, fi=fi, ki=ki)
    sys_ = H.jax_system(cfg)
    m2, bank2, ki2, kp_new, n_new, view2 = H.kf_step_jax(sys_, m, bank, ff, kp_pt, R, t,
                                                         fi, ki)
    refresh = sys_._kf_pose_refresh(m2, jnp.asarray(ki, jnp.int32), R, t, R_prev, t_prev)
    post = H.post_ba_stages_jax(sys_, m2, bank2, ki, ff, kp_new, view2, fi)
    return cfg, pre, (m2, bank2, ki2, kp_new, n_new, view2), refresh, post


def _torch_step(cfg, pre):
    cam = torch.tensor(cfg.K4)
    m = convert.map_from_numpy(H.fields(pre["m"]))
    bank = convert.bank_from_numpy(H.fields(pre["bank"]))
    ff = convert.frame_from_numpy(H.fields(pre["ff"]))
    kp_ur = torch.full((ff.xy.shape[0],), -1.0)
    out = tsys.kf_step(ss.slam_config(cfg), cam, m, bank, ff, _t(pre["kp_pt"]),
                       _t(pre["R"]), _t(pre["t"]), pre["fi"] / 10.0, pre["fi"], kp_ur,
                       pre["ki"])
    return cam, ff, out


def _assert_points_close(got, ref, pt_valid):
    """Points within 1e-3 of their distance from the origin (the float32
    BA solve sums thousands of terms in another order)."""
    got, ref = got[pt_valid], ref[pt_valid]
    scale = np.maximum(np.linalg.norm(ref, axis=1), 1.0)
    assert np.all(np.linalg.norm(got - ref, axis=1) <= 1e-3 * scale)


def test_kf_step_matches_jax(first_step):
    """Insertion, triangulation, culling and the view: equal; keyframe
    poses within 1e-4 (6 LM steps with the same accept pattern)."""
    cfg, pre, ref, _, _ = first_step
    _, _, got = _torch_step(cfg, pre)
    m_r, bank_r, ki_r, kp_r, n_r, view_r = ref
    m_t, bank_t, ki_t, kp_t, n_t, view_t = got
    assert int(ki_t) == int(ki_r) == pre["ki"]
    assert int(n_t) == int(n_r) > 0
    np.testing.assert_array_equal(kp_t.numpy(), _np(kp_r))
    created = _np(kp_r)[(_np(pre["kp_pt"]) < 0) & (_np(kp_r) >= 0)]
    assert len(created) == int(n_r)
    np.testing.assert_array_equal(bank_t.kp_pt.numpy(), _np(bank_r.kp_pt))
    for name in ("n_pt", "n_obs", "pt_valid", "obs_pt", "obs_kf", "obs_valid",
                 "pt_kf_mask", "pt_desc", "kf_valid"):
        np.testing.assert_array_equal(getattr(m_t, name).numpy(),
                                      _np(getattr(m_r, name)), err_msg=name)
    np.testing.assert_array_equal(view_t.idx.numpy(), _np(view_r.idx))
    np.testing.assert_allclose(m_t.kf_R.numpy(), _np(m_r.kf_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(m_t.kf_t.numpy(), _np(m_r.kf_t), rtol=0, atol=1e-4)
    _assert_points_close(m_t.pt_xyz.numpy(), _np(m_r.pt_xyz), _np(m_r.pt_valid))


def test_kf_step_mismatch_relabels_new_slots_and_reports_real_differences(first_step):
    """The device-against-device check of the smoke: two new points that
    swapped slots (near-tied parallax scores ordered the other way) agree;
    a moved point, a lost binding or a pose off by more than its tolerance
    do not."""
    cfg, pre, _, _, _ = first_step
    _, _, got = _torch_step(cfg, pre)
    m, bank, ki, kp_new, n_new, view = got
    kp_in = _t(pre["kp_pt"])
    same = dict(pose=0.0, point=0.0, relabelled=0)
    assert ss.kf_step_mismatch(got, got, kp_in) == ([], same)
    j1, j2 = torch.nonzero((kp_in < 0) & (kp_new >= 0)).flatten()[:2].tolist()
    s1, s2 = int(kp_new[j1]), int(kp_new[j2])

    def swap_ids(kp):
        return torch.where(kp == s1, s2, torch.where(kp == s2, s1, kp))

    def swap_rows(x):
        x = x.clone()
        x[[s1, s2]] = x[[s2, s1]]
        return x

    swapped = (m._replace(pt_xyz=swap_rows(m.pt_xyz), pt_valid=swap_rows(m.pt_valid)),
               bank._replace(kp_pt=swap_ids(bank.kp_pt)), ki, swap_ids(kp_new), n_new, view)
    assert not torch.equal(swapped[3], kp_new)
    assert ss.kf_step_mismatch(got, swapped, kp_in) == ([], dict(same, relabelled=2))

    moved = m.pt_xyz.clone()
    moved[s1] += 0.1
    bad, _ = ss.kf_step_mismatch(got, (m._replace(pt_xyz=moved),) + got[1:], kp_in)
    assert len(bad) == 1 and bad[0].startswith("points max relative diff")
    lost = kp_new.clone()
    lost[j1] = -1
    assert "new points come from other keypoints" in ss.kf_step_mismatch(
        got, got[:3] + (lost,) + got[4:], kp_in)[0]
    turned = m.kf_R.clone()
    turned[ki] = turned[ki] @ torch.tensor([[1.0, -1e-3, 0.0], [1e-3, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert any(b.startswith("kf_R") for b in ss.kf_step_mismatch(
        got, (m._replace(kf_R=turned),) + got[1:], kp_in)[0])


def test_pose_refresh_and_post_ba_stages_match_jax(first_step):
    """The pose refresh and the map stages that follow (fusion into
    keyframe 4 and the descriptor refresh), on the JAX step's output."""
    cfg, pre, ref, refresh, post = first_step
    cam = torch.tensor(cfg.K4)
    m2 = convert.map_from_numpy(H.fields(ref[0]))
    bank2 = convert.bank_from_numpy(H.fields(ref[1]))
    view2 = convert.view_from_numpy(H.fields(ref[5]))
    ff = convert.frame_from_numpy(H.fields(pre["ff"]))
    got = tsys.kf_pose_refresh(m2, pre["ki"], _t(pre["R"]), _t(pre["t"]),
                               _t(pre["R_prev"]), _t(pre["t_prev"]))
    for g, r in zip(got, refresh):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=0, atol=1e-6)
    m3, bank3, kp3, view3, culled = tsys.post_ba_stages(ss.slam_config(cfg), cam, m2, bank2,
                                                pre["ki"], ff, _t(ref[3]), view2)
    m_r, bank_r, kp_r, view_r = post
    assert culled is None                       # keyframe culling starts past keyframe 6
    np.testing.assert_array_equal(kp3.numpy(), _np(kp_r))
    assert (kp3 >= 0).sum() > (_t(ref[3]) >= 0).sum()          # fusion bound more
    np.testing.assert_array_equal(bank3.kp_pt.numpy(), _np(bank_r.kp_pt))
    for k, v in convert.to_numpy(m3).items():
        np.testing.assert_array_equal(v, _np(H.fields(m_r)[k]), err_msg=k)
    np.testing.assert_array_equal(view3.idx.numpy(), _np(view_r.idx))


def _drive_both(cfg):
    frames = ss.render_frames(cfg)
    mt, bt, vt = ss.seed_map(cfg, frames, "cpu")
    mt, bt, vt, res_t, _, steps_t = ss.track_with_keyframes(cfg, mt, bt, vt, frames, "cpu")
    mj, bj, vj = H.seed_map_jax(cfg, frames)
    mj, bj, vj, res_j, steps_j = H.kf_drive_jax(cfg, mj, bj, vj, frames)
    return (mt, bt, res_t, steps_t), (mj, res_j, steps_j)


def _check_drive(cfg, torch_run, jax_run):
    mt, bt, res_t, steps_t = torch_run
    mj, res_j, steps_j = jax_run
    n_kf = len(cfg.track_frames) // cfg.kf_every
    assert len(steps_t) == len(steps_j) == n_kf
    assert ss.check_gates(cfg, res_t) == []
    assert ss.check_gates(cfg, res_j) == []
    assert ss.check_kf_gates(cfg, steps_t) == []
    for s, (ki, fi, n_new, z) in zip(steps_t, steps_j):
        assert (s.ki, s.frame) == (ki, fi)
        assert n_new > 0 and z <= cfg.max_new_pt_z
        # same map state up to float32 noise: the same number of new points
        assert abs(s.n_new - n_new) <= 0.02 * n_new, (ki, s.n_new, n_new)
    for (fi, Rt, tt, nt), (fj, Rj, tj, nj) in zip(res_t, res_j):
        assert fi == fj
        assert abs(nt - nj) <= 0.02 * nj, (fi, nt, nj)
        np.testing.assert_allclose(tt, tj, rtol=0, atol=2e-3)
    # compaction (the smoke's last check): the valid points move to the
    # front and every remapped binding still names the same point
    mc, remap = tstate.compact(mt)
    assert int(mc.n_pt) == int(mt.pt_valid.sum()) == int(mc.pt_valid.sum())
    kp = bt.kp_pt
    kp2 = tsys.remap_bindings(kp, remap)
    keep = (kp >= 0) & (kp2 >= 0)
    assert keep.any()
    torch.testing.assert_close(mc.pt_xyz[kp2[keep].long()], mt.pt_xyz[kp[keep].long()],
                               rtol=0, atol=0)
    assert not bool(mt.pt_valid[kp[(kp >= 0) & (kp2 < 0)].long()].any())


def test_keyframe_drive_small_matches_jax_and_ground_truth():
    cfg = SMALL_KF
    _check_drive(cfg, *_drive_both(cfg))


@pytest.mark.slow
def test_keyframe_drive_full_size_matches_jax_and_ground_truth():
    cfg = dataclasses.replace(ss.SceneConfig(), track_frames=tuple(range(19, 67)))
    _check_drive(cfg, *_drive_both(cfg))
