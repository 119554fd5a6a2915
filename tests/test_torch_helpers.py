"""The four JAX helpers that only JAX tests call, against JAX on those
tests' inputs: `lie.se3_log` with `inv_right_jacobian_so3` (test_lie.py:85,
the exp/log round trip), `lie.quat_to_rot` (test_lie.py:135),
`orient.ic_angle_conv` (test_orb_frontend.py:195) and
`OrbParams.level_sigma2`."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslam3_tpu.features import extractor as jx
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import orient as jorient
from orbslam3_tpu_torch.features import extractor as tx
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.ops import orient as torient
from test_lie import rand_w

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_se3_log_matches_jax_and_inverts_exp():
    """1e-5 against JAX; the round trip within test_lie's 1e-4."""
    xi = jax.random.normal(jax.random.PRNGKey(4), (32, 6))
    phi = xi[:, 3:]
    xi = xi.at[:, 3:].set(phi / (1.0 + jnp.linalg.norm(phi, axis=-1, keepdims=True) / jnp.pi))
    R, t = jlie.se3_exp(xi)
    got = tlie.se3_log(_t(R), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlie.se3_log(R, t)), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xi), atol=1e-4)
    w = jnp.concatenate([xi[:, 3:], jnp.zeros((1, 3)), jnp.full((1, 3), 1e-5)])
    np.testing.assert_allclose(tlie.inv_right_jacobian_so3(_t(w)).numpy(),
                               np.asarray(jlie.inv_right_jacobian_so3(w)), atol=1e-5)


def test_quat_to_rot_matches_jax():
    """1e-6 against JAX; the round trip with rot_to_quat within 1e-5."""
    R = jlie.exp_so3(rand_w(jax.random.PRNGKey(9), n=128, scale=2.5))
    q = jlie.rot_to_quat(R)
    got = tlie.quat_to_rot(_t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlie.quat_to_rot(q)), atol=1e-6)
    np.testing.assert_allclose(tlie.quat_to_rot(tlie.rot_to_quat(_t(R))).numpy(), np.asarray(R),
                               atol=1e-5)


def test_ic_angle_conv_matches_jax_and_the_patch_oracle():
    """Within 5e-3 degrees of JAX's correlation (each sums the masked
    window's float32 products in its own order; measured 2.2e-3 on these
    moments, some of which are small) and test_orb_frontend's 0.1 degrees
    of the patch formulation."""
    rng = np.random.default_rng(9)
    img = (rng.random((200, 300)).astype(np.float32) * 255)
    xy = rng.uniform(20, 180, (50, 2)).astype(np.float32)
    ref = np.asarray(jorient.ic_angle_conv(jnp.asarray(img), jnp.asarray(xy)))
    got = torient.ic_angle_conv(_t(img), _t(xy)).numpy()
    d = np.abs(got - ref)
    assert np.minimum(d, 360 - d).max() < 5e-3
    d = np.abs(got - torient.ic_angle(_t(img), _t(xy)).numpy())
    assert np.minimum(d, 360 - d).max() < 0.1


def test_level_sigma2_matches_jax():
    for kw in ({}, dict(n_levels=4, scale_factor=1.5)):
        np.testing.assert_array_equal(tx.OrbParams(**kw).level_sigma2(),
                                      jx.OrbParams(**kw).level_sigma2())
