"""The port's plane fit (`compute_seed_planes`) against the JAX package's on
the same frame and SLIC output.  Tolerances: the ok masks agree on >= 99% of
seeds; where both fit, normals within 0.5 deg and positions within 2 mm
(the plane-fit tolerances of DIVERGENCES #5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import (CameraIntrinsics, DRIVE_PROFILE,
                                           SurfelMapConfig)
from densesurfelmapping_tpu.core.state import pad_frame
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.ops import normals as JN
from densesurfelmapping_tpu.ops import superpixel as JS
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import SuperpixelState
from densesurfelmapping_tpu_torch.ops import normals as TN

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                           cx=59.5, cy=27.5)
    ref = SurfelMapConfig(camera=cam, profile=DRIVE_PROFILE,
                          surfel_capacity=4096)
    # pitched down and 8 m in: ground, box faces and depth edges in view
    c, s = np.cos(0.35), np.sin(0.35)
    pose = np.eye(4)
    pose[:3, :3] = [[1, 0, 0], [0, c, s], [0, -s, c]]
    pose[2, 3] = 8.0
    img, dep = synthetic.default_scene().render(ref, pose, depth_noise=0.02,
                                                seed=7)
    pi, pd = pad_frame(ref, img, dep)

    def f(i, d):
        seeds, asg = JS.run_slic(ref, i, d, use_pallas=False)
        planes, space = JN.compute_seed_planes(ref, seeds, asg, d)
        return seeds, asg, planes, space

    out = jax.tree_util.tree_map(np.array, jax.jit(f)(jnp.asarray(pi),
                                                      jnp.asarray(pd)))
    return tcfg.SurfelMapConfig.from_json(ref.to_json()), pd, out


def _state(s) -> SuperpixelState:
    return SuperpixelState(**{k: torch.from_numpy(np.array(getattr(s, k)))
                              for k in SuperpixelState.__dataclass_fields__})


def test_seed_planes_match_jax(case):
    cfg, depth, (seeds, asg, want, space) = case
    got, tspace = TN.compute_seed_planes(cfg, _state(seeds),
                                         torch.from_numpy(asg),
                                         torch.from_numpy(depth))
    np.testing.assert_allclose(tspace.numpy(), space, rtol=1e-6, atol=1e-6)

    ok_j = np.any(want.norm != 0, axis=-1)
    ok_t = np.any(got.norm.numpy() != 0, axis=-1)
    assert (ok_j == ok_t).mean() >= 0.99
    both = ok_j & ok_t
    assert both.sum() > 50
    cos = np.sum(got.norm.numpy()[both] * want.norm[both], axis=-1)
    angle = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert angle.max() < 0.5, angle.max()
    err = np.abs(got.pos.numpy()[both] - want.pos[both]).max()
    assert err < 2e-3, err


def test_pixel_normals_match_jax(case):
    cfg, depth, (_, _, _, space) = case
    ref = SurfelMapConfig.from_json(cfg.to_json())
    want = np.asarray(JN.pixel_normals(ref, jnp.asarray(space)))
    got = TN.pixel_normals(cfg, torch.from_numpy(space)).numpy()
    assert ((want != 0).any(-1) == (got != 0).any(-1)).mean() > 0.999
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_solve4_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 4, 4))
    h = (a @ a.transpose(0, 2, 1) + 5 * np.eye(4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    got = TN._solve4(torch.from_numpy(h), torch.from_numpy(b)).numpy()
    want = np.linalg.solve(h.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
