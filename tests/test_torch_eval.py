"""The port's map-fidelity evaluation (`eval/fidelity.py`) against the JAX
package's on the same numpy inputs.

render_depth: the coverage masks are identical and the depths bitwise equal
(the splat is a scatter-min, exact in any order).  The host metrics agree
within 1e-6."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu import eval as jeval
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch import eval as teval

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
REF = SurfelMapConfig(camera=CAM, surfel_capacity=1024, fuse_far=12.0)
CFG = tcfg.SurfelMapConfig.from_json(REF.to_json())
METRIC_TOL = 1e-6


def _surfels(position, size, seed=0):
    position = np.asarray(position, np.float32).reshape(-1, 3)
    n = len(position)
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    return dict(position=position, normal=normal,
                size=np.asarray(size, np.float32).reshape(-1),
                color=rng.uniform(0, 255, n).astype(np.float32))


def _pose():
    pose = np.eye(4)
    c, s = np.cos(0.1), np.sin(0.1)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = (0.3, -0.2, 0.5)
    return pose


def _random_map(n, seed):
    """Surfels in front of _pose(), some behind it or off the image."""
    rng = np.random.default_rng(seed)
    cam_pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-3, 3, n),
                        rng.uniform(-1, 11, n)], 1)
    world = cam_pts @ _pose()[:3, :3].T + _pose()[:3, 3]
    return _surfels(world, rng.uniform(0.005, 0.3, n), seed)


def _in_front(u, v, z, size):
    """A world point that projects to pixel (u, v) at depth z in _pose()."""
    p_c = np.array([(u - CAM.cx) / CAM.fx * z, (v - CAM.cy) / CAM.fy * z, z])
    return _pose()[:3, :3] @ p_c + _pose()[:3, 3], size


def _two_overlapping():
    (a, sa), (b, sb) = _in_front(40, 20, 5.0, 0.2), _in_front(42, 21, 3.0,
                                                              0.1)
    return _surfels([a, b], [sa, sb])


CASES = {
    "single": lambda: _surfels(*_in_front(60, 30, 4.0, 0.15)),
    "two_overlapping": _two_overlapping,
    "empty": lambda: _surfels(np.zeros((0, 3)), np.zeros(0)),
    "random_300": lambda: _random_map(300, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_depth_matches_jax(case):
    surfels = CASES[case]()
    want = jeval.render_depth(REF, surfels, _pose())
    got = teval.render_depth(CFG, surfels, _pose(), device="cpu")
    assert got.shape == want.shape == (CAM.height, CAM.width)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got, want)
    if case == "two_overlapping":
        # the z-buffer keeps the nearer surfel where the disks overlap
        assert got[21, 42] == pytest.approx(3.0, abs=1e-5)
        assert got[20, 37] == pytest.approx(5.0, abs=1e-5)
    if case != "empty":
        assert (got > 0).any()


def _depth_pair(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 35, (CAM.height, CAM.width)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.2] = 0
    rendered = (gt + rng.normal(0, 0.2, gt.shape)).astype(np.float32)
    rendered[rng.random(gt.shape) < 0.3] = 0
    return rendered, gt


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL,
                                   err_msg=k)


def test_depth_metrics_matches_jax():
    rendered, gt = _depth_pair(2)
    _close(teval.depth_metrics(rendered, gt, 30.0),
           jeval.depth_metrics(rendered, gt, 30.0))
    empty = np.zeros_like(gt)
    _close(teval.depth_metrics(empty, gt), jeval.depth_metrics(empty, gt))


def test_backproject_densify_and_cloud_metrics_match_jax():
    _, gt = _depth_pair(3)
    want = jeval.backproject_cloud(REF, gt, _pose())
    got = teval.backproject_cloud(CFG, gt, _pose())
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL)
    surfels = _random_map(300, 4)
    dj, dt = jeval.densify_surfels(surfels), teval.densify_surfels(surfels)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=METRIC_TOL)
    _close(teval.cloud_metrics(dt, got, threshold=0.5, sample=2000),
           jeval.cloud_metrics(dj, want, threshold=0.5, sample=2000))
    _close(teval.cloud_metrics(np.zeros((0, 3)), got),
           jeval.cloud_metrics(np.zeros((0, 3)), want))


def test_evaluate_map_and_clouds_match_jax():
    """The two mapping-level entry points on a stand-in mapping (config,
    device, map_surfels): the same map scored against the same frames."""
    surfels = _random_map(400, 5)
    frames = []
    for seed in (6, 7):
        _, gt = _depth_pair(seed)
        frames.append((np.zeros_like(gt), gt))
    poses = [_pose(), np.eye(4)]
    jm = SimpleNamespace(config=REF, map_surfels=lambda: surfels)
    tm = SimpleNamespace(config=CFG, device=torch.device("cpu"),
                         map_surfels=lambda: surfels)
    _close(teval.evaluate_map(tm, frames, poses),
           jeval.evaluate_map(jm, frames, poses))
    _close(teval.evaluate_map_clouds(tm, frames, poses),
           jeval.evaluate_map_clouds(jm, frames, poses))
