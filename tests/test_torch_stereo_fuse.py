"""The port's stereo-resident fuse step and drivers against the JAX package
on the scene of tests/test_stereo_fuse.py: one frame through
`fuse_frame_stereo_onebuf`, the 6-frame `feed_stereo` drive through both
`DeviceResidentMapping`s (box and SGM census matchers), the host-pool
driver, the feed guard, and a JAX stereo checkpoint resumed in the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models.stereo import StereoConfig as JaxStereo
from densesurfelmapping_tpu.pipeline import fuse_step as jfuse
from densesurfelmapping_tpu.pipeline.device_driver import (
    DeviceResidentMapping as JaxDeviceResidentMapping)
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core import state as tstate
from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfuse
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping

from test_device_driver import sorted_rows

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                       cx=59.5, cy=27.5)
BASELINE = 0.5
BF = CAM.fx * BASELINE
MATCHERS = {
    "box": dict(max_disparity=64, min_disparity=1, radius=3),
    "sgm": dict(max_disparity=64, min_disparity=1, radius=3,
                aggregation="sgm"),
}
REF = SurfelMapConfig(camera=CAM, surfel_capacity=16384, lane_align=8,
                      drift_free_poses=3)
CFG = tcfg.SurfelMapConfig.from_json(REF.to_json())
N_FRAMES = 6


def _stereo_configs(name):
    kw = MATCHERS[name]
    # the JAX scan backend: pinned bitwise to its Pallas kernels by its tests
    return JaxStereo(**dict(kw, sgm_pallas=False)), StereoConfig(**kw)


@pytest.fixture(scope="module")
def scene():
    return synthetic.Scene(ground_y=1.5, wall_z=18.0,
                           boxes=synthetic.default_scene().boxes,
                           max_depth=25.0, texture="multisine")


def _pair(scene, pose):
    rp = np.array(pose, np.float64).copy()
    rp[:3, 3] += rp[:3, 0] * BASELINE
    li, _ = scene.render(REF, pose)
    ri, _ = scene.render(REF, rp)
    return li, ri


def _pose(i):
    pose = np.eye(4)
    pose[0, 3] = 0.15 * i
    return pose


def _drive(m, scene, stereo_config, frames=range(N_FRAMES)):
    if stereo_config is not None:
        m.enable_stereo(bf=BF, stereo_config=stereo_config)
    for i in frames:
        li, ri = _pair(scene, _pose(i))
        m.feed_pose(float(i), _pose(i), is_keyframe=(i % 2 == 0))
        m.feed_stereo(float(i), li, ri)
    return m


def _live(m):
    """Every live row of a driver's map (active at any update count +
    frozen), sorted."""
    act = m.active_surfels(min_updates=1)
    ina = m.inactive_surfels()
    return sorted_rows({k: np.concatenate([act[k], ina[k]]) for k in act})


def _same_map(a, b):
    assert len(a["position"]) == len(b["position"]) > 0
    np.testing.assert_allclose(a["position"], b["position"], atol=1e-4)
    np.testing.assert_allclose(a["normal"], b["normal"], atol=1e-4)
    np.testing.assert_array_equal(a["update_times"], b["update_times"])


@pytest.mark.parametrize("matcher", ["box", "sgm"])
def test_one_frame_onebuf_matches_jax(scene, matcher):
    jsc, tsc = _stereo_configs(matcher)
    li, ri = _pair(scene, np.eye(4))
    aux = jstate.pack_aux(np.eye(4, dtype=np.float32), 0,
                          np.ones(REF.max_keyframes, bool), bf=BF)
    buf = jstate.pack_stereo_with_aux(
        REF, jstate.pack_stereo_pair(REF, li, ri), aux)
    tbuf = tstate.pack_stereo_with_aux(
        CFG, tstate.pack_stereo_pair(CFG, li, ri),
        tstate.pack_aux(np.eye(4, dtype=np.float32), 0,
                        np.ones(CFG.max_keyframes, bool), bf=BF))
    np.testing.assert_array_equal(tbuf, buf)

    jbank, jst = jfuse.jitted_fuse_frame_stereo_onebuf(REF, jsc)(
        jstate.SurfelBank.empty(REF.surfel_capacity), jnp.asarray(buf))
    tbank = tstate.SurfelBank.empty(CFG.surfel_capacity, "cpu")
    _, tst = tfuse.fuse_frame_stereo_onebuf(CFG, tsc, True, tbank,
                                            torch.from_numpy(tbuf))
    assert {k: int(v) for k, v in tst.items()} \
        == {k: int(v) for k, v in jst.items()}
    assert int(tst["n_new"]) > 5
    n = int(jbank.count)
    np.testing.assert_allclose(tbank.position[:n].numpy(),
                               np.asarray(jbank.position)[:n], atol=1e-5)


@pytest.fixture(scope="module")
def drives(scene):
    out = {}
    for matcher in MATCHERS:
        jsc, tsc = _stereo_configs(matcher)
        out[matcher] = dict(
            jax=_drive(JaxDeviceResidentMapping(REF), scene, jsc),
            dev=_drive(DeviceResidentMapping(CFG, device="cpu"), scene, tsc))
    out["box"]["host"] = _drive(SurfelMapping(CFG, device="cpu"), scene,
                                _stereo_configs("box")[1])
    return out


@pytest.mark.parametrize("matcher", ["box", "sgm"])
def test_drive_matches_jax(drives, matcher):
    j, t = drives[matcher]["jax"], drives[matcher]["dev"]
    assert t.frames_fused == j.frames_fused == N_FRAMES
    assert t.local_indices == j.local_indices
    _same_map(_live(t), _live(j))
    assert t.metrics()["active_count"] == j.metrics()["active_count"] > 20


def test_host_pool_driver_same_map(drives):
    host, dev = drives["box"]["host"], drives["box"]["dev"]
    assert host.frames_fused == N_FRAMES
    _same_map(sorted_rows(host.map_surfels()), sorted_rows(dev.map_surfels()))
    _same_map(sorted_rows(host.active_surfels(min_updates=1)),
              sorted_rows(dev.active_surfels(min_updates=1)))


@pytest.mark.parametrize("cls", [SurfelMapping, DeviceResidentMapping])
def test_feed_stereo_requires_enable(cls):
    m = cls(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="enable_stereo"):
        m.feed_stereo(0.0, np.zeros((CAM.height, CAM.width), np.uint8),
                      np.zeros((CAM.height, CAM.width), np.uint8))


def test_jax_stereo_checkpoint_resumes_in_port(drives, scene, tmp_path):
    """A stereo map saved by the JAX driver loads into the port; one more
    pair fed to both gives the same map."""
    path = str(tmp_path / "jax_stereo.npz")
    drives["sgm"]["jax"].save_checkpoint(path)
    jsc, tsc = _stereo_configs("sgm")
    j = JaxDeviceResidentMapping(REF)
    j.load_checkpoint(path)
    j.enable_stereo(bf=BF, stereo_config=jsc)
    t = DeviceResidentMapping(CFG, device="cpu")
    t.load_checkpoint(path)
    t.enable_stereo(bf=BF, stereo_config=tsc)
    _same_map(_live(t), _live(j))
    for m in (j, t):
        _drive(m, scene, None, frames=[N_FRAMES])
    assert t.frames_fused == j.frames_fused == N_FRAMES + 1
    _same_map(_live(t), _live(j))


def _quarter_kitti_depth_check(depth, rendered):
    sel = (rendered >= 1.0) & (rendered <= 25.0)
    ok = sel & (depth > 0)
    rel = np.abs(depth[ok] - rendered[ok]) / rendered[ok]
    return float(ok.sum() / sel.sum()), float(np.median(rel))


def test_depth_check_bounds_from_jax():
    """chip_smoke.py's stereo depth check (coverage floor, median relative
    error bound) derives from the JAX package's compute_depth_stereo on the
    same frame at a quarter of KITTI size: the CLI's --sgm matcher on the
    first pair of the synthetic drive.  The port computes the same depth."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    import jax
    from densesurfelmapping_tpu.config import KITTI_00_INTRINSICS, kitti_config

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    k = KITTI_00_INTRINSICS
    cam = CameraIntrinsics(width=310, height=94, fx=k.fx / 4, fy=k.fy / 4,
                           cx=k.cx / 4, cy=k.cy / 4)
    ref = dataclasses.replace(kitti_config(surfel_capacity=1 << 16),
                              camera=cam)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    pose = synthetic.forward_trajectory(smoke.N_STEREO_FRAMES + 3,
                                        step=0.4)[0]
    rp = pose.copy()
    rp[:3, 3] += rp[:3, 0] * smoke.BASELINE_M
    scene = synthetic.default_scene()
    li, ld = scene.render(ref, pose)
    ri, _ = scene.render(ref, rp)
    li, ri = (np.clip(x, 0, 255).astype(np.uint8).astype(np.float32)
              for x in (li, ri))
    bf = np.float32(cam.fx * smoke.BASELINE_M)
    jsc = JaxStereo(max_disparity=128, aggregation="sgm", sgm_pallas=False)
    dj, _ = jax.jit(lambda a, b: jfuse.compute_depth_stereo(
        ref, jsc, a, b, jnp.float32(bf)))(jnp.asarray(li), jnp.asarray(ri))
    dt, _ = tfuse.compute_depth_stereo(
        cfg, StereoConfig(max_disparity=128, aggregation="sgm"),
        torch.from_numpy(li), torch.from_numpy(ri), torch.tensor(bf))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))

    cov, err = _quarter_kitti_depth_check(np.asarray(dj), ld)
    assert smoke.DEPTH_REL_ERR_BOUND == pytest.approx(min(1.5 * err, 0.05),
                                                      abs=1e-5)
    assert smoke.DEPTH_COVERAGE_FLOOR == pytest.approx(cov / 1.5, abs=1e-4)
