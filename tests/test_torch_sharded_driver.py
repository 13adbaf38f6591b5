"""The port's sharded drivers against the JAX package's on JAX's scenario
(`tests/test_sharded_driver.py::run_scenario`: a keyframe chain with
migration, a loop edge and a pose-graph correction), on an 8-shard CPU mesh
beside the JAX tests' 8 virtual devices.

Tolerances: the device-resident drivers shard by shard (same layout):
counts, update_times and last_update exact, positions and normals within
1e-5 m; the host-pool driver's sorted rows within 1e-5 m; the port's dense
drivers within JAX's own 1e-4 m of its sharded ones; stereo within 1e-4 m.
"""

import jax
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu.pipeline import device_driver as jdd
from densesurfelmapping_tpu.pipeline.sharded_driver import (
    ShardedSurfelMapping as JShardedPool)
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.pipeline import device_driver as tdd
from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping
from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
    ShardedSurfelMapping)

from test_driver import tiny_config
from test_sharded_driver import run_scenario, sorted_rows
from test_torch_sharding import same_shards

torch.set_num_threads(1)


def port(cfg):
    return tcfg.SurfelMapConfig.from_json(cfg.to_json())


def tmesh():
    return tsh.make_mesh(8, devices="cpu")


def close_rows(a, b, tol, what=""):
    a, b = sorted_rows(a), sorted_rows(b)
    assert len(a["position"]) == len(b["position"]), what
    assert len(a["position"]) > 0, what
    np.testing.assert_allclose(a["position"], b["position"], rtol=0,
                               atol=tol, err_msg=what)
    np.testing.assert_allclose(a["normal"], b["normal"], rtol=0, atol=tol,
                               err_msg=what)


DRM_CFG = dict(drift_free_poses=2, surfel_capacity=8192, stats_interval=2,
               compact_interval=4)


@pytest.fixture(scope="module")
def jax_sharded_drm():
    cfg = tiny_config(**DRM_CFG)
    return cfg, run_scenario(jdd.ShardedDeviceResidentMapping(
        cfg, jsh.make_mesh(8, data=1)))


@pytest.mark.parametrize("frame_sharded", [False, True])
def test_sharded_device_resident_matches_jax(jax_sharded_drm,
                                             frame_sharded):
    """Both forms of the port's ShardedDeviceResidentMapping hold the JAX
    sharded bank shard by shard (JAX's own frame_sharded drive equals its
    replicated one, tests/test_sharded_driver.py); the port's dense
    DeviceResidentMapping agrees within 1e-4 m."""
    cfg, jm = jax_sharded_drm
    tm = run_scenario(tdd.ShardedDeviceResidentMapping(
        port(cfg), tmesh(), frame_sharded=frame_sharded))
    assert tm.frames_fused == jm.frames_fused == 7
    assert tm.local_indices == jm.local_indices
    assert tm.compactions > 0
    same_shards(jm.bank, tm.bank, 8)
    for getter in ("map_surfels", "active_surfels", "inactive_surfels"):
        a, b = getattr(tm, getter)(), getattr(jm, getter)()
        assert len(a["position"]) == len(b["position"]), getter
    np.testing.assert_array_equal(
        sorted_rows(tm.map_surfels())["update_times"],
        sorted_rows({k: np.asarray(v) for k, v in
                     jm.map_surfels().items()})["update_times"])
    m = tm.metrics()
    assert m["active_count"] > 0 and m["inactive_count"] > 0

    dense = run_scenario(tdd.DeviceResidentMapping(port(cfg), device="cpu"))
    close_rows(tm.map_surfels(), dense.map_surfels(), 1e-4, "dense")


def test_sharded_checkpoints_cross_packages(jax_sharded_drm, tmp_path):
    """A checkpoint (dense gathered rows) written by either package's
    sharded driver loads round-robin into the other's, and the resumed
    port mapper keeps fusing on the mesh."""
    from test_driver import feed_frame, render_plane
    cfg, jm = jax_sharded_drm
    jpath = str(tmp_path / "jax.npz")
    jm.save_checkpoint(jpath)
    tm = tdd.ShardedDeviceResidentMapping(port(cfg), tmesh())
    tm.load_checkpoint(jpath)
    assert tm.local_indices == jm.local_indices
    # round-robin scatter of the same rows: the JAX driver's own reload
    jm2 = jdd.ShardedDeviceResidentMapping(cfg, jsh.make_mesh(8, data=1))
    jm2.load_checkpoint(jpath)
    same_shards(jm2.bank, tm.bank, 8)

    # the reloaded banks write the same checkpoint in both packages
    tpath, j2path = str(tmp_path / "port.npz"), str(tmp_path / "jax2.npz")
    tm.save_checkpoint(tpath)
    jm2.save_checkpoint(j2path)
    a, b = np.load(j2path), np.load(tpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the port's checkpoint loads into both packages alike
    jm3 = jdd.ShardedDeviceResidentMapping(cfg, jsh.make_mesh(8, data=1))
    jm3.load_checkpoint(tpath)
    tm3 = tdd.ShardedDeviceResidentMapping(port(cfg), tmesh())
    tm3.load_checkpoint(tpath)
    same_shards(jm3.bank, tm3.bank, 8)

    pose = np.eye(4)
    pose[0, 3] = 2.8
    img, dep = render_plane(cfg, pose)
    feed_frame(tm, 8.0, pose, img, dep, is_keyframe=True)
    assert tm.frames_fused == jm.frames_fused + 1


def test_sharded_host_pool_matches_jax(tmp_path):
    """ShardedSurfelMapping (host pool) against JAX's: the pool slabs, the
    active rows (within 1e-5 m, update_times exact) and a checkpoint
    round trip; the port's dense SurfelMapping within 1e-4 m."""
    cfg = tiny_config(drift_free_poses=2, surfel_capacity=8192,
                      migration_buffer=1024, stats_interval=2,
                      compact_upload=False)
    jm = run_scenario(JShardedPool(cfg, jsh.make_mesh(8, data=1)))
    tm = run_scenario(ShardedSurfelMapping(port(cfg), tmesh()))
    assert tm.frames_fused == jm.frames_fused == 7
    assert tm.local_indices == jm.local_indices
    assert set(tm.pool.slabs) == set(jm.pool.slabs) != set()
    for k in tm.pool.slabs:
        close_rows(tm.pool.slabs[k], jm.pool.slabs[k], 1e-5, f"pool {k}")
    a = sorted_rows(tm.active_surfels(min_updates=1))
    b = sorted_rows({k: np.asarray(v) for k, v in
                     jm.active_surfels(min_updates=1).items()})
    close_rows(a, b, 1e-5, "active")
    np.testing.assert_array_equal(a["update_times"], b["update_times"])
    assert np.isfinite(tm.map_surfels()["position"]).all()
    assert tm.memory_usage_kb() > 0

    dense = run_scenario(SurfelMapping(port(cfg), device="cpu"))
    close_rows(tm.active_surfels(min_updates=1),
               dense.active_surfels(min_updates=1), 1e-4, "dense")

    path = str(tmp_path / "pool.npz")
    tm.save_checkpoint(path)
    j2 = JShardedPool(cfg, jsh.make_mesh(8, data=1))
    j2.load_checkpoint(path)
    t2 = ShardedSurfelMapping(port(cfg), tmesh())
    t2.load_checkpoint(path)
    assert t2.local_indices == j2.local_indices == tm.local_indices
    assert set(t2.pool.slabs) == set(j2.pool.slabs)
    close_rows(t2.active_surfels(min_updates=1),
               {k: np.asarray(v) for k, v in
                j2.active_surfels(min_updates=1).items()}, 1e-5, "reload")


def test_sharded_stereo_matches_jax():
    """The stereo-resident sharded drivers (the case of tests/test_sharded_
    driver.py::test_sharded_stereo_matches_dense_stereo) against the JAX
    sharded device-resident stereo drive within 1e-4 m."""
    from densesurfelmapping_tpu.config import CameraIntrinsics, \
        SurfelMapConfig
    from densesurfelmapping_tpu.io import synthetic
    from densesurfelmapping_tpu.models.stereo import StereoConfig as JSC
    from densesurfelmapping_tpu_torch.models.stereo import StereoConfig

    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                           cx=59.5, cy=27.5)
    cfg = SurfelMapConfig(camera=cam, surfel_capacity=8192, lane_align=8,
                          drift_free_poses=3)
    scene = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                            boxes=synthetic.default_scene().boxes,
                            max_depth=25.0, texture="multisine")
    kw = dict(max_disparity=64, min_disparity=1, radius=3)
    bf = cam.fx * 0.5
    pairs = []
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        rp = pose.copy()
        rp[:3, 3] += rp[:3, 0] * 0.5
        pairs.append((pose, scene.render(cfg, pose)[0],
                      scene.render(cfg, rp)[0]))

    def drive(m, scfg):
        m.enable_stereo(bf=bf, stereo_config=scfg)
        for i, (pose, li, ri) in enumerate(pairs):
            m.feed_pose(float(i), pose, is_keyframe=True)
            m.feed_stereo(float(i), li, ri)
        assert m.frames_fused == 4
        return {k: np.asarray(v) for k, v in m.map_surfels().items()}

    want = drive(jdd.ShardedDeviceResidentMapping(
        cfg, jsh.make_mesh(len(jax.devices()), data=1)), JSC(**kw))
    tc, mesh = port(cfg), tmesh()
    for name, m in (
            ("sharded_dev", tdd.ShardedDeviceResidentMapping(tc, mesh)),
            ("sharded_pool", ShardedSurfelMapping(tc, mesh)),
            ("dense", tdd.DeviceResidentMapping(tc, device="cpu"))):
        close_rows(drive(m, StereoConfig(**kw)), want, 1e-4, name)
