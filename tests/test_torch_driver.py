"""The port's drivers against the JAX package's DeviceResidentMapping on the
loop scenario of tests/test_device_driver.py: same window, frame count and
map (positions and normals within 1e-4, update_times exact); the host-pool
driver, the pipelined feed and a resumed JAX checkpoint give the same map."""

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.pipeline.device_driver import (
    DeviceResidentMapping as JaxDeviceResidentMapping)
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping
from densesurfelmapping_tpu_torch.pipeline.multi_session import (
    MultiSessionMapping)

from test_driver import tiny_config, render_plane, feed_frame
from test_device_driver import run_scenario, sorted_rows

torch.set_num_threads(1)

CFG = dict(drift_free_poses=2, surfel_capacity=8192, migration_buffer=1024,
           stats_interval=2, compact_interval=4)


def _same_map(a, b):
    a, b = sorted_rows(a), sorted_rows(b)
    assert len(a["position"]) == len(b["position"]) > 0
    np.testing.assert_allclose(a["position"], b["position"], atol=1e-4)
    np.testing.assert_allclose(a["normal"], b["normal"], atol=1e-4)
    np.testing.assert_array_equal(a["update_times"], b["update_times"])


@pytest.fixture(scope="module")
def drivers():
    ref = tiny_config(**CFG)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    pipelined = DeviceResidentMapping(cfg, device="cpu", pipelined=True)
    run_scenario(pipelined)
    pipelined.close()
    return dict(
        jax=run_scenario(JaxDeviceResidentMapping(ref)),
        dev=run_scenario(DeviceResidentMapping(cfg, device="cpu")),
        host=run_scenario(SurfelMapping(cfg, device="cpu")),
        pipelined=pipelined)


def test_same_window_and_frames(drivers):
    j = drivers["jax"]
    for name in ("dev", "host", "pipelined"):
        assert drivers[name].local_indices == j.local_indices, name
        assert drivers[name].frames_fused == j.frames_fused == 7, name


@pytest.mark.parametrize("name,other", [
    ("dev", "jax"), ("host", "jax"), ("pipelined", "jax"),
    ("host", "dev"), ("pipelined", "dev")])
def test_same_map(drivers, name, other):
    _same_map(drivers[name].map_surfels(), drivers[other].map_surfels())


def test_active_frozen_split_matches_jax(drivers):
    for getter in ("active_surfels", "inactive_surfels"):
        a = getattr(drivers["dev"], getter)()
        b = getattr(drivers["jax"], getter)()
        assert len(a["position"]) == len(b["position"]), getter


def test_jax_checkpoint_resumes_in_port(drivers, tmp_path):
    """A map saved by the JAX DeviceResidentMapping loads into the port, and
    one more frame fed to both gives the same map."""
    path = str(tmp_path / "jax.npz")
    drivers["jax"].save_checkpoint(path)
    ref = tiny_config(**CFG)
    j = JaxDeviceResidentMapping(ref)
    j.load_checkpoint(path)
    t = DeviceResidentMapping(tcfg.SurfelMapConfig.from_json(ref.to_json()),
                              device="cpu")
    t.load_checkpoint(path)
    assert t.local_indices == j.local_indices
    _same_map(t.map_surfels(), j.map_surfels())
    pose = np.eye(4)
    pose[0, 3] = 0.6
    img, dep = render_plane(ref, pose)
    for m in (j, t):
        feed_frame(m, 8.0, pose, img, dep, is_keyframe=True)
    assert t.frames_fused == j.frames_fused == 8
    _same_map(t.map_surfels(), j.map_surfels())


def test_port_checkpoint_roundtrip(drivers, tmp_path):
    path = str(tmp_path / "port.npz")
    dev = drivers["dev"]
    dev.save_checkpoint(path)
    m2 = DeviceResidentMapping(dev.config, device="cpu")
    m2.load_checkpoint(path)
    assert m2.local_indices == dev.local_indices
    _same_map(m2.map_surfels(), dev.map_surfels())


def test_driver_defaults_to_cuda():
    """With no device argument the drivers take the GPU: on a machine
    without one they raise instead of running on the CPU."""
    cfg = tcfg.SurfelMapConfig.from_json(tiny_config(**CFG).to_json())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    for cls in (SurfelMapping, DeviceResidentMapping):
        with pytest.raises((RuntimeError, AssertionError)):
            cls(cfg)


def test_keyframe_capacity_grows():
    """Outgrowing max_keyframes grows the window mask instead of crashing,
    with the same map as a driver sized right from the start; a loop_path
    arriving before the next fuse grows it on the warp path too."""
    def port_cfg(**kw):
        return tcfg.SurfelMapConfig.from_json(tiny_config(**kw).to_json())

    small = DeviceResidentMapping(port_cfg(max_keyframes=4,
                                           drift_free_poses=2), device="cpu")
    big = DeviceResidentMapping(port_cfg(max_keyframes=16,
                                         drift_free_poses=2), device="cpu")
    for i in range(10):
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i
        img, dep = render_plane(small.config, pose)
        for m in (small, big):
            feed_frame(m, float(i), pose, img, dep, is_keyframe=True)
    assert small.config.max_keyframes == 16
    _same_map(small.map_surfels(), big.map_surfels())

    m = DeviceResidentMapping(port_cfg(max_keyframes=4), device="cpu")
    img, dep = render_plane(m.config, np.eye(4))
    feed_frame(m, 0.0, np.eye(4), img, dep, is_keyframe=True)
    for i in range(1, 7):
        pose = np.eye(4)
        pose[0, 3] = 0.3 * i
        m.feed_pose(float(i), pose, is_keyframe=True)
    shift = np.eye(4)
    shift[1, 3] = 0.25
    before = bank_to_numpy(m.bank)
    assert (before["update_times"] > 0).sum() > 0
    m.feed_pose(7.0, shift @ m.graph.keyframes[-1].cam_pose,
                loop_path=[shift @ kf.cam_pose for kf in m.graph.keyframes])
    assert m.config.max_keyframes >= 7
    assert len(m._window_np) == m.config.max_keyframes
    np.testing.assert_allclose(bank_to_numpy(m.bank)["position"],
                               before["position"] + shift[:3, 3], atol=1e-5)


class OneStreamFleet:
    """Stream 0 of a one-stream MultiSessionMapping behind the solo
    drivers' feed calls (a round stepped after each, as the solo drivers
    fuse a frame once its pose, image and depth are in)."""

    def __init__(self, cfg, device):
        self.fleet = MultiSessionMapping(cfg, n_streams=1, device=device)

    def __getattr__(self, name):      # graph, dropped, pose_buffer, ...
        return getattr(self.fleet.sessions[0], name)

    def _fed(self, feed, *args, **kw):
        feed(0, *args, **kw)
        self.fleet.step(flush=True)

    def feed_pose(self, *args, **kw):
        self._fed(self.fleet.feed_pose, *args, **kw)

    def feed_image(self, *args):
        self._fed(self.fleet.feed_image, *args)

    def feed_depth(self, *args):
        self._fed(self.fleet.feed_depth, *args)


def test_unknown_reference_drops_the_pose():
    """A reference_index naming a keyframe never fed drops the pose and
    counts it (`dropped["unknown_reference"]`), in the solo drivers and in
    each session of the fleet, where the JAX driver raises IndexError; a
    new keyframe may still name itself, and the next pose is fused as if
    the dropped one never came."""
    ref = tiny_config(**CFG)
    jax_drv = JaxDeviceResidentMapping(ref)
    jax_drv.feed_pose(0.0, np.eye(4), is_keyframe=True)
    with pytest.raises(IndexError):
        jax_drv.feed_pose(1.0, np.eye(4), reference_index=3)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    img, dep = render_plane(cfg, np.eye(4))
    for cls in (SurfelMapping, DeviceResidentMapping, OneStreamFleet):
        m = cls(cfg, device="cpu")
        feed_frame(m, 0.0, np.eye(4), img, dep, is_keyframe=True)
        for ref_index, kf in ((3, False), (-1, False), (2, True)):
            m.feed_pose(1.0, np.eye(4), reference_index=ref_index,
                        is_keyframe=kf)
        assert m.dropped["unknown_reference"] == 3
        assert len(m.graph) == 1 and not m.pose_buffer
        m.feed_pose(1.0, np.eye(4), is_keyframe=True, reference_index=1)
        m.feed_image(1.0, img)
        m.feed_depth(1.0, dep)
        assert len(m.graph) == 2 and m.frames_fused == 2
