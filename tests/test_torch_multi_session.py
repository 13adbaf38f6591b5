"""The port's MultiSessionMapping (`pipeline/multi_session.py`, the fuse step
under torch.func.vmap over the streams) against the JAX package's fleet and
against solo port drivers, on the CPU, in the style of
tests/test_multi_session.py.

Tolerances: positions within 1e-5 m of the JAX fleet and of solo drivers
(the JAX fleet's own tolerance, tests/test_multi_session.py:45-47), surfel
counts exact; the stereo fleet within 1e-4 m of the JAX stereo fleet;
pipelined == eager and checkpoint round trips bitwise.  Every vmap here
runs with PyTorch's batching-fallback warning made an error: an op without
a batching rule would loop over the streams."""

import warnings

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.pipeline.multi_session import (
    MultiSessionMapping as JaxMultiSessionMapping)
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.parallel import multistream
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.multi_session import (
    MultiSessionMapping)

from test_driver import tiny_config, render_plane

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def vmap_fallback_is_an_error():
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def port_cfg(ref):
    return tcfg.SurfelMapConfig.from_json(ref.to_json())


def fleet(ref, n, **kw):
    return MultiSessionMapping(port_cfg(ref), n_streams=n, device="cpu", **kw)


def feed(m, k, i, pose, ref_cfg, is_keyframe=True):
    img, dep = render_plane(ref_cfg, pose)
    m.feed_pose(k, float(i), pose, is_keyframe=is_keyframe)
    m.feed_image(k, float(i), img)
    m.feed_depth(k, float(i), dep)


def feed_and_step(m, ref_cfg, k_list, i, offsets=None):
    for k in k_list:
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i + (offsets[k] if offsets else 0.0)
        feed(m, k, i, pose, ref_cfg)
    m.step(flush=True)


def sorted_pos(rows):
    return np.sort(rows["position"], axis=0)


# ---------------------------------------------------------------------------
# two streams, five rounds: the JAX fleet, the port fleet, two solo drivers
# ---------------------------------------------------------------------------
REF = tiny_config(surfel_capacity=8192, compact_interval=1000)
OFFSETS = [0.0, 0.2]


@pytest.fixture(scope="module")
def fleets():
    jax_fleet = JaxMultiSessionMapping(REF, n_streams=2)
    port = fleet(REF, 2)
    solos = [DeviceResidentMapping(port_cfg(REF), device="cpu")
             for _ in range(2)]
    with warnings.catch_warnings():
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        warnings.filterwarnings("error", message=".*performance drop.*")
        for i in range(5):
            for k in range(2):
                pose = np.eye(4)
                pose[0, 3] = 0.4 * i + OFFSETS[k]
                img, dep = render_plane(REF, pose)
                for m in (jax_fleet, port):
                    m.feed_pose(k, float(i), pose, is_keyframe=True)
                    m.feed_image(k, float(i), img)
                    m.feed_depth(k, float(i), dep)
                solos[k].feed_pose(float(i), pose, is_keyframe=True)
                solos[k].feed_image(float(i), img)
                solos[k].feed_depth(float(i), dep)
            assert port.step_ready()
            port.step()
            jax_fleet.step()
    return dict(jax=jax_fleet, port=port, solos=solos)


@pytest.mark.parametrize("k", [0, 1])
def test_two_sessions_match_jax_fleet(fleets, k):
    got = fleets["port"].session_surfels(k, min_updates=1)
    want = fleets["jax"].session_surfels(k, min_updates=1)
    assert len(got["position"]) == len(want["position"]) > 0
    np.testing.assert_allclose(sorted_pos(got), sorted_pos(want), atol=1e-5)
    np.testing.assert_array_equal(np.sort(got["update_times"]),
                                  np.sort(want["update_times"]))


@pytest.mark.parametrize("k", [0, 1])
def test_two_sessions_match_solo_port_drivers(fleets, k):
    got = fleets["port"].session_surfels(k, min_updates=1)
    rows = fleets["solos"][k]._rows_host()
    live = rows["update_times"] > 0
    assert len(got["position"]) == int(live.sum()) > 0
    np.testing.assert_allclose(sorted_pos(got),
                               np.sort(rows["position"][live], axis=0),
                               atol=1e-5)


def test_session_metrics_match_jax(fleets):
    assert fleets["port"].session_metrics() == fleets["jax"].session_metrics()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_across_packages(fleets, tmp_path, writer):
    """A checkpoint written by either package's fleet loads into the
    other's and gives the same rows and session state."""
    path = str(tmp_path / "s1.npz")
    fleets[writer].save_checkpoint(1, path)
    reader = "port" if writer == "jax" else "jax"
    fresh = (fleet(REF, 2) if reader == "port"
             else JaxMultiSessionMapping(REF, n_streams=2))
    fresh.load_checkpoint(1, path)
    a = fresh.session_surfels(1)
    b = fleets[writer].session_surfels(1)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert fresh.sessions[1].frames_fused == 5
    np.testing.assert_array_equal(fresh.sessions[1].window,
                                  fleets[writer].sessions[1].window)


def test_checkpoint_schema_matches_jax(fleets, tmp_path):
    fleets["port"].save_checkpoint(0, str(tmp_path / "p.npz"))
    fleets["jax"].save_checkpoint(0, str(tmp_path / "j.npz"))
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    for key in p.files:
        assert p[key].dtype == j[key].dtype, key
        assert p[key].shape == j[key].shape, key


# ---------------------------------------------------------------------------
# the batched modules
# ---------------------------------------------------------------------------
def test_make_banks_dead_rows_and_place_rows():
    cfg = port_cfg(tiny_config(surfel_capacity=64))
    banks = multistream.make_banks(cfg, 3, "cpu")
    assert banks.position.shape == (3, 64, 3)
    assert banks.count.shape == (3,) and banks.count.dtype == torch.int32
    assert (banks.last_update == -1).all() and (banks.update_times == 0).all()
    rng = np.random.default_rng(0)
    rows = {"position": rng.normal(size=(5, 3)).astype(np.float32),
            "normal": rng.normal(size=(5, 3)).astype(np.float32),
            "color": rng.uniform(0, 255, 5).astype(np.float32),
            "size": rng.uniform(0, 1, 5).astype(np.float32),
            "weight": rng.uniform(0, 1, 5).astype(np.float32),
            "update_times": np.arange(1, 6, dtype=np.int32),
            "last_update": np.arange(5, dtype=np.int32)}
    multistream.place_rows(banks, 1, rows, 5)
    assert banks.count.tolist() == [0, 5, 0]
    np.testing.assert_array_equal(banks.position[1, :5].numpy(),
                                  rows["position"])
    assert (banks.last_update[1, 5:] == -1).all()
    assert (banks.last_update[0] == -1).all()
    with pytest.raises(ValueError, match="capacity"):
        multistream.place_rows(banks, 0, rows, 65)


def test_batched_fuse_step_matches_jax_batched_step():
    """multistream.batched_fuse_step (the compact step of every stream in
    one vmap) against the JAX package's jit(vmap(fuse_frame_compact)) on
    the same stacked frames: stats exact, banks within 1e-5 m."""
    from densesurfelmapping_tpu.parallel import multistream as jms
    from densesurfelmapping_tpu.core.state import compact_frame

    ref = tiny_config(surfel_capacity=4096)
    cfg = port_cfg(ref)
    frames = []
    for k in range(3):
        pose = np.eye(4)
        pose[0, 3], pose[2, 3] = 0.3 * k, 0.1 * k
        ci, cd = compact_frame(ref, *render_plane(ref, pose))
        frames.append((ci, cd, pose, k))
    jbanks, jstats = jms.batched_fuse_step(ref)(
        jms.make_banks(ref, 3), *jms.stack_frames(frames))
    banks = multistream.make_banks(cfg, 3, "cpu")
    out, stats = multistream.batched_fuse_step(cfg)(
        banks, *multistream.stack_frames(frames, "cpu"))
    assert out is banks
    for key in jstats:
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)
    np.testing.assert_array_equal(banks.count.numpy(),
                                  np.asarray(jbanks.count))
    for k in range(3):
        n = int(banks.count[k])
        np.testing.assert_allclose(banks.position[k, :n].numpy(),
                                   np.asarray(jbanks.position)[k, :n],
                                   atol=1e-5)


def test_batched_compact_is_a_stable_partition_per_stream():
    cfg = port_cfg(tiny_config(surfel_capacity=16))
    banks = multistream.make_banks(cfg, 2, "cpu")
    banks.count.copy_(torch.tensor([6, 4], dtype=torch.int32))
    banks.update_times[0, :6] = torch.tensor([1, 0, 2, 0, 3, 4])
    banks.update_times[1, :4] = torch.tensor([0, 5, 0, 6])
    banks.color[0, :6] = torch.arange(6.0)
    banks.color[1, :4] = torch.arange(10.0, 14.0)
    multistream.batched_compact(banks)
    assert banks.count.tolist() == [4, 2]
    assert banks.color[0, :4].tolist() == [0.0, 2.0, 4.0, 5.0]
    assert banks.color[1, :2].tolist() == [11.0, 13.0]
    assert banks.update_times[1, :2].tolist() == [5, 6]
    assert (banks.update_times[0, 4:] == 0).all()


# ---------------------------------------------------------------------------
# the serving lifecycle, as tests/test_multi_session.py holds the JAX fleet
# ---------------------------------------------------------------------------
def test_flush_pads_missing_sessions():
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 2)
    feed(multi, 0, 0, np.eye(4), ref)
    assert not multi.step_ready()
    with pytest.raises(RuntimeError):
        multi.step()
    assert multi.step(flush=True) == 1
    assert multi.sessions[0].frames_fused == 1
    assert multi.sessions[1].frames_fused == 0
    assert int(multi.banks.count[1]) == 0
    assert int(multi.banks.count[0]) > 0


def test_add_remove_session_mid_run():
    ref = tiny_config(surfel_capacity=8192, compact_interval=1000)
    multi = fleet(ref, 2)
    for i in range(3):
        feed_and_step(multi, ref, [0, 1], i)
    before1 = sorted_pos(multi.session_surfels(1))
    k2 = multi.add_session()
    assert k2 == 2 and multi.n_streams == 3
    for i in range(3, 5):
        feed_and_step(multi, ref, [0, 1, 2], i)
    assert multi.sessions[2].frames_fused == 2
    assert int(multi.banks.count[2]) > 0
    n0 = len(multi.session_map_surfels(0)["position"])
    rows = multi.remove_session(0)
    assert len(rows["position"]) == n0
    assert multi.n_streams == 2 and multi.banks.position.shape[0] == 2
    after = sorted_pos(multi.session_surfels(0))
    assert len(after) >= len(before1)
    feed_and_step(multi, ref, [0, 1], 5)
    assert multi.sessions[0].frames_fused == 6


def test_session_export_matches_solo_driver(tmp_path):
    ref = tiny_config(surfel_capacity=8192, compact_interval=1000)
    multi = fleet(ref, 2)
    solo = DeviceResidentMapping(port_cfg(ref), device="cpu")
    for i in range(5):
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i
        for k in range(2):
            feed(multi, k, i, pose, ref)
        multi.step()
        img, dep = render_plane(ref, pose)
        solo.feed_pose(float(i), pose, is_keyframe=True)
        solo.feed_image(float(i), img)
        solo.feed_depth(float(i), dep)
    a = multi.session_map_surfels(0)
    b = solo.map_surfels()
    assert len(a["position"]) == len(b["position"])
    np.testing.assert_allclose(sorted_pos(a), sorted_pos(b), atol=1e-5)
    n_cloud = multi.save_cloud(0, str(tmp_path / "s0.pcd"))
    n_mesh = multi.save_mesh(0, str(tmp_path / "s0.ply"))
    assert n_cloud == len(a["position"]) and n_mesh > 0
    assert n_cloud == solo.save_cloud(str(tmp_path / "solo.pcd"))


def test_session_checkpoint_roundtrip(tmp_path):
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 2)
    for i in range(4):
        feed_and_step(multi, ref, [0, 1], i, offsets=[0.0, 0.2])
    path = str(tmp_path / "s1.npz")
    multi.save_checkpoint(1, path)
    fresh = fleet(ref, 2)
    fresh.load_checkpoint(1, path)
    np.testing.assert_allclose(sorted_pos(fresh.session_surfels(1)),
                               sorted_pos(multi.session_surfels(1)),
                               atol=1e-6)
    assert fresh.sessions[1].frames_fused == 4
    feed_and_step(fresh, ref, [1], 4, offsets=[0.0, 0.2])
    assert fresh.sessions[1].frames_fused == 5


def test_checkpoint_restore_dead_rows_match_empty(tmp_path):
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 1)
    feed(multi, 0, 0, np.eye(4), ref)
    multi.step()
    p = str(tmp_path / "s.npz")
    multi.save_checkpoint(0, p)
    fresh = fleet(ref, 1)
    fresh.load_checkpoint(0, p)
    n = int(fresh.banks.count[0])
    assert n > 0
    assert (fresh.banks.last_update[0, n:] == -1).all()


def test_pump_flush_timeout_and_drop_counters():
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 2, flush_timeout=0.05)
    pose = np.eye(4)
    img, dep = render_plane(ref, pose)
    feed(multi, 0, 0, pose, ref)
    t_arr = multi.sessions[0].pose_buffer[0][3]
    assert multi.pump(now=t_arr + 0.01) == 0
    assert multi.pump(now=t_arr + 1.0) == 1
    assert multi.sessions[0].frames_fused == 1
    multi.feed_image(0, 0.5, img)           # no pose will ever match 0.5
    multi.feed_pose(0, 1.0, pose, is_keyframe=False)
    multi.feed_image(0, 1.0, img)
    multi.feed_depth(0, 1.0, dep)
    multi.step(flush=True)
    m = multi.session_metrics()
    assert m[0]["dropped_images"] == 1
    assert m[0]["frames_fused"] == 2
    assert 0.0 < m[0]["saturation"] < 1.0
    assert m[0]["surfels_dropped"] == 0


def test_saturation_reports_overflow_drops():
    ref = tiny_config(surfel_capacity=64, compact_interval=2)
    multi = fleet(ref, 1)
    for i in range(4):
        feed_and_step(multi, ref, [0], i)
    m = multi.session_metrics()[0]
    assert m["surfels_dropped"] > 0
    assert m["saturation"] > 0.5
    assert multi.compactions == 2


def test_multi_session_loop_warp():
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 2)
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 0.4 * i
        for k in range(2):
            feed(multi, k, i, pose, ref)
        multi.step()
    before = [multi.session_surfels(k)["position"].copy() for k in range(2)]
    s0 = multi.sessions[0]
    shift = np.eye(4)
    shift[1, 3] = 1.0
    loop_path = [shift @ kf.cam_pose for kf in s0.graph.keyframes]
    multi.feed_pose(0, 3.0, shift, is_keyframe=False, loop_path=loop_path)
    after0 = multi.session_surfels(0)["position"]
    after1 = multi.session_surfels(1)["position"]
    np.testing.assert_allclose(after0[:, 1], before[0][:, 1] + 1.0,
                               atol=1e-4)
    np.testing.assert_array_equal(after1, before[1])


def _drive_fleet(m, ref, n_frames=6):
    for i in range(n_frames):
        for k in range(2):
            pose = np.eye(4)
            pose[0, 3] = 0.4 * i + 0.2 * k
            feed(m, k, i, pose, ref)
        m.step()
    # a loop correction for stream 0 while a pipelined round is in flight:
    # the warp must flush it first
    shift = np.eye(4)
    shift[1, 3] = 0.3
    g = m.sessions[0].graph
    loop_path = [shift @ kf.cam_pose for kf in g.keyframes]
    last = np.eye(4)
    last[0, 3] = 0.4 * (n_frames - 1)
    m.feed_pose(0, float(n_frames), shift @ last, loop_path=loop_path,
                is_keyframe=False)
    return m


def test_pipelined_rounds_match_eager():
    ref = tiny_config(surfel_capacity=8192, compact_interval=3)
    eager = _drive_fleet(fleet(ref, 2), ref)
    piped = _drive_fleet(fleet(ref, 2, pipelined=True), ref)
    piped.flush_rounds()
    assert piped.rounds == eager.rounds
    for k in range(2):
        a = piped.session_surfels(k, min_updates=1)
        b = eager.session_surfels(k, min_updates=1)
        assert len(a["position"]) == len(b["position"])
        oa, ob = np.lexsort(a["position"].T), np.lexsort(b["position"].T)
        for key in a:
            np.testing.assert_array_equal(a[key][oa], b[key][ob],
                                          err_msg=f"stream {k} {key}")
    assert piped.session_metrics() == eager.session_metrics()
    piped.close()


def test_keyframe_capacity_grows_the_payload():
    """More keyframes than max_keyframes: the window mask, and with it the
    aux block of every payload row, doubles; the fleet keeps fusing."""
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000,
                      max_keyframes=4)
    multi = fleet(ref, 2)
    for i in range(6):
        feed_and_step(multi, ref, [0, 1], i, offsets=[0.0, 0.2])
    assert multi.config.max_keyframes == 8
    assert all(len(s.window) == 8 for s in multi.sessions)
    assert [s.frames_fused for s in multi.sessions] == [6, 6]


def test_session_trajectory_export(tmp_path):
    ref = tiny_config(surfel_capacity=4096, compact_interval=1000)
    multi = fleet(ref, 1)
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 0.25 * i
        feed(multi, 0, i, pose, ref)
        multi.step()
    out = tmp_path / "s0.txt"
    assert multi.save_trajectory(0, str(out)) == 3
    rows = np.loadtxt(str(out))
    assert rows.shape == (3, 12)
    np.testing.assert_allclose(rows[1].reshape(3, 4)[0, 3], 0.25, atol=1e-8)
    with pytest.raises(ValueError, match="format"):
        multi.save_trajectory(0, str(out), fmt="xyz")


def test_invalid_pose_dropped_per_session():
    multi = fleet(tiny_config(surfel_capacity=4096), 1)
    bad = np.eye(4)
    bad[1, 3] = np.inf
    multi.feed_pose(0, 0.0, bad, is_keyframe=True)
    assert multi.sessions[0].dropped["invalid_pose"] == 1
    assert len(multi.sessions[0].graph) == 0


def test_fleet_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiSessionMapping(port_cfg(tiny_config(surfel_capacity=64)), 1)


# ---------------------------------------------------------------------------
# the stereo fleet (120 x 56): the JAX stereo fleet over 3 rounds
# ---------------------------------------------------------------------------
def _stereo_setup():
    from densesurfelmapping_tpu.config import (CameraIntrinsics,
                                               SurfelMapConfig)
    from densesurfelmapping_tpu.io import synthetic
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                           cx=59.5, cy=27.5)
    cfg = SurfelMapConfig(camera=cam, surfel_capacity=8192, lane_align=8,
                          drift_free_poses=3, compact_interval=1000)
    scene = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                            boxes=synthetic.default_scene().boxes,
                            max_depth=25.0, texture="multisine")
    return cfg, scene


def test_stereo_fleet_matches_jax_stereo_fleet():
    from densesurfelmapping_tpu.models.stereo import StereoConfig as JSC
    from densesurfelmapping_tpu_torch.models.stereo import StereoConfig

    ref, scene = _stereo_setup()
    kw = dict(max_disparity=64, min_disparity=1, radius=3)
    baseline = 0.5
    bf = ref.camera.fx * baseline
    jax_fleet = JaxMultiSessionMapping(ref, n_streams=2)
    jax_fleet.enable_stereo(bf=bf, stereo_config=JSC(**kw))
    port = fleet(ref, 2)
    port.enable_stereo(bf=bf, stereo_config=StereoConfig(**kw))
    with pytest.raises(RuntimeError, match="stereo mode"):
        port.feed_depth(0, 0.0, np.zeros((56, 120)))
    for i in range(3):
        for k in range(2):
            pose = np.eye(4)
            pose[0, 3] = 0.3 * i + OFFSETS[k]
            rp = pose.copy()
            rp[:3, 3] += rp[:3, 0] * baseline
            li, _ = scene.render(ref, pose)
            ri, _ = scene.render(ref, rp)
            for m in (jax_fleet, port):
                m.feed_pose(k, float(i), pose, is_keyframe=True)
                m.feed_stereo(k, float(i), li, ri)
        port.step()
        jax_fleet.step()
    for k in range(2):
        got = port.session_surfels(k)
        want = jax_fleet.session_surfels(k)
        assert len(got["position"]) == len(want["position"]) > 50
        np.testing.assert_allclose(sorted_pos(got), sorted_pos(want),
                                   atol=1e-4)


def test_stereo_fleet_flush_pad_is_noop():
    from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
    ref, scene = _stereo_setup()
    multi = fleet(ref, 2)
    multi.enable_stereo(bf=ref.camera.fx * 0.5, stereo_config=StereoConfig(
        max_disparity=64, min_disparity=1, radius=3))
    with pytest.raises(RuntimeError, match="enable_stereo"):
        fleet(ref, 1).feed_stereo(0, 0.0, np.zeros((56, 120)),
                                  np.zeros((56, 120)))
    pose = np.eye(4)
    rp = pose.copy()
    rp[0, 3] += 0.5
    li, _ = scene.render(ref, pose)
    ri, _ = scene.render(ref, rp)
    multi.feed_pose(0, 0.0, pose, is_keyframe=True)
    multi.feed_stereo(0, 0.0, li, ri)
    assert not multi.step_ready()
    multi.step(flush=True)
    counts = multi.banks.count.tolist()
    assert counts[0] > 30
    assert counts[1] == 0
