"""The benchmark's torch copies of the feeds against the port's originals:
the renderer against `io/synthetic.Scene.render`, the pose stream against
`io/stressfeed.make_seq00_like`; and the drive the replay mix describes."""

import dataclasses

import numpy as np
import torch

from benchmark import harness, traffic
from benchmark.tests.small import SMALL_CAMERA, SMALL_MIX
from densesurfelmapping_tpu_torch.config import CameraIntrinsics, kitti_config
from densesurfelmapping_tpu_torch.io import stressfeed, synthetic

REPLAY = harness.load_cell("kitti00_depth.replay").mix


def _scene(boxes):
    return synthetic.Scene(
        ground_y=traffic.GROUND_Y, wall_z=None, max_depth=traffic.MAX_DEPTH,
        boxes=[synthetic.Box(lo=lo, hi=hi) for lo, hi in boxes])


def test_render_matches_scene_render():
    """Bit for bit, with only each frame's visible boxes given to the
    torch copy and every box of the town to the original."""
    cfg = dataclasses.replace(kitti_config(),
                              camera=CameraIntrinsics(**SMALL_CAMERA))
    boxes = traffic.town(REPLAY)
    poses = traffic.route_poses(REPLAY)[[0, 57, 230, 1000, 2150, 4540]]
    right = poses.copy()
    right[:, :3, 3] += right[:, :3, 0] * traffic.BASELINE_M
    both = np.concatenate([poses, right])
    img, dep = traffic.render(traffic.padded_boxes(boxes, cfg.camera, both),
                              cfg.camera, both, "cpu")
    scene = _scene(boxes)
    for j, pose in enumerate(both):
        ref_img, ref_dep = scene.render(cfg, pose)
        assert np.array_equal(dep[j].numpy(), ref_dep)
        assert np.array_equal(img[j].numpy(), ref_img)
        assert (ref_dep > 0).mean() > 0.5


def test_replay_drive_is_kitti_00_sized():
    """4541 frames about 0.82 m apart (KITTI 00: 3.72 km), four loop
    closures, the first inside the warm-up, every keyframe's window
    local: no more revisit edges than a street driven a third time gives
    (two or three to each earlier pass)."""
    pos, _ = traffic.route_path(REPLAY)
    step = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    assert len(pos) == 4541 and abs(step.mean() - 0.82) < 0.01
    assert step.max() - step.min() < 1e-3
    s = traffic.stream_for(REPLAY, traffic.route_poses(REPLAY), 3)
    msgs = [s.next() for _ in range(REPLAY.route_frames)]
    closures = [i for i, m in enumerate(msgs) if m.closure]
    assert len(closures) == 4 and closures[0] < REPLAY.warmup_frames
    assert max(len(m.loop_edges) for m in msgs) <= REPLAY.covis_back + 8
    assert len(s.kf_est) == 2271
    # past the route's end the drive goes on along it
    assert s.next().frame_index == 0


def test_town_clears_the_route():
    for mix in (REPLAY, traffic.Mix(**SMALL_MIX)):
        boxes = traffic.town(mix)
        pos, _ = traffic.route_path(mix)
        near = np.stack([np.clip(pos[:, None, 0], boxes[:, 0, 0],
                                 boxes[:, 1, 0]),
                         np.clip(pos[:, None, 1], boxes[:, 0, 2],
                                 boxes[:, 1, 2])], -1)
        gap = np.hypot(near[..., 0] - pos[:, None, 0],
                       near[..., 1] - pos[:, None, 1])
        assert gap.min() > 0.5 * mix.clear_m


def test_pose_stream_matches_make_seq00_like():
    """On its circuit, whose one revisit comes after half the frames, the
    keyframes, edges and the closure (and everything after it) as it
    publishes them; drift left out, since the copy's drift is odometry's,
    in the camera's frame."""
    n = 80
    seq = stressfeed.make_seq00_like(n_frames=n, drift_yaw=0.0,
                                     drift_trans=0.0)
    gt = np.stack(stressfeed.circuit_trajectory(n, 8.0))
    mix = dataclasses.replace(REPLAY, route_frames=n, drift_yaw_rad=0.0,
                              drift_trans_m=0.0)
    s = traffic.PoseStream(mix, gt, (1.0, 1.0))
    for i, want in enumerate(seq.feed.messages):
        got = s.next()
        assert got.closure == (i == seq.loop_frame)
        assert np.allclose(got.pose, want.pose, atol=1e-12)
        assert got.is_keyframe == want.is_keyframe
        assert got.reference_index == want.reference_index
        assert sorted(got.loop_edges) == sorted(want.loop_edges)
        assert np.allclose(got.loop_path, want.loop_path, atol=1e-12)
    assert seq.loop_frame > 0


def test_drift_is_odometry_error_in_the_camera_frame():
    """Each frame's estimated motion is the true motion times the error
    (so the estimate moves as far as the car does, wherever it is), and a
    closure snaps the estimate back to ground truth."""
    gt = traffic.route_poses(REPLAY)
    s = traffic.stream_for(REPLAY, gt, 11)
    msgs = [s.next() for _ in range(2200)]
    delta = s.delta
    for i in (1, 500, 1999):
        moved = np.linalg.inv(msgs[i - 1].pose) @ msgs[i].pose
        true = np.linalg.inv(gt[i - 1]) @ gt[i]
        assert np.allclose(moved, true @ delta, atol=1e-9)
    before = msgs[2149].pose[:3, 3] - gt[2149][:3, 3]
    assert 1.0 < np.linalg.norm(before) < 100.0
    assert np.allclose(msgs[2150].pose, gt[2150])


def test_route_render_is_u8_and_f32():
    cfg = dataclasses.replace(kitti_config(),
                              camera=CameraIntrinsics(**SMALL_CAMERA))
    mix = dataclasses.replace(traffic.Mix(**SMALL_MIX), route_frames=6)
    fr = traffic.render_route(mix, cfg.camera, torch.device("cpu"),
                              stereo=True, chunk=4)
    assert fr.images.dtype == np.uint8 and fr.rights.dtype == np.uint8
    assert fr.images.shape == (6, 56, 120) and fr.depths is None
    assert not np.array_equal(fr.images[0], fr.rights[0])
    fr = traffic.render_route(mix, cfg.camera, torch.device("cpu"),
                              stereo=False, chunk=4)
    assert fr.depths.dtype == np.float32 and fr.rights is None
