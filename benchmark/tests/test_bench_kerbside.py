"""The `kitti00_stereo_d192.replay_kerbside` cell: its traffic (the replay
drive through a kerbside town, whose near surfaces are matched past plane
127 of PSMNet's 192-disparity search), its configuration (the stereo cell's
with `max_disparity` 192), and the port's matcher against the reference's,
bitwise, on a crop of a rendered pair at the configuration's own stereo
block."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference import stereo as ref_stereo

CELL = "kitti00_stereo_d192.replay_kerbside"
KERBSIDE = harness.BENCH / "workloads" / "replay_kerbside.json"
REPLAY = harness.BENCH / "workloads" / "replay.json"
D192 = json.loads((harness.BENCH / "configs" /
                   "kitti00_stereo_d192.json").read_text())
STEREO = json.loads((harness.BENCH / "configs" /
                     "kitti00_stereo.json").read_text())


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(CELL)


def camera(c):
    from densesurfelmapping_tpu_torch.config import SurfelMapConfig
    return SurfelMapConfig.from_json(json.dumps(c.config["mapper"])).camera


def bf(c) -> float:
    return camera(c).fx * traffic.BASELINE_M


def test_kerbside_mix_is_replay_with_nearer_streets(cell):
    """The mix loads, and differs from `replay` only in the setbacks and
    the clearance (and its `why`)."""
    assert cell.traffic == "replay_kerbside" and cell.chips == 1
    assert cell.mix == traffic.Mix.load(KERBSIDE)
    got = json.loads(KERBSIDE.read_text())
    want = json.loads(REPLAY.read_text())
    assert {k for k in want if got[k] != want[k]} == {
        "why", "setback_m", "clear_m"}
    assert got["setback_m"] == [2.2, 6.0] and got["clear_m"] == 2.2


def test_kerbside_route_is_replays(cell):
    replay = traffic.Mix.load(REPLAY)
    assert np.array_equal(traffic.route_poses(cell.mix),
                          traffic.route_poses(replay))


def test_no_pose_within_1_5_m_of_a_box(cell):
    """The camera never comes nearer than 1.5 m to a building's footprint
    over the whole drive (nothing lies inside `fuse_near`)."""
    poses = traffic.route_poses(cell.mix)
    boxes = traffic.town(cell.mix)
    tx, tz = poses[:, 0, 3, None], poses[:, 2, 3, None]
    lo, hi = boxes[None, :, 0], boxes[None, :, 1]
    dx = np.maximum(0.0, np.maximum(lo[..., 0] - tx, tx - hi[..., 0]))
    dz = np.maximum(0.0, np.maximum(lo[..., 2] - tz, tz - hi[..., 2]))
    near = np.hypot(dx, dz).min()
    assert near > 1.5
    assert near > cell.config["mapper"]["fuse_near"]


def test_a_fifth_of_the_frames_hold_disparities_past_plane_127(cell):
    """Every 10th frame of the route, rendered on the CPU: at least 15%
    hold pixels whose true disparity lies at 128-190, the planes the
    fused route (D' < 128) never reaches."""
    poses = traffic.route_poses(cell.mix)[::10]
    boxes = traffic.town(cell.mix)
    cam = camera(cell)
    near = []
    for a in range(0, len(poses), 32):
        p = poses[a:a + 32]
        _, dep = traffic.render(traffic.padded_boxes(boxes, cam, p), cam,
                                p, "cpu")
        disp = torch.where(dep > 0, bf(cell) / dep.clamp_min(1e-9), 0.0)
        near += ((disp >= 128) & (disp <= 190)).flatten(1).any(1).tolist()
    assert len(near) == 455
    assert sum(near) >= 0.15 * len(near)


def test_d192_config_is_the_stereo_config_at_192():
    """`kitti00_stereo_d192` is the stereo cell's file with `max_disparity`
    192 and its prose; no width is cut."""
    assert {k for k in STEREO if D192[k] != STEREO[k]} == {
        "source", "deployment", "input", "assumed", "stereo"}
    assert D192["stereo"] == dict(STEREO["stereo"], max_disparity=192)
    assert D192["mapper"] == STEREO["mapper"]
    assert D192["reduced"] == ["sequence_frames"]
    assert {k for k in STEREO["assumed"]
            if D192["assumed"][k] != STEREO["assumed"][k]} == {"scene"}


def kerbside_crop(c, frame=200, rows=(170, 202), cols=(794, 1241)):
    """A (32, 447) crop of route frame `frame`'s rendered pair: a wall
    2.57-3.0 m away at the left image's crop columns 355-446 (true
    disparities 129-151), matched inside the crop in the right image."""
    cam = camera(c)
    pose = traffic.route_poses(c.mix)[frame:frame + 1]
    right = pose.copy()
    right[:, :3, 3] += right[:, :3, 0] * traffic.BASELINE_M
    boxes = traffic.town(c.mix)
    both = np.concatenate([pose, right])
    img, dep = traffic.render(traffic.padded_boxes(boxes, cam, both), cam,
                              both, "cpu")
    crop = (slice(*rows), slice(*cols))
    return img[0][crop], img[1][crop], dep[0][crop]


def test_port_matches_the_reference_past_plane_127(cell):
    """`models/stereo.depth_from_stereo` (the CPU twins of B4 and the WTA
    kernel) is bitwise the reference's depth on a kerbside crop at the
    configuration's own stereo block, and both match pixels of the near
    wall at disparities of 128 or more."""
    from densesurfelmapping_tpu_torch.models import stereo as port
    left, right, true_depth = kerbside_crop(cell)
    wall = (true_depth > 2.1) & (true_depth < 3.0)
    cols = wall.nonzero()[:, 1]
    assert wall.any() and cols.min() > 191
    st = cell.config["stereo"]
    b = float(np.float32(bf(cell)))
    got = port.depth_from_stereo(left, right, b, port.StereoConfig(**st))
    ref_disp = ref_stereo.disparity(left, right,
                                    ref_stereo.StereoConfig(**st))
    ref = torch.where(ref_disp > 0,
                      torch.tensor(b) / ref_disp.clamp_min(1e-6), 0.0)
    assert torch.equal(got, ref)
    got_disp = port.disparity(left, right, port.StereoConfig(**st))
    assert torch.equal(got_disp, ref_disp)
    assert (got_disp >= 128).sum() > 0 and (ref_disp >= 128).sum() > 0
