"""The stereo fleet's captured round (`parallel/multistream.py::
graphed_stereo_onebuf_step`, replayed by `MultiSessionMapping._run_round`
in stereo mode) on the CPU, where the StepGraph runs the round eagerly
through its static (B, 2 h w + 72 + P) payload, at the 120 x 56 config of
tests/test_torch_step_graph.py with the box matcher of the port's stereo
tests.  The CUDA graph itself is held to the eager round by chip_smoke.py's
`multi-stereo` phase.

Checked here: the graphed round is bitwise `batched_stereo_onebuf_step`
(banks and stats, two rounds); the fleet builds its stereo round, its
compaction and its warp again after `enable_stereo` (which drops the
depth-fed round), `add_session` and `remove_session`, each for the current
stream count and against the current banks."""

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
from densesurfelmapping_tpu_torch.parallel import multistream
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs
from densesurfelmapping_tpu_torch.pipeline.multi_session import (
    MultiSessionMapping)

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
REF = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      drift_free_poses=3, compact_interval=2)
CFG = tcfg.SurfelMapConfig.from_json(REF.to_json())
SCFG = StereoConfig(max_disparity=64, min_disparity=1, radius=3)
BASELINE = 0.5
BF = CAM.fx * BASELINE
FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update", "count")
SCENE = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                        boxes=synthetic.default_scene().boxes,
                        max_depth=25.0, texture="multisine")


def pose_of(i, k):
    pose = np.eye(4)
    pose[0, 3] = 0.15 * i + 0.2 * k
    return pose


def pair(pose):
    rp = pose.copy()
    rp[:3, 3] += rp[:3, 0] * BASELINE
    return SCENE.render(REF, pose)[0], SCENE.render(REF, rp)[0]


@pytest.fixture
def built(monkeypatch):
    """Every StepGraph built, in order."""
    made = []

    class Recorded(tfs.StepGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tfs, "StepGraph", Recorded)
    return made


def test_graphed_stereo_round_is_the_eager_round():
    """Two rounds of two streams through the graphed round's static
    payload: banks and stats bitwise those of batched_stereo_onebuf_step
    on the same payloads."""
    graphed = multistream.make_banks(CFG, 2, "cpu")
    eager = multistream.make_banks(CFG, 2, "cpu")
    step = multistream.graphed_stereo_onebuf_step(CFG, SCFG, True, graphed)
    n = tfs.stereo_onebuf_bytes(CFG)
    assert step.buf.shape == (2, n) and step.bank is graphed
    mask = np.zeros(CFG.max_keyframes, bool)
    for i in range(2):
        mask[i] = True
        rows = []
        for k in range(2):
            pose = pose_of(i, k)
            li, ri = pair(pose)
            rows.append(jstate.pack_stereo_with_aux(
                REF, jstate.pack_stereo_pair(REF, li, ri),
                jstate.pack_aux(pose, i, mask, BF)))
        payload = torch.from_numpy(np.stack(rows))
        got = step(payload)
        want = multistream.batched_stereo_onebuf_step(CFG, SCFG, True,
                                                      eager, payload)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert int(graphed.count.min()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(graphed, f), getattr(eager, f)), f


def test_stereo_fleet_rebuilds_its_graphs(built):
    """enable_stereo drops the depth-fed round; the stereo round is built
    at the next step for the current streams, and built again after
    add_session and remove_session, as are the compaction and the warp."""
    multi = MultiSessionMapping(CFG, n_streams=2, device="cpu")

    def round_(i, streams):
        for k in range(streams):
            pose = pose_of(i, k)
            li, ri = pair(pose)
            multi.feed_pose(k, float(i), pose, is_keyframe=True)
            multi.feed_stereo(k, float(i), li, ri)
        multi.step()

    multi.enable_stereo(bf=BF, stereo_config=SCFG)
    assert multi._round is None
    for i in range(2):
        round_(i, 2)
    assert multi.compactions == 1 and multi._compact_graph.bank is multi.banks
    assert multi.add_session() == 2
    assert multi._round is multi._compact_graph is multi._warp_graph is None
    round_(2, 3)
    shift = np.eye(4)
    shift[1, 3] = 0.5
    path = [shift @ kf.cam_pose for kf in multi.sessions[0].graph.keyframes]
    multi.feed_pose(0, 3.0, shift @ pose_of(3, 0), loop_path=path)
    assert multi._warp_graph.inputs[0].shape == (3, CFG.max_keyframes, 4, 4)
    multi.remove_session(0)
    assert multi._round is multi._compact_graph is multi._warp_graph is None
    round_(4, 2)
    n = tfs.stereo_onebuf_bytes(CFG)
    assert [tuple(g.buf.shape) for g in built] == [(2, n), (3, n), (2, n)]
    assert multi._round is built[-1] and built[-1].bank is multi.banks
    assert multi.banks.count.shape == (2,) and int(multi.banks.count.min()) > 0


def test_enable_stereo_frees_the_depth_fed_round(built):
    """A depth-fed round, then enable_stereo: the depth-fed graph is
    dropped and the next round builds the stereo one."""
    multi = MultiSessionMapping(CFG, n_streams=1, device="cpu")
    img, dep = SCENE.render(REF, pose_of(0, 0))
    multi.feed_pose(0, 0.0, pose_of(0, 0), is_keyframe=True)
    multi.feed_image(0, 0.0, img)
    multi.feed_depth(0, 0.0, dep)
    multi.step()
    assert multi._round is built[0]
    assert built[0].buf.shape == (1, tfs.onebuf_bytes(CFG))
    multi.enable_stereo(bf=BF, stereo_config=SCFG)
    assert multi._round is None
    li, ri = pair(pose_of(1, 0))
    multi.feed_pose(0, 1.0, pose_of(1, 0), is_keyframe=True)
    multi.feed_stereo(0, 1.0, li, ri)
    multi.step()
    assert multi._round is built[1]
    assert built[1].buf.shape == (1, tfs.stereo_onebuf_bytes(CFG))
