"""The captured per-frame steps (`pipeline/fuse_step.py::StepGraph` and the
drivers that replay them) on the CPU, where a StepGraph runs its step
eagerly through the same static input buffer, at the 120 x 56 config of
tests/test_pallas_slic.py.  The CUDA graphs themselves are held to the
eager steps by chip_smoke.py's `graph` phase.

Checked here: the StepGraph step is bitwise the eager one-buffer step and
within 1e-6 m of the JAX package's `jitted_fuse_frame_onebuf`; the drivers
build a new StepGraph wherever the JAX drivers re-jit (keyframe-capacity
growth, the fleet's session changes) and where the bank is replaced (a
checkpoint load), and their maps stay those of the JAX driver (within
1e-5 m, the bound of the fleet's and the CLI's drives against JAX), of an
uninterrupted drive and of solo drivers (bitwise); the sharded driver
builds its mesh steps as StepGraphs too (tests/test_torch_sharded_graph.py
holds them to the eager mesh programs)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core.state import SurfelBank as JBank
from densesurfelmapping_tpu.core.state import pack_aux, pack_frame_with_aux
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.pipeline import fuse_step as jfs
from densesurfelmapping_tpu.pipeline.device_driver import (
    DeviceResidentMapping as JaxDeviceResidentMapping)
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import SurfelBank, bank_to_numpy
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.pipeline import device_driver as tdd
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs
from densesurfelmapping_tpu_torch.pipeline.multi_session import (
    MultiSessionMapping)

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      compact_interval=4)
FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update")
TOL_M = 1e-6          # one step against the JAX step
DRIVE_TOL_M = 1e-5    # a drive against the JAX driver (the fleet's and
                      # the kitti/replay checks' bound; 1-2 ulp at 12 m)


def port(cfg):
    return tcfg.SurfelMapConfig.from_json(cfg.to_json())


def frames(n, step=0.4):
    scene = synthetic.default_scene()
    return [scene.render(CFG, p) + (p,)
            for p in synthetic.forward_trajectory(n, step=step)]


FRAMES = frames(10)


def feed(drv, i, kf_every=1):
    img, dep, pose = FRAMES[i]
    drv.feed_pose(float(i), pose, is_keyframe=(i % kf_every == 0))
    drv.feed_image(float(i), img)
    drv.feed_depth(float(i), dep)


@pytest.fixture
def built(monkeypatch):
    """Every StepGraph built, in order (the class the factories reach)."""
    made = []

    class Recorded(tfs.StepGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tfs, "StepGraph", Recorded)
    return made


def close_to_jax(rows, jrows, what, tol=TOL_M):
    assert len(rows["color"]) == len(jrows["color"]) > 0, what
    for k in FIELDS:
        got, want = rows[k], np.asarray(jrows[k])
        if k in ("update_times", "last_update"):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"{what} {k}")


def test_step_graph_is_the_onebuf_step_and_matches_jax():
    """(a) A StepGraph fed the packed payloads gives the eager step's bank
    and stats bitwise; both within 1e-6 m of jitted_fuse_frame_onebuf."""
    tc = port(CFG)
    graphed = SurfelBank.empty(tc.surfel_capacity, "cpu")
    eager = SurfelBank.empty(tc.surfel_capacity, "cpu")
    step = tfs.graphed_fuse_frame_onebuf(tc, graphed)
    assert step.buf.shape == (3 * 56 * 120 + 72 + 8,)
    assert step.bank is graphed
    jstep = jfs.jitted_fuse_frame_onebuf(CFG)
    jbank = JBank.empty(CFG.surfel_capacity)
    mask = np.ones(CFG.max_keyframes, bool)
    for i, (img, dep, pose) in enumerate(FRAMES[:3]):
        buf = pack_frame_with_aux(CFG, img, dep, pack_aux(pose, i, mask))
        got = step(torch.from_numpy(buf))
        assert torch.equal(step.buf, torch.from_numpy(buf))
        _, want = tfs.fuse_frame_onebuf(tc, eager, torch.from_numpy(buf))
        jbank, jstats = jstep(jbank, jnp.asarray(buf))
        assert set(got) == set(want) == set(jstats)
        for k in got:
            assert torch.equal(got[k], want[k]), k
            assert int(got[k]) == int(jstats[k]), k
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(graphed, k), getattr(eager, k)), k
    n = int(jbank.count)
    close_to_jax(bank_to_numpy(graphed),
                 {k: np.asarray(getattr(jbank, k))[:n] for k in FIELDS},
                 "graphed vs jax")


def test_step_graph_replays_on_a_cpu_bank_eagerly():
    """On a CPU bank there is nothing to capture: no graph is kept."""
    tc = port(CFG)
    bank = SurfelBank.empty(tc.surfel_capacity, "cpu")
    step = tfs.graphed_fuse_frame_packed(tc, bank)
    img, dep, pose = FRAMES[0]
    buf = pack_frame_with_aux(CFG, img, dep,
                              pack_aux(pose, 0, np.zeros(0, bool)))
    stats = step(torch.from_numpy(buf))
    assert step.graph is None and int(stats["n_new"]) > 0
    assert int(bank.count) == int(stats["n_new"])


def test_keyframe_growth_rebuilds_the_step(built):
    """(b) max_keyframes = 4 driven to 10 keyframes: the step is rebuilt
    for P = 8 and P = 16, against the current bank, and the map equals the
    JAX DeviceResidentMapping's under the same growth (rows in order,
    integers exact, floats within 1e-5 m)."""
    small = dataclasses.replace(CFG, max_keyframes=4)
    drv = tdd.DeviceResidentMapping(port(small), device="cpu")
    jdrv = JaxDeviceResidentMapping(small)
    for i in range(10):
        feed(drv, i)
        feed(jdrv, i)
    assert drv.config.max_keyframes == jdrv.config.max_keyframes == 16
    assert [g.buf.shape[0] - 3 * 56 * 120 - 72 for g in built] == [4, 8, 16]
    assert drv._fuse_graph is built[-1] and built[-1].bank is drv.bank
    assert drv.frames_fused == jdrv.frames_fused == 10
    assert drv.compactions > 0
    close_to_jax(bank_to_numpy(drv.bank), jdrv._rows_host(), "growth",
                 DRIVE_TOL_M)


def test_checkpoint_load_rebuilds_the_step(built, tmp_path):
    """(c) A checkpoint saved after 5 frames and loaded into a new driver:
    the step is rebuilt against the loaded bank, and 5 more frames give the
    bank of an uninterrupted 10-frame drive."""
    cfg = port(CFG)
    whole = tdd.DeviceResidentMapping(cfg, device="cpu")
    first = tdd.DeviceResidentMapping(cfg, device="cpu")
    for i in range(5):
        feed(whole, i, kf_every=2)
        feed(first, i, kf_every=2)
    path = str(tmp_path / "mid.npz")
    first.save_checkpoint(path)
    resumed = tdd.DeviceResidentMapping(cfg, device="cpu")
    old = resumed._fuse_graph
    resumed.load_checkpoint(path)
    assert resumed._fuse_graph is not old
    assert resumed._fuse_graph.bank is resumed.bank
    for i in range(5, 10):
        feed(whole, i, kf_every=2)
        feed(resumed, i, kf_every=2)
    assert resumed.frames_fused == whole.frames_fused == 10
    a, b = bank_to_numpy(resumed.bank), bank_to_numpy(whole.bank)
    assert len(a["color"]) == len(b["color"]) > 0
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fleet_session_changes_rebuild_the_round(built):
    """(d) add_session / remove_session rebuild the round's step for the
    new stream count; every session equals a solo driver fed its frames
    (no compaction in this drive, so the rows line up)."""
    cfg = port(dataclasses.replace(CFG, compact_interval=1000))
    multi = MultiSessionMapping(cfg, n_streams=2, device="cpu")
    solos = [tdd.DeviceResidentMapping(cfg, device="cpu") for _ in range(3)]

    def round_(pairs, i):
        """One round: (stream, solo twin) pairs; stream k fuses frame
        i + k."""
        for k, solo in pairs:
            img, dep, pose = FRAMES[i + k]
            for m, args in ((multi, (k,)), (solo, ())):
                m.feed_pose(*args, float(i), pose, is_keyframe=True)
                m.feed_image(*args, float(i), img)
                m.feed_depth(*args, float(i), dep)
        multi.step()

    for i in range(2):
        round_([(0, solos[0]), (1, solos[1])], i)
    assert multi.add_session() == 2 and multi._round is None
    for i in range(2, 4):
        round_([(0, solos[0]), (1, solos[1]), (2, solos[2])], i)
    multi.remove_session(0)
    assert multi._round is None
    round_([(0, solos[1]), (1, solos[2])], 4)
    assert [g.buf.shape[0] for g in built if g.buf.dim() == 2] == [2, 3, 2]
    assert multi._round is built[-1] and built[-1].bank is multi.banks
    for k, solo in enumerate(solos[1:]):
        got = multi.session_surfels(k, min_updates=0)
        want = bank_to_numpy(solo.bank)
        assert len(got["color"]) == len(want["color"]) > 0
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"session {k} {f}")


def test_sharded_driver_builds_no_step_graph(built):
    """(e) ShardedDeviceResidentMapping builds its mesh steps as StepGraphs
    over its ShardedBanks (the name is the one this test had while the
    sharded steps ran eagerly): the depth-fed step at construction, the
    stereo step at enable_stereo, each payload (1, n) bytes; the feed runs
    through the depth-fed one."""
    drv = tdd.ShardedDeviceResidentMapping(
        port(CFG), tsh.make_mesh(2, devices="cpu"))
    assert built == [drv._fuse_graph] and drv._fuse_graph.bank is drv.bank
    assert drv._fuse_graph.buf.shape == (1, 3 * 56 * 120 + 72 + 8)
    for i in range(3):
        feed(drv, i)
    drv.enable_stereo(bf=CAM.fx * 0.54)
    assert drv.frames_fused == 3 and not drv.graphed
    assert built == [drv._fuse_graph, drv._stereo_graph]
    assert drv._stereo_graph.buf.shape == (1, 2 * 56 * 120 + 72 + 8)
    assert drv._stereo_graph.bank is drv.bank
