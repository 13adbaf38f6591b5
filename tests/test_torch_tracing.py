"""The port's tracer (`utils/timing.py`) on the CPU: host stages become
`dsm.*` profiler annotations and fill the window only while a profiler
records (or over a `timing.window()` block), from every thread of a
pipelined fleet; `timing.phase` does nothing on a CPU tensor; the ring's
arithmetic (cursor wrap, phases, bank programs and the gaps between
replays) on synthetic stamps.  The stamps themselves run on the card
(benchmark/tests/test_bench_tracing.py, the `card` test)."""

import contextlib

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import FIELDS
from densesurfelmapping_tpu_torch.io import synthetic
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.multi_session import (
    MultiSessionMapping)
from densesurfelmapping_tpu_torch.utils import timing

torch.set_num_threads(1)

CAM = tcfg.CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                            cx=59.5, cy=27.5)
CFG = tcfg.SurfelMapConfig(camera=CAM, surfel_capacity=4096,
                           max_keyframes=8, compact_interval=4)
FED = ("loop_path", "bfs", "pack", "stage", "launch", "compact")


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.default_scene()
    return [scene.render(CFG, p) + (p,)
            for p in synthetic.forward_trajectory(6, step=0.4)]


def names(prof) -> set:
    """The names of a profile's raw records (`prof.events()` parses each
    into an object: seconds more)."""
    return {e.name() for e in prof.profiler.kineto_results.events()}


def feed(drv, frames, i):
    img, dep, pose = frames[i]
    path = [k.cam_pose for k in drv.graph.keyframes]
    drv.feed_pose(float(i), pose, loop_path=path, is_keyframe=True)
    drv.feed_image(float(i), img)
    drv.feed_depth(float(i), dep)


def test_stages_under_a_profiler_annotate_and_fill_the_window(frames):
    drv = DeviceResidentMapping(CFG, device="cpu")
    feed(drv, frames, 0)
    with torch.profiler.profile() as prof:
        for i in (1, 2, 3):
            feed(drv, frames, i)
    feed(drv, frames, 4)          # finds no profiler: closes the window
    assert {"dsm." + s for s in FED} <= names(prof)
    w = timing.last_window()
    assert w["frames"] == 3
    assert set(FED) <= set(w["host_ms"])
    assert all(v > 0 for v in w["host_ms"].values())
    # the launch holds the step (on the CPU: run eagerly)
    assert w["host_ms"]["launch"] > w["host_ms"]["stage"]
    assert w["captures"] == {}             # no graph on the CPU
    # no card: no backlog, no stamps
    assert w["backlog_frames"] is None and w["device_ms"] == {}
    assert w["between_replays_ms"] is None
    # the driver's own totals count every frame, traced or not
    assert drv.timer.counts["launch"] == 5


def test_no_profiler_no_annotation_and_no_window(frames, monkeypatch):
    before = timing.last_window()
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(timing, "_Window",
                        lambda owner: opened.append("window"))
    drv = DeviceResidentMapping(CFG, device="cpu")
    for i in range(3):
        feed(drv, frames, i)
    assert opened == [] and timing._open is None
    assert timing.last_window() is before
    assert drv.timer.counts["loop_path"] == 2


def test_phase_is_a_no_op_on_the_cpu(frames, monkeypatch):
    """No stamp and no annotation on a CPU tensor, even under a profiler;
    a drive's bank is bitwise the same with the phases taken out."""
    def drive():
        drv = DeviceResidentMapping(CFG, device="cpu")
        for i in range(5):
            feed(drv, frames, i)
        return drv.bank

    traced = drive()
    with monkeypatch.context() as m:
        m.setattr(timing, "phase",
                  lambda name, device: contextlib.nullcontext())
        plain = drive()
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(traced, k), getattr(plain, k)), k

    def refuse(*_):
        raise AssertionError("a stamp on the CPU")

    monkeypatch.setattr(timing, "_stamp", refuse)
    x = torch.zeros(3)
    with torch.profiler.profile() as prof:
        with timing.phase("superpixel", x.device):
            x += 1
        with timing.replay_stamps("step", x.device):
            x += 1
    assert not any(n.startswith("dsm.") for n in names(prof))


@pytest.mark.parametrize("over,want", [
    (dict(max_disparity=24), ["stereo_aggregate", "stereo_wta"]),
    (dict(max_disparity=24, sgm_fused_census=False),
     ["stereo_volume", "stereo_scan", "stereo_wta"]),
    (dict(max_disparity=140), ["stereo_volume", "stereo_scan", "stereo_wta"])],
    ids=["fused", "materialized_narrow", "materialized_wide"])
def test_stereo_phases_by_route(monkeypatch, over, want):
    """The matcher's phases in order: the fused census route keeps its one
    `stereo_aggregate` phase; the materialized route splits it into the
    volume's build and B4's scans."""
    from densesurfelmapping_tpu_torch.models import stereo
    opened = []

    @contextlib.contextmanager
    def record(name, device):
        opened.append(name)
        yield

    monkeypatch.setattr(timing, "phase", record)
    g = torch.Generator().manual_seed(7)
    left = torch.randint(0, 256, (12, 160), generator=g).float()
    right = torch.roll(left, -5, 1)
    cfg = stereo.StereoConfig(aggregation="sgm", cost="census", **over)
    disp = stereo.disparity(left, right, cfg)
    assert opened == want
    assert (disp > 0).any()


def keys():
    return [("end", "end"), ("start", "step"), ("phase", "superpixel"),
            ("phase", "planefit"), ("phase", "fuse"), ("phase", "append"),
            ("start", "compact")]


def test_ring_wraps_and_phases_split_the_span():
    """Eight slots; stamps 5..12 written (slot i % 8 holds stamp i): a
    step replay, the gap to a compaction, the compaction, the gap to the
    next step's start, that step's first phase."""
    stamps = [(1, 100), (2, 103), (3, 110), (4, 130), (5, 160), (0, 170),
              (6, 190), (0, 240)]
    ring = np.zeros((8, 2), np.int64)
    for i, s in zip(range(5, 13), stamps):
        ring[i % 8] = s
    got = timing.ring_entries(ring, 5, 13)
    np.testing.assert_array_equal(got, np.array(stamps))
    # more stamps than slots: the newest eight
    np.testing.assert_array_equal(timing.ring_entries(ring, 0, 13), got)
    t = timing.phase_times(np.vstack([got, [[1, 300], [2, 301]]]), keys())
    # a start stamp opens its step's first phase: 100 -> 110 and 300 ->
    # 301 are superpixel
    assert t["phases"] == {"superpixel": 10 + 1, "planefit": 20,
                           "fuse": 30, "append": 10}
    assert t["programs"] == {"compact": 50}
    assert t["between"] == 20 + 60
    assert sum(t["phases"].values()) + sum(t["programs"].values()) \
        + t["between"] == t["span"] == 301 - 100


def test_window_counts_frames_and_captures(monkeypatch):
    """The window's counters: frames from the step replays, captures by
    kind as `fuse_step.capture` reports them; none outside a window."""
    timing.count_capture("programs")
    monkeypatch.setattr(timing, "_enabled", lambda: True)
    assert timing._recording()
    timing.count_capture("programs")
    timing.count_capture("programs")
    timing.count_frame(torch.device("cpu"))
    monkeypatch.setattr(timing, "_enabled", lambda: False)
    assert not timing._recording()
    timing.count_frame(torch.device("cpu"))
    w = timing.last_window()
    assert w["frames"] == 1 and w["captures"] == {"programs": 2}


def test_a_pipelined_fleet_fills_the_window_from_its_worker(frames):
    """The pipelined fleet runs each round's upload and dispatch on a
    worker thread, where the main thread's profiler does not record: those
    stages add to the window that the main thread's profiler opened, the
    worker closes nothing, and each round counts."""
    m = MultiSessionMapping(CFG, n_streams=2, device="cpu", pipelined=True)

    def fleet_round(i):
        img, dep, pose = frames[i]
        for k in range(2):
            m.feed_pose(k, float(i), pose, is_keyframe=True)
            m.feed_image(k, float(i), img)
            m.feed_depth(k, float(i), dep)
        m.step(flush=True)

    fleet_round(0)
    m.flush_rounds()
    with torch.profiler.profile() as prof:
        for i in (1, 2, 3):
            fleet_round(i)
        m.flush_rounds()          # round 3 lands inside the window
    fleet_round(4)                # finds no profiler: closes the window
    m.close()
    w = timing.last_window()
    assert w["frames"] == 3
    assert {"prep", "upload", "dispatch"} <= set(w["host_ms"])
    assert "dsm.prep" in names(prof)


def test_an_explicit_window_needs_no_profiler(frames, monkeypatch):
    """`timing.window()` fills a window over an untraced stretch: the
    stages' seconds and the frames, with no annotation."""
    def refuse(name):
        raise AssertionError(f"annotation {name} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    drv = DeviceResidentMapping(CFG, device="cpu")
    feed(drv, frames, 0)
    with timing.window():
        for i in (1, 2):
            feed(drv, frames, i)
    feed(drv, frames, 3)
    w = timing.last_window()
    assert w["frames"] == 2 and timing._open is None
    assert set(FED) - {"compact"} <= set(w["host_ms"])
