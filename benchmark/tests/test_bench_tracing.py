"""The readers of the program's traced window (`benchmark/window.py`, the
`host_ms.*` and `device_ms.*` metrics) on a
synthetic window, None without one and with a program that has no such
tracer; on the card, the stamps of a captured graph read back through the
window."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_metrics import record
from densesurfelmapping_tpu_torch.utils import timing

WINDOW = dict(
    frames=250, captures={"steps": 0, "programs": 0}, stamps=1500,
    host_ms=dict(loop_path=4.5, bfs=2.25, pack=1.5, stage=0.25, launch=0.75,
                 migrate=2.5, fuse=2.75),
    backlog_frames=0.5,
    device_ms=dict(superpixel=0.5, planefit=4.25, fuse=0.5, append=0.25),
    programs_ms=dict(compact=0.125), between_replays_ms=3.5, span_ms=9.125)
STEREO = dict(stereo_aggregate=2.5, stereo_wta=8.0, depth_filter=1.5)
READS = {"host_ms.loop_path": 4.5, "host_ms.bfs": 2.25, "host_ms.pack": 1.5,
         "device_ms.superpixel": 0.5, "device_ms.planefit": 4.25,
         "device_ms.fuse": 0.5, "device_ms.append": 0.25}


def read(name):
    return harness.reader(name)(record())


def test_readers_on_a_synthetic_window(monkeypatch):
    monkeypatch.setattr(timing, "last_window", lambda: WINDOW)
    for name, want in READS.items():
        assert read(name) == want, name
    for name in STEREO:
        assert read("device_ms." + name) is None      # a depth-fed window
    stereo = dict(WINDOW, device_ms=dict(WINDOW["device_ms"], **STEREO))
    monkeypatch.setattr(timing, "last_window", lambda: stereo)
    for name, want in STEREO.items():
        assert read("device_ms." + name) == want


@pytest.mark.parametrize("program", ["no window", "no tracer"])
def test_readers_without_a_window(monkeypatch, program):
    """None where the run opened no window, and where the program has no
    `last_window` (a checkout from before the tracer): no raise."""
    if program == "no window":
        monkeypatch.setattr(timing, "last_window", lambda: None)
    else:
        monkeypatch.delattr(timing, "last_window")
    for name in list(READS) + ["device_ms." + s for s in STEREO]:
        assert read(name) is None, name


def test_entries_name_their_readers():
    spec = harness.load_cell("kitti00_stereo.replay")
    names = {m["name"] for m in spec.per_layer}
    assert set(READS) | {"device_ms." + s for s in STEREO} <= names
    depth = {m["name"] for m in
             harness.load_cell("kitti00_depth.replay").per_layer}
    assert set(READS) <= depth
    assert not depth & {"device_ms." + s for s in STEREO}


@pytest.mark.card
def test_stamps_of_a_captured_graph(card, monkeypatch):
    """Five replays of a graph with a start, two phases and an end stamp:
    twenty stamps in the window, whose phases and gaps sum to its span."""
    x = torch.zeros(1 << 20, device=card)

    def body():
        with timing.replay_stamps("step", card):
            with timing.phase("superpixel", card):
                x.add_(1.0)
            with timing.phase("fuse", card):
                x.mul_(0.5)

    body()                     # the ring and the library, outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    monkeypatch.setattr(timing, "_enabled", lambda: True)
    assert timing._recording()
    for _ in range(5):
        g.replay()
        timing.count_frame(card)
    monkeypatch.setattr(timing, "_enabled", lambda: False)
    assert not timing._recording()
    w = timing.last_window()
    assert w["frames"] == 5 and w["stamps"] == 20
    assert set(w["device_ms"]) == {"superpixel", "fuse"}
    assert all(v > 0 for v in w["device_ms"].values())
    assert w["between_replays_ms"] > 0 and w["backlog_frames"] >= 0
    assert sum(w["device_ms"].values()) + w["between_replays_ms"] \
        == pytest.approx(w["span_ms"], rel=1e-9)
