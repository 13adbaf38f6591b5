"""Each metric's arithmetic on synthetic records, and the roofline byte
counts against the port's kernel table (PERF.md: B1-B6 at KITTI size,
3.35 TB/s)."""

import pytest

from benchmark import harness, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"


def record(**kw):
    cell = harness.load_cell("kitti00_depth.replay")
    rec = harness.RunRecord(cell.name, cell.mix, cell.config, H100)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_rate_is_all_frames_over_the_window():
    """Every frame over the whole window: a rate that falls through the
    window reads its mean over time, not a median of segments."""
    assert harness.reader("frames_per_s")(
        record(frames=3000, window_s=30.5)) == pytest.approx(3000 / 30.5)
    assert harness.reader("frames_per_s")(record()) is None


def test_host_spans_per_frame():
    rec = record(feed_s=[0.004, 0.006, 0.011])
    assert harness.reader("feed_host_ms_per_frame.replay")(rec) \
        == pytest.approx(7.0)
    assert harness.reader("feed_host_ms_per_frame.replay")(record()) is None
    assert harness.reader("setup_s")(record(setup_s=12.5)) == 12.5


def test_trace_busy_gaps_and_kernels():
    s = 10 ** 9
    dev = [(0, 2 * s // 10, "slic_assign_kernel"),
           (1 * s // 10, 3 * s // 10, "memcpy"),
           (6 * s // 10, 8 * s // 10, "slic_huber_kernel"),
           (int(1.2 * s), int(1.3 * s), "edge")]
    host = [(0, s, "bench.feed_frame"), (int(0.35 * s), int(0.5 * s),
                                         "cudaGraphLaunch")]
    v = trace.summarize(dev, host, 0, s)
    assert v.window_s == 1.0 and v.busy_s == pytest.approx(0.5)
    assert v.idle_gaps[0] == ("feed_frame (cudaGraphLaunch)",
                              pytest.approx(0.3))
    assert v.idle_gaps[1] == ("feed_frame", pytest.approx(0.2))
    assert v.kernel("slic_") == (2, pytest.approx(0.4))
    assert "edge" not in v.kernels
    rec = record(view=v)
    assert harness.reader("device_idle_share")(rec) == pytest.approx(50.0)


def test_roofline_share_of_slic_records():
    work = roofline.slic_work(376, 1280, 7520)
    pk = roofline.peak(H100)
    need = roofline.bound_s(*work["slic_assign"], pk)
    v = trace.DeviceView(1.0, 0.5, {"slic_assign_kernel": (3, 6 * need)},
                         [], [], 3)
    assert harness.reader("slic_roofline")(record(view=v)) \
        == pytest.approx(50.0)
    assert harness.reader("sgm_roofline")(record(view=v)) is None
    assert roofline.peak("some other card") is None


def test_byte_bounds_match_the_kernel_table():
    pk = roofline.peak(H100)
    us = lambda w: round(1e6 * roofline.bound_s(*w, pk), 2)  # noqa: E731
    slic = roofline.slic_work(376, 1280, 7520)
    sgm = roofline.sgm_work(376, 1241, 127)
    assert [us(slic[k]) for k in ("slic_assign", "slic_centroid",
                                  "slic_huber")] == [2.34, 1.78, 1.17]
    assert [us(sgm[k]) for k in ("axis_scan", "census_y", "census_x")] \
        == [106.14, 142.63, 71.87]
