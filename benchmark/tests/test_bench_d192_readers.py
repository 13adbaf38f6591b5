"""The readers that `kitti00_stereo_d192.replay_kerbside` adds: B4's roofline
(`metrics/b4_roofline.py`) on synthetic records, and the materialized
route's two phases (`device_ms.stereo_volume`, `device_ms.stereo_scan`) on
a synthetic window; None where the trace or the window holds nothing of
them."""

import pytest

from benchmark import harness, roofline, trace
from densesurfelmapping_tpu_torch.utils import timing

H100 = "NVIDIA H100 80GB HBM3"
D192 = "kitti00_stereo_d192.replay_kerbside"
SCAN = ("void (anonymous namespace)::scan_lines_kernel<(anonymous "
        "namespace)::VolumeCost, false>((anonymous namespace)::VolumeCost, "
        "float*, int, int, int, int, int, int, int, float, float, int, int)")
COMBINE = ("void (anonymous namespace)::combine_axis_kernel<false>(float "
           "const*, float*, unsigned long, unsigned long, int)")
LINE = "void (anonymous namespace)::axis_line_kernel<false>(...)"
BAND = "void (anonymous namespace)::axis_band_kernel<false>(...)"
PHASES = dict(stereo_volume=3.5, stereo_scan=11.25)


def record(cell, kernels=None):
    c = harness.load_cell(cell)
    rec = harness.RunRecord(c.name, c.mix, c.config, H100)
    if kernels is not None:
        rec.view = trace.DeviceView(1.0, 0.5, kernels, [], [], 3)
    return rec


def test_b4_roofline_of_the_wide_route():
    """A call is one `combine_axis_kernel` run; its need is the bf16
    volume read once and the f32 family written once (the scratch is not
    counted), over the time of both kernels' records."""
    read = harness.reader("b4_roofline")
    cells = 191 * 376 * 1241
    need = roofline.bound_s(cells * 2 + cells * 4, 0, roofline.peak(H100))
    assert need == roofline.bound_s(
        *roofline.sgm_work(376, 1241, 191)["axis_scan"], roofline.peak(H100))
    assert round(1e6 * need, 2) == 159.62
    # 4 calls (x and y families of two frames) in 16 needs' time
    got = read(record(D192, {SCAN: (4, 12 * need), COMBINE: (4, 4 * need)}))
    assert got == pytest.approx(25.0)


def test_b4_roofline_of_the_narrow_route():
    """The narrow route's kernels are one call each."""
    read = harness.reader("b4_roofline")
    need = roofline.bound_s(*roofline.sgm_work(376, 1241, 191)["axis_scan"],
                            roofline.peak(H100))
    got = read(record(D192, {LINE: (2, 2 * need), BAND: (2, 6 * need)}))
    assert got == pytest.approx(50.0)


@pytest.mark.parametrize("cell,kernels", [
    (D192, {"census_y_kernel": (4, 1e-3), "wta_scan_kernel": (4, 1e-3)}),
    (D192, None),
    ("kitti00_stereo.replay", {"census_x_kernel": (4, 1e-3)}),
    ("kitti00_depth.replay", {COMBINE: (4, 1e-3)})],
    ids=["no_b4_record", "untraced", "fused_route", "no_matcher"])
def test_b4_roofline_reads_none_without_b4(cell, kernels):
    assert harness.reader("b4_roofline")(record(cell, kernels)) is None


def test_phase_readers_on_a_synthetic_window(monkeypatch):
    """The two phases read what the window holds; a fused-route window
    (`stereo_aggregate`) and no window read None."""
    window = dict(frames=250, device_ms=dict(planefit=4.25, **PHASES))
    monkeypatch.setattr(timing, "last_window", lambda: window)
    for name, want in PHASES.items():
        assert harness.reader("device_ms." + name)(record(D192)) == want
    fused = dict(frames=250, device_ms=dict(stereo_aggregate=1.8))
    monkeypatch.setattr(timing, "last_window", lambda: fused)
    for name in PHASES:
        assert harness.reader("device_ms." + name)(record(D192)) is None
    monkeypatch.setattr(timing, "last_window", lambda: None)
    for name in PHASES:
        assert harness.reader("device_ms." + name)(record(D192)) is None


def test_the_cells_metrics():
    """The new cell reads the two phases and B4's roofline, and every
    per-layer metric of the stereo cell but the fused route's; the stereo
    cell reads none of the new ones."""
    d192 = {m["name"] for m in harness.load_cell(D192).per_layer}
    stereo = {m["name"] for m in
              harness.load_cell("kitti00_stereo.replay").per_layer}
    new = {"device_ms.stereo_volume", "device_ms.stereo_scan", "b4_roofline"}
    assert d192 == (stereo - {"sgm_roofline", "device_ms.stereo_aggregate"}
                    ) | new
    assert not stereo & new
    e2e = {m["name"] for m in harness.load_cell(D192).end_to_end}
    assert e2e == {"frames_per_s", "setup_s"}
