"""The plane-fit kernel's roofline reader (`metrics/planefit_roofline.py`):
its work at KITTI shapes, and the reader on synthetic records; None where
the trace holds no record of the kernel (a checkout whose plane fit has
none) or no trace at all."""

import importlib.util

import pytest

from benchmark import harness, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"
NAME = ("void (anonymous namespace)::planefit_kernel(float const*, int "
        "const*, float const*, float const*, float const*, ...)")
CELLS = ("kitti00_depth.replay", "kitti00_stereo.replay",
         "kitti00_stereo_d192.replay_kerbside")


def metric_module():
    path = harness.BENCH / "metrics" / "planefit_roofline.py"
    spec = importlib.util.spec_from_file_location("planefit_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(cell, kernels=None):
    c = harness.load_cell(cell)
    rec = harness.RunRecord(c.name, c.mix, c.config, H100)
    if kernels is not None:
        rec.view = trace.DeviceView(1.0, 0.5, kernels, [], [], 3)
    return rec


def test_planefit_work_at_kitti():
    """The raw 376 x 1241 image with the padded grid's 7,520 seeds: the
    depth and assignment planes and 20 seed floats each moved once; 12
    operations at every pixel, 68 more at each Huber inlier (57% of the
    pixels) and five Gauss-Newton steps of 42 at each inlier of a fitted
    seed (46%).  Bound by its bytes, 1.29 us on the H100 (its operations
    need 1.03)."""
    mod = metric_module()
    assert (mod.INLIER_SHARE, mod.FIT_SHARE) == (0.57, 0.46)
    nbytes, ops = mod.planefit_work(376, 1241, 7520)
    assert nbytes == 2 * 376 * 1241 * 4 + 7520 * 20 * 4 == 4_334_528
    assert ops == pytest.approx(376 * 1241 * (12 + 0.57 * 68 + 0.46 * 5 * 42))
    pk = roofline.peak(H100)
    need = roofline.bound_s(nbytes, ops, pk)
    assert need == nbytes / pk["bytes_per_s"]
    assert (round(1e6 * need, 2), round(1e6 * ops / pk["f32_per_s"], 2)) \
        == (1.29, 1.03)


@pytest.mark.parametrize("cell", CELLS)
def test_planefit_roofline_share(cell):
    """Every cell fits the raw 376 x 1241 image at sp 8, 7,520 seeds on
    the padded grid: four runs in 40 needs' time read 10%."""
    read = harness.reader("planefit_roofline")
    need = roofline.bound_s(*metric_module().planefit_work(376, 1241, 7520),
                            roofline.peak(H100))
    assert read(record(cell, {NAME: (4, 40 * need)})) == pytest.approx(10.0)


@pytest.mark.parametrize("kernels", [
    {"slic_huber_kernel": (4, 1e-3), "wta_scan_kernel": (4, 1e-3)}, None])
def test_planefit_roofline_reads_none_without_the_kernel(kernels):
    read = harness.reader("planefit_roofline")
    assert read(record("kitti00_stereo.replay", kernels)) is None
