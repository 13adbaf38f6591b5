"""The launch plans of the SGM kernels B4, B5 and B6
(`ops/cuda/sgm.py::axis_plan`, `census_y_plan`, `census_x_plan`): plain
Python, checked here on the CPU for the shapes the card runs (KITTI 376 x
1241 with 127 disparities, the odd crops of chip_smoke.py) and odd H and
W."""

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu_torch.ops import sgm as tsgm
from densesurfelmapping_tpu_torch.ops.cuda import sgm as ksgm

# (H, W, n_d): KITTI, chip_smoke.py's crop and strip, odd and tiny shapes
SHAPES = [(376, 1241, 127), (61, 97, 37), (24, 1800, 37), (17, 33, 7),
          (5, 3, 128), (1, 1, 1), (377, 1239, 100)]
# bf16 (376, 1241, 128): the first halves' totals, as in PERF.md
KITTI_SLAB_BYTES = 119_453_696


def _covered_once(ranges, n):
    hits = np.zeros(n, np.int64)
    for r in ranges:
        hits[list(r)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("hwd", SHAPES)
def test_census_y_plan_covers_and_fits(hwd, g, sms):
    H, W, n_d = hwd
    plan = ksgm.census_y_plan(H, W, n_d, g, sms)
    bands = plan.bands(W)
    # one block per SM at most: the cooperative launch needs all resident
    assert 1 <= plan.nbands and 2 * plan.nbands <= max(sms, 2)
    assert len(bands) == plan.nbands and all(len(b) >= 1 for b in bands)
    assert _covered_once(bands, W)
    assert all(len(b) <= plan.ncols for b in bands)
    assert plan.smem <= ksgm.MAX_SMEM
    # the warps of a block cover its band: warp w owns [w cpw, w cpw + cpw)
    warps = plan.threads // 32
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 640
    assert _covered_once([range(w * plan.cpw, min(plan.ncols,
                                                  (w + 1) * plan.cpw))
                          for w in range(warps)], plan.ncols)
    # the forward scan's first half [0, mid) and the backward scan's
    # [mid, H) cover the image's rows once, and so do their second halves
    fwd, bwd = range(0, plan.mid), range(plan.mid, H)
    assert _covered_once([fwd, bwd], H)
    assert abs(len(fwd) - len(bwd)) <= 1
    assert plan.slab_shape == (H, W, 128)
    assert plan.slab_bytes == 2 * H * W * 128
    # per orientation, band and side: g rings of 4 rows of 128 tagged
    # carries (8 bytes); then one u32 row counter per band
    assert plan.halo_bytes == (2 * plan.nbands * 2 * g * 4 * 128 * 8
                               + 2 * plan.nbands * 4)


@pytest.mark.parametrize("hwd", SHAPES)
def test_census_x_plan_covers_and_fits(hwd):
    H, W, n_d = hwd
    plan = ksgm.census_x_plan(H, W, n_d)
    assert plan.blocks == H and plan.threads == 64
    assert plan.smem <= ksgm.MAX_SMEM
    # the forward warp's first half [0, mid) and the backward warp's
    # [mid, W) cover the row once, and so do their second halves
    fwd, bwd = range(0, plan.mid), range(plan.mid, W)
    assert _covered_once([fwd, bwd], W)
    assert abs(len(fwd) - len(bwd)) <= 1
    assert plan.slab_shape == (H, W, 128)
    assert plan.slab_bytes == 2 * H * W * 128


def test_kitti_plans_as_documented():
    """The KITTI geometry PERF.md describes: 66 bands of 19 columns per
    orientation (one block per SM of an H100), a warp per column, 133,568 B
    of shared memory per block (8 paths), meeting at row 188; B6 meets at
    column 620; each kernel's bf16 slab is 119 MB."""
    y = ksgm.census_y_plan(376, 1241, 127, 3)
    assert (y.nbands, y.ncols, y.cpw, y.threads) == (66, 19, 1, 608)
    assert y.slab_bytes == KITTI_SLAB_BYTES and y.mid == 188
    # two row-state buffers of 3 x 21 x 128 f32, two chunks of 8 census
    # rows of 4 x 37 + 19 ints, four rows of the other scan's totals (19 x
    # 128 bf16) and of out (128 x 19 f32)
    assert y.smem == (4 * (2 * 3 * 21 * 128 + 2 * 8 * (4 * 37 + 19))
                      + 4 * 19 * 256 + 4 * 4 * 128 * 19) == 133568
    assert ksgm.census_y_plan(376, 1241, 127, 1).smem == 90560
    x = ksgm.census_x_plan(376, 1241, 127)
    assert x.slab_bytes == KITTI_SLAB_BYTES and x.mid == 620
    assert x.smem == 32768 + 8192 + 4 * (4 * 311 + 1241) == 50900


def test_census_y_plan_refuses_what_a_block_cannot_hold():
    # 8 paths at 4200 columns on 60 SMs: a 140-column band x 3 directions
    # is more than 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        ksgm.census_y_plan(100, 4200, 127, 3, sms=60)
    with pytest.raises(ValueError):
        ksgm.census_y_plan(10, 10, 129, 1)
    with pytest.raises(ValueError):
        ksgm.census_y_plan(10, 10, 16, 2)


@pytest.mark.parametrize("v_rolls", [(0,), (0, 1, -1), [0, 1, -1]])
def test_census_y_takes_the_matchers_roll_sets(v_rolls):
    assert ksgm.census_y_rolls(v_rolls) == list(v_rolls) + [0] * (
        3 - len(v_rolls))


@pytest.mark.parametrize("v_rolls", [(1,), (-1,), (0, 1), (1, -1),
                                     (0, -1, 1), (1, 0, -1), ()])
def test_census_y_refuses_other_roll_sets(v_rolls):
    # one-way diagonals would need the band ring's writer to wait on its
    # reader; B5 runs only the matcher's sets, both ways or none
    with pytest.raises(ValueError, match="roll sets"):
        ksgm.census_y_rolls(v_rolls)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("hwd", SHAPES)
def test_axis_plan_covers_and_fits(hwd, g, sms):
    """B4 on both families' volumes of an (H, W, n_d) pair: the x family
    (L, R) = (W, H), the y family (H, W)."""
    H, W, n_d = hwd
    rolls = (0,) if g == 1 else (0, 1, -1)
    for L, R in ((W, H), (H, W)):
        plan = ksgm.axis_plan(L, R, n_d, rolls, sms)
        assert (plan.route, plan.g, plan.scratch_shape) == ("warp", g, ())
        # the forward scan's first half [0, mid) and the backward scan's
        # [mid, L) cover axis 0 once; the slab holds their bf16 totals
        assert _covered_once([range(0, plan.mid), range(plan.mid, L)], L)
        assert plan.slab_shape == (L, R, 128)
        assert plan.smem <= ksgm.MAX_SMEM
        if g == 1:
            # a block of two warps per row, each with a ring of 8 staged
            # rows and other totals
            assert (plan.blocks, plan.threads, plan.halo_bytes) == (R, 64, 0)
            assert plan.smem == 2 * 8 * (272 + 256)
            continue
        # B5's bands over the rows, one block per SM and orientation
        y = ksgm.census_y_plan(L, R, n_d, 3, sms)
        assert (plan.nbands, plan.ncols, plan.cpw, plan.threads,
                plan.halo_bytes) == (y.nbands, y.ncols, y.cpw, y.threads,
                                     y.halo_bytes)
        assert plan.blocks == 2 * plan.nbands <= max(sms, 2)
        assert _covered_once(y.bands(R), R)
        # row state, four staged band rows (from the 16-byte chunk holding
        # a row's start) and four rows of the other scan's totals
        row = 16 * ((2 * plan.ncols * n_d + 29) // 16)
        assert row >= 2 * plan.ncols * n_d + 14 and row % 16 == 0
        assert plan.smem == (4 * 2 * 3 * (plan.ncols + 2) * 128 + 4 * row
                             + 4 * plan.ncols * 256)


@pytest.mark.parametrize("D, route", [(1, "warp"), (127, "warp"),
                                      (128, "warp"), (129, "lines"),
                                      (150, "lines"), (1024, "lines")])
def test_axis_plan_routes_by_planes(D, route):
    """A warp holds 128 planes: D <= 128 takes the warp step, 128 < D <=
    1024 the line kernel and its combine pass over an f32 scratch of one
    (L, R, D) slab per direction and orientation."""
    for rolls in ((0,), (0, 1, -1)):
        plan = ksgm.axis_plan(61, 97, D, rolls)
        assert plan.route == route
        if route == "lines":
            g = len(rolls)
            assert plan.scratch_shape == (2 * g, 61 * 97 * D)
            assert plan.slab_shape == () and plan.halo_bytes == 0
            assert plan.threads == 32 * -(-D // 32) and plan.blocks == (
                97 + 61 - 1) * 2 * g


def test_kitti_axis_plans_as_documented():
    """KITTI, 127 planes: the x family (1241 steps of 376 rows) runs 376
    blocks of two warps; the y family of 8 paths (376 steps of 1241 rows)
    runs B5's 66 bands of 19 rows per orientation with 103,360 B of shared
    memory a block (57 bands of 22 rows, two a warp, on 114 SMs); both
    meet through a 119 MB bf16 slab, where PR 2's design wrote 2g f32
    slabs of 237 MB."""
    x = ksgm.axis_plan(1241, 376, 127, (0,))
    assert (x.blocks, x.threads, x.mid) == (376, 64, 620)
    y = ksgm.axis_plan(376, 1241, 127, (0, 1, -1))
    assert (y.nbands, y.ncols, y.cpw, y.threads, y.mid) == (66, 19, 1, 608,
                                                            188)
    assert y.smem == 64512 + 4 * 4848 + 19 * 256 * 4 == 103360
    y114 = ksgm.axis_plan(376, 1241, 127, (0, 1, -1), sms=114)
    assert (y114.nbands, y114.ncols, y114.cpw, y114.smem) == (57, 22, 2,
                                                              118720)
    for p in (x, y):
        assert 2 * np.prod(p.slab_shape) == KITTI_SLAB_BYTES


@pytest.mark.parametrize("rolls", [(1,), (-1,), (0, 1), (1, -1),
                                   (0, -1, 1), (1, 0, -1)])
def test_axis_plan_refuses_other_roll_sets_on_the_warp_route(rolls):
    """D <= 128 runs the matcher's roll sets only, as B5; the line kernel
    (D > 128) takes any set of 1-3 shifts."""
    with pytest.raises(ValueError, match="roll sets"):
        ksgm.axis_plan(20, 30, 37, rolls)
    assert ksgm.axis_plan(20, 30, 150, rolls).route == "lines"


def test_axis_scan_takes_any_roll_set_on_the_cpu():
    """The refusal is the kernels': a CPU tensor runs the plain twin for
    every roll set."""
    rng = np.random.RandomState(3)
    v = torch.from_numpy(rng.randint(0, 25, (9, 11, 5)).astype(
        np.float32)).to(torch.bfloat16)
    for rolls in ((0, 1), (-1,), (0, 1, -1)):
        assert torch.equal(ksgm.axis_scan(v, rolls, 1.0, 8.0, entry="y"),
                           tsgm.axis_scan(v, rolls, 1.0, 8.0, entry="y"))


@pytest.mark.parametrize("shape", [(0, 4, 4), (4, 0, 4), (4, 4, 0),
                                   (4, 4, 1025)])
def test_axis_plan_refuses_bad_volumes(shape):
    with pytest.raises(ValueError, match="1 <= D <= 1024"):
        ksgm.axis_plan(*shape, (0,))
