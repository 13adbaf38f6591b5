"""The launch plans of the census SGM kernels B5 and B6
(`ops/cuda/sgm.py::census_y_plan`, `census_x_plan`): plain Python, checked
here on the CPU for the shapes the card runs (KITTI 376 x 1241 with 127
disparities, the odd crops of chip_smoke.py) and odd H and W."""

import numpy as np
import pytest

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
