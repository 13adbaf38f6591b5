"""The reference's census SGM against the port, bitwise, on both of the
port's routes: the fused kernels for D' < 128 with `sgm_fused_census`, the
materialized volume with B4 otherwise (its narrow route at D' <= 128, its
wide one above), on the CPU path (whose kernel entries run their plain
twins there) and on the card at KITTI size; what `check_route` still
refuses; and cells on the materialized route, sound and under the
control."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.reference import stereo as ref_stereo
from benchmark.tests.small import run_small

CELL_STEREO = json.loads(
    (harness.BENCH / "configs" / "kitti00_stereo.json").read_text())["stereo"]


def pair(h: int = 24, w: int = 240, near: int = 145, far: int = 20):
    """A u8-valued (as f32) rectified pair of random texture: a background
    at disparity `far` and a block in front of it at `near`, at the left
    image's right edge (x_right = x_left - d), which hides the background
    behind it from the right camera."""
    g = torch.Generator().manual_seed(2 ** 31 + 5)
    tex = torch.randint(0, 256, (3, h, w), generator=g).float()
    back, block, fresh = ((t + t.roll(1, 1) + t.roll(1, 0)) / 3.0
                          for t in tex)
    rows = torch.zeros((h, 1), dtype=torch.bool)
    rows[h // 4: 3 * h // 4] = True
    x = torch.arange(w)[None]
    on_left = rows & (x >= w - 50)
    right = torch.where(rows & (x >= w - 50 - near) & (x < w - near), block,
                        back)
    left = torch.where(x >= far,
                       torch.gather(back, 1, (x - far).clamp_min(0)
                                    .expand(h, w)), fresh)
    left = torch.where(on_left, torch.gather(block, 1, (x - near)
                                             .clamp_min(0).expand(h, w)),
                       left)
    return left.round(), right.round()


def both(max_disparity: int, **over):
    """The port's and the reference's disparity of one pair."""
    from densesurfelmapping_tpu_torch.models import stereo as port
    kw = dict(CELL_STEREO, max_disparity=max_disparity, **over)
    left, right = pair()
    return (port.disparity(left, right, port.StereoConfig(**kw)),
            ref_stereo.disparity(left, right, ref_stereo.StereoConfig(**kw)))


@pytest.mark.parametrize("max_disparity,fused,paths", [
    (32, False, 8), (32, False, 4), (151, True, 8), (192, True, 8),
    (192, False, 4)])
def test_materialized_route_matches_the_port_bitwise(max_disparity, fused,
                                                     paths):
    got, ref = both(max_disparity, sgm_fused_census=fused, sgm_paths=paths)
    assert torch.equal(got, ref)
    assert (ref > 0).float().mean() > 0.5
    if max_disparity > 146:
        # the near block is matched on planes past the fused route's 127
        assert (ref > 140).sum() > 100


def test_fused_route_is_unchanged():
    """D' = 31 with `sgm_fused_census`: the reference is bitwise the
    port's fused kernels' twins, and those agree with the port's
    materialized route."""
    got, ref = both(32)
    assert torch.equal(got, ref)
    assert torch.equal(got, both(32, sgm_fused_census=False)[0])


@pytest.mark.parametrize("n_d", [1, 127, 128, 129, 191, 1024])
@pytest.mark.parametrize("fused", [True, False])
def test_check_route_admits_census_sgm(n_d, fused):
    ref_stereo.check_route(ref_stereo.StereoConfig(**dict(
        CELL_STEREO, max_disparity=1 + n_d, sgm_fused_census=fused)))


@pytest.mark.parametrize("off,over", [
    ("cost", dict(cost="sad")),
    ("aggregation", dict(aggregation="box")),
    ("sgm_carry_bf16", dict(sgm_carry_bf16=True)),
    ("wta_streaming", dict(wta_streaming=False)),
    ("hierarchical", dict(hierarchical=True)),
    ("occlusion_fill", dict(occlusion_fill=True)),
    ("prior_rescue", dict(prior_rescue=True)),
    ("sgm_pallas", dict(sgm_pallas=False)),
    ("sgm_paths", dict(sgm_paths=6)),
    ("max_disparity", dict(max_disparity=1)),
    ("max_disparity", dict(max_disparity=1026)),
    ("max_disparity", dict(max_disparity=1026, sgm_fused_census=False))])
def test_check_route_refuses_the_other_routes(off, over):
    cfg = ref_stereo.StereoConfig(**dict(CELL_STEREO, **over))
    with pytest.raises(ValueError, match=off):
        ref_stereo.check_route(cfg)


@pytest.mark.parametrize("stereo", [dict(sgm_fused_census=False),
                                    dict(max_disparity=136)],
                         ids=["narrow", "wide"])
@pytest.mark.parametrize("control", [False, True])
def test_small_cell_on_the_materialized_route(stereo, control):
    out = run_small("kitti00_stereo.replay", stereo=stereo,
                    lowp_control=control)
    res = out["result"]
    if control:
        assert not res["correct"]
    else:
        assert res["correct"], res["compared"]
        assert res["failed"] == 0 and res["attempted"] > 0


def kitti_stereo_cell(**stereo) -> harness.Cell:
    """`kitti00_stereo.replay` at KITTI size with its matcher's settings
    changed: a scratch cell built in code, in no file of the benchmark."""
    cell = harness.load_cell("kitti00_stereo.replay")
    cell.config = dict(cell.config,
                       stereo=dict(cell.config["stereo"], **stereo))
    return cell


@pytest.mark.card
@pytest.mark.parametrize("stereo", [dict(max_disparity=192),
                                    dict(sgm_fused_census=False)],
                         ids=["d192_wide", "d128_narrow"])
def test_kitti_size_materialized_route_on_the_card(card, stereo):
    """KITTI 00 stereo on B4: at PSMNet's 192 disparities (D' = 191, B4's
    wide route) and at the cell's 128 with the fused kernels off (B4's
    narrow route); a sound run is correct, the bf16 control is not."""
    cell = kitti_stereo_cell(**stereo)
    sound = harness.run_cell(cell, 4000000007, 5.0, False)["result"]
    assert sound["correct"], sound["compared"]
    assert sound["compared"]["frames_failed"]["value"] == 0
    control = harness.run_cell(cell, 4000000007, 5.0, False,
                               lowp_control=True)["result"]
    assert not control["correct"], control["compared"]


@pytest.mark.card
@pytest.mark.parametrize("max_disparity,fused,near", [
    (192, True, 145), (128, False, 100)], ids=["d192_wide", "d128_narrow"])
def test_kitti_size_disparity_matches_the_reference_on_the_card(
        card, max_disparity, fused, near):
    """A KITTI-size (376 x 1241) pair with a near block: B4 and the WTA
    kernel give the reference's disparity bitwise, at D' 191 with matches
    won past plane 127 (B4's wide route) and at D' 127 with the fused
    kernels off (its narrow route)."""
    from densesurfelmapping_tpu_torch.models import stereo as port
    kw = dict(CELL_STEREO, max_disparity=max_disparity,
              sgm_fused_census=fused)
    left, right = (t.to(card) for t in pair(376, 1241, near=near))
    got = port.disparity(left, right, port.StereoConfig(**kw))
    ref = ref_stereo.disparity(left, right, ref_stereo.StereoConfig(**kw))
    assert torch.equal(got, ref)
    assert (ref > near - 5).sum() > 1000
