"""The census aggregate above 128 planes: B4's line kernel and combine pass
reading the Hamming cost from the two census images
(`ops/cuda/sgm.py::census_aggregate`, `csrc/sgm.cu::sgm_census_lines`) in
place of a materialized (D', H, W) volume, and the matcher's route to it
(`models/stereo.py::_disparity_sgm`, 128 < D' <= 1024).

On the CPU: the route choice (`_launch_census_aggregate`) and each
family's geometry (`axis_plan`), the wrapper's plain twin against B4's twin
on the census volume, and the matcher's routes.
The tests marked `card` need a CUDA card and skip without one; this file
imports no JAX, so they run on the card without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_census_lines.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu_torch.models import stereo as S
from densesurfelmapping_tpu_torch.ops import sgm as tsgm
from densesurfelmapping_tpu_torch.ops.cuda import sgm as K

ROLLS = {4: (0,), 8: (0, 1, -1)}
P1, P2 = 1.0, 8.0


def _volume_route(cl, cr, paths, min_d, n_d, carry_bf16):
    """B4 on the materialized census volume (its twin on a CPU tensor)."""
    return S._sgm_aggregate(S._census_volume(cl, cr, min_d, n_d), P1, P2,
                            paths, use_kernels=True, carry_bf16=carry_bf16,
                            min_d=min_d)


def _census_pair(h, w, shift, seed):
    """Census images of a random image and of it moved `shift` px left."""
    g = torch.Generator().manual_seed(seed)
    left = torch.randint(0, 256, (h, w), generator=g).float()
    right = torch.roll(left, -shift, 1)
    return S._census(left, 2), S._census(right, 2)


# ---------------------------------------------------------------------------
# the route and the geometry


def _routed(monkeypatch, H, W, n_d, v_rolls, streams):
    """`_launch_census_aggregate` on CPU images with its launches replaced
    by recorders: returns (the calls, the result).  A line family answers
    its (L, R, n_d) block filled with 1 (x) or 2 (y); B6 and B5 answer
    zeros."""
    calls = []
    lead = (streams,) if streams > 1 else ()

    def lines(cl, cr, rolls, entry, p1, p2, min_d, n, carry_bf16):
        calls.append(("lines", entry, tuple(rolls), n))
        L, R = (W, H) if entry == "x" else (H, W)
        return torch.full(lead + (L, R, n), 1.0 if entry == "x" else 2.0)

    def b6(cl, cr, p1, p2, min_d, n, carry_bf16):
        calls.append(("census_x", n))
        return torch.zeros(lead + (n, H, W))

    def b5(cl, cr, out, rolls, p1, p2, min_d, carry_bf16):
        calls.append(("census_y", tuple(rolls)))
        return out

    monkeypatch.setattr(K, "_census_lines_family", lines)
    monkeypatch.setattr(K, "_launch_census_x", b6)
    monkeypatch.setattr(K, "_launch_census_y", b5)
    img = torch.zeros(lead + (H, W), dtype=torch.int32)
    out = K._launch_census_aggregate(img, img, v_rolls, P1, P2, 1, n_d,
                                     False)
    return calls, out


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("n_d", [1, 37, 127, 128])
def test_route_takes_b6_b5_up_to_128_planes(monkeypatch, n_d, paths,
                                            streams):
    calls, out = _routed(monkeypatch, 9, 21, n_d, ROLLS[paths], streams)
    assert calls == [("census_x", n_d), ("census_y", ROLLS[paths])]
    assert out.shape == ((streams,) if streams > 1 else ()) + (n_d, 9, 21)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("n_d", [129, 150, 191, 1024])
def test_route_takes_the_line_kernel_above_128_planes(monkeypatch, n_d,
                                                      paths, streams):
    """129-1024 planes: one line-kernel call a family, the x family on
    rolls (0) and the y family on the matcher's, summed into (n_d, H, W)
    as `_sgm_aggregate` sums them."""
    calls, out = _routed(monkeypatch, 5, 7, n_d, ROLLS[paths], streams)
    assert calls == [("lines", "x", (0,), n_d),
                     ("lines", "y", ROLLS[paths], n_d)]
    assert out.shape == ((streams,) if streams > 1 else ()) + (n_d, 5, 7)
    assert bool((out == 3.0).all())


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("hwd", [(376, 1241, 191), (61, 97, 150),
                                 (376, 1241, 129), (17, 33, 1024)])
def test_line_families_take_the_wide_route_geometry(hwd, paths, streams):
    """Each family is B4's wide route over its (L, R) = (W, H) (x family,
    rolls (0)) or (H, W) (y family, the matcher's rolls): 2g f32 scratch
    slabs of H W n_d a stream."""
    H, W, n_d = hwd
    g = len(ROLLS[paths])
    for rolls, gf, L, R in (((0,), 1, W, H), (ROLLS[paths], g, H, W)):
        fam = K.axis_plan(L, R, n_d, rolls, streams=streams)
        assert fam.route == "lines" and fam.g == gf
        assert fam.threads == 32 * -(-n_d // 32) <= 1024
        assert fam.blocks == (R + L - 1) * 2 * gf
        assert fam.scratch_shape == (streams * 2 * gf, H * W * n_d)
        assert fam.streams == streams


def test_kitti_d192_scratch_as_documented():
    """D' 191 at KITTI size: 0.71 GB of scratch for the x family and 2.14
    GB for the y family of 8 paths (2.85 GB, PERF.md), one family's at a
    time."""
    fams = (K.axis_plan(1241, 376, 191, (0,)),
            K.axis_plan(376, 1241, 191, (0, 1, -1)))
    nbytes = [4 * int(np.prod(f.scratch_shape)) for f in fams]
    assert nbytes == [712_989_248, 2_138_967_744]


@pytest.mark.parametrize("n_d", [0, 1025, 2048])
def test_line_families_refuse_other_plane_counts(n_d):
    for L, R, rolls in ((1241, 376, (0,)), (376, 1241, (0, 1, -1))):
        with pytest.raises(ValueError, match="1 <= D <= 1024"):
            K.axis_plan(L, R, n_d, rolls)


# ---------------------------------------------------------------------------
# the wrapper on the CPU (its plain twin)


@pytest.mark.parametrize("min_d", [1, 3])
@pytest.mark.parametrize("carry_bf16", [False, True])
@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("n_d", [139, 191])
def test_cpu_census_aggregate_equals_b4_on_the_volume(n_d, paths,
                                                      carry_bf16, min_d):
    cl, cr = _census_pair(9, 214, 150, 11)
    got = K.census_aggregate(cl, cr, ROLLS[paths], P1, P2, min_d, n_d,
                             carry_bf16)
    want = _volume_route(cl, cr, paths, min_d, n_d, carry_bf16)
    assert got.shape == (n_d, 9, 214)
    assert torch.equal(got, want)


def test_cpu_streams_equal_per_stream_calls():
    """(B, H, W) images and a call under torch.func.vmap at D' 150: each
    stream equals its own call."""
    pairs = [_census_pair(7, 170, s, 20 + s) for s in (140, 60)]
    cl = torch.stack([p[0] for p in pairs])
    cr = torch.stack([p[1] for p in pairs])
    args = ((0, 1, -1), P1, P2, 2, 150)
    batched = K.census_aggregate(cl, cr, *args)
    mapped = torch.func.vmap(lambda a, b: K.census_aggregate(a, b, *args))(
        cl, cr)
    for b in range(2):
        want = K.census_aggregate(cl[b], cr[b], *args)
        assert torch.equal(batched[b], want) and torch.equal(mapped[b], want)


# ---------------------------------------------------------------------------
# the matcher's routes


def _pair(h, w, shift, seed):
    g = torch.Generator().manual_seed(seed)
    left = torch.randint(0, 256, (h, w), generator=g).float()
    return left, torch.roll(left, -shift, 1)


@pytest.mark.parametrize("paths", [4, 8])
def test_d192_census_route_equals_the_materialized_route(paths):
    """max_disparity 192 (D' 191): the census route's disparity is the
    volume route's (sgm_fused_census False), with a winner past plane
    127."""
    left, right = _pair(14, 230, 150, 5)
    cfg = S.StereoConfig(aggregation="sgm", max_disparity=192,
                         sgm_paths=paths)
    got = S.disparity(left, right, cfg)
    want = S.disparity(left, right, cfg._replace(sgm_fused_census=False))
    assert torch.equal(got, want)
    assert bool((got > 128).any())


def _spy(monkeypatch):
    """Record the census route's calls, the materialized route's volume
    builds (`_cost_volume`) and every census volume with the file that
    asked for it."""
    calls = dict(census=0, scan=0, volume=[])
    real_vol, real_scan = S._census_volume, S._cost_volume
    real_agg = K.census_aggregate
    pkg = os.path.dirname(os.path.dirname(S.__file__))

    def volume(*a):
        calls["volume"].append(os.path.relpath(
            sys._getframe(1).f_code.co_filename, pkg))
        return real_vol(*a)

    def scan(*a):
        calls["scan"] += 1
        return real_scan(*a)

    def agg(*a, **kw):
        calls["census"] += 1
        return real_agg(*a, **kw)

    monkeypatch.setattr(S, "_census_volume", volume)
    monkeypatch.setattr(S, "_cost_volume", scan)
    monkeypatch.setattr(K, "census_aggregate", agg)
    return calls


TWIN = os.path.join("ops", "sgm.py")
MATCHER = os.path.join("models", "stereo.py")


def test_census_route_builds_no_volume_outside_the_twin(monkeypatch):
    """The route above 128 planes calls `census_aggregate` once; the only
    volumes built are the plain twin's (`ops/sgm.py`, which the wrapper
    runs on a CPU tensor), never the matcher's."""
    calls = _spy(monkeypatch)
    left, right = _pair(8, 200, 140, 6)
    S.disparity(left, right, S.StereoConfig(aggregation="sgm",
                                            max_disparity=192))
    assert calls["census"] == 1 and calls["scan"] == 0
    assert calls["volume"] and set(calls["volume"]) == {TWIN}


@pytest.mark.parametrize("over,census,scan,volumes", [
    (dict(max_disparity=129), 1, 0, [TWIN, TWIN]),     # D' == 128
    (dict(max_disparity=192, sgm_fused_census=False), 0, 1, [MATCHER]),
    (dict(max_disparity=192, cost="sad"), 0, 1, []),
    (dict(max_disparity=192, sgm_pallas=False), 0, 1, [MATCHER])],
    ids=["d128", "fused_off", "sad", "kernels_off"])
def test_other_configs_keep_the_materialized_route(monkeypatch, over, census,
                                                   scan, volumes):
    """The fused census route off, SAD cost and the kernels off build the
    volume in the matcher; D' = 128 takes the census route's B6 + B5 like
    every D' up to 128 (`plane_route`), its only volumes the plain twin's,
    one a family."""
    calls = _spy(monkeypatch)
    left, right = _pair(6, 200, 100, 7)
    S.disparity(left, right, S.StereoConfig(aggregation="sgm", **over))
    assert calls["census"] == census and calls["scan"] == scan
    assert calls["volume"] == volumes


# ---------------------------------------------------------------------------
# on the card

NEAR_D = 170          # the pasted block's disparity (plane 169 from 1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def census(card):
    """Census images of a KITTI-size pair of the synthetic scene (the right
    camera 0.54 m along x) with a block of the left image pasted into the
    right one NEAR_D px to the left, on the card."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.io import synthetic
    cfg = kitti_config()
    pose = synthetic.forward_trajectory(3, step=0.4)[0]
    right = np.array(pose, np.float64)
    right[:3, 3] += right[:3, 0] * 0.54
    scene = synthetic.default_scene()
    li, ri = [np.clip(scene.render(cfg, p)[0], 0, 255).astype(np.uint8)
              for p in (pose, right)]
    ri[100:260, 600 - NEAR_D:900 - NEAR_D] = li[100:260, 600:900]
    return [S._census(torch.from_numpy(i).to(card).float(), 2)
            for i in (li, ri)]


def _crop(census, i):
    cl, cr = census
    ys, xs = slice(150 + 20 * i, 211 + 20 * i), slice(300 + 150 * i,
                                                      397 + 150 * i)
    return cl[ys, xs].contiguous(), cr[ys, xs].contiguous()


def _counted(fn):
    K.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(K.LAUNCHES)


@pytest.mark.card
@pytest.mark.parametrize("carry_bf16", [False, True])
@pytest.mark.parametrize("paths", [4, 8])
def test_kitti_d191_equals_b4_on_the_volume_and_the_twin(census, paths,
                                                         carry_bf16):
    cl, cr = census
    got, n = _counted(lambda: K.census_aggregate(
        cl, cr, ROLLS[paths], P1, P2, 1, 191, carry_bf16))
    assert n["sgm_census_lines"] == 2 and n["sgm_axis_scan"] == 0
    assert n["sgm_census_x"] == n["sgm_census_y"] == 0
    want, n = _counted(lambda: _volume_route(cl, cr, paths, 1, 191,
                                             carry_bf16))
    assert n["sgm_axis_scan"] == 2 and n["sgm_census_lines"] == 0
    assert torch.equal(got, want)
    assert torch.equal(got, tsgm.census_aggregate(
        cl, cr, ROLLS[paths], P1, P2, 1, 191, carry_bf16))
    # the pasted block wins at its disparity, past plane 127
    win = got[:, 120:240, 640:880].argmin(0)
    assert float((win == NEAR_D - 1).float().mean()) > 0.5


@pytest.mark.card
@pytest.mark.parametrize("carry_bf16", [False, True])
@pytest.mark.parametrize("paths", [4, 8])
def test_crop_d150_equals_b4_on_the_volume_and_the_twin(census, paths,
                                                        carry_bf16):
    cl, cr = _crop(census, 0)
    got = K.census_aggregate(cl, cr, ROLLS[paths], P1, P2, 3, 150,
                             carry_bf16)
    assert torch.equal(got, _volume_route(cl, cr, paths, 3, 150,
                                          carry_bf16))
    assert torch.equal(got, tsgm.census_aggregate(
        cl, cr, ROLLS[paths], P1, P2, 3, 150, carry_bf16))


@pytest.mark.card
@pytest.mark.parametrize("carry_bf16", [False, True])
def test_two_streams_in_one_call_and_under_vmap(census, carry_bf16):
    crops = [_crop(census, i) for i in (1, 2)]
    cl = torch.stack([c[0] for c in crops])
    cr = torch.stack([c[1] for c in crops])
    args = ((0, 1, -1), P1, P2, 3, 150, carry_bf16)
    batched, n = _counted(lambda: K.census_aggregate(cl, cr, *args))
    assert n["sgm_census_lines"] == 2 and n["sgm_axis_scan"] == 0
    mapped, n = _counted(lambda: torch.func.vmap(
        lambda a, b: K.census_aggregate(a, b, *args))(cl, cr))
    assert n["sgm_census_lines"] == 2
    for b in range(2):
        want = _volume_route(cl[b], cr[b], 8, 3, 150, carry_bf16)
        assert torch.equal(batched[b], want)
        assert torch.equal(mapped[b], want)
        assert torch.equal(K.census_aggregate(cl[b], cr[b], *args), want)


@pytest.mark.card
def test_census_route_in_a_captured_graph(census):
    """Captured once, replayed on two crops copied into its inputs: each
    replay equals B4 on that crop's volume."""
    crops = [_crop(census, i) for i in (0, 3)]
    sl, sr = (c.clone() for c in crops[0])
    args = ((0, 1, -1), P1, P2, 3, 150)
    K.census_aggregate(sl, sr, *args)           # the library, outside
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.census_aggregate(sl, sr, *args)
    for cl, cr in (crops[1], crops[0]):
        sl.copy_(cl)
        sr.copy_(cr)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, _volume_route(cl, cr, 8, 3, 150, False))


@pytest.mark.card
def test_matcher_d192_on_the_card(card):
    """`disparity` at max_disparity 192 on a CUDA tensor: two census-route
    calls and no B4 call on the volume; the disparity equals the
    materialized route's."""
    g = torch.Generator().manual_seed(9)
    left = torch.randint(0, 256, (40, 400), generator=g).float()
    right = torch.roll(left, -160, 1)
    left, right = left.to(card), right.to(card)
    cfg = S.StereoConfig(aggregation="sgm", max_disparity=192)
    got, n = _counted(lambda: S.disparity(left, right, cfg))
    assert n["sgm_census_lines"] == 2 and n["sgm_axis_scan"] == 0
    want, n = _counted(lambda: S.disparity(
        left, right, cfg._replace(sgm_fused_census=False)))
    assert n["sgm_census_lines"] == 0 and n["sgm_axis_scan"] == 2
    assert torch.equal(got, want) and bool((got > 128).any())


@pytest.mark.card
def test_wrapper_refuses_more_than_1024_planes(census):
    cl, cr = _crop(census, 0)
    with pytest.raises(ValueError, match="1 <= n_d <= 1024"):
        K.census_aggregate(cl, cr, (0,), P1, P2, 1, 1025)
