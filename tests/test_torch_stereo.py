"""The port's stereo matcher (`models/stereo.py`), depth post-filters
(`ops/depthfilter.py`) and prior render (`ops/render.py`) against the JAX
package on the same numpy inputs: the 120x56 multisine stereo pair of
tests/test_stereo.py.  Every comparison is exact (the port mirrors the
arithmetic XLA compiles); the JAX side runs its scan backend
(sgm_pallas=False), which its own tests pin bitwise to its Pallas kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core.state import SurfelBank as JaxBank
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.ops import depthfilter as jdf
from densesurfelmapping_tpu.ops.render import render_prior_depth as jrender
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import bank_from_numpy
from densesurfelmapping_tpu_torch.models import stereo as tstereo
from densesurfelmapping_tpu_torch.ops import depthfilter as tdf
from densesurfelmapping_tpu_torch.ops.cuda import wta as kwta
from densesurfelmapping_tpu_torch.ops.render import (
    render_prior_depth as trender)

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                       cx=59.5, cy=27.5)
BASELINE = 0.5
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=1024)
# disparities of the scene are <= fx * B / 1.5 m ~ 27 px
BASE = dict(max_disparity=32, min_disparity=1, radius=3)


@pytest.fixture(scope="module")
def pair():
    scene = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                            boxes=synthetic.default_scene().boxes,
                            max_depth=25.0, texture="multisine")
    right_pose = np.eye(4)
    right_pose[0, 3] = BASELINE
    li, ld = scene.render(CFG, np.eye(4))
    ri, _ = scene.render(CFG, right_pose)
    return li, ri, ld


def test_stereo_config_same_fields():
    ref = jstereo.StereoConfig(aggregation="sgm", max_disparity=96)
    port = tstereo.StereoConfig(**ref._asdict())
    assert port._fields == ref._fields
    assert port._asdict() == ref._asdict()
    assert tstereo.StereoConfig()._asdict() == jstereo.StereoConfig()._asdict()
    assert port._replace(sgm_paths=4).sgm_paths == 4


def test_census_and_popcount_exact(pair):
    li, ri, _ = pair
    for img in (li, ri):
        want = np.asarray(jstereo._census(jnp.asarray(img), 2))
        got = tstereo._census(torch.from_numpy(img), 2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    codes = np.random.default_rng(0).integers(0, 1 << 24, 4096)
    want = np.asarray(jax.lax.population_count(
        jnp.asarray(codes.astype(np.uint32))))
    got = tstereo._popcount32(torch.from_numpy(codes.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    with pytest.raises(ValueError, match="radius"):
        tstereo._census(torch.zeros(8, 8), 3)


def _sparse_disparity(seed, h=56, w=120):
    rng = np.random.default_rng(seed)
    d = rng.uniform(2.0, 30.0, (h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.35] = 0.0
    d[rng.random((h, w)) < 0.02] += 9.0          # speckles
    return d


def test_post_filters_exact():
    for seed in range(3):
        d = _sparse_disparity(seed)
        dj, dt = jnp.asarray(d), torch.from_numpy(d)
        np.testing.assert_array_equal(
            tstereo._median_postfilter(dt, 2.0, 4).numpy(),
            np.asarray(jax.jit(lambda a: jstereo._median_postfilter(
                a, 2.0, 4))(dj)))
        for gap, tol in ((32, 3.0), (4, 0.0)):
            np.testing.assert_array_equal(
                tstereo._scanline_fill(dt, gap, tol).numpy(),
                np.asarray(jax.jit(lambda a: jstereo._scanline_fill(
                    a, gap, tol))(dj)), err_msg=f"{gap} {tol}")
        depth = np.where(d > 0, 40.0 / np.maximum(d, 1e-6), 0.0).astype(
            np.float32)
        np.testing.assert_array_equal(
            tdf.clean_depth(torch.from_numpy(depth)).numpy(),
            np.asarray(jax.jit(jdf.clean_depth)(jnp.asarray(depth))))
        np.testing.assert_array_equal(
            tdf.median3x3(torch.from_numpy(depth), fill_invalid=True).numpy(),
            np.asarray(jdf.median3x3(jnp.asarray(depth), fill_invalid=True)))


@pytest.mark.parametrize("paths,subpixel,prior,uniqueness,min_d", [
    pytest.param(8, True, True, 0.95, 1, id="8-True-True"),
    pytest.param(4, False, False, 0.95, 1, id="4-False-False"),
    pytest.param(8, True, False, 0.0, 3, id="8-True-False-u0-md3"),
    pytest.param(8, False, True, 0.0, 1, id="8-False-True-u0"),
    pytest.param(4, True, True, 0.95, 3, id="4-True-True-md3"),
    pytest.param(8, False, False, 0.0, 3, id="8-False-False-u0-md3")])
def test_wta_streaming_matches_reductions(pair, paths, subpixel, prior,
                                          uniqueness, min_d):
    """The streaming WTA, and the kernel's wrapper (which runs it on a CPU
    tensor and launches nothing), equal the full reductions."""
    li, ri, _ = pair
    cfg = tstereo.StereoConfig(**dict(BASE, min_disparity=min_d),
                               aggregation="sgm", sgm_paths=paths,
                               subpixel=subpixel,
                               uniqueness_ratio=uniqueness)
    l, r = torch.from_numpy(li), torch.from_numpy(ri)
    agg = tstereo._sgm_aggregate(tstereo._cost_volume(l, r, cfg), 1.0, 8.0,
                                 paths, min_d=min_d)
    plane = None
    if prior:
        plane = torch.from_numpy(np.random.default_rng(1).integers(
            0, agg.shape[0], agg.shape[1:]).astype(np.int32))
    kwta.reset_launch_counts()
    a = tstereo._wta_scan(agg, cfg, prior_plane=plane)
    b = tstereo._wta_reductions(agg, cfg, prior_plane=plane)
    c = kwta.wta_scan(agg, min_d, subpixel, uniqueness, plane)
    assert kwta.LAUNCHES["wta_scan"] == 0
    for x, y, z in zip(a, b, c):
        if isinstance(x, tuple):
            for u, v, w in zip(x, y, z):
                assert torch.equal(u, v) and torch.equal(w, v)
        elif x is None:
            assert y is None and z is None
        else:
            assert torch.equal(x, y) and torch.equal(z, y)


CASES = {
    "box": dict(),
    "sgm_census_fused": dict(aggregation="sgm"),
    "sgm_census_materialized": dict(aggregation="sgm",
                                    sgm_fused_census=False),
    "sgm_census_bf16_reductions": dict(aggregation="sgm",
                                       sgm_carry_bf16=True,
                                       wta_streaming=False,
                                       occlusion_fill=True),
    "sgm_sad": dict(aggregation="sgm", cost="sad", sgm_pallas=False),
    "hierarchical": dict(aggregation="sgm", hierarchical=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_disparity_matches_jax(pair, case):
    li, ri, _ = pair
    kw = dict(BASE, **CASES[case])
    want = np.asarray(jstereo.jitted_disparity(jstereo.StereoConfig(
        **dict(kw, sgm_pallas=False)))(jnp.asarray(li), jnp.asarray(ri)))
    got = tstereo.disparity(torch.from_numpy(li), torch.from_numpy(ri),
                            tstereo.StereoConfig(**kw)).numpy()
    assert (want > 0).mean() > 0.5, case
    np.testing.assert_array_equal(got, want, err_msg=case)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("paths", [4, 8])
def test_disparity_d192_matches_jax(paths, fused):
    """max_disparity 192 (D' 191, the census route above 128 planes when
    fused, the materialized volume when not) against the JAX package's
    materialized volume and scans, on a pair whose disparity, 150, lies
    past plane 127."""
    g = np.random.default_rng(5)
    li = g.integers(0, 256, (14, 230)).astype(np.float32)
    ri = np.roll(li, -150, 1)
    kw = dict(aggregation="sgm", max_disparity=192, sgm_paths=paths)
    want = np.asarray(jstereo.jitted_disparity(jstereo.StereoConfig(
        **dict(kw, sgm_pallas=False)))(jnp.asarray(li), jnp.asarray(ri)))
    got = tstereo.disparity(torch.from_numpy(li), torch.from_numpy(ri),
                            tstereo.StereoConfig(
                                **kw, sgm_fused_census=fused)).numpy()
    assert (want > 128).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aggregation", ["sgm", "box"])
def test_prior_rescue_matches_jax(pair, aggregation):
    li, ri, ld = pair
    prior = np.where(ld > 0, CAM.fx * BASELINE / np.maximum(ld, 1e-6), 0.0)
    prior = np.where(prior > 2.0, prior, 0.0).astype(np.float32)
    kw = dict(BASE, aggregation=aggregation, prior_rescue=True)
    jcfg = jstereo.StereoConfig(**dict(kw, sgm_pallas=False))
    dj, nj = jax.jit(lambda a, b, p: jstereo.disparity(
        a, b, jcfg, prior_disp=p, with_rescued=True))(
        jnp.asarray(li), jnp.asarray(ri), jnp.asarray(prior))
    dt, nt = tstereo.disparity(torch.from_numpy(li), torch.from_numpy(ri),
                               tstereo.StereoConfig(**kw),
                               prior_disp=torch.from_numpy(prior),
                               with_rescued=True)
    assert int(nt) == int(nj) > 0
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _banks(points, update_times, count=None):
    n = len(points)
    pos = np.zeros((CFG.surfel_capacity, 3), np.float32)
    ut = np.zeros(CFG.surfel_capacity, np.int32)
    pos[:n] = points
    ut[:n] = update_times
    n = n if count is None else count
    jb = JaxBank.empty(CFG.surfel_capacity)
    jb = jb.replace(position=jnp.asarray(pos), update_times=jnp.asarray(ut),
                    count=jnp.asarray(n, jnp.int32))
    fields = {k: np.asarray(getattr(jb, k)) for k, _ in jb.field_arrays()}
    return jb, bank_from_numpy(fields, n, "cpu", CFG.surfel_capacity)


def _at(u, v, z):
    return ((u - CAM.cx) * z / CAM.fx, (v - CAM.cy) * z / CAM.fy, z)


@pytest.mark.parametrize("scenario", ["zbuffer", "gates", "beyond_count",
                                      "pose"])
def test_render_prior_depth_matches_jax(scenario):
    """The banks and poses of tests/test_prior.py."""
    pose = np.eye(4, dtype=np.float32)
    count = None
    if scenario == "zbuffer":
        pts, upd = [_at(32, 16, 5.0), _at(35, 20, 3.0), _at(80, 40, 9.0)], \
            [7, 7, 7]
    elif scenario == "gates":
        pts = [_at(32, 16, 5.0), _at(80, 40, 9.0),
               _at(48, 24, CFG.fuse_far + 5.0), (-100.0, 0.0, 4.0)]
        upd = [4, 0, 9, 9]
    elif scenario == "beyond_count":
        pts, upd, count = [_at(32, 16, 5.0)], [9], 0
    else:
        pts, upd = [_at(59, 27, 6.0)], [9]
        pose[0, 3] = -1.0
    jb, tb = _banks(np.asarray(pts, np.float32), upd, count)
    want = np.asarray(jrender(CFG, jb, jnp.asarray(pose), stride=8,
                              min_updates=5))
    tc = tcfg.SurfelMapConfig.from_json(CFG.to_json())
    got = trender(tc, tb, torch.from_numpy(pose), stride=8, min_updates=5)
    assert got.shape == (CAM.height, CAM.width)
    np.testing.assert_array_equal(got.numpy(), want)
    if scenario == "zbuffer":
        assert float(got[16:24, 32:40].max()) == pytest.approx(3.0)
    # the sharded banks' hook: merging with an empty shard's z-buffer (all
    # inf) changes nothing
    merged = trender(tc, tb, torch.from_numpy(pose), stride=8, min_updates=5,
                     reduce=lambda c: torch.minimum(
                         c, torch.full_like(c, float("inf"))))
    assert torch.equal(merged, got)
