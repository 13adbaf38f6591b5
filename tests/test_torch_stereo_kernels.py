"""The port's SGM plain twins (`ops/sgm.py`, the CPU path of the wrappers in
`ops/cuda/sgm.py`) against the JAX package's scan path and its Pallas
kernels in interpret mode: bitwise, for both carry dtypes.  The CUDA kernels
themselves are held to these twins on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.ops.pallas import sgm as jsgm
from densesurfelmapping_tpu_torch.models import stereo as tstereo
from densesurfelmapping_tpu_torch.ops import sgm as tsgm
from densesurfelmapping_tpu_torch.ops.cuda import sgm as ksgm

torch.set_num_threads(1)

# (scan permutation of the (D, H, W) volume, rolls, entry)
SCANS = [((2, 1, 0), (0,), None), ((1, 2, 0), (0, 1, -1), None),
         ((2, 1, 0), (0,), "x"), ((1, 2, 0), (0, 1, -1), "y")]


def _wedge_volume(shape, seed=7):
    """Random integer costs with the out-of-range wedge at 1e4, the volumes
    of the JAX package's test_pallas_sgm_matches_xla_axis_scan."""
    D, H, W = shape
    rng = np.random.RandomState(seed)
    vol = rng.randint(0, 25, size=(D, H, W)).astype(np.float32)
    wedge = np.arange(W)[None, None, :] < (np.arange(D) + 1)[:, None, None]
    return np.where(wedge, 1e4, vol).astype(np.float32)


@pytest.mark.parametrize("carry_bf16", [False, True])
@pytest.mark.parametrize("hwd", [(24, 40, 30), (17, 33, 7)])
def test_axis_scan_matches_jax_scan_and_pallas(hwd, carry_bf16):
    H, W, D = hwd
    vol = _wedge_volume((D, H, W))
    vj = jnp.asarray(vol, jnp.bfloat16)
    vt = torch.from_numpy(vol).to(torch.bfloat16)
    for perm, rolls, entry in SCANS:
        a = jnp.transpose(vj, perm)
        b = vt.permute(*perm).contiguous()
        kw = dict(carry_bf16=carry_bf16, entry=entry, min_d=1)
        want = np.asarray(jstereo._axis_scan(a, rolls, 1.0, 8.0, **kw),
                          np.float32)
        pallas = np.asarray(jsgm.axis_scan_pallas(a, rolls, 1.0, 8.0, **kw),
                            np.float32)
        got = ksgm.axis_scan(b, rolls, 1.0, 8.0, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{rolls} {entry}")
        np.testing.assert_array_equal(got.numpy(), pallas,
                                      err_msg=f"{rolls} {entry}")
        # the scan path's own grouping (c + cand) - Lmin equals the kernel
        # grouping on integer costs
        np.testing.assert_array_equal(
            tstereo._axis_scan(b, rolls, 1.0, 8.0, **kw).numpy(), want)


@pytest.fixture(scope="module")
def census_pair():
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                           cx=59.5, cy=27.5)
    cfg = SurfelMapConfig(camera=cam, surfel_capacity=1024)
    scene = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                            boxes=synthetic.default_scene().boxes,
                            max_depth=25.0, texture="multisine")
    right_pose = np.eye(4)
    right_pose[0, 3] = 0.5
    li, _ = scene.render(cfg, np.eye(4))
    ri, _ = scene.render(cfg, right_pose)
    # the kernels' cost depends only on the census codes; a 72-px crop
    # keeps the interpret-mode reference quick
    li, ri = li[:, :72], ri[:, :72]
    return ([jstereo._census(jnp.asarray(x), 2) for x in (li, ri)],
            [tstereo._census(torch.from_numpy(x), 2) for x in (li, ri)])


@pytest.mark.parametrize("paths,min_d,carry_bf16", [
    (8, 1, False), (4, 1, False), (8, 3, False), (8, 1, True)])
def test_census_aggregate_matches_pallas(census_pair, paths, min_d,
                                         carry_bf16):
    (jl, jr), (tl, tr) = census_pair
    np.testing.assert_array_equal(tl.numpy(),
                                  np.asarray(jl).astype(np.int32))
    v_rolls = (0,) if paths == 4 else (0, 1, -1)
    n_d = 40 - min_d
    want = np.asarray(jsgm.census_aggregate(jl, jr, v_rolls, 1.0, 8.0, min_d,
                                            n_d, carry_bf16=carry_bf16))
    got = ksgm.census_aggregate(tl, tr, v_rolls, 1.0, 8.0, min_d, n_d,
                                carry_bf16=carry_bf16)
    assert got.shape == (n_d,) + tuple(tl.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    # the twin is the materialized aggregation of the census volume
    vol = tstereo._census_volume(tl, tr, min_d, n_d)
    np.testing.assert_array_equal(
        tstereo._sgm_aggregate(vol, 1.0, 8.0, paths, use_kernels=True,
                               carry_bf16=carry_bf16, min_d=min_d).numpy(),
        want)


def test_wrappers_count_only_kernel_launches(census_pair):
    """On CPU tensors the wrappers run the plain twins and launch
    nothing."""
    _, (tl, tr) = census_pair
    ksgm.reset_launch_counts()
    a = ksgm.census_aggregate(tl, tr, (0,), 1.0, 8.0, 1, 7)
    b = tsgm.census_aggregate(tl, tr, (0,), 1.0, 8.0, 1, 7)
    assert torch.equal(a, b)
    assert all(v == 0 for v in ksgm.LAUNCHES.values())
