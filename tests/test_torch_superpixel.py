"""The port's SLIC (plain twins of the three CUDA kernels) against the JAX
package's XLA path and its Pallas kernels (interpret mode), on the same
numpy frame.  Tolerances: a single sweep is exact; sums to rtol 1e-5 (sum
order); whole SLIC to the JAX package's own Pallas-vs-XLA bounds
(tests/test_pallas_slic.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import (CameraIntrinsics, DRIVE_PROFILE,
                                           SurfelMapConfig)
from densesurfelmapping_tpu.core.state import pad_frame
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.ops import superpixel as JS
from densesurfelmapping_tpu.ops import windows as JW
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.ops import superpixel as TS
from densesurfelmapping_tpu_torch.ops.cuda import kernel
from densesurfelmapping_tpu_torch.ops.cuda import slic as K

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfgs():
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0,
                           cx=59.5, cy=27.5)
    ref = SurfelMapConfig(camera=cam, profile=DRIVE_PROFILE,
                          surfel_capacity=4096)
    return ref, tcfg.SurfelMapConfig.from_json(ref.to_json())


@pytest.fixture(scope="module")
def frame(cfgs):
    ref, _ = cfgs
    img, dep = synthetic.default_scene().render(ref, np.eye(4),
                                                depth_noise=0.02, seed=7)
    return pad_frame(ref, img, dep)


@pytest.fixture(scope="module")
def sweep(cfgs, frame):
    """One JAX XLA sweep + seed update from the initial state."""
    ref, _ = cfgs
    ji, jd = (jnp.asarray(a) for a in frame)

    def f(i, d):
        inv = jnp.where(d > 0.01, 1.0 / jnp.maximum(d, 1e-20), 0.0)
        seeds = JS.initialize_seeds(ref, i, d)
        g = JS._static_geometry(ref)
        asg0 = jnp.where(jnp.asarray(g["pixel_valid"]), 0, -1).astype(
            jnp.int32)
        asg, s1, _ = JS.assign_pixels(ref, seeds, i, inv, asg0)
        s2 = JS.update_seeds(ref, s1, asg, JW.extract_windows(i, 8),
                             JW.extract_windows(d, 8))
        return seeds, asg, s1, s2

    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(ji, jd))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_initial_seeds_exact(cfgs, frame, sweep):
    _, cfg = cfgs
    seeds = TS.initialize_seeds(cfg, _t(frame[0]), _t(frame[1]))
    for name in ("x", "y", "mean_intensity", "mean_depth", "stable"):
        np.testing.assert_array_equal(getattr(seeds, name).numpy(),
                                      getattr(sweep[0], name), err_msg=name)


def test_single_sweep_matches_xla(cfgs, frame, sweep):
    _, cfg = cfgs
    image, depth = _t(frame[0]), _t(frame[1])
    inv = torch.where(depth > 0.01, 1.0 / depth.clamp_min(1e-20), 0.0)
    seeds = TS.initialize_seeds(cfg, image, depth)
    asg0 = torch.where(_t(TS._static_geometry(cfg)["pixel_valid"]), 0,
                       -1).to(torch.int32)
    asg, s1 = TS.assign_pixels(cfg, seeds, image, inv, asg0)
    np.testing.assert_array_equal(asg.numpy(), sweep[1])
    np.testing.assert_array_equal(s1.stable.numpy(), sweep[2].stable)


def test_seed_sums_match_xla(cfgs, frame, sweep):
    ref, cfg = cfgs
    asg = sweep[1]
    n, sx, sy, si, nd, sd = TS.seed_sums(cfg, _t(frame[0]), _t(frame[1]),
                                         _t(asg))
    g = JS._static_geometry(ref)
    member = (np.asarray(JW.extract_windows(jnp.asarray(asg), 8))
              == g["flat_id"][..., None]) & g["interior"]
    iw = np.asarray(JW.extract_windows(jnp.asarray(frame[0]), 8))
    dw = np.asarray(JW.extract_windows(jnp.asarray(frame[1]), 8))
    dmem = member & (dw > 0.1)
    want = (member.sum(-1), (member * g["win_x"]).sum(-1),
            (member * g["win_y"]).sum(-1), (member * iw).sum(-1),
            dmem.sum(-1), (dmem * dw).sum(-1))
    for got, exp in zip((n, sx, sy, si, nd, sd), want):
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=0)


def test_update_seeds_matches_xla(cfgs, frame, sweep):
    """The two plain functions behind update_seeds (sums, then the 5-step
    Huber mean depth) reproduce the JAX update."""
    _, cfg = cfgs
    s1 = sweep[2]
    seeds = TS.initialize_seeds(cfg, _t(frame[0]), _t(frame[1])).replace(
        stable=_t(s1.stable))
    s2 = TS.update_seeds(cfg, seeds, _t(sweep[1]), _t(frame[0]),
                         _t(frame[1]))
    for name in ("x", "y", "mean_intensity", "mean_depth"):
        np.testing.assert_allclose(getattr(s2, name).numpy(),
                                   getattr(sweep[3], name), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(s2.stable.numpy(), sweep[3].stable)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_run_slic_matches_jax(cfgs, frame, use_pallas):
    ref, cfg = cfgs
    js, ja = jax.jit(lambda i, d: JS.run_slic(ref, i, d,
                                              use_pallas=use_pallas))(
        jnp.asarray(frame[0]), jnp.asarray(frame[1]))
    ts, ta = TS.run_slic(cfg, _t(frame[0]), _t(frame[1]))
    mismatch = (ta.numpy() != np.asarray(ja)).mean()
    assert mismatch < 0.01, mismatch
    for name in ("x", "y", "mean_intensity", "mean_depth"):
        ok = np.isclose(getattr(ts, name).numpy(),
                        np.asarray(getattr(js, name)), rtol=5e-3, atol=5e-3)
        assert ok.mean() > 0.98, (name, ok.mean())
    assert (ts.stable.numpy() == np.asarray(js.stable)).mean() > 0.97


def test_cpu_tensors_take_the_plain_twins(cfgs, frame):
    """On CPU tensors the kernel wrappers run the plain functions (no
    launch is counted), so use_kernels=None and False agree exactly."""
    _, cfg = cfgs
    K.reset_launch_counts()
    sa, aa = TS.run_slic(cfg, _t(frame[0]), _t(frame[1]))
    sb, ab = TS.run_slic(cfg, _t(frame[0]), _t(frame[1]), use_kernels=True)
    sc, ac = TS.run_slic(cfg, _t(frame[0]), _t(frame[1]), use_kernels=False)
    assert K.LAUNCHES == {"slic_assign": 0, "slic_centroid": 0,
                          "slic_huber": 0}
    for a, b in ((aa, ab), (aa, ac)):
        assert torch.equal(a, b)
    assert torch.equal(sa.mean_depth, sc.mean_depth)


def test_zero_depth_frame(cfgs):
    _, cfg = cfgs
    h, w = cfg.padded_height, cfg.padded_width
    z = torch.zeros((h, w))
    seeds, asg = TS.run_slic(cfg, z, z)
    assert not torch.isnan(seeds.mean_depth).any()
    assert not torch.isnan(seeds.x).any()
    valid = torch.from_numpy(TS._static_geometry(cfg)["pixel_valid"])
    assert (asg[valid] >= 0).all()


def test_kernel_wrappers_validate_inputs(cfgs):
    _, cfg = cfgs
    rc = (cfg.sp_rows, cfg.sp_cols)
    cpu = torch.device("cpu")
    ok = torch.zeros(rc)
    assert kernel.check("x", ok, torch.float32, rc, cpu) == ok.data_ptr()
    with pytest.raises(TypeError):
        kernel.check("x", ok.double(), torch.float32, rc, cpu)
    with pytest.raises(ValueError):
        kernel.check("x", ok[:, :-1], torch.float32, rc, cpu)
    with pytest.raises(ValueError):
        kernel.check("x", torch.zeros(rc[::-1]).T, torch.float32, rc, cpu)
    with pytest.raises(ValueError):
        kernel.stream(cpu)
