"""The port's axis-sharded SGM (`parallel/sgm_sharding.py`) BITWISE against
its replicated `models/stereo.disparity` on the plain scan path and against
the JAX package's `sharded_sgm_disparity`, on the cases of
tests/test_sgm_sharding.py (4 and 8 paths, the post-median, bf16 carries,
divisible shapes, the prior rescue), over an 8-shard CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu.parallel import sgm_sharding as jsgm
from densesurfelmapping_tpu_torch.models import stereo as tstereo
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.parallel import sgm_sharding as tsgm

from test_sgm_sharding import stereo_pair

torch.set_num_threads(1)


def both(paths, post_median, seed=0, h=44, w=93, n=8, prior=False,
         **kw):
    left, right, max_d = stereo_pair(h=h, w=w, seed=seed)
    jc = jstereo.StereoConfig(max_disparity=max_d, aggregation="sgm",
                              sgm_paths=paths, sgm_pallas=False,
                              post_median=post_median, prior_rescue=prior,
                              **kw)
    tc = tstereo.StereoConfig(**jc._asdict())
    tl, tr = (torch.from_numpy(np.array(a)) for a in (left, right))
    base = tstereo.disparity(tl, tr, tc)
    prior_t = None
    if prior:
        prior_t = torch.where(base > 0, base, 8.0)
    want = tstereo.disparity(tl, tr, tc, prior_disp=prior_t)
    got = tsgm.sharded_sgm_disparity(
        tsh.make_mesh(n, devices="cpu"), tc, h, w)(tl, tr, prior_t)
    jfn = jsgm.sharded_sgm_disparity(jsh.make_mesh(n, data=1), jc, h, w)
    jgot = np.asarray(jfn(left, right) if not prior
                      else jfn(left, right, jnp.asarray(prior_t.numpy())))
    return want, got, jgot


@pytest.mark.parametrize("paths,post_median,seed,shape,kw", [
    (4, False, 0, (44, 93), {}),
    (8, True, 0, (44, 93), {}),
    (4, False, 3, (48, 96), {}),
    (8, False, 7, (44, 93), {"sgm_carry_bf16": True}),
])
def test_sharded_disparity_bitwise(paths, post_median, seed, shape, kw):
    want, got, jgot = both(paths, post_median, seed, *shape, **kw)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jgot)
    assert (want > 0).float().mean() > 0.3


def test_sharded_prior_rescue_bitwise():
    """A replicated prior reaches the rescue gate as on the dense path, and
    it changes the output somewhere (the pin is not vacuous)."""
    want, got, jgot = both(4, False, seed=11, prior=True)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jgot)
    left, right, max_d = stereo_pair(seed=11)
    base = tstereo.disparity(
        torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right)),
        tstereo.StereoConfig(max_disparity=max_d, aggregation="sgm",
                             sgm_paths=4, sgm_pallas=False,
                             post_median=False, prior_rescue=True))
    assert not torch.equal(want, base)


def test_sharded_8_paths_on_2_shards():
    """Two shards (the chip check's mesh): the ring of two, each shard
    both neighbours of the other."""
    want, got, jgot = both(8, False, seed=5, n=2)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_sad_cost_rejected():
    with pytest.raises(ValueError):
        tsgm.sharded_sgm_disparity(
            tsh.make_mesh(8, devices="cpu"),
            tstereo.StereoConfig(cost="sad", aggregation="sgm"), 48, 96)
