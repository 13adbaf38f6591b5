"""The port's column-slab segmentation (`parallel/frame_sharding.py`)
against its replicated segmentation and against the JAX package's
`slab_segmentation`, for each slab count of tests/test_frame_sharding.py.

Tolerances: assignment and `stable` exact; the other seed planes within
1e-5 (m for positions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from densesurfelmapping_tpu.core.state import pad_frame
from densesurfelmapping_tpu.parallel import frame_sharding as jfs
from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.ops import normals as TN
from densesurfelmapping_tpu_torch.ops import superpixel as TS
from densesurfelmapping_tpu_torch.parallel import frame_sharding as tfs

from test_frame_sharding import make_config
from test_golden_superpixel import synthetic_frame

torch.set_num_threads(1)

PLANES = ("x", "y", "mean_intensity", "mean_depth", "size", "view_cos",
          "norm", "pos")


def jax_slab_segmentation(cfg, n_slabs, pi, pd):
    mesh = jsh.make_mesh(n_slabs, data=1)
    ext = jfs._extended_geometry(cfg, n_slabs)

    def body(image, depth):
        return jfs.slab_segmentation(cfg, ext, n_slabs, image, depth)

    from densesurfelmapping_tpu.ops import superpixel as JS
    shape_seeds, _ = jax.eval_shape(
        lambda i, d: JS.run_slic(cfg, i, d, use_pallas=False), pi, pd)
    seeds_spec = jax.tree.map(lambda _: P(), shape_seeds)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P()),
        out_specs=(seeds_spec, P()), check_vma=False))(pi, pd)


@pytest.mark.parametrize("n_slabs", [2, 8])
def test_slab_segmentation_matches_replicated_and_jax(n_slabs):
    cfg = make_config()
    tc = tcfg.SurfelMapConfig.from_json(cfg.to_json())
    pi, pd = pad_frame(cfg, *synthetic_frame(cfg))
    ti, td = torch.from_numpy(pi), torch.from_numpy(pd)

    want_seeds, want_assign = TS.run_slic(tc, ti, td)
    want_seeds, _ = TN.compute_seed_planes(tc, want_seeds, want_assign, td)
    got = tfs.slab_segmentation(tc, n_slabs, ti, td)
    assert len(got) == n_slabs
    jseeds, jassign = jax_slab_segmentation(cfg, n_slabs, jnp.asarray(pi),
                                            jnp.asarray(pd))
    for seeds, assign in got:
        assert torch.equal(assign, want_assign)
        np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
        assert torch.equal(seeds.stable, want_seeds.stable)
        np.testing.assert_array_equal(seeds.stable.numpy(),
                                      np.asarray(jseeds.stable))
        for name in PLANES:
            g = getattr(seeds, name).numpy()
            np.testing.assert_allclose(
                g, getattr(want_seeds, name).numpy(), rtol=0, atol=1e-5,
                err_msg=name)
            np.testing.assert_allclose(
                g, np.asarray(getattr(jseeds, name)), rtol=0, atol=1e-5,
                err_msg=name)
    # the stage did its work: planes were fitted
    assert (want_seeds.view_cos > 0).sum() > 20


def test_slab_geometry_and_kernel_refusal():
    """Each slab's geometry is the JAX package's slice of the extended
    grid; asking for the SLIC kernels with a geometry override raises."""
    cfg = make_config()
    tc = tcfg.SurfelMapConfig.from_json(cfg.to_json())
    ext = jfs._extended_geometry(cfg, 4)
    for s in range(4):
        g = tfs.slab_geometry(tc, 4, s, torch.device("cpu"))
        jg = jfs._slab_geom(ext, jnp.int32(s), cfg.sp_size)
        for k in ("pixel_valid", "seed_valid", "flat_id", "interior",
                  "win_x", "px_x", "center_x"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(jg[k]),
                                          err_msg=k)
        for key in jg["nb_flat"]:
            np.testing.assert_array_equal(g["nb_flat"][key].numpy(),
                                          np.asarray(jg["nb_flat"][key]))
        assert g["col0"] == int(jg["col0"])
    pi, pd = pad_frame(cfg, *synthetic_frame(cfg))
    g = tfs.slab_geometry(tc, 4, 0, torch.device("cpu"))
    with pytest.raises(ValueError):
        TS.run_slic(tc, torch.from_numpy(pi), torch.from_numpy(pd),
                    use_kernels=True, geom=g)
