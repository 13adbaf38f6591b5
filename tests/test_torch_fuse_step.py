"""The port's one-buffer fuse step against the JAX package's over the same
packed frames (all-true window): count and n_new exact, rows compared after
a lexsort with positions within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core.state import SurfelBank as JBank
from densesurfelmapping_tpu.core.state import pack_aux, pack_frame_with_aux
from densesurfelmapping_tpu.pipeline.fuse_step import jitted_fuse_frame_onebuf
from densesurfelmapping_tpu.pipeline.inactive_pool import FIELDS
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch.core.state import SurfelBank, bank_to_numpy
from densesurfelmapping_tpu_torch.pipeline import fuse_step

from test_driver import tiny_config, render_plane
from test_device_driver import sorted_rows

torch.set_num_threads(1)


def _odd_config(**kw):
    """A camera whose H*W is odd: the packed depth and aux start at
    unaligned byte offsets."""
    cam = CameraIntrinsics(width=63, height=47, fx=60.0, fy=60.0,
                           cx=31.0, cy=23.0)
    return SurfelMapConfig(camera=cam, lane_align=8, **kw)


def _run(ref, n_frames):
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    jbank = JBank.empty(ref.surfel_capacity)
    tbank = SurfelBank.empty(cfg.surfel_capacity, "cpu")
    step = jitted_fuse_frame_onebuf(ref)
    mask = np.ones(ref.max_keyframes, bool)
    stats = []
    for i in range(n_frames):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[2, 3] = 0.3 * i, 0.1 * i
        img, dep = render_plane(ref, pose, noise=0.01, seed=i)
        buf = pack_frame_with_aux(ref, img, dep, pack_aux(pose, i, mask))
        jbank, js = step(jbank, jnp.asarray(buf))
        _, ts = fuse_step.fuse_frame_onebuf(cfg, tbank, torch.from_numpy(buf))
        stats.append(({k: int(v) for k, v in js.items()},
                      {k: int(v) for k, v in ts.items()}))
    n = int(jbank.count)
    want = {k: np.asarray(getattr(jbank, k))[:n] for k in FIELDS}
    return stats, want, bank_to_numpy(tbank)


@pytest.fixture(scope="module", params=["tiny", "odd"])
def run(request):
    if request.param == "tiny":
        ref = tiny_config(surfel_capacity=8192, max_keyframes=64)
    else:
        ref = _odd_config(surfel_capacity=4096, max_keyframes=8)
    return _run(ref, 3)


def test_stats_match(run):
    stats, _, _ = run
    for i, (js, ts) in enumerate(stats):
        assert ts == js, i
    assert stats[0][0]["n_new"] > 0 and stats[-1][0]["n_fused_seeds"] > 0


def test_bank_rows_match(run):
    _, want, got = run
    assert len(got["color"]) == len(want["color"])
    a, b = sorted_rows(got), sorted_rows(want)
    np.testing.assert_array_equal(a["update_times"], b["update_times"])
    np.testing.assert_array_equal(a["last_update"], b["last_update"])
    for k in ("position", "normal"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(a["color"], b["color"], atol=1e-3)
