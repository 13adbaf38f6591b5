"""The port's batch replay paths (`pipeline/fuse_step.py`:
`fuse_frames_scan`, `fuse_frames_looped`) against the port's single-frame
step and against the JAX package's `lax.scan` paths, at the 120 x 56 config
of tests/test_pallas_slic.py.  On the CPU the looped replay runs its steps
eagerly; the CUDA graph is held to the eager loop by chip_smoke.py's
`batch` phase.

Tolerances: against the port's own step bitwise; against the JAX package
the live-count trace and stats exact, bank floats within 1e-6 (m)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core.state import SurfelBank as JBank
from densesurfelmapping_tpu.core.state import compact_frame
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.pipeline import fuse_step as jfs
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import SurfelBank
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=8192)
FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update")


def stack(k):
    scene = synthetic.default_scene()
    poses = synthetic.forward_trajectory(k, step=0.4)
    ci, cd = zip(*(compact_frame(CFG, *scene.render(CFG, p)) for p in poses))
    return (np.stack(ci), np.stack(cd),
            np.stack(poses).astype(np.float32))


def port_inputs(imgs, deps, poses):
    return (torch.from_numpy(imgs), torch.from_numpy(deps),
            torch.from_numpy(poses))


def same_as_jax(tbank, jbank):
    n = int(jbank.count)
    assert int(tbank.count) == n > 0
    for k in FIELDS:
        got = getattr(tbank, k)[:n].numpy()
        want = np.asarray(getattr(jbank, k))[:n]
        if k in ("update_times", "last_update"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=k)


def test_fuse_frames_scan_matches_steps_and_jax():
    tc = tcfg.SurfelMapConfig.from_json(CFG.to_json())
    imgs, deps, poses = stack(3)
    idx = np.arange(3, dtype=np.int32)
    ti, td, tp = port_inputs(imgs, deps, poses)

    bank = SurfelBank.empty(tc.surfel_capacity, "cpu")
    _, stats = tfs.fuse_frames_scan(tc, bank, ti, td, tp,
                                    torch.from_numpy(idx))
    ref = SurfelBank.empty(tc.surfel_capacity, "cpu")
    ref_stats = [tfs.fuse_frame_compact(tc, ref, ti[i], td[i], tp[i],
                                        torch.tensor(i, dtype=torch.int32))[1]
                 for i in range(3)]
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(bank, k), getattr(ref, k)), k
    for k, v in stats.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([st[k] for st in ref_stats])), k

    jbank, jstats = jax.jit(lambda *a: jfs.fuse_frames_scan(CFG, *a))(
        JBank.empty(CFG.surfel_capacity), jnp.asarray(imgs),
        jnp.asarray(deps), jnp.asarray(poses), jnp.asarray(idx))
    same_as_jax(bank, jbank)
    for k in jstats:
        np.testing.assert_array_equal(stats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)


def test_fuse_frames_looped_matches_jax():
    """2 laps over 2 frames: step t fuses frame t mod 2 with index t."""
    tc = tcfg.SurfelMapConfig.from_json(CFG.to_json())
    imgs, deps, poses = stack(2)
    bank = SurfelBank.empty(tc.surfel_capacity, "cpu")
    _, trace = tfs.fuse_frames_looped(tc, 2, bank,
                                      *port_inputs(imgs, deps, poses))
    jbank, jtrace = jax.jit(
        lambda *a: jfs.fuse_frames_looped(CFG, 2, *a))(
        JBank.empty(CFG.surfel_capacity), jnp.asarray(imgs),
        jnp.asarray(deps), jnp.asarray(poses))
    assert trace.dtype == torch.int32 and trace.shape == (4,)
    np.testing.assert_array_equal(trace.numpy(), np.asarray(jtrace))
    assert (np.diff(trace.numpy()) >= 0).all()
    same_as_jax(bank, jbank)
    # the last lap ran with frame indices 2 and 3
    assert int(bank.last_update[:int(bank.count)].max()) == 3


def test_fuse_frame_packed_matches_compact():
    """The packed single-buffer steps decode to the compact step."""
    from densesurfelmapping_tpu_torch.core.state import pack_frame
    tc = tcfg.SurfelMapConfig.from_json(CFG.to_json())
    scene = synthetic.default_scene()
    pose = np.eye(4, dtype=np.float32)
    img, dep = scene.render(CFG, pose)
    buf = torch.from_numpy(pack_frame(tc, img, dep))
    ci, cd = compact_frame(CFG, img, dep)
    index = torch.tensor(0, dtype=torch.int32)
    a = SurfelBank.empty(tc.surfel_capacity, "cpu")
    b = SurfelBank.empty(tc.surfel_capacity, "cpu")
    c = SurfelBank.empty(tc.surfel_capacity, "cpu")
    tfs.fuse_frame_packed(tc, a, buf, torch.from_numpy(pose), index)
    tfs.fuse_frame_compact(tc, b, torch.from_numpy(ci), torch.from_numpy(cd),
                           torch.from_numpy(pose), index)
    tfs.fuse_frame_windowed_packed(
        tc, c, buf, torch.from_numpy(pose), index,
        torch.ones(tc.max_keyframes, dtype=torch.bool))
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
        assert torch.equal(getattr(c, k), getattr(b, k)), k
    assert int(a.count) > 0
