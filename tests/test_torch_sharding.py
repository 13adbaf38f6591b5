"""The port's mesh execution (`parallel/sharding.py`) against the JAX
package's on the same inputs: a CPU mesh of the shape of the JAX tests' 8
virtual devices.  Because the bank layout is the JAX layout (equal row slabs
per shard, round-robin new surfels), each (stream, shard) is held against
the same shard of the JAX bank.

Tolerances: counts, update_times and last_update exact; positions and
normals within 1e-5 m; compact_and_append and the sharded prior exact."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.core.state import FrameInput as JFrame
from densesurfelmapping_tpu.core.state import SurfelBank as JBank
from densesurfelmapping_tpu.core.state import pad_frame
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.ops import fusion as jfusion
from densesurfelmapping_tpu.ops import migration as jmigration
from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import FrameInput, SurfelBank
from densesurfelmapping_tpu_torch.core.state import bank_from_numpy
from densesurfelmapping_tpu_torch.ops import fusion as tfusion
from densesurfelmapping_tpu_torch.parallel import sharding as tsh

from test_driver import tiny_config

torch.set_num_threads(1)

FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update")
EXACT = ("update_times", "last_update")


def port_config(cfg):
    return tcfg.SurfelMapConfig.from_json(cfg.to_json())


def make_frames(cfg, poses, scene):
    imgs, deps = [], []
    for pose in poses:
        pi, pd = pad_frame(cfg, *scene.render(cfg, pose))
        imgs.append(pi)
        deps.append(pd)
    return np.stack(imgs), np.stack(deps)


def same_shards(jbanks, tbanks, n_shards, tol=1e-5):
    """Every (stream, shard) of the port's banks against the same shard of
    the JAX banks: counts, then the allocated rows."""
    jcounts = np.asarray(jbanks.count)
    np.testing.assert_array_equal(tbanks.counts(), jcounts)
    slab = np.asarray(jbanks.position).shape[1] // n_shards
    assert tbanks.rows_per_shard == slab
    for k in FIELDS:
        jf = np.asarray(getattr(jbanks, k))
        tf = tbanks.host(k)
        for b in range(jf.shape[0]):
            for s in range(n_shards):
                n = int(jcounts[b, s])
                got = tf[b, s * slab:s * slab + n]
                want = jf[b, s * slab:s * slab + n]
                if k in EXACT:
                    np.testing.assert_array_equal(got, want, err_msg=k)
                else:
                    np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                               err_msg=k)


def drive_both(cfg, stream_poses, n_streams=2, data=2):
    """Two fuse steps of the sharded step in both packages on a
    (data, 8 / data) mesh; stream b fuses stream_poses[b]."""
    scene = synthetic.default_scene()
    jmesh = jsh.make_mesh(8, data=data)
    tmesh = tsh.make_mesh(8, data=data, devices="cpu")
    tc = port_config(cfg)
    jstep = jsh.sharded_fuse_frame(cfg, jmesh)
    tstep = tsh.sharded_fuse_frame(tc, tmesh)
    jbanks = jsh.replicate_banks(jmesh, cfg, n_streams=n_streams)
    tbanks = tsh.replicate_banks(tmesh, tc, n_streams=n_streams)
    for t in range(len(stream_poses[0])):
        poses = [stream_poses[b][t] for b in range(n_streams)]
        imgs, deps = make_frames(cfg, poses, scene)
        pose_arr = np.stack(poses).astype(np.float32)
        jframes = jsh.shard_frames(jmesh, JFrame(
            image=jnp.asarray(imgs), depth=jnp.asarray(deps),
            pose=jnp.asarray(pose_arr),
            frame_index=jnp.full((n_streams,), t, jnp.int32)))
        jbanks, jstats = jstep(jbanks, jframes)
        tframes = tsh.shard_frames(tmesh, FrameInput(
            image=torch.from_numpy(imgs), depth=torch.from_numpy(deps),
            pose=torch.from_numpy(pose_arr),
            frame_index=torch.full((n_streams,), t, dtype=torch.int32)))
        tbanks, tstats = tstep(tbanks, tframes)
        for k in ("n_live", "n_new", "n_dropped", "n_fused_seeds"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
    return (jmesh, jbanks), (tmesh, tbanks), tc


@pytest.fixture(scope="module")
def two_streams():
    """The case of tests/test_sharding.py::test_sharded_matches_single_
    device: 2 streams x 4 shards, stream 1 one pose ahead."""
    cfg = tiny_config(surfel_capacity=4096)
    poses = synthetic.forward_trajectory(2, step=0.3)
    return cfg, drive_both(cfg, [[poses[0], poses[1]],
                                 [poses[1], poses[0]]])


def test_sharded_fuse_matches_jax(two_streams):
    cfg, ((_, jbanks), (_, tbanks), _) = two_streams
    assert tbanks.counts().sum() > 0
    same_shards(jbanks, tbanks, 4)


def test_sharded_fuse_matches_dense_port(two_streams):
    """Each stream's sharded bank holds the rows of the port's dense step
    over the same frames (as sets)."""
    from densesurfelmapping_tpu_torch.pipeline.fuse_step import fuse_frame
    cfg, (_, (_, tbanks), tc) = two_streams
    scene = synthetic.default_scene()
    poses = synthetic.forward_trajectory(2, step=0.3)
    counts = tbanks.counts()
    for b, seq in enumerate(([poses[0], poses[1]], [poses[1], poses[0]])):
        dense = SurfelBank.empty(tc.surfel_capacity, "cpu")
        for t, pose in enumerate(seq):
            pi, pd = pad_frame(cfg, *scene.render(cfg, pose))
            fuse_frame(tc, dense, FrameInput(
                image=torch.from_numpy(pi), depth=torch.from_numpy(pd),
                pose=torch.from_numpy(pose.astype(np.float32)),
                frame_index=torch.tensor(t, dtype=torch.int32)))
        live = dense.live_mask.numpy()
        want = np.sort(dense.position.numpy()[live], axis=0)
        got = np.sort(tsh.live_rows(tbanks.host("position")[b], counts[b]),
                      axis=0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mesh_shapes():
    assert tsh.make_mesh(8, data=4, devices="cpu").shape == \
        {"data": 4, "surfel": 2}
    assert tsh.make_mesh(8, devices="cpu").shape == {"data": 1, "surfel": 8}
    mesh = tsh.make_mesh(4, data=2, devices=["cpu", "cpu"])
    assert mesh.device(1, 1) == torch.device("cpu")
    with pytest.raises(ValueError):
        tsh.make_mesh(6, data=4, devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsh.make_mesh(2)
        with pytest.raises(RuntimeError):
            tsh.make_mesh(2, devices="cuda")


def test_sharded_bank_lifecycle_matches_jax():
    """The lifecycle case of tests/test_sharding.py (extract, compact,
    active warp) plus append and the per-pose warp, each step held
    shard by shard against the JAX package's."""
    cfg = tiny_config(surfel_capacity=4096)
    poses = synthetic.forward_trajectory(2, step=0.3)
    (jmesh, jb), (tmesh, tb), tc = drive_both(cfg, [poses, poses])
    n_shards = 4

    ids = np.full(jmigration.MAX_REMOVE_POSES, -1, np.int32)
    ids[0] = 0
    jb, jbufs, jns = jsh.sharded_extract_by_pose(cfg, jmesh, 512)(
        jb, jnp.asarray(ids))
    tb, tbufs, tns = tsh.sharded_extract_by_pose(tc, tmesh, 512)(
        tb, torch.from_numpy(ids))
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))
    assert (tns.numpy() > 0).any()
    for k in FIELDS:
        np.testing.assert_allclose(tbufs[k].numpy(), np.asarray(jbufs[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    same_shards(jb, tb, n_shards)

    jb = jsh.sharded_compact(cfg, jmesh)(jb)
    tsh.sharded_compact(tc, tmesh)(tb)
    same_shards(jb, tb, n_shards)

    warp0 = np.eye(4, dtype=np.float32)
    warp0[1, 3] = 1.0
    warps = np.stack([warp0, np.eye(4, dtype=np.float32)])
    jb = jsh.sharded_warp_active(cfg, jmesh)(jb, jnp.asarray(warps))
    tsh.sharded_warp_active(tc, tmesh)(tb, torch.from_numpy(warps))
    same_shards(jb, tb, n_shards)

    # re-append the extracted rows, round-robin slices per shard
    per = 256
    rng = np.random.default_rng(0)
    ns = rng.integers(0, per, (2, n_shards)).astype(np.int32)
    fields = {k: np.asarray(jbufs[k])[:, :n_shards * per] for k in FIELDS}
    jb = jsh.sharded_append(cfg, jmesh, per)(
        jb, {k: jnp.asarray(v) for k, v in fields.items()}, jnp.asarray(ns))
    tsh.sharded_append(tc, tmesh, per)(
        tb, {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in fields.items()}, torch.from_numpy(ns))
    same_shards(jb, tb, n_shards)

    P = cfg.max_keyframes
    wst = np.tile(np.eye(4, dtype=np.float32), (2, P, 1, 1))
    wst[:, 1, 0, 3] = 0.5
    wst[:, 0, 2, 3] = -0.25
    moved = np.zeros((2, P), bool)
    moved[:, :2] = True
    masks = np.zeros((2, P), bool)
    masks[0, 1] = True
    firsts = np.array([1, 0], np.int32)
    jb = jsh.sharded_warp_by_pose(cfg, jmesh)(
        jb, jnp.asarray(wst), jnp.asarray(moved), jnp.asarray(masks),
        jnp.asarray(firsts))
    tsh.sharded_warp_by_pose(tc, tmesh)(
        tb, torch.from_numpy(wst), torch.from_numpy(moved),
        torch.from_numpy(masks), torch.from_numpy(firsts.astype(np.int64)))
    same_shards(jb, tb, n_shards)


def _random_bank(rng, cap, count, dead_frac):
    n = count
    fields = dict(
        position=rng.normal(size=(n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        color=rng.uniform(0, 255, n).astype(np.float32),
        size=rng.uniform(0, 1, n).astype(np.float32),
        weight=rng.uniform(0, 1, n).astype(np.float32),
        update_times=np.where(rng.uniform(size=n) < dead_frac, 0,
                              rng.integers(1, 9, n)).astype(np.int32),
        last_update=rng.integers(-1, 9, n).astype(np.int32))
    jb = JBank.empty(cap)
    upd = {k: jnp.asarray(np.asarray(getattr(jb, k)).copy()) for k in FIELDS}
    for k in FIELDS:
        upd[k] = upd[k].at[:n].set(fields[k])
    jb = jb.replace(count=jnp.int32(n), **upd)
    return jb, bank_from_numpy(fields, n, "cpu", cap)


@pytest.mark.parametrize("count,n_new", [(40, 25), (90, 30), (0, 12)])
def test_compact_and_append_matches_jax(count, n_new):
    """Out of place, exact: the live rows repacked in order, then the valid
    new rows; the overflow case drops (90 live-or-dead rows + 30 new into
    100)."""
    rng = np.random.default_rng(count + n_new)
    cap = 100
    jb, tb = _random_bank(rng, cap, count, dead_frac=0.3)
    S = 48
    new = dict(
        position=rng.normal(size=(S, 3)).astype(np.float32),
        normal=rng.normal(size=(S, 3)).astype(np.float32),
        color=rng.uniform(0, 255, S).astype(np.float32),
        size=rng.uniform(0, 1, S).astype(np.float32),
        weight=rng.uniform(0, 1, S).astype(np.float32),
        update_times=np.ones(S, np.int32),
        last_update=np.full(S, 3, np.int32))
    mask = np.zeros(S, bool)
    mask[rng.choice(S, n_new, replace=False)] = True
    jout, jst = jfusion.compact_and_append(
        jb, {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(mask))
    before = {k: getattr(tb, k).clone() for k in FIELDS + ("count",)}
    tout, tst = tfusion.compact_and_append(
        tb, {k: torch.from_numpy(v) for k, v in new.items()},
        torch.from_numpy(mask))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tout, k).numpy(),
                                      np.asarray(getattr(jout, k)),
                                      err_msg=k)
        assert torch.equal(getattr(tb, k), before[k]), "not out of place"
    assert int(tout.count) == int(jout.count)
    for k in ("n_live", "n_new", "n_dropped"):
        assert int(tst[k]) == int(jst[k]), k


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_prior_matches_dense(n_shards):
    """Each shard's merged prior equals the dense bank's render exactly
    (and the JAX package's): a min over the shards' z-buffers."""
    from densesurfelmapping_tpu.ops.render import render_prior_depth as jr
    from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
    from densesurfelmapping_tpu_torch.pipeline.fuse_step import _stereo_prior
    from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
        scatter_rows_to_sharded)

    cfg = tiny_config(surfel_capacity=512)
    tc = port_config(cfg)
    rng = np.random.default_rng(n_shards)
    n = 300
    z = rng.uniform(1.0, 12.0, n).astype(np.float32)
    u = rng.uniform(0, cfg.width, n)
    v = rng.uniform(0, cfg.height, n)
    cam = cfg.camera
    pos = np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z],
                   -1).astype(np.float32)
    rows = dict(position=pos, normal=np.zeros((n, 3), np.float32),
                color=np.zeros(n, np.float32), size=np.zeros(n, np.float32),
                weight=np.ones(n, np.float32),
                update_times=rng.integers(0, 9, n).astype(np.int32),
                last_update=np.zeros(n, np.int32))
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.1
    scfg = StereoConfig(aggregation="sgm", prior_rescue=True)
    dense = bank_from_numpy(rows, n, "cpu", tc.surfel_capacity)
    want = _stereo_prior(tc, scfg, dense, torch.from_numpy(pose))
    mesh = tsh.make_mesh(n_shards, devices="cpu")
    banks = scatter_rows_to_sharded(tc, mesh, rows)
    got = tsh.sharded_prior(tc, scfg, banks.shards[0],
                            [torch.from_numpy(pose)] * n_shards)
    assert (want > 0).sum() > 10
    for g in got:
        assert torch.equal(g, want)
    jb = JBank.empty(cfg.surfel_capacity)
    jb = jb.replace(
        count=jnp.int32(n),
        **{k: jnp.asarray(np.asarray(getattr(jb, k))).at[:n].set(rows[k])
           for k in FIELDS})
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jr(cfg, jb, jnp.asarray(pose),
                                    stride=scfg.prior_stride,
                                    min_updates=scfg.prior_min_updates)))


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip(n_devices):
    """The port's `entry.dryrun_multichip` on a CPU mesh: one sharded step
    equal to the dense step, then the bank lifecycle."""
    from densesurfelmapping_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(n_devices, device="cpu")
    assert out["mesh"] == {"data": 2, "surfel": n_devices // 2}
    assert out["n_new"] > 0
    assert out["live"] + out["extracted"] == out["n_new"]
