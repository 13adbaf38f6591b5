"""The host-pool driver's captured programs (`pipeline/driver.py::
SurfelMapping` over `pipeline/fuse_step.py`'s StepGraph and BankGraph) on
the CPU, where each graph runs its program eagerly through the same static
inputs, at the 120 x 56 config of tests/test_torch_step_graph.py.  The CUDA
graphs themselves are held to eager references by chip_smoke.py's `graph`
phase.

Checked here: each host-pool fuse step as a StepGraph is bitwise the eager
step and within 1e-6 m of the JAX package's `jitted_fuse_frame_compact` /
`jitted_fuse_frame`; the bank programs as BankGraphs (compaction, the
migration append and extract, the active warp, the device driver's pose
warp and the fleet's batched compaction and warp) are bitwise the eager
programs; a host-pool drive with migrations, a re-activation, a loop warp
and compaction stays within 1e-5 m of the JAX SurfelMapping (bank and pool,
compact and padded uploads; a stereo drive within 1e-4 m), also when
resumed from a JAX checkpoint; the driver rebuilds its graphs on
enable_stereo and on a checkpoint load, and ShardedSurfelMapping builds its
mesh programs as graphs too."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models.stereo import StereoConfig as JaxStereo
from densesurfelmapping_tpu.pipeline import fuse_step as jfs
from densesurfelmapping_tpu.pipeline.driver import (
    SurfelMapping as JaxSurfelMapping)
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import (FrameInput, SurfelBank,
                                                     bank_to_numpy,
                                                     compact_frame)
from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
from densesurfelmapping_tpu_torch.ops import fusion, migration
from densesurfelmapping_tpu_torch.ops import warp as warp_ops
from densesurfelmapping_tpu_torch.parallel import multistream
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    DeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping
from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
    ShardedSurfelMapping)

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
# a window of the newest keyframe and its direct neighbours, so keyframes
# migrate to the pool from the third frame on; a small slack, so the stats
# frames compact
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      drift_free_poses=2, migration_buffer=1024,
                      stats_interval=2, compaction_slack=8)
FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update")
TOL_M = 1e-6          # one step against the JAX step, plus one f32 ulp
ULP = 2.0 ** -23      # of the coordinate (1.9e-6 m at the 18 m wall)
DRIVE_TOL_M = 1e-5    # a drive against the JAX driver
STEREO_TOL_M = 1e-4   # a stereo drive against the JAX driver
N_CHAIN = 6           # keyframes of the chain before the loop


def port(cfg):
    return tcfg.SurfelMapConfig.from_json(cfg.to_json())


# the textured scene of the stereo tests (tests/test_torch_stereo_fuse.py)
SCENE = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                        boxes=synthetic.default_scene().boxes,
                        max_depth=25.0, texture="multisine")
POSES = synthetic.forward_trajectory(N_CHAIN, step=0.4)
FRAMES = [SCENE.render(CFG, p) for p in POSES]


def feed(drv, i, pose, frame, is_keyframe=True, **kw):
    drv.feed_pose(float(i), pose, is_keyframe=is_keyframe, **kw)
    drv.feed_image(float(i), frame[0])
    drv.feed_depth(float(i), frame[1])


def chain(drv, frames=range(N_CHAIN)):
    """Keyframes moving forward: keyframes leave the window and migrate."""
    for i in frames:
        feed(drv, i, POSES[i], FRAMES[i])
    return drv


def loop(drv):
    """A revisit of keyframe 0 linked to it by a loop edge (its surfels
    come back from the pool: the append), then a pose-graph correction of
    every keyframe by +0.5 m in y (the active warp and the pool's warp)
    with one more frame, referenced to the revisiting keyframe, fused after
    it."""
    feed(drv, N_CHAIN, POSES[0], FRAMES[0], loop_edges=[(N_CHAIN, 0)])
    shift = np.eye(4)
    shift[1, 3] = 0.5
    path = [shift @ kf.cam_pose for kf in drv.graph.keyframes]
    feed(drv, N_CHAIN + 1, shift @ POSES[1], FRAMES[1], is_keyframe=False,
         loop_path=path)
    return drv


def jax_rows(jbank) -> dict:
    n = int(jbank.count)
    return {k: np.asarray(getattr(jbank, k))[:n] for k in FIELDS}


def close_rows(got, want, what, tol, rtol=0.0):
    assert len(got["color"]) == len(want["color"]) > 0, what
    for k in FIELDS:
        a, b = got[k], np.asarray(want[k])
        if k in ("update_times", "last_update"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=tol,
                                       err_msg=f"{what} {k}")


def same_drive(t, j, tol=DRIVE_TOL_M):
    """Window, frames, bank rows (in order) and every pool slab."""
    assert t.frames_fused == j.frames_fused
    assert t.local_indices == j.local_indices
    close_rows(bank_to_numpy(t.bank), jax_rows(j.bank), "bank", tol)
    assert set(t.pool.slabs) == set(j.pool.slabs) != set()
    for k in t.pool.slabs:
        close_rows(t.pool.slabs[k], j.pool.slabs[k], f"pool {k}", tol)


# ---------------------------------------------------------------------------
# the graphed fuse steps
# ---------------------------------------------------------------------------
def _payload(kind, img, dep, pose, i):
    aux = jstate.pack_aux(pose, i, np.zeros(0, bool))
    if kind == "compact":
        return jstate.pack_frame_with_aux(CFG, img, dep, aux)
    planes = jstate.pad_frame(CFG, img, dep)
    return np.concatenate([np.asarray(p, np.float32).reshape(-1).view(
        np.uint8) for p in planes] + [aux])


@pytest.mark.parametrize("kind", ["compact", "padded"])
def test_host_pool_step_is_the_eager_step_and_matches_jax(kind):
    """A StepGraph fed the packed payloads gives the eager step's bank and
    stats bitwise; both within 1e-6 m and one f32 ulp of the coordinate of
    the JAX package's jit of the same step (jitted_fuse_frame_compact /
    jitted_fuse_frame)."""
    tc = port(CFG)
    graphed = SurfelBank.empty(tc.surfel_capacity, "cpu")
    eager = SurfelBank.empty(tc.surfel_capacity, "cpu")
    if kind == "compact":
        step = tfs.graphed_fuse_frame_compact(tc, graphed)
        jstep = jfs.jitted_fuse_frame_compact(CFG)
        n_bytes = 3 * 56 * 120 + 72
    else:
        step = tfs.graphed_fuse_frame(tc, graphed)
        jstep = jfs.jitted_fuse_frame(CFG)
        n_bytes = 8 * CFG.padded_height * CFG.padded_width + 72
    assert step.buf.shape == (n_bytes,) and step.bank is graphed
    jbank = jstate.SurfelBank.empty(CFG.surfel_capacity)
    for i, ((img, dep), pose) in enumerate(zip(FRAMES[:3], POSES)):
        got = step(torch.from_numpy(_payload(kind, img, dep, pose, i)))
        pose32 = torch.from_numpy(np.asarray(pose, np.float32))
        idx = torch.tensor(i, dtype=torch.int32)
        if kind == "compact":
            ci, cd = compact_frame(tc, img, dep)
            _, want = tfs.fuse_frame_compact(tc, eager, torch.from_numpy(ci),
                                             torch.from_numpy(cd), pose32,
                                             idx)
            jci, jcd = jstate.compact_frame(CFG, img, dep)
            jbank, jstats = jstep(jbank, jnp.asarray(jci), jnp.asarray(jcd),
                                  jnp.asarray(pose, jnp.float32),
                                  jnp.int32(i))
        else:
            pi, pd = jstate.pad_frame(CFG, img, dep)
            _, want = tfs.fuse_frame(tc, eager, FrameInput(
                image=torch.from_numpy(pi), depth=torch.from_numpy(pd),
                pose=pose32, frame_index=idx))
            jbank, jstats = jstep(jbank, jstate.FrameInput(
                image=jnp.asarray(pi), depth=jnp.asarray(pd),
                pose=jnp.asarray(pose, jnp.float32), frame_index=jnp.int32(i)))
        assert set(got) == set(want) == set(jstats)
        for k in got:
            assert torch.equal(got[k], want[k]), k
            assert int(got[k]) == int(jstats[k]), k
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(graphed, k), getattr(eager, k)), k
    close_rows(bank_to_numpy(graphed), jax_rows(jbank), "graphed vs jax",
               TOL_M, ULP)


# ---------------------------------------------------------------------------
# the bank programs
# ---------------------------------------------------------------------------
def _filled_bank(seed=0):
    """A bank of three fused frames with every third row killed (holes for
    compaction) and rows owned by keyframes 0-2."""
    tc = port(CFG)
    bank = SurfelBank.empty(tc.surfel_capacity, "cpu")
    for i in range(3):
        img, dep = FRAMES[i]
        ci, cd = compact_frame(tc, img, dep)
        tfs.fuse_frame_compact(tc, bank, torch.from_numpy(ci),
                               torch.from_numpy(cd), torch.from_numpy(
                                   np.asarray(POSES[i], np.float32)),
                               torch.tensor(i, dtype=torch.int32))
    n = int(bank.count)
    rng = np.random.default_rng(seed)
    kill = torch.from_numpy(rng.random(n) < 0.3)
    bank.update_times[:n][kill] = 0
    return bank


def _clone(bank):
    return SurfelBank(**{k: getattr(bank, k).clone()
                         for k in FIELDS + ("count",)})


def _rigid(rng, n):
    """n random rigid 4x4 transforms, f32."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for m in out:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m[:3, :3] = q * np.sign(np.linalg.det(q))
        m[:3, 3] = rng.normal(size=3)
    return out


def _programs(rng):
    """name -> (graph factory on a bank, eager program on a bank, inputs)
    for the single-bank programs."""
    tc = port(CFG)
    P = tc.max_keyframes
    m = tc.migration_buffer
    slab = {k: np.zeros((m,) + ((3,) if k in ("position", "normal") else ()),
                        np.int32 if k in ("update_times", "last_update")
                        else np.float32) for k in FIELDS}
    n = 200
    for k in FIELDS:
        slab[k][:n] = rng.integers(1, 9, slab[k][:n].shape) \
            if slab[k].dtype == np.int32 else rng.normal(
                size=slab[k][:n].shape)
    ids = np.full(migration.MAX_REMOVE_POSES, -1, np.int32)
    ids[:2] = (0, 2)
    warps = _rigid(rng, P)
    moved = rng.random(P) < 0.5
    window = rng.random(P) < 0.5
    return {
        "compact": (lambda b: tfs.graphed_compact(b),
                    fusion.compact_bank, ()),
        "append": (lambda b: tfs.graphed_append(tc, b),
                   lambda b, *a: fusion.append_new(
                       b, {k: torch.from_numpy(slab[k]) for k in FIELDS},
                       torch.arange(m) < n),
                   tuple(slab[k] for k in FIELDS) + (np.int32(n),)),
        "extract": (lambda b: tfs.graphed_extract(tc, b),
                    lambda b, *a: migration.extract_by_pose(
                        b, torch.from_numpy(ids), m), (ids,)),
        "warp_active": (lambda b: tfs.graphed_warp_active(b),
                        lambda b, *a: warp_ops.warp_active(
                            b, torch.from_numpy(warps[1])), (warps[1],)),
        "warp_bank_by_pose": (
            lambda b: tfs.graphed_warp_bank_by_pose(tc, b),
            lambda b, *a: warp_ops.warp_bank_by_pose(
                b, torch.from_numpy(warps), torch.from_numpy(moved),
                torch.from_numpy(window), 1),
            (warps, moved, window, np.int64(1))),
    }


def _same_out(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same_out(got[k], want[k], f"{what} {k}")
    elif isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _same_out(g, w, f"{what} {i}")
    elif want is not None:
        assert torch.equal(got, want), what


@pytest.mark.parametrize("name", ["compact", "append", "extract",
                                  "warp_active", "warp_bank_by_pose"])
def test_bank_graph_is_the_eager_program(name):
    """Each bank program as a BankGraph (two calls through its static
    inputs) writes the bank and returns the outputs of the eager program,
    bitwise."""
    rng = np.random.default_rng(1)
    make, eager_fn, args = _programs(rng)[name]
    graphed = _filled_bank()
    eager = _clone(graphed)
    prog = make(graphed)
    assert prog.bank is graphed
    assert len(prog.inputs) == len(args)
    for call in range(2):
        got = prog(*args)
        for s, a in zip(prog.inputs, args):
            assert torch.equal(s, torch.as_tensor(a).to(s.dtype))
        want = eager_fn(eager, *args)
        _same_out(got, want, f"{name} call {call}")
        for k in FIELDS + ("count",):
            assert torch.equal(getattr(graphed, k), getattr(eager, k)), \
                f"{name} call {call} {k}"
    assert prog.graph is None     # a CPU bank: nothing captured


@pytest.mark.parametrize("name", ["batched_compact", "batched_warp"])
def test_fleet_bank_graph_is_the_eager_program(name):
    """The fleet's batched compaction and warp as BankGraphs are bitwise
    `multistream.batched_compact` / `batched_warp` on two streams."""
    tc = port(CFG)
    rng = np.random.default_rng(2)
    banks = multistream.make_banks(tc, 2, "cpu")
    for k, seed in enumerate((0, 1)):
        one = _filled_bank(seed)
        for f in FIELDS + ("count",):
            getattr(banks, f)[k].copy_(getattr(one, f))
    eager = _clone(banks)
    P = tc.max_keyframes
    if name == "batched_compact":
        prog, args = multistream.graphed_compact(banks), ()
        run = multistream.batched_compact
    else:
        args = (np.stack([_rigid(rng, P) for _ in range(2)]),
                rng.random((2, P)) < 0.5, rng.random((2, P)) < 0.5,
                np.array([0, 2], np.int32))
        prog = multistream.graphed_warp(tc, banks)
        run = multistream.batched_warp
    prog(*args)
    run(eager, *(torch.from_numpy(np.asarray(a)) for a in args))
    for f in FIELDS + ("count",):
        assert torch.equal(getattr(banks, f), getattr(eager, f)), f


# ---------------------------------------------------------------------------
# the driver against the JAX SurfelMapping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compact_upload", [True, False])
def test_host_pool_drive_matches_jax(compact_upload):
    """The keyframe chain (migrations), the loop edge (a re-activation
    append), the correction (active and pool warps) and the stats-driven
    compaction: the port's graphed SurfelMapping within 1e-5 m of the JAX
    SurfelMapping, bank rows in order and every pool slab."""
    cfg = dataclasses.replace(CFG, compact_upload=compact_upload)
    t = loop(chain(SurfelMapping(port(cfg), device="cpu")))
    j = loop(chain(JaxSurfelMapping(cfg)))
    assert t.frames_fused == N_CHAIN + 2
    assert 0 in t.local_indices and 0 not in t.pool.slabs
    assert t.compactions > 0
    same_drive(t, j)


def test_host_pool_stereo_drive_matches_jax():
    """Four stereo pairs (box matcher) through the host-pool driver's
    stereo step, against the JAX SurfelMapping within 1e-4 m."""
    kw = dict(max_disparity=64, min_disparity=1, radius=3)
    baseline = 0.5
    t = SurfelMapping(port(CFG), device="cpu")
    j = JaxSurfelMapping(CFG)
    t.enable_stereo(bf=CAM.fx * baseline, stereo_config=StereoConfig(**kw))
    j.enable_stereo(bf=CAM.fx * baseline,
                    stereo_config=JaxStereo(**dict(kw, sgm_pallas=False)))
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.15 * i
        rp = pose.copy()
        rp[:3, 3] += rp[:3, 0] * baseline
        li, ri = SCENE.render(CFG, pose)[0], SCENE.render(CFG, rp)[0]
        for m in (t, j):
            m.feed_pose(float(i), pose, is_keyframe=True)
            m.feed_stereo(float(i), li, ri)
    assert t.frames_fused == 4 and t._stereo_graph.bank is t.bank
    same_drive(t, j, STEREO_TOL_M)


def test_jax_checkpoint_resumes_with_rebuilt_graphs(tmp_path):
    """A JAX host-pool checkpoint (bank, graph, pool) loaded into the port:
    every graph is rebuilt against the loaded bank, and the loop and the
    correction fed to both give the JAX map within 1e-5 m."""
    j = chain(JaxSurfelMapping(CFG))
    path = str(tmp_path / "jax_pool.npz")
    j.save_checkpoint(path)
    t = SurfelMapping(port(CFG), device="cpu")
    names = ("_fuse_graph", "_compact_graph", "_append_graph",
             "_extract_graph", "_warp_graph")
    old = {n: getattr(t, n) for n in names}
    t.load_checkpoint(path)
    for n in names:
        assert getattr(t, n) is not old[n] and getattr(t, n).bank is t.bank
    same_drive(t, j)
    same_drive(loop(t), loop(j))


def test_enable_stereo_and_checkpoint_load_rebuild_the_graphs(tmp_path):
    """enable_stereo builds the stereo step against the bank (the others
    stay); a checkpoint load builds every graph, the stereo step included,
    against the loaded bank."""
    drv = chain(SurfelMapping(port(CFG), device="cpu"), range(3))
    assert drv._stereo_graph is None
    before = (drv._fuse_graph, drv._compact_graph)
    drv.enable_stereo(bf=CAM.fx * 0.5)
    assert drv._stereo_graph.bank is drv.bank
    assert drv._stereo_graph.buf.shape == (2 * 56 * 120 + 72,)
    assert (drv._fuse_graph, drv._compact_graph) == before
    path = str(tmp_path / "mid.npz")
    drv.save_checkpoint(path)
    stereo = drv._stereo_graph
    drv.load_checkpoint(path)
    assert drv._stereo_graph is not stereo
    assert drv._fuse_graph is not before[0]
    for g in (drv._fuse_graph, drv._stereo_graph, drv._compact_graph,
              drv._append_graph, drv._extract_graph, drv._warp_graph):
        assert g.bank is drv.bank


def test_device_driver_rebuilds_compaction_and_warp(tmp_path):
    """DeviceResidentMapping builds its compaction and pose warp with the
    step, for the current max_keyframes, and again on a checkpoint load;
    the host-pool programs it never runs are not built."""
    drv = DeviceResidentMapping(port(CFG), device="cpu")
    assert drv._pose_warp_graph.inputs[0].shape == (8, 4, 4)
    assert drv._append_graph is None and drv._extract_graph is None
    chain(drv, range(3))
    path = str(tmp_path / "dev.npz")
    drv.save_checkpoint(path)
    old = (drv._compact_graph, drv._pose_warp_graph)
    drv.load_checkpoint(path)
    assert drv._compact_graph is not old[0]
    assert drv._pose_warp_graph is not old[1]
    assert drv._compact_graph.bank is drv._pose_warp_graph.bank is drv.bank


def test_sharded_host_pool_builds_no_graph(monkeypatch):
    """ShardedSurfelMapping builds its mesh programs as graphs over its
    ShardedBanks (the name is the one this test had while they ran
    eagerly): the fuse step and the four bank programs at construction,
    the stereo step at enable_stereo, each against the driver's banks; the
    chain, the loop and the correction run through them."""
    made = []

    class Recorded(tfs.BankGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    class RecordedStep(tfs.StepGraph, Recorded):
        pass

    monkeypatch.setattr(tfs, "StepGraph", RecordedStep)
    monkeypatch.setattr(tfs, "BankGraph", Recorded)
    drv = ShardedSurfelMapping(port(CFG), tsh.make_mesh(2, devices="cpu"))
    names = ("_fuse_graph", "_compact_graph", "_extract_graph",
             "_append_graph", "_warp_graph")
    assert made == [getattr(drv, n) for n in names]
    assert drv._stereo_graph is None
    assert drv._fuse_graph.buf.shape == (1, 8 * 56 * 128 + 72)
    drv = loop(chain(drv))
    assert drv.frames_fused == N_CHAIN + 2 and len(drv.pool) > 0
    assert len(made) == len(names)
    drv.enable_stereo(bf=CAM.fx * 0.5)
    assert made[-1] is drv._stereo_graph and len(made) == len(names) + 1
    assert drv._stereo_graph.buf.shape == (1, 2 * 56 * 120 + 72)
    assert all(getattr(drv, n).bank is drv.bank
               for n in names + ("_stereo_graph",))
    assert not drv.graphed
