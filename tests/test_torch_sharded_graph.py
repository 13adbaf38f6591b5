"""The port's mesh programs as graphs (`parallel/sharding.py::graphed_*`,
`parallel/frame_sharding.py`, `parallel/sgm_sharding.py`, and the sharded
drivers that replay them) on 2- and 8-shard CPU meshes, where each graph
object runs its program eagerly through the same static inputs, at the
120 x 56 config of tests/test_pallas_slic.py.  The CUDA graphs themselves
are held to eager references by chip_smoke.py's `sharded` phase; the
parity of the sharded drivers with the JAX package stays with
tests/test_torch_sharded_driver.py and the other sharded tests.

Checked here, every comparison bitwise (`torch.equal`): the in-place tail
of the mesh step against the out-of-place `compact_and_append` (rows,
order, count, a drop at capacity); each graphed factory against its eager
mesh function; both sharded drivers fed through their graph objects
against drivers that call the eager mesh programs, over a chain with
compactions and a loop warp (the host pool with migrations and a
re-activation); the graphs rebuilt on keyframe growth, a checkpoint load
and enable_stereo, against the current banks; a mesh over several devices
kept on the eager programs, and a capture over several devices refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from densesurfelmapping_tpu_torch.config import (CameraIntrinsics,
                                                 SurfelMapConfig)
from densesurfelmapping_tpu_torch.core.state import (
    FIELDS, FrameInput, SurfelBank, pack_aux, pack_frame_with_aux,
    pack_stereo_pair, pack_stereo_with_aux, pad_frame)
from densesurfelmapping_tpu_torch.io import synthetic
from densesurfelmapping_tpu_torch.models import stereo as ST
from densesurfelmapping_tpu_torch.ops import fusion, migration
from densesurfelmapping_tpu_torch.parallel import frame_sharding as tfsh
from densesurfelmapping_tpu_torch.parallel import sgm_sharding as tsgm
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.parallel.multistream import unpack_payload
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs
from densesurfelmapping_tpu_torch.pipeline.device_driver import (
    ShardedDeviceResidentMapping)
from densesurfelmapping_tpu_torch.pipeline.driver import _StereoPair
from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
    ShardedSurfelMapping)

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
# keyframes leave a window of 2 and migrate (host pool); compaction every
# 4 frames (device-resident) and at stats frames (host pool)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      drift_free_poses=2, migration_buffer=1024,
                      stats_interval=2, compaction_slack=8,
                      compact_interval=4)
HW = CAM.height * CAM.width
SCENE = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                        boxes=synthetic.default_scene().boxes,
                        max_depth=25.0, texture="multisine")
N_CHAIN = 6
POSES = synthetic.forward_trajectory(N_CHAIN, step=0.4)
FRAMES = [SCENE.render(CFG, p) for p in POSES]
BOX = dict(max_disparity=64, min_disparity=1, radius=3)   # box matcher
BASELINE = 0.5


def mesh(n):
    return tsh.make_mesh(n, devices="cpu")


def same_banks(a: tsh.ShardedBanks, b: tsh.ShardedBanks) -> None:
    assert a.n_shards == b.n_shards
    for ra, rb in zip(a.shards, b.shards):
        for s, (x, y) in enumerate(zip(ra, rb)):
            for k in FIELDS + ("count",):
                assert torch.equal(getattr(x, k), getattr(y, k)), (s, k)


def same_stats(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def addresses(banks: tsh.ShardedBanks) -> list:
    return [getattr(b, k).data_ptr() for row in banks.shards for b in row
            for k in FIELDS + ("count",)]


def stereo_pair(i):
    pose = np.eye(4)
    pose[0, 3] = 0.15 * i
    rp = pose.copy()
    rp[:3, 3] += rp[:3, 0] * BASELINE
    return pose, SCENE.render(CFG, pose)[0], SCENE.render(CFG, rp)[0]


# ---------------------------------------------------------------------------
# the in-place tail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("full", [False, True], ids=["room", "capacity"])
def test_in_place_tail_is_the_out_of_place_tail(full):
    """compact_and_append_ writes exactly compact_and_append's bank (rows,
    order, count) and stats into the bank's own tensors; with the bank
    nearly full, new surfels are dropped and counted the same way."""
    rng = np.random.default_rng(3)
    cap, S = 256, 64
    bank = SurfelBank.empty(cap, "cpu")
    n = 240 if full else 100
    for k in FIELDS:
        t = getattr(bank, k)
        t[:n] = torch.from_numpy(rng.integers(1, 50, (n,) + t.shape[1:])
                                 .astype(t.numpy().dtype))
    dead = torch.from_numpy(rng.random(n) < 0.05)
    bank.update_times[:n][dead] = 0
    bank.count.fill_(n)
    new = {k: torch.from_numpy(rng.integers(1, 50, (S,) + getattr(
        bank, k).shape[1:]).astype(getattr(bank, k).numpy().dtype))
        for k in FIELDS}
    mask = torch.from_numpy(rng.random(S) < 0.7)
    want, want_st = fusion.compact_and_append(bank, new, mask)
    before = [getattr(bank, k).data_ptr() for k in FIELDS + ("count",)]
    got_st = fusion.compact_and_append_(bank, new, mask)
    assert [getattr(bank, k).data_ptr()
            for k in FIELDS + ("count",)] == before
    for k in FIELDS + ("count",):
        assert torch.equal(getattr(bank, k), getattr(want, k)), k
    same_stats(got_st, want_st)
    assert (int(got_st["n_dropped"]) > 0) == full


# ---------------------------------------------------------------------------
# each graphed factory against its eager mesh function
# ---------------------------------------------------------------------------
def padded_payload(i, mask=None):
    aux = pack_aux(POSES[i], i, np.zeros(0, bool) if mask is None else mask)
    planes = pad_frame(CFG, *FRAMES[i])
    return np.concatenate([np.asarray(p, np.float32).reshape(-1).view(
        np.uint8) for p in planes] + [aux])


def onebuf_payload(i, mask):
    img, dep = FRAMES[i]
    return pack_frame_with_aux(CFG, img, dep, pack_aux(POSES[i], i, mask))


def stereo_payload(i, mask=None):
    _, li, ri = stereo_pair(i)
    aux = pack_aux(stereo_pair(i)[0], i,
                   np.zeros(0, bool) if mask is None else mask,
                   bf=CAM.fx * BASELINE)
    return pack_stereo_with_aux(CFG, pack_stereo_pair(CFG, li, ri), aux)


def eager_padded(fuse, m, banks, payload, masks=False):
    frames, mask = tsh.unpack_padded(CFG, payload)
    args = (mask,) if masks else ()
    return fuse(banks, tsh.shard_frames(m, frames), *args)[1]


# name: (graphed factory, its eager mesh function, payload(i, mask),
# eager call of the function on the decoded payload)
MASK = np.array([True, True] + [False] * 6)
STEPS = {
    "fuse_frame": (
        tsh.graphed_fuse_frame, tsh.sharded_fuse_frame,
        lambda i: padded_payload(i),
        lambda f, m, b, p: eager_padded(f, m, b, p)),
    "windowed": (
        tsh.graphed_fuse_frame_windowed, tsh.sharded_fuse_frame_windowed,
        lambda i: padded_payload(i, MASK),
        lambda f, m, b, p: eager_padded(f, m, b, p, masks=True)),
    "windowed_packed": (
        tsh.graphed_fuse_frame_windowed_packed,
        tsh.sharded_fuse_frame_windowed_packed,
        lambda i: onebuf_payload(i, MASK),
        lambda f, m, b, p: f(b, *(x for j, x in enumerate(
            unpack_payload(p, 3 * HW)) if j != 3))[1]),
    "framestage": (
        tfsh.graphed_fuse_frame_framestage,
        tfsh.sharded_fuse_frame_framestage,
        lambda i: padded_payload(i),
        lambda f, m, b, p: eager_padded(f, m, b, p)),
    "framestage_windowed_packed": (
        tfsh.graphed_fuse_frame_framestage_windowed_packed,
        tfsh.sharded_fuse_frame_framestage_windowed_packed,
        lambda i: onebuf_payload(i, MASK),
        lambda f, m, b, p: f(b, *(x for j, x in enumerate(
            unpack_payload(p, 3 * HW)) if j != 3))[1]),
}


def _stereo_args(scfg):
    return (CFG, scfg, True)


STEREO_STEPS = {
    "stereo": (
        tsh.graphed_fuse_frame_stereo, tsh.sharded_fuse_frame_stereo,
        lambda i: stereo_payload(i),
        lambda f, m, b, p: f(b, *unpack_payload(p, 2 * HW)[:4])[1]),
    "stereo_windowed_packed": (
        tsh.graphed_fuse_frame_stereo_windowed_packed,
        tsh.sharded_fuse_frame_stereo_windowed_packed,
        lambda i: stereo_payload(i, MASK),
        lambda f, m, b, p: f(b, *unpack_payload(p, 2 * HW))[1]),
}


def run_step(graphed, eager_fn, payload, call, m, args, frames):
    g_banks = tsh.replicate_banks(m, CFG, 1)
    e_banks = tsh.replicate_banks(m, CFG, 1)
    step = graphed(*args, m, g_banks)
    assert step.bank is g_banks and not step.graphed
    fn = eager_fn(*args, m)
    ptrs = addresses(g_banks)
    for i in frames:
        buf = torch.from_numpy(payload(i))
        got = step(buf)
        assert torch.equal(step.buf, buf[None])
        same_stats(got, call(fn, m, e_banks, buf[None]))
    assert addresses(g_banks) == ptrs        # written in place
    assert int(g_banks.counts().sum()) > 0
    same_banks(g_banks, e_banks)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_graphed_mesh_step_is_the_mesh_step(name, n):
    """Two frames through each depth-fed mesh step's graph object and
    through its eager function: stats and every shard's bank equal, the
    banks' tensors written in place."""
    graphed, eager_fn, payload, call = STEPS[name]
    run_step(graphed, eager_fn, payload, call, mesh(n), (CFG,), range(2))


@pytest.mark.parametrize("name", sorted(STEREO_STEPS))
def test_graphed_stereo_step_is_the_mesh_step(name):
    """Two stereo pairs (box matcher) through each stereo mesh step's
    graph object and through its eager function, on 2 shards."""
    graphed, eager_fn, payload, call = STEREO_STEPS[name]
    run_step(graphed, eager_fn, payload, call, mesh(2),
             _stereo_args(ST.StereoConfig(**BOX)), range(2))


def filled(m, n_frames=3):
    """Banks with a few frames fused (replicated step, window mask of
    keyframes 0-1 so the pose warp has frozen rows to move)."""
    banks = tsh.replicate_banks(m, CFG, 1)
    step = tsh.graphed_fuse_frame(CFG, m, banks)
    for i in range(n_frames):
        step(torch.from_numpy(padded_payload(i)))
    # a hole in every shard, for compaction
    for b in banks.shards[0]:
        b.update_times[1] = 0
    return banks


def clone_banks(banks):
    return tsh.ShardedBanks([[tfs._clone(b) for b in row]
                             for row in banks.shards])


def bank_programs(m, banks):
    """name: (graphed object over `banks`, its eager mesh function bound
    to its arguments, the host arguments)."""
    P = CFG.max_keyframes
    rng = np.random.default_rng(5)
    warps = np.tile(np.eye(4, dtype=np.float32), (1, P, 1, 1))
    warps[0, :3, :3, 3] = rng.normal(size=(3, 3))
    moved = np.zeros((1, P), bool)
    moved[0, :3] = True
    ids = np.full(migration.MAX_REMOVE_POSES, -1, np.int32)
    ids[:2] = (0, 2)
    per = 32
    n = m.shape["surfel"]
    one = banks.shards[0][0]
    slab = {k: rng.integers(1, 9, (1, n * per) + getattr(one, k).shape[1:])
            .astype(getattr(one, k).numpy().dtype) for k in FIELDS}
    ns = rng.integers(0, per + 1, (1, n)).astype(np.int32)
    active = np.eye(4, dtype=np.float32)[None].copy()
    active[0, :3, 3] = (0.25, -0.5, 1.0)
    t = torch.from_numpy
    return {
        "warp_by_pose": (
            tsh.graphed_warp_by_pose(CFG, m, banks),
            lambda b: tsh.sharded_warp_by_pose(CFG, m)(
                b, t(warps), t(moved), t(MASK[None].copy()),
                t(np.ones(1, np.int64))),
            (warps, moved, MASK[None], np.ones(1, np.int64))),
        "compact": (tsh.graphed_compact(CFG, m, banks),
                    lambda b: tsh.sharded_compact(CFG, m)(b), ()),
        "extract_by_pose": (
            tsh.graphed_extract_by_pose(CFG, m, banks, 64),
            lambda b: tsh.sharded_extract_by_pose(CFG, m, 64)(b, t(ids))[1:],
            (ids,)),
        "append": (
            tsh.graphed_append(CFG, m, banks, per),
            lambda b: tsh.sharded_append(CFG, m, per)(
                b, {k: t(v) for k, v in slab.items()}, t(ns)),
            tuple(slab[k] for k in FIELDS) + (ns,)),
        "warp_active": (
            tsh.graphed_warp_active(CFG, m, banks),
            lambda b: tsh.sharded_warp_active(CFG, m)(b, t(active)),
            (active,)),
    }


@pytest.mark.parametrize("name", ["warp_by_pose", "compact",
                                  "extract_by_pose", "append",
                                  "warp_active"])
def test_graphed_bank_program_is_the_mesh_program(name):
    """Each bank program's graph object over 8 shards against its eager
    mesh function on a clone of the same banks: every shard's bank, and
    the extract's buffers and counts, equal; the banks written in place."""
    m = mesh(8)
    g_banks = filled(m)
    e_banks = clone_banks(g_banks)
    prog, eager, args = bank_programs(m, g_banks)[name]
    ptrs = addresses(g_banks)
    got = prog(*args)
    want = eager(e_banks)
    assert addresses(g_banks) == ptrs
    same_banks(g_banks, e_banks)
    if name == "extract_by_pose":
        (gb, gn), (wb, wn) = got, want
        assert torch.equal(gn, wn) and int(gn.sum()) > 0
        for k in FIELDS:
            assert torch.equal(gb[k], wb[k]), k


@pytest.mark.parametrize("paths, prior", [(8, False), (4, True)])
def test_graphed_sgm_is_the_sharded_sgm(paths, prior):
    """The sharded SGM's graph object (static left, right and prior) on 2
    shards against its eager call and the replicated plain disparity."""
    rng = np.random.default_rng(7)
    h, w = 24, 40
    cfg = ST.StereoConfig(max_disparity=16, min_disparity=1,
                          aggregation="sgm", sgm_paths=paths,
                          sgm_pallas=False, prior_rescue=prior)
    left = torch.from_numpy(rng.integers(0, 255, (h, w)).astype(np.float32))
    right = torch.roll(left, -3, dims=1)
    extra = (torch.full((h, w), 3.0),) if prior else ()
    m = mesh(2)
    graph = tsgm.graphed_sharded_sgm_disparity(m, cfg, h, w,
                                               with_prior=prior)
    assert len(graph.inputs) == 2 + prior and not graph.graphed
    got = graph(left, right, *extra)
    eager = tsgm.sharded_sgm_disparity(m, cfg, h, w)(left, right, *extra)
    want = ST.disparity(left, right, cfg,
                        prior_disp=extra[0] if prior else None)
    assert torch.equal(got, eager) and torch.equal(got, want)
    assert float((got > 0).float().mean()) > 0.3


# ---------------------------------------------------------------------------
# the drivers through their graph objects against the eager mesh programs
# ---------------------------------------------------------------------------
class EagerSharded(ShardedDeviceResidentMapping):
    """The driver on the eager mesh programs (the uploaded payload decoded
    and passed to the mesh function), as it ran before its graphs."""

    def _fuse_packed(self, buf):
        frames, poses, refs, _, masks = unpack_payload(
            self._upload(buf)[None], 3 * HW)
        make = (tfsh.sharded_fuse_frame_framestage_windowed_packed
                if self.frame_sharded
                else tsh.sharded_fuse_frame_windowed_packed)
        self._fused(make(self.config, self.mesh)(self.bank, frames, poses,
                                                 refs, masks)[1])

    def _fuse_stereo_packed(self, buf):
        step = tsh.sharded_fuse_frame_stereo_windowed_packed(
            self.config, self._stereo_cfg, self._stereo_filter, self.mesh)
        self._fused(step(self.bank, *unpack_payload(
            self._upload(buf)[None], 2 * HW))[1])

    def _do_compact(self):
        tsh.sharded_compact(self.config, self.mesh)(self.bank)
        self.compactions += 1

    def _apply_pose_warp(self, wstack, mstack):
        tsh.sharded_warp_by_pose(self.config, self.mesh)(
            self.bank, self._to_device(wstack[None]),
            self._to_device(mstack[None]),
            self._to_device(self._window_np[None]),
            self._to_device(np.full(1, self._first_local, np.int64)))


class EagerShardedPool(ShardedSurfelMapping):
    """The host-pool driver on the eager mesh programs."""

    def _fuse_frame(self, image, depth, pose, ref_index):
        pose_dev = self._to_device(np.asarray(pose, np.float32)[None])
        refs = self._to_device(np.full(1, ref_index, np.int32))
        if isinstance(depth, _StereoPair):
            step = tsh.sharded_fuse_frame_stereo(
                self.config, self._stereo_cfg, self._stereo_filter,
                self.mesh)
            _, stats = step(self.bank, self._to_device(depth.buf[None]),
                            pose_dev, refs, self._to_device(
                                np.full(1, self._stereo_bf, np.float32)))
        else:
            pi, pd = pad_frame(self.config, np.asarray(image, np.float32),
                               np.asarray(depth, np.float32))
            frames = FrameInput(image=self._to_device(pi[None]),
                                depth=self._to_device(pd[None]),
                                pose=pose_dev, frame_index=refs)
            _, stats = tsh.sharded_fuse_frame(self.config, self.mesh)(
                self.bank, tsh.shard_frames(self.mesh, frames))
        self._fuse_epilogue(stats)

    def _do_compact(self):
        tsh.sharded_compact(self.config, self.mesh)(self.bank)
        self.compactions += 1

    def _extract_chunk(self, ids):
        _, bufs, ns = tsh.sharded_extract_by_pose(
            self.config, self.mesh, self._per_chunk)(self.bank,
                                                     self._to_device(ids))
        ns = ns[0].numpy()
        if int(ns.sum()) == 0:
            return {}, 0
        host = {k: np.concatenate([
            v[0].numpy().reshape((self.n_shards, self._per_chunk)
                                 + tuple(v.shape[2:]))[s, :ns[s]]
            for s in range(self.n_shards)]) for k, v in bufs.items()}
        if (ns == self._per_chunk).any():
            return host, self.config.migration_buffer
        return host, min(int(ns.sum()), self.config.migration_buffer - 1)

    def _append_hostslab(self, padded, n):
        owner = np.arange(n) % self.n_shards
        fields, ns = {}, np.zeros((1, self.n_shards), np.int32)
        for k in FIELDS:
            rows = padded[k][:n]
            out = np.zeros((1, self.n_shards, self._per_chunk)
                           + rows.shape[1:], rows.dtype)
            for s in range(self.n_shards):
                out[0, s, :(owner == s).sum()] = rows[owner == s]
                ns[0, s] = (owner == s).sum()
            fields[k] = self._to_device(out.reshape(
                (1, -1) + rows.shape[1:]))
        tsh.sharded_append(self.config, self.mesh, self._per_chunk)(
            self.bank, fields, self._to_device(ns))

    def _apply_active_warp(self, warp):
        tsh.sharded_warp_active(self.config, self.mesh)(
            self.bank, self._to_device(np.asarray(warp, np.float32)[None]))


def feed(drv, i, pose, frame, is_keyframe=True, **kw):
    drv.feed_pose(float(i), pose, is_keyframe=is_keyframe, **kw)
    drv.feed_image(float(i), frame[0])
    drv.feed_depth(float(i), frame[1])


def chain_and_loop(drv):
    """The keyframe chain (the host pool's keyframes migrate), a revisit of
    keyframe 0 linked to it by a loop edge (the re-activation append), and
    a correction of every keyframe by +0.5 m in y (the loop warp) with one
    more frame after it."""
    for i in range(N_CHAIN):
        feed(drv, i, POSES[i], FRAMES[i])
    feed(drv, N_CHAIN, POSES[0], FRAMES[0], loop_edges=[(N_CHAIN, 0)])
    shift = np.eye(4)
    shift[1, 3] = 0.5
    path = [shift @ kf.cam_pose for kf in drv.graph.keyframes]
    feed(drv, N_CHAIN + 1, shift @ POSES[1], FRAMES[1], is_keyframe=False,
         loop_path=path)
    return drv


def same_pool(a, b):
    assert set(a.slabs) == set(b.slabs) != set()
    for k in a.slabs:
        for f in FIELDS:
            np.testing.assert_array_equal(a.slabs[k][f], b.slabs[k][f])


@pytest.mark.parametrize("frame_sharded", [False, True],
                         ids=["replicated", "frame-sharded"])
def test_device_driver_graphs_are_the_eager_mesh_programs(frame_sharded):
    """ShardedDeviceResidentMapping through its graph objects against the
    eager mesh programs over the chain, the loop and the correction (two
    compactions, one pose warp): every shard's bank and the stats equal."""
    m = mesh(2)
    g = chain_and_loop(ShardedDeviceResidentMapping(
        CFG, m, frame_sharded=frame_sharded))
    e = chain_and_loop(EagerSharded(CFG, m, frame_sharded=frame_sharded))
    assert g.frames_fused == N_CHAIN + 2 and g.compactions == 2
    same_banks(g.bank, e.bank)
    same_stats(g._stats_dev, e._stats_dev)
    assert g._fuse_graph.bank is g.bank and not g.graphed


def test_host_pool_graphs_are_the_eager_mesh_programs():
    """ShardedSurfelMapping through its graph objects against the eager
    mesh programs over the chain (migrations), the loop (a re-activation)
    and the correction (active and pool warps), with the stats-driven
    compactions (the mesh step leaves no holes, so the capacity is cut
    until the tail's headroom asks for one at every stats frame): every
    shard's bank and every pool slab equal."""
    m = mesh(2)
    cfg = dataclasses.replace(CFG, surfel_capacity=512, migration_buffer=256)
    g = chain_and_loop(ShardedSurfelMapping(cfg, m))
    e = chain_and_loop(EagerShardedPool(cfg, m))
    assert g.compactions > 0 and 0 in g.local_indices
    assert 0 not in g.pool.slabs and len(g.pool) > 0
    same_banks(g.bank, e.bank)
    same_pool(g.pool, e.pool)


@pytest.mark.parametrize("cls", ["device", "host-pool"])
def test_stereo_graph_is_the_eager_mesh_program(cls):
    """Three stereo pairs (box matcher) through each sharded driver's
    stereo graph object and through the eager stereo mesh program."""
    m = mesh(2)
    make = {"device": (ShardedDeviceResidentMapping, EagerSharded),
            "host-pool": (ShardedSurfelMapping, EagerShardedPool)}[cls]
    drvs = [c(CFG, m) for c in make]
    for d in drvs:
        d.enable_stereo(bf=CAM.fx * BASELINE,
                        stereo_config=ST.StereoConfig(**BOX))
        for i in range(3):
            pose, li, ri = stereo_pair(i)
            d.feed_pose(float(i), pose, is_keyframe=True)
            d.feed_stereo(float(i), li, ri)
    assert drvs[0].frames_fused == 3
    assert int(drvs[0].bank.counts().sum()) > 0
    same_banks(drvs[0].bank, drvs[1].bank)


# ---------------------------------------------------------------------------
# rebuilds
# ---------------------------------------------------------------------------
def graphs_of(drv):
    names = [n for n in ("_fuse_graph", "_stereo_graph", "_compact_graph",
                         "_pose_warp_graph", "_append_graph",
                         "_extract_graph", "_warp_graph")
             if getattr(drv, n, None) is not None]
    return {n: getattr(drv, n) for n in names}


def test_keyframe_growth_rebuilds_the_mesh_graphs():
    """max_keyframes = 4 outgrown by 6 keyframes: every graph is rebuilt
    at the new payload and warp length against the driver's banks, and
    the next frame and the warp write them."""
    cfg = dataclasses.replace(CFG, max_keyframes=4, drift_free_poses=8)
    drv = ShardedDeviceResidentMapping(cfg, mesh(2))
    drv.enable_stereo(bf=CAM.fx * BASELINE,
                      stereo_config=ST.StereoConfig(**BOX))
    first = graphs_of(drv)
    assert first["_fuse_graph"].buf.shape == (1, 3 * HW + 72 + 4)
    for i in range(N_CHAIN):
        feed(drv, i, POSES[i], FRAMES[i])
    assert drv.config.max_keyframes == 8
    now = graphs_of(drv)
    assert set(now) == set(first)
    for n, g in now.items():
        assert g is not first[n] and g.bank is drv.bank, n
    assert now["_fuse_graph"].buf.shape == (1, 3 * HW + 72 + 8)
    assert now["_stereo_graph"].buf.shape == (1, 2 * HW + 72 + 8)
    assert now["_pose_warp_graph"].inputs[0].shape == (1, 8, 4, 4)
    assert drv.frames_fused == N_CHAIN
    assert int(drv.bank.counts().sum()) > 0


@pytest.mark.parametrize("cls", [ShardedDeviceResidentMapping,
                                 ShardedSurfelMapping],
                         ids=["device", "host-pool"])
def test_checkpoint_load_and_enable_stereo_rebuild_the_mesh_graphs(
        cls, tmp_path):
    """enable_stereo builds the stereo graph and leaves the others; a
    checkpoint load builds every graph against the loaded banks, which the
    next frame then writes (and not the replaced ones)."""
    drv = cls(CFG, mesh(2))
    for i in range(3):
        feed(drv, i, POSES[i], FRAMES[i])
    before = graphs_of(drv)
    assert "_stereo_graph" not in before
    drv.enable_stereo(bf=CAM.fx * BASELINE,
                      stereo_config=ST.StereoConfig(**BOX))
    after = graphs_of(drv)
    assert after["_stereo_graph"].bank is drv.bank
    assert all(after[n] is g for n, g in before.items())
    path = str(tmp_path / "mid.npz")
    drv.save_checkpoint(path)
    old_banks = drv.bank
    old_counts = old_banks.counts().copy()
    drv.load_checkpoint(path)
    assert drv.bank is not old_banks
    loaded = graphs_of(drv)
    assert set(loaded) == set(after)
    for n, g in loaded.items():
        assert g is not after[n] and g.bank is drv.bank, n
    n0 = int(drv.bank.counts().sum())
    feed(drv, 3, POSES[3], FRAMES[3])
    assert int(drv.bank.counts().sum()) > n0
    assert np.array_equal(old_banks.counts(), old_counts)


# ---------------------------------------------------------------------------
# several devices: graphed on cards, eager on the CPU
# ---------------------------------------------------------------------------
def test_mesh_over_several_devices_keeps_the_eager_programs():
    """A mesh over two cards is graphed as one card repeated is (one
    capture spans the cards); a CPU mesh over two devices keeps the eager
    programs: a driver on it builds its graph objects on the eager branch
    and runs the chain through them."""
    two = tsh.Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]])
    one = tsh.Mesh([[torch.device("cuda", 0)] * 2])
    assert tsh.graphed_mesh(two) and tsh.graphed_mesh(one)
    m = tsh.make_mesh(2, devices=["cpu:0", "cpu:1"])
    assert len(m.devices()) == 2 and not tsh.graphed_mesh(m)
    drv = ShardedSurfelMapping(CFG, m)
    assert not drv.graphed
    assert not any(g.graphed for g in graphs_of(drv).values())
    for i in range(3):
        feed(drv, i, POSES[i], FRAMES[i])
    assert drv._fuse_graph.graph is None and drv.frames_fused == 3


def test_capture_refuses_a_target_over_several_devices():
    """fuse_step.capture takes banks over several cards as one capture,
    but refuses, before anything runs, banks off the cards (here on two
    devices, cpu and meta); the plan for banks on two cards: the home
    card cuda:0 holds the capture stream and the graph's pool, cuda:1 its
    lane and a MemPool routed by use_mem_pool, each card one cell."""
    banks = tsh.ShardedBanks([[SurfelBank.empty(8, "cpu"),
                               SurfelBank.empty(8, "meta")]])
    assert [d.type for d in tfs.devices_of(banks)] == ["cpu", "meta"]
    ran = []
    with pytest.raises(ValueError, match="needs CUDA banks"):
        tfs.capture(banks, ran.append)
    assert not ran
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    plan = tsh.capture_plan(tsh.Mesh([[c0, c1]]))
    assert plan["graphed"] and plan["home"] == c0
    assert plan["cards"] == {
        c0: dict(lane="capture", pool="graph", cells=[(0, 0)], streams=[1]),
        c1: dict(lane=0, pool="use_mem_pool", cells=[(0, 1)], streams=[1])}
