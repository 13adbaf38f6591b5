"""The mesh programs with several streams on a data row, on the CPU.

Every mesh program of the port (`parallel/sharding.py`,
`parallel/frame_sharding.py`) runs one torch.func.vmap per cell over the
streams of the cell's data row, on one batched bank per (row, shard)
(`ShardedBanks.rows`), as the JAX package's `jax.vmap(per_stream)` runs
inside its `shard_map`.  Every case here puts 2 streams on each data row:

* the depth-fed steps (`sharded_fuse_frame`,
  `sharded_fuse_frame_windowed_packed`) against the JAX package's on a
  (2, 4) mesh with 4 streams, and the stereo windowed step (box matcher,
  the map-prior rescue) on a (2, 2) mesh: stats and counts exact,
  update_times and last_update exact, positions and normals within 1e-5 m
  (the stereo step's other float fields within a relative 1e-5, as
  tests/test_torch_multicard.py holds them);
* each stream of a (2, 2) mesh torch.equal to the same stream driven alone
  on a one-row mesh of the same 2 shards: every fuse step (the frame stage
  column-sharded too) and each of the five bank programs;
* the plain SLIC and SGM entry points (the twins the kernels' wrappers run
  on a CPU tensor) called once per cell per step, not once per stream and
  cell;
* B4's wide route (D > 128) over a stream axis: the batched twin and its
  vmap equal the per-stream calls, and the plan's scratch holds one slab
  set per stream for its 2 launches.

The CUDA launches (B1-B3 sp_iters times, B5 and B6 once per cell and
step) are counted by chip_smoke.py's `sharded` and `multicard` phases."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import SurfelMapConfig as JConfig
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu_torch.config import (CameraIntrinsics,
                                                 SurfelMapConfig)
from densesurfelmapping_tpu_torch.core.state import (
    FIELDS, FrameInput, pack_frame, pack_stereo_pair, pad_frame)
from densesurfelmapping_tpu_torch.io import synthetic
from densesurfelmapping_tpu_torch.models import stereo as ST
from densesurfelmapping_tpu_torch.ops import sgm as tsgm
from densesurfelmapping_tpu_torch.ops import superpixel
from densesurfelmapping_tpu_torch.ops.cuda import sgm as ksgm
from densesurfelmapping_tpu_torch.ops.migration import MAX_REMOVE_POSES
from densesurfelmapping_tpu_torch.parallel import frame_sharding as tfsh
from densesurfelmapping_tpu_torch.parallel import sharding as tsh
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs

from test_torch_sharding import EXACT, same_shards

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      drift_free_poses=2)
JCFG = JConfig.from_json(CFG.to_json())
SCENE = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                        boxes=synthetic.default_scene().boxes,
                        max_depth=25.0, texture="multisine")
BASELINE = 0.5
BF = CAM.fx * BASELINE
N_STREAMS = 4
N_FRAMES = 2
MASK = np.array([True, True] + [False] * 6)
# the box matcher with the prior rescue; the prior takes surfels fused
# once, so the second pair already has one
BOX = dict(max_disparity=64, min_disparity=1, radius=3, prior_rescue=True,
           prior_min_updates=1)


@pytest.fixture(autouse=True)
def vmap_fallback_is_an_error():
    """No op of a mesh program takes functorch's per-stream fallback."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def rows_mesh():
    """2 data rows of 2 shards."""
    return tsh.make_mesh(4, data=2, devices="cpu")


def solo_mesh():
    """One row of the same 2 shards."""
    return tsh.make_mesh(2, devices="cpu")


@functools.lru_cache(maxsize=None)
def pose(b, t):
    """Stream b's pose at frame t: distinct per stream."""
    p = np.eye(4)
    p[0, 3] = 0.15 * (b + t)
    p[2, 3] = 0.3 * t
    return p


@functools.lru_cache(maxsize=None)
def frame(b, t):
    return SCENE.render(CFG, pose(b, t))


@functools.lru_cache(maxsize=None)
def pair(b, t):
    right = pose(b, t).copy()
    right[:3, 3] += right[:3, 0] * BASELINE
    return SCENE.render(CFG, pose(b, t))[0], SCENE.render(CFG, right)[0]


def batched(arrays, dtype=None):
    out = torch.from_numpy(np.stack(arrays))
    return out if dtype is None else out.to(dtype)


def padded_frames(streams, t):
    planes = [pad_frame(CFG, *frame(b, t)) for b in streams]
    return FrameInput(
        image=batched([p[0] for p in planes], torch.float32),
        depth=batched([p[1] for p in planes], torch.float32),
        pose=batched([pose(b, t) for b in streams], torch.float32),
        frame_index=torch.full((len(streams),), t, dtype=torch.int32))


def head(streams, t):
    """Poses (B, 4, 4) f32, refs (B,) i32, masks (B, P) bool."""
    return (batched([pose(b, t) for b in streams], torch.float32),
            torch.full((len(streams),), t, dtype=torch.int32),
            batched([MASK] * len(streams)))


def packed(streams, t):
    return batched([pack_frame(CFG, *frame(b, t)) for b in streams])


def stereo_bufs(streams, t):
    return batched([pack_stereo_pair(CFG, *pair(b, t)) for b in streams])


def bfs(streams):
    return torch.full((len(streams),), BF, dtype=torch.float32)


# name: (the mesh function, its call on the given streams' frame t)
STEPS = {
    "fuse_frame": (
        tsh.sharded_fuse_frame,
        lambda f, m, bk, st, t: f(bk, tsh.shard_frames(m, padded_frames(
            st, t)))),
    "windowed": (
        tsh.sharded_fuse_frame_windowed,
        lambda f, m, bk, st, t: f(bk, tsh.shard_frames(m, padded_frames(
            st, t)), head(st, t)[2])),
    "windowed_packed": (
        tsh.sharded_fuse_frame_windowed_packed,
        lambda f, m, bk, st, t: f(bk, packed(st, t), *head(st, t))),
    "framestage": (
        tfsh.sharded_fuse_frame_framestage,
        lambda f, m, bk, st, t: f(bk, tsh.shard_frames(m, padded_frames(
            st, t)))),
    "framestage_windowed_packed": (
        tfsh.sharded_fuse_frame_framestage_windowed_packed,
        lambda f, m, bk, st, t: f(bk, packed(st, t), *head(st, t))),
    "stereo": (
        lambda c, m: tsh.sharded_fuse_frame_stereo(
            c, ST.StereoConfig(**BOX), True, m),
        lambda f, m, bk, st, t: f(bk, stereo_bufs(st, t),
                                  *head(st, t)[:2], bfs(st))),
    "stereo_windowed_packed": (
        lambda c, m: tsh.sharded_fuse_frame_stereo_windowed_packed(
            c, ST.StereoConfig(**BOX), True, m),
        lambda f, m, bk, st, t: f(bk, stereo_bufs(st, t),
                                  *head(st, t)[:2], bfs(st),
                                  head(st, t)[2])),
}


def drive(name, m, streams, n_frames=N_FRAMES):
    """The streams' frames 0 .. n_frames - 1 through one mesh step:
    (banks, stats of each frame)."""
    make, call = STEPS[name]
    fn = make(CFG, m)
    banks = tsh.replicate_banks(m, CFG, len(streams))
    return banks, [call(fn, m, banks, streams, t)[1]
                   for t in range(n_frames)]


def same_stream(banks, b, solo) -> None:
    """Stream b of `banks` torch.equal to stream 0 of `solo`, shard by
    shard, every field and the count."""
    for s, (x, y) in enumerate(zip(banks.shards[b], solo.shards[0])):
        for k in FIELDS + ("count",):
            assert torch.equal(getattr(x, k), getattr(y, k)), (b, s, k)


def test_layout_one_batched_bank_per_cell():
    """replicate_banks(make_mesh(4, data=2), 4 streams): a (2, 2) grid of
    batched banks, streams 0-1 on row 0 and 2-3 on row 1; `shards[b][s]`
    are views of row b // 2's cell s (writes through them land in the
    row's bank); a one-stream row of unbatched banks is taken as views."""
    m = rows_mesh()
    banks = tsh.replicate_banks(m, CFG, N_STREAMS)
    rows = -(-CFG.surfel_capacity // 2)
    assert [[b.position.shape for b in row] for row in banks.rows] == \
        [[(2, rows, 3)] * 2] * 2
    assert banks.spans() == [(0, 2), (2, 4)]
    assert (banks.n_streams, banks.n_shards, banks.rows_per_shard) == (
        4, 2, rows)
    banks.shards[3][1].count.fill_(7)
    banks.shards[3][1].position[0] = 1.0
    assert banks.rows[1][1].count.tolist() == [0, 7]
    assert float(banks.rows[1][1].position[1, 0].sum()) == 3.0
    assert banks.counts().tolist() == [[0, 0], [0, 0], [0, 0], [0, 7]]
    assert banks.host("position").shape == (4, 2 * rows, 3)
    assert banks.nbytes() == sum(
        t.numel() * t.element_size() for row in banks.rows for b in row
        for _, t in b.field_arrays())
    clone = tfs._scratch(banks)
    assert [[b.count.shape for b in row] for row in clone.rows] == \
        [[(2,)] * 2] * 2
    one = tsh.ShardedBanks([list(solo_mesh_banks().shards[0])])
    assert one.rows[0][0].count.shape == (1,)
    with pytest.raises(ValueError, match="do not split"):
        tsh.replicate_banks(m, CFG, 3)


def solo_mesh_banks():
    return tsh.replicate_banks(solo_mesh(), CFG, 1)


# ---------------------------------------------------------------------------
# against the JAX package, 2 streams a row
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fuse_frame", "windowed_packed"])
def test_depth_step_two_streams_a_row_matches_jax(name):
    """`sharded_fuse_frame` and `sharded_fuse_frame_windowed_packed` (the
    window masks differing per stream) on a (2, 4) mesh with 4 streams
    of distinct poses, 2 frames, against the JAX package's: stats exact
    each frame, every (stream, shard) against the JAX bank's (counts and
    the exact fields equal, positions and normals within 1e-5 m)."""
    jmesh = jsh.make_mesh(8, data=2)
    tmesh = tsh.make_mesh(8, data=2, devices="cpu")
    streams = range(N_STREAMS)
    jbanks = jsh.replicate_banks(jmesh, JCFG, n_streams=N_STREAMS)
    tbanks = tsh.replicate_banks(tmesh, CFG, N_STREAMS)
    if name == "fuse_frame":
        jstep = jsh.sharded_fuse_frame(JCFG, jmesh)
    else:
        jstep = jsh.sharded_fuse_frame_windowed_packed(JCFG, jmesh)
    tstep = STEPS[name][0](CFG, tmesh)
    masks = np.zeros((N_STREAMS, CFG.max_keyframes), bool)
    masks[:, 0] = True
    masks[1::2, 1] = True
    for t in range(N_FRAMES):
        poses, refs, _ = head(streams, t)
        if name == "fuse_frame":
            fr = padded_frames(streams, t)
            jbanks, jstats = jstep(jbanks, jsh.shard_frames(
                jmesh, jstate.FrameInput(*(jnp.asarray(x.numpy()) for x in (
                    fr.image, fr.depth, fr.pose, fr.frame_index)))))
            tstats = tstep(tbanks, tsh.shard_frames(tmesh, fr))[1]
        else:
            args = (packed(streams, t), poses, refs, torch.from_numpy(masks))
            jbanks, jstats = jstep(jbanks, *(jnp.asarray(x.numpy())
                                             for x in args))
            tstats = tstep(tbanks, *args)[1]
        for k in ("n_live", "n_new", "n_dropped", "n_fused_seeds"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
    assert (tbanks.counts() > 0).all()
    same_shards(jbanks, tbanks, 4)


def test_sharded_stereo_two_streams_a_row_matches_jax():
    """`sharded_fuse_frame_stereo_windowed_packed` (box matcher, the
    map-prior rescue from the merged z-buffers) on a (2, 2) mesh with 4
    streams, 2 pairs: n_new and n_rescued_px exact, counts exact, every
    (stream, shard)'s rows to the tolerances of
    tests/test_torch_multicard.py."""
    jmesh = jsh.make_mesh(4, data=2)
    tmesh = rows_mesh()
    jstep = jsh.sharded_fuse_frame_stereo_windowed_packed(
        JCFG, jstereo.StereoConfig(**BOX), True, jmesh)
    tstep = tsh.sharded_fuse_frame_stereo_windowed_packed(
        CFG, ST.StereoConfig(**BOX), True, tmesh)
    jbanks = jsh.replicate_banks(jmesh, JCFG, n_streams=N_STREAMS)
    tbanks = tsh.replicate_banks(tmesh, CFG, N_STREAMS)
    streams = range(N_STREAMS)
    rescued = 0
    for t in range(2):
        bufs = stereo_bufs(streams, t)
        poses, refs, masks = head(streams, t)
        jbanks, jstats = jstep(jbanks, *(jnp.asarray(x.numpy()) for x in (
            bufs, poses, refs, bfs(streams), masks)))
        tbanks, tstats = tstep(tbanks, bufs, poses, refs, bfs(streams),
                               masks)
        for k in ("n_new", "n_rescued_px"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
        rescued += int(tstats["n_rescued_px"].sum())
    counts = np.asarray(jbanks.count)
    np.testing.assert_array_equal(tbanks.counts(), counts)
    assert (counts > 0).all() and rescued > 0
    slab = tbanks.rows_per_shard
    for k in FIELDS:
        jf, tf = np.asarray(getattr(jbanks, k)), tbanks.host(k)
        for b in streams:
            for s in range(2):
                rows = slice(s * slab, s * slab + int(counts[b, s]))
                if k in EXACT:
                    np.testing.assert_array_equal(tf[b, rows], jf[b, rows],
                                                  k)
                elif k in ("position", "normal"):
                    np.testing.assert_allclose(tf[b, rows], jf[b, rows],
                                               rtol=0, atol=1e-5, err_msg=k)
                else:
                    np.testing.assert_allclose(tf[b, rows], jf[b, rows],
                                               rtol=1e-5, atol=0, err_msg=k)


# ---------------------------------------------------------------------------
# each stream of a row == the same stream alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(STEPS))
def test_each_stream_of_a_row_is_the_stream_alone(name):
    """Each mesh step over 2 frames of 4 streams on a (2, 2) mesh: every
    stream's banks and stats torch.equal to the same stream driven alone
    on a one-row mesh of 2 shards."""
    banks, stats = drive(name, rows_mesh(), range(N_STREAMS))
    assert (banks.counts() > 0).all()
    for b in range(N_STREAMS):
        solo, solo_stats = drive(name, solo_mesh(), [b])
        same_stream(banks, b, solo)
        for got, want in zip(stats, solo_stats):
            assert set(got) == set(want)
            for k in got:
                assert torch.equal(got[k][b:b + 1], want[k]), (b, k)


@pytest.fixture(scope="module")
def driven():
    """The windowed packed step's banks after 2 frames: 4 streams on the
    (2, 2) mesh and each stream alone, with a hole in every slab."""
    out = [drive("windowed_packed", rows_mesh(), range(N_STREAMS))[0]]
    out += [drive("windowed_packed", solo_mesh(), [b])[0]
            for b in range(N_STREAMS)]
    for banks in out:
        for row in banks.rows:
            for bank in row:
                bank.update_times[:, 1] = 0
    return out


def clone(banks):
    return tfs._scratch(banks)


def bank_program(name, m, streams):
    """(the bank program over m, its inputs for the given streams)."""
    P = CFG.max_keyframes
    rng = np.random.default_rng(11)
    warps = np.tile(np.eye(4, dtype=np.float32), (N_STREAMS, P, 1, 1))
    warps[:, :3, :3, 3] = rng.normal(size=(N_STREAMS, 3, 3))
    moved = np.zeros((N_STREAMS, P), bool)
    moved[:, :2] = True
    moved[1::2, 0] = False
    masks = np.tile(MASK, (N_STREAMS, 1))
    firsts = np.arange(N_STREAMS, dtype=np.int64) % 2
    active = np.tile(np.eye(4, dtype=np.float32), (N_STREAMS, 1, 1))
    active[:, :3, 3] = rng.normal(size=(N_STREAMS, 3))
    per = 32
    slab = {k: rng.integers(1, 9, (N_STREAMS, 2 * per)
                            + getattr(solo_mesh_banks().shards[0][0],
                                      k).shape[1:])
            .astype(getattr(solo_mesh_banks().shards[0][0],
                            k).numpy().dtype) for k in FIELDS}
    ns = rng.integers(0, per + 1, (N_STREAMS, 2)).astype(np.int32)
    ids = np.full(MAX_REMOVE_POSES, -1, np.int32)
    ids[0] = 1
    st = list(streams)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[st]))

    return {
        "warp_by_pose": (tsh.sharded_warp_by_pose(CFG, m),
                         (t(warps), t(moved), t(masks), t(firsts))),
        "compact": (tsh.sharded_compact(CFG, m), ()),
        "extract_by_pose": (tsh.sharded_extract_by_pose(CFG, m, 64),
                            (torch.from_numpy(ids),)),
        "append": (tsh.sharded_append(CFG, m, per),
                   ({k: t(v) for k, v in slab.items()}, t(ns))),
        "warp_active": (tsh.sharded_warp_active(CFG, m), (t(active),)),
    }[name]


@pytest.mark.parametrize("name", ["warp_by_pose", "compact",
                                  "extract_by_pose", "append",
                                  "warp_active"])
def test_each_stream_of_a_row_is_the_stream_alone_in_the_bank_programs(
        driven, name):
    """Each bank program on clones of the driven banks, with per-stream
    inputs: every stream torch.equal to the same stream alone, the
    extract's buffers and counts too (stream b's rows of the (B, 2 * 64)
    buffers and (B, 2) counts)."""
    banks = clone(driven[0])
    fn, args = bank_program(name, rows_mesh(), range(N_STREAMS))
    got = fn(banks, *args)
    for b in range(N_STREAMS):
        solo = clone(driven[1 + b])
        fn1, args1 = bank_program(name, solo_mesh(), [b])
        want = fn1(solo, *args1)
        same_stream(banks, b, solo)
        if name == "extract_by_pose":
            assert torch.equal(got[2][b:b + 1], want[2])
            for k in FIELDS:
                assert torch.equal(got[1][k][b:b + 1], want[1][k]), k
    if name == "extract_by_pose":
        assert got[2].shape == (N_STREAMS, 2) and int(got[2].sum()) > 0
        assert got[1]["position"].shape == (N_STREAMS, 2 * 64, 3)


def test_sharded_prior_is_the_merged_row_zbuffer():
    """`sharded_prior` of stream b == the upsample of the row's merged
    z-buffers (`merged_zbuffers`, pass 0 of the stereo steps) for that
    stream, on every shard."""
    from densesurfelmapping_tpu_torch.ops.render import upsample_prior
    banks = drive("windowed_packed", rows_mesh(), range(N_STREAMS))[0]
    scfg = ST.StereoConfig(**BOX)
    poses = head(range(N_STREAMS), 1)[0]
    for r, (row, (lo, hi)) in enumerate(zip(banks.rows, banks.spans())):
        merged = tsh.merged_zbuffers(CFG, scfg, row,
                                     [poses[lo:hi]] * len(row))
        for j, b in enumerate(range(lo, hi)):
            got = tsh.sharded_prior(CFG, scfg, banks.shards[b],
                                    [poses[b]] * 2)
            want = upsample_prior(CFG, merged[0][j], scfg.prior_stride)
            assert (want > 0).sum() > 10
            for g in got:
                assert torch.equal(g, want)


# ---------------------------------------------------------------------------
# the plain entry points once per cell per step
# ---------------------------------------------------------------------------
def counting(monkeypatch, module, names) -> dict:
    calls = dict.fromkeys(names, 0)
    for n in names:
        fn = getattr(module, n)

        def counted(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, n, counted)
    return calls


SLIC_TWINS = ("assign_sweep", "seed_sums", "huber_mean_depth")


@pytest.mark.parametrize("kind", ["depth", "census", "materialized"])
def test_plain_entry_points_run_once_per_cell(monkeypatch, kind):
    """One step of 4 streams on the (2, 2) mesh calls each plain SLIC twin
    (the B1-B3 wrappers' CPU path) as often as the same step of one stream
    on a one-row mesh of 2 shards, times 4 cells / 2 cells: once per cell
    and sweep, not per stream.  The SGM matcher: the fused census
    aggregate (B5 + B6) once per cell, on the materialized branch the
    axis scan (B4) twice per cell (the census twin runs its own scans)."""
    slic = counting(monkeypatch, superpixel, SLIC_TWINS)
    sgm = counting(monkeypatch, tsgm, ("census_aggregate", "axis_scan"))
    scfg = ST.StereoConfig(max_disparity=48, min_disparity=1,
                           aggregation="sgm", prior_rescue=True,
                           prior_min_updates=1,
                           sgm_fused_census=(kind == "census"))

    def one_step(m, streams):
        for c in (slic, sgm):
            c.update(dict.fromkeys(c, 0))
        banks = tsh.replicate_banks(m, CFG, len(streams))
        if kind == "depth":
            tsh.sharded_fuse_frame_windowed_packed(CFG, m)(
                banks, packed(streams, 0), *head(streams, 0))
        else:
            tsh.sharded_fuse_frame_stereo_windowed_packed(
                CFG, scfg, True, m)(banks, stereo_bufs(streams, 0),
                                    *head(streams, 0)[:2], bfs(streams),
                                    head(streams, 0)[2])
        return dict(slic), dict(sgm)

    solo_slic, solo_sgm = one_step(solo_mesh(), [0])
    slic4, sgm4 = one_step(rows_mesh(), range(N_STREAMS))
    assert solo_slic["assign_sweep"] == 2 * CFG.sp_iters
    assert slic4 == {k: 2 * v for k, v in solo_slic.items()}
    assert sgm4 == {k: 2 * v for k, v in solo_sgm.items()}
    if kind == "census":
        assert solo_sgm["census_aggregate"] == 2
    else:
        scans = {"depth": 0, "materialized": 2}[kind]
        assert solo_sgm == dict(census_aggregate=0, axis_scan=2 * scans)


# ---------------------------------------------------------------------------
# B4's wide route with a stream axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rolls", [(0,), (0, 1, -1)])
def test_wide_axis_scan_takes_a_stream_axis(rolls):
    """D = 150 takes the line kernel and its combine pass: for 2 streams
    the plan's scratch holds 2 x 2g slabs of (L, R, D) and the grid one
    block set per stream (the kernels launch twice per call, whatever the
    stream count).  On the CPU the batched call and its vmap are bitwise
    the per-stream twins."""
    L, R, D = 9, 11, 150
    plan = ksgm.axis_plan(L, R, D, rolls, streams=2)
    g = len(rolls)
    assert plan.route == "lines"
    assert plan.scratch_shape == (2 * 2 * g, L * R * D)
    assert plan.blocks == (R + L - 1) * 2 * g
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.integers(0, 40, (2, L, R, D)).astype(
        np.float32)).to(torch.bfloat16)
    for bf16 in (False, True):
        args = (rolls, 1.0, 8.0, bf16, "y", 3)
        want = torch.stack([tsgm.axis_scan(v[k], *args) for k in range(2)])
        assert torch.equal(ksgm.axis_scan(v, *args), want)
        assert torch.equal(torch.func.vmap(
            lambda x: ksgm.axis_scan(x, *args))(v), want)
