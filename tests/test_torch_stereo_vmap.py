"""The stereo fleet's round under torch.func.vmap (`parallel/multistream.py::
batched_stereo_onebuf_step`, the JAX fleet's `jax.vmap` of
`fuse_frame_stereo_onebuf`) and the SGM wrappers' stream axis
(`ops/cuda/sgm.py`), on the CPU.

* the batched twins: `torch.func.vmap` of census_aggregate and axis_scan
  over two streams is bitwise `jax.vmap` of the JAX package's Pallas
  kernels in interpret mode, and bitwise the per-stream twins for every
  path count and carry dtype (the per-stream twins are held to the
  unbatched Pallas kernels by tests/test_torch_stereo_kernels.py, bf16
  carries included).  A `jax.vmap` of a Pallas kernel costs 8-13 s of
  tracing and compiling on one CPU worker whatever its size, 26-35 s with
  bf16 carries, so the JAX comparison runs 4 and 8 paths with f32 carries
  and B4's y family of 8 paths, and the bf16 carries are held to the
  per-stream twins;
* the vmapped round with the SGM matcher (fused census, the materialized
  branch, the map-prior rescue) at the 120 x 56 config of
  tests/test_torch_stereo_fleet_graph.py: each stream's depth, banks and
  stats bitwise those of a solo `fuse_frame_stereo_onebuf` of that stream
  (no batched reduction breaks equality here);
* no op of the round takes functorch's per-stream fallback (its
  "performance drop" warning is an error, as in
  tests/test_torch_multi_session.py);
* B5's batched plan: the refused per-stream split of the SMs, the block
  count unchanged with the stream count, and halo tags and ring slots that
  never confuse two streams.

The CUDA kernels' stream axis is held to the single-stream kernels and the
twins on the card by chip_smoke.py (`sgm` and `multi-stereo` phases)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.ops.pallas import sgm as jsgm
from densesurfelmapping_tpu_torch import config as tcfg
from densesurfelmapping_tpu_torch.core.state import SurfelBank
from densesurfelmapping_tpu_torch.models import stereo as tstereo
from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
from densesurfelmapping_tpu_torch.ops import sgm as tsgm
from densesurfelmapping_tpu_torch.ops.cuda import sgm as ksgm
from densesurfelmapping_tpu_torch.parallel import multistream
from densesurfelmapping_tpu_torch.pipeline import fuse_step as tfs

torch.set_num_threads(1)

CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
REF = SurfelMapConfig(camera=CAM, surfel_capacity=4096, max_keyframes=8,
                      drift_free_poses=3, compact_interval=2)
CFG = tcfg.SurfelMapConfig.from_json(REF.to_json())
BASELINE = 0.5
BF = CAM.fx * BASELINE
SCENE = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                        boxes=synthetic.default_scene().boxes,
                        max_depth=25.0, texture="multisine")
FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update", "count")


@pytest.fixture(autouse=True)
def vmap_fallback_is_an_error():
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def pair(pose):
    rp = np.array(pose, np.float64).copy()
    rp[:3, 3] += rp[:3, 0] * BASELINE
    return SCENE.render(REF, pose)[0], SCENE.render(REF, rp)[0]


@pytest.fixture(scope="module")
def census_streams():
    """Two streams of 72-px crops of the 120 x 56 pair (the crop of
    tests/test_torch_stereo_kernels.py::census_pair and the pair's right
    72 columns): census images stacked (2, 56, 72), JAX and port."""
    li, ri = pair(np.eye(4))
    crops = (slice(0, 72), slice(48, 120))
    jl, jr, tl, tr = [], [], [], []
    for c in crops:
        jl.append(jstereo._census(jnp.asarray(li[:, c]), 2))
        jr.append(jstereo._census(jnp.asarray(ri[:, c]), 2))
        tl.append(tstereo._census(torch.from_numpy(li[:, c]), 2))
        tr.append(tstereo._census(torch.from_numpy(ri[:, c]), 2))
    return (jnp.stack(jl), jnp.stack(jr)), (torch.stack(tl), torch.stack(tr))


def _rolls(paths):
    return (0,) if paths == 4 else (0, 1, -1)


@pytest.mark.parametrize("paths", [4, 8])
def test_vmapped_census_aggregate_matches_jax_vmap_of_pallas(
        census_streams, paths):
    (jl, jr), (tl, tr) = census_streams
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).astype(np.int32))
    v_rolls, min_d, n_d = _rolls(paths), 1, 39
    want = np.asarray(jax.vmap(functools.partial(
        jsgm.census_aggregate, v_rolls=v_rolls, p1=1.0, p2=8.0, min_d=min_d,
        n_d=n_d))(jl, jr))
    got = torch.func.vmap(functools.partial(
        ksgm.census_aggregate, v_rolls=v_rolls, p1=1.0, p2=8.0, min_d=min_d,
        n_d=n_d))(tl, tr)
    assert got.shape == (2, n_d) + tuple(tl.shape[1:])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("carry_bf16", [False, True])
def test_batched_census_wrappers_are_the_per_stream_twins(
        census_streams, paths, carry_bf16):
    """vmap, and an explicit (B, H, W) stream axis, of census_aggregate,
    census_x and census_y: each stream bitwise its own twin; census_y adds
    into a batched out in place; nothing launches on CPU tensors."""
    _, (tl, tr) = census_streams
    v_rolls, min_d, n_d = _rolls(paths), 3, 37
    ksgm.reset_launch_counts()
    agg = functools.partial(ksgm.census_aggregate, v_rolls=v_rolls, p1=1.0,
                            p2=8.0, min_d=min_d, n_d=n_d,
                            carry_bf16=carry_bf16)
    want = torch.stack([tsgm.census_aggregate(
        tl[k], tr[k], v_rolls, 1.0, 8.0, min_d, n_d, carry_bf16)
        for k in range(2)])
    assert torch.equal(torch.func.vmap(agg)(tl, tr), want)
    assert torch.equal(agg(tl, tr), want)
    x = torch.func.vmap(lambda a, b: ksgm.census_x(
        a, b, 1.0, 8.0, min_d, n_d, carry_bf16))(tl, tr)

    def add_y(a, b, out):
        return ksgm.census_y(a, b, out, v_rolls, 1.0, 8.0, min_d, carry_bf16)

    out = x.clone()
    assert torch.equal(torch.func.vmap(add_y)(tl, tr, out), want)
    assert torch.equal(out, want)
    assert all(v == 0 for v in ksgm.LAUNCHES.values())


@pytest.fixture(scope="module")
def tiny_volumes():
    rng = np.random.RandomState(11)
    vol = rng.randint(0, 25, size=(2, 7, 12, 20)).astype(np.float32)
    wedge = (np.arange(20)[None, None, :]
             < (np.arange(7) + 1)[:, None, None])
    vol = np.where(wedge[None], 1e4, vol).astype(np.float32)
    # (B, D, H, W) -> the y family's (B, H, W, D)
    vy = np.ascontiguousarray(vol.transpose(0, 2, 3, 1))
    return (jnp.asarray(vy, jnp.bfloat16),
            torch.from_numpy(vy).to(torch.bfloat16))


def test_vmapped_axis_scan_matches_jax_vmap_of_pallas(tiny_volumes):
    vj, vt = tiny_volumes
    kw = dict(rolls=(0, 1, -1), p1=1.0, p2=8.0, entry="y", min_d=1)
    want = np.asarray(jax.vmap(functools.partial(jsgm.axis_scan_pallas,
                                                 **kw))(vj), np.float32)
    got = torch.func.vmap(functools.partial(ksgm.axis_scan, **kw))(vt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("carry_bf16", [False, True])
def test_batched_axis_scan_is_the_per_stream_twin(tiny_volumes, carry_bf16):
    """Both families' roll sets, vmap and an explicit (B, L, R, D) axis:
    each stream bitwise its own twin."""
    _, vt = tiny_volumes
    vx = vt.permute(0, 2, 1, 3).contiguous()       # scan over x
    for v, rolls, entry in ((vx, (0,), "x"), (vt, (0, 1, -1), "y"),
                            (vt, (0,), "y")):
        kw = dict(rolls=rolls, p1=1.0, p2=8.0, carry_bf16=carry_bf16,
                  entry=entry, min_d=1)
        want = torch.stack([tsgm.axis_scan(v[k], **kw) for k in range(2)])
        assert torch.equal(torch.func.vmap(
            functools.partial(ksgm.axis_scan, **kw))(v), want), entry
        assert torch.equal(ksgm.axis_scan(v, **kw), want), entry


# the SGM matcher of the round (n_d 63 at this width), its materialized
# branch, and the map-prior rescue on a map of one round
ROUND_CONFIGS = {
    "fused_census": dict(),
    "materialized": dict(sgm_fused_census=False),
    "prior_rescue": dict(prior_rescue=True, prior_min_updates=0),
}


def payload_of(round_, masks):
    rows = []
    for k in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.15 * round_ + 0.2 * k
        li, ri = pair(pose)
        rows.append(jstate.pack_stereo_with_aux(
            REF, jstate.pack_stereo_pair(REF, li, ri),
            jstate.pack_aux(pose, round_, masks, BF)))
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("name", sorted(ROUND_CONFIGS))
def test_vmapped_round_is_solo_steps(name):
    """Two rounds of two streams: the vmapped round's banks and stats, and
    each stream's depth, bitwise a solo fuse_frame_stereo_onebuf of that
    stream on its own bank."""
    scfg = StereoConfig(max_disparity=64, aggregation="sgm",
                        **ROUND_CONFIGS[name])
    fleet = multistream.make_banks(CFG, 2, "cpu")
    solo = multistream.make_banks(CFG, 2, "cpu")
    masks = np.zeros(CFG.max_keyframes, bool)
    rescued = 0
    for i in range(2):
        masks[i] = True
        payload = payload_of(i, masks)
        # the depth of each stream, vmapped and solo, from the banks before
        # this round's update
        frames, poses, _, bf, _ = multistream.unpack_payload(
            payload, 2 * CFG.height * CFG.width)

        def depth_of(bank_fields, frame, pose, bf):
            bank = SurfelBank(**bank_fields)
            left, right = tfs.unpack_stereo(CFG, frame)
            return tfs.compute_depth_stereo(
                CFG, scfg, left, right, bf, True,
                prior_depth=tfs._stereo_prior(CFG, scfg, bank, pose))

        fields = {k: getattr(fleet, k) for k in FIELDS}
        depth, n_resc = torch.func.vmap(depth_of)(fields, frames, poses, bf)
        stats = multistream.batched_stereo_onebuf_step(CFG, scfg, True,
                                                       fleet, payload)
        assert torch.equal(stats["n_rescued_px"], n_resc)
        for k in range(2):
            bank = multistream.stream_bank(solo, k)
            d1, r1 = depth_of({f: getattr(bank, f) for f in FIELDS},
                              frames[k], poses[k], bf[k])
            assert torch.equal(depth[k], d1) and torch.equal(n_resc[k], r1)
            _, st = tfs.fuse_frame_stereo_onebuf(CFG, scfg, True, bank,
                                                 payload[k])
            assert set(st) == set(stats)
            for key in st:
                assert torch.equal(stats[key][k], st[key]), (key, k)
        rescued += int(stats["n_rescued_px"].sum())
        assert int((depth > 0).sum()) > 0
    for f in FIELDS:
        assert torch.equal(getattr(fleet, f), getattr(solo, f)), f
    assert int(fleet.count.min()) > 0
    if scfg.prior_rescue:
        assert rescued > 0


# B5 at KITTI size: 376 x 1241, 127 planes, 8 paths, on an H100's 132 SMs
KITTI = (376, 1241, 127, 3)


def test_b5_per_stream_sm_split_is_refused():
    """Giving each of two streams half the SMs widens a band to 38
    columns: 254,592 B of shared memory, more than a block may hold, which
    is why the blocks walk the streams instead."""
    assert ksgm.MAX_SMEM == 232448
    with pytest.raises(ValueError, match="254592 B of shared memory"):
        ksgm.census_y_plan(*KITTI, sms=ksgm.H100_SMS // 2)
    with pytest.raises(ValueError, match="shared memory"):
        ksgm.census_y_plan(*KITTI, sms=ksgm.H100_SMS // 4)


@pytest.mark.parametrize("streams", [1, 2, 3, 4])
def test_b5_batched_plan_keeps_its_blocks(streams):
    """The stream count changes neither the grid (2 x 66 blocks, one per
    SM) nor a block's shared memory nor the halo buffer; each stream has a
    slab of its own."""
    one = ksgm.census_y_plan(*KITTI)
    plan = ksgm.census_y_plan(*KITTI, streams=streams)
    assert plan.streams == streams and plan.rows == 376
    assert plan._replace(streams=1) == one
    assert 2 * plan.nbands == ksgm.H100_SMS and plan.smem == 133568
    assert plan.slab_shape == (376, 1241, 128)
    x = ksgm.census_x_plan(376, 1241, 127, streams)
    assert (x.blocks, x.streams) == (376, streams)
    b4 = ksgm.axis_plan(376, 1241, 127, (0, 1, -1), streams=streams)
    assert b4._replace(streams=1) == ksgm.axis_plan(376, 1241, 127,
                                                    (0, 1, -1))


@pytest.mark.parametrize("H", [376, 61, 5, 1])
def test_b5_halo_tags_never_confuse_streams(H):
    """Tags: distinct over every (stream, row) of a launch and never 0 (a
    zeroed ring); a reader of stream s, row t waits for the tag of row t -
    1 of the same stream, which no other (stream, row) writes.  Ring slots:
    a band runs at most one global row ahead of a neighbour within a
    stream and two across a stream boundary (row 0 waits on no halo), and
    the slot it then writes is never one the neighbour has still to read
    (rows g - 3 and g - 2 of the writer's global row g)."""
    B = 4
    plan = ksgm.census_y_plan(H, 1241, 127, 3, streams=B)
    tags = [plan.tag(s, t) for s in range(B) for t in range(H)]
    assert len(set(tags)) == B * H and min(tags) >= 1
    assert plan.tag(0, 0) == 1 and plan.tag(B - 1, H - 1) == B * H
    for s in range(B):
        for t in range(1, H):
            waited = plan.tag(s, t - 1)
            assert [(s2, t2) for s2 in range(B) for t2 in range(H)
                    if plan.tag(s2, t2) == waited] == [(s, t - 1)]
    for s in range(B):
        for t in range(H):
            g = s * H + t
            assert plan.ring_slot(s, t) == g % 4
            for behind in (2, 3):
                if g - behind >= 0:
                    assert plan.ring_slot(s, t) != (g - behind) % 4
    # the meeting of stream s waits for the other orientation's count of
    # s H + its first half, which only stream s's first half reaches
    first_bwd = H - H // 2
    for s in range(B):
        need = s * H + first_bwd
        assert plan.rows_done(s, first_bwd - 1) == need
        assert all(plan.rows_done(s2, t) < need for s2 in range(s + 1)
                   for t in range(H) if (s2, t) < (s, first_bwd - 1))
