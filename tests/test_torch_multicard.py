"""Meshes over several cards, on the CPU.

The graphed/eager decision and the capture plan (`parallel/sharding.py::
graphed_mesh`, `capture_plan`: which card gets which pool, lane, cell
streams, warm-up clones and the home cell) for meshes built from
`torch.device("cuda", k)` objects, nothing allocated: one card, four, 8
cells on 4 cards, and 2 data rows.  Then the passes over the shards that
issue each cell's work on its own stream on a card (`sharding.cells`:
`_fuse_row`, `_stereo_row`) and the ring of the sharded SGM
(`sgm_sharding._ring_axis_scan`, on the cards' lanes), on an 8-cell CPU
mesh laid out as 8 cells on 4 devices, against the JAX
package's sharded programs on its 8 virtual devices at the 120 x 56
config: the fuse and stereo steps shard by shard (counts, update_times and
last_update exact, positions and normals within 1e-5 m; the other float
fields within 1e-5 m, the stereo step's within a relative 1e-5: its
sizes reach 10 m, where an f32 ulp is ~1e-6 m), the sharded SGM
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core.state import FrameInput as JFrame
from densesurfelmapping_tpu.core.state import pack_stereo_pair, pad_frame
from densesurfelmapping_tpu.io import synthetic
from densesurfelmapping_tpu.models import stereo as jstereo
from densesurfelmapping_tpu.parallel import sgm_sharding as jsgm
from densesurfelmapping_tpu.parallel import sharding as jsh
from densesurfelmapping_tpu_torch.core.state import FrameInput
from densesurfelmapping_tpu_torch.models import stereo as tstereo
from densesurfelmapping_tpu_torch.parallel import sgm_sharding as tsgm
from densesurfelmapping_tpu_torch.parallel import sharding as tsh

from test_sgm_sharding import stereo_pair
from test_torch_sharding import EXACT, FIELDS, port_config, same_shards

torch.set_num_threads(1)

CARDS = [torch.device("cuda", k) for k in range(4)]
CPUS = [f"cpu:{k}" for k in range(4)]        # 8 cells on 4 devices
CAM = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                       cy=27.5)
CFG = SurfelMapConfig(camera=CAM, surfel_capacity=8192, lane_align=8,
                      drift_free_poses=3)


@pytest.fixture
def cards(monkeypatch):
    """make_mesh over CUDA device objects without a card: only its check
    that CUDA is available is bypassed; nothing is allocated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return CARDS


@pytest.mark.parametrize("n,n_cards,data,cells,streams", [
    # one card: 2 virtual cells, each on a cell stream of its own
    (2, 1, 1, {0: [(0, 0), (0, 1)]}, {0: [1, 2]}),
    (4, 4, 1, {k: [(0, k)] for k in range(4)}, {k: [1] for k in range(4)}),
    # 8 cells on 4 cards: each card holds shards k and k + 4
    (8, 4, 1, {k: [(0, k), (0, k + 4)] for k in range(4)},
     {k: [1, 2] for k in range(4)}),
    # 2 data rows of 2 cards: each row's pass is its own
    (4, 4, 2, {0: [(0, 0)], 1: [(0, 1)], 2: [(1, 0)], 3: [(1, 1)]},
     {k: [1] for k in range(4)}),
])
def test_capture_plan(cards, n, n_cards, data, cells, streams):
    mesh = tsh.make_mesh(n, data=data, devices=cards[:n_cards])
    plan = tsh.capture_plan(mesh)
    assert plan["graphed"] and tsh.graphed_mesh(mesh)
    assert plan["home"] == cards[0] == mesh.device(0, 0)
    assert list(plan["cards"]) == cards[:n_cards] == mesh.devices()
    for k, card in enumerate(cards[:n_cards]):
        got = plan["cards"][card]
        home = k == 0
        assert got["lane"] == ("capture" if home else 0)
        assert got["pool"] == ("graph" if home else "use_mem_pool")
        assert got["cells"] == cells[k] and got["streams"] == streams[k]
        # the warm-up clones the banks of these cells on this card
        assert all(mesh.device(r, s) == card for r, s in got["cells"])


def test_cpu_mesh_is_eager():
    mesh = tsh.make_mesh(8, devices=CPUS)
    plan = tsh.capture_plan(mesh)
    assert not plan["graphed"] and not tsh.graphed_mesh(mesh)
    assert tsh.cell_streams(mesh.grid[0]) == [
        (torch.device(d), 1 + i // 4) for i, d in enumerate(CPUS * 2)]


def test_fuse_stream_on_8_cells_matches_jax():
    """`sharded_fuse_frame` (one `_fuse_row` per frame: the
    replicated stage and the fuse pass, the max of the fused flags, the
    extract/append pass) over two frames."""
    scene = synthetic.default_scene()
    jmesh = jsh.make_mesh(8, data=1)
    tmesh = tsh.make_mesh(8, devices=CPUS)
    tc = port_config(CFG)
    jstep = jsh.sharded_fuse_frame(CFG, jmesh)
    tstep = tsh.sharded_fuse_frame(tc, tmesh)
    jbanks = jsh.replicate_banks(jmesh, CFG, n_streams=1)
    tbanks = tsh.replicate_banks(tmesh, tc, n_streams=1)
    for t, pose in enumerate(synthetic.forward_trajectory(2, step=0.3)):
        img, dep = pad_frame(CFG, *scene.render(CFG, pose))
        pose = pose.astype(np.float32)[None]
        jbanks, jstats = jstep(jbanks, jsh.shard_frames(jmesh, JFrame(
            image=jnp.asarray(img[None]), depth=jnp.asarray(dep[None]),
            pose=jnp.asarray(pose), frame_index=jnp.full((1,), t,
                                                         jnp.int32))))
        tbanks, tstats = tstep(tbanks, tsh.shard_frames(tmesh, FrameInput(
            image=torch.from_numpy(img[None]),
            depth=torch.from_numpy(dep[None]), pose=torch.from_numpy(pose),
            frame_index=torch.full((1,), t, dtype=torch.int32))))
        for k in ("n_live", "n_new", "n_dropped", "n_fused_seeds"):
            np.testing.assert_array_equal(tstats[k].numpy(),
                                          np.asarray(jstats[k]), err_msg=k)
    assert tbanks.counts().sum() > 0
    same_shards(jbanks, tbanks, 8)


def test_stereo_stream_on_8_cells_matches_jax():
    """`sharded_fuse_frame_stereo` (`_stereo_row`: the z-buffers' pass
    over the shards, then `_fuse_row` with the matcher in its first pass)
    over one pair of the textured
    scene."""
    scene = synthetic.Scene(ground_y=1.5, wall_z=18.0,
                            boxes=synthetic.default_scene().boxes,
                            max_depth=25.0, texture="multisine")
    kw = dict(max_disparity=64, min_disparity=1, radius=3)
    pose = np.eye(4)
    right = pose.copy()
    right[:3, 3] += right[:3, 0] * 0.5
    buf = pack_stereo_pair(CFG, scene.render(CFG, pose)[0],
                           scene.render(CFG, right)[0])[None]
    jmesh = jsh.make_mesh(8, data=1)
    tmesh = tsh.make_mesh(8, devices=CPUS)
    tc = port_config(CFG)
    bf = np.full(1, CAM.fx * 0.5, np.float32)
    pose = pose.astype(np.float32)[None]
    jbanks, jstats = jsh.sharded_fuse_frame_stereo(
        CFG, jstereo.StereoConfig(**kw), True, jmesh)(
            jsh.replicate_banks(jmesh, CFG, n_streams=1), jnp.asarray(buf),
            jnp.asarray(pose), jnp.zeros(1, jnp.int32), jnp.asarray(bf))
    tbanks, tstats = tsh.sharded_fuse_frame_stereo(
        tc, tstereo.StereoConfig(**kw), True, tmesh)(
            tsh.replicate_banks(tmesh, tc, n_streams=1),
            torch.from_numpy(buf), torch.from_numpy(pose),
            torch.zeros(1, dtype=torch.int32), torch.from_numpy(bf))
    for k in ("n_new", "n_rescued_px"):
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    counts = np.asarray(jbanks.count)
    np.testing.assert_array_equal(tbanks.counts(), counts)
    assert counts.sum() > 0
    slab = tbanks.rows_per_shard
    for k in FIELDS:
        jf, tf = np.asarray(getattr(jbanks, k))[0], tbanks.host(k)[0]
        for s in range(8):
            rows = slice(s * slab, s * slab + int(counts[0, s]))
            if k in EXACT:
                np.testing.assert_array_equal(tf[rows], jf[rows], k)
            elif k in ("position", "normal"):
                np.testing.assert_allclose(tf[rows], jf[rows], rtol=0,
                                           atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(tf[rows], jf[rows], rtol=1e-5,
                                           atol=0, err_msg=k)


def test_ring_scan_on_8_cells_matches_jax():
    """`sharded_sgm_disparity` with 8 paths (the diagonals' ring,
    `_ring_axis_scan`) at 56 x 120: bitwise the replicated plain
    disparity and the JAX package's sharded SGM."""
    left, right, max_d = stereo_pair(h=56, w=120, seed=2)
    jc = jstereo.StereoConfig(max_disparity=max_d, aggregation="sgm",
                              sgm_paths=8, sgm_pallas=False)
    tc = tstereo.StereoConfig(**jc._asdict())
    tl, tr = (torch.from_numpy(np.array(a)) for a in (left, right))
    want = tstereo.disparity(tl, tr, tc)
    got = tsgm.sharded_sgm_disparity(tsh.make_mesh(8, devices=CPUS), tc,
                                     56, 120)(tl, tr)
    jgot = jsgm.sharded_sgm_disparity(jsh.make_mesh(8, data=1), jc, 56,
                                      120)(left, right)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert (want > 0).float().mean() > 0.3
