"""The plane-fit kernel (`ops/cuda/planefit.py`, `csrc/planefit.cu`) against
its plain twin `ops/normals.py::seed_plane_fields`.

On the CPU the wrapper runs the twin: bitwise, for one stream and, over a
(B, ...) stream axis or under torch.func.vmap, for each of two, and for a
column slab of the frame-sharded driver (`compute_seed_planes(...,
geom=)`, which asks the wrapper too); the launch geometry and the launch's
operand checks, a slab's included.

The kernel sums in its own order, so on the card it is held to the twin
within tolerances: a seed's `ok` gate equal (the counts and the Huber test
that decide it are computed as the twin computes them; a seed whose depth
residual lies within an ulp of huber_range is counted and allowed to
differ), the fitted normals within 1e-5 of the twin's in cosine, positions
and mean depths within 1e-5 m, the view cosine within 1e-5, the size
bitwise, and a seed that fails the gates keeps its fields bitwise; these
sit well inside DIVERGENCES #5's 0.5 degrees and 2 mm.  A slab, whose
pixels sit at the frame's columns from its first, is held to the same.  The tests marked
`card` need a CUDA card and skip without one; this file imports no JAX, so
they run on the card without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_planefit_kernel.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from densesurfelmapping_tpu_torch.config import (DRIVE_PROFILE,
                                                 CameraIntrinsics,
                                                 SurfelMapConfig,
                                                 kitti_config)
from densesurfelmapping_tpu_torch.core.state import pad_frame
from densesurfelmapping_tpu_torch.io import synthetic
from densesurfelmapping_tpu_torch.ops import normals as N
from densesurfelmapping_tpu_torch.ops import superpixel as S
from densesurfelmapping_tpu_torch.ops import windows as W
from densesurfelmapping_tpu_torch.ops.cuda import planefit as K
from densesurfelmapping_tpu_torch.parallel import frame_sharding as FS

FIELDS = ("x", "y", "mean_depth", "norm", "pos", "view_cos", "size")
OUTPUTS = ("norm", "pos", "mean_depth", "view_cos", "size")
TOL = 1e-5


def small_config(sp: int = 8) -> SurfelMapConfig:
    """The 120 x 56 camera of the CPU tests at seed pitch sp."""
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                           cy=27.5)
    return SurfelMapConfig(camera=cam, profile=DRIVE_PROFILE,
                           surfel_capacity=4096, sp_size=sp)


def pitched(angle: float, z: float) -> np.ndarray:
    """A pose pitched down by `angle` and `z` m into the scene: ground, box
    faces and depth edges in view."""
    c, s = np.cos(angle), np.sin(angle)
    pose = np.eye(4)
    pose[:3, :3] = [[1, 0, 0], [0, c, s], [0, -s, c]]
    pose[2, 3] = z
    return pose


def segmented(cfg, pose, device, noise=0.02, seed=7):
    """A rendered frame, padded, and its SLIC: (depth, assignment, seeds)."""
    img, dep = synthetic.default_scene().render(cfg, pose, depth_noise=noise,
                                                seed=seed)
    pi, pd = pad_frame(cfg, img, dep)
    image = torch.from_numpy(pi).to(device)
    depth = torch.from_numpy(pd).to(device)
    seeds, assignment = S.run_slic(cfg, image, depth)
    return depth, assignment, seeds


def slab(cfg, pose, n_slabs, shard, device):
    """Shard `shard`'s column slab of the rendered frame at `pose`, cut as
    `frame_sharding._slab_segmentation` cuts it, and its plain SLIC:
    (depth, assignment, seeds, the slab's geometry)."""
    img, dep = synthetic.default_scene().render(cfg, pose, depth_noise=0.02,
                                                seed=7)
    ext = FS._extended_geometry(cfg, n_slabs)
    sp, own, halo = cfg.sp_size, ext["own"], ext["halo"]
    pad = (halo * sp, (ext["c_round"] - cfg.sp_cols + halo) * sp)
    x0, width = shard * own * sp, (own + 2 * halo) * sp
    image, depth = (F.pad(torch.from_numpy(a), pad)[:, x0:x0 + width]
                    .contiguous().to(device)
                    for a in pad_frame(cfg, img, dep))
    g = FS.slab_geometry(cfg, n_slabs, shard, torch.device(device))
    seeds, assignment = S.run_slic(cfg, image, depth, use_kernels=False,
                                   geom=g)
    return depth, assignment, seeds, g


def operands(depth, assignment, seeds):
    return (depth, assignment) + tuple(getattr(seeds, f) for f in FIELDS)


def stacked(cases):
    """Two streams' operands, stream axis first."""
    return tuple(torch.stack(ts) for ts in zip(*cases))


def same(got, want):
    assert len(got) == len(want) == len(OUTPUTS)
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# on the CPU


@pytest.fixture(scope="module")
def cpu_cases():
    cfg = small_config()
    return cfg, [operands(*segmented(cfg, pitched(a, z), "cpu", seed=s))
                 for a, z, s in ((0.35, 8.0, 7), (0.2, 4.0, 3))]


def test_wrapper_on_cpu_is_the_twin(cpu_cases):
    """One stream: the wrapper's output is the twin's, bitwise, and the
    fit took (initial normals are zero; a fitted one is a unit vector)."""
    cfg, (ops, _) = cpu_cases
    K.reset_launch_counts()
    got = K.seed_planes(cfg, *ops)
    same(got, N.seed_plane_fields(cfg, *ops))
    assert int((got[0] != 0).any(-1).sum()) > 20
    assert K.LAUNCHES["planefit"] == 0


def test_wrapper_streams_on_cpu_equal_per_stream_twin(cpu_cases):
    """Two streams: a (B, ...) call and a call under torch.func.vmap each
    equal the twin stream by stream."""
    cfg, cases = cpu_cases
    batched = stacked(cases)
    outs = [K.seed_planes(cfg, *batched),
            torch.func.vmap(lambda *a: K.seed_planes(cfg, *a))(*batched)]
    for b, ops in enumerate(cases):
        want = N.seed_plane_fields(cfg, *ops)
        for got in outs:
            same(tuple(t[b] for t in got), want)


@pytest.fixture(scope="module")
def cpu_slabs():
    """Both column slabs of the 120 x 56 frame cut in two."""
    cfg = small_config()
    return cfg, [slab(cfg, pitched(0.35, 8.0), 2, s, "cpu") for s in (0, 1)]


def test_slab_geometry_takes_the_twin(cpu_cases, cpu_slabs, monkeypatch):
    """`compute_seed_planes` asks the wrapper with and without a column
    slab's geometry; on the CPU both give the twin's fields bitwise, a
    slab's with its geometry, and the seeds' other fields pass through."""
    cfg, (ops, _) = cpu_cases
    depth, asg = ops[:2]
    seeds = segmented(cfg, pitched(0.35, 8.0), "cpu")[2]
    calls = []
    real = K.seed_planes
    monkeypatch.setattr(K, "seed_planes",
                        lambda *a: calls.append(1) or real(*a))
    cases = [(N.compute_seed_planes(cfg, seeds, asg, depth), seeds,
              N.seed_plane_fields(cfg, *ops))]
    for sdepth, sasg, sseeds, g in cpu_slabs[1]:
        cases.append((N.compute_seed_planes(cfg, sseeds, sasg, sdepth,
                                            geom=g), sseeds,
                      N.seed_plane_fields(cfg, *operands(sdepth, sasg,
                                                         sseeds), geom=g)))
    assert len(calls) == 3
    for got, given, want in cases:
        same(tuple(getattr(got, f) for f in OUTPUTS), want)
        assert int((got.norm != 0).any(-1).sum()) > 5
        for f in ("x", "y", "mean_intensity", "stable", "fused"):
            assert getattr(got, f) is getattr(given, f)


@pytest.mark.parametrize("shard", [0, 1])
def test_launch_takes_a_slab(cpu_cases, cpu_slabs, shard):
    """A slab's operands pass the launch's checks with the slab's geometry
    and reach the stream, which wants CUDA; a whole frame's do not."""
    cfg, slabs = cpu_slabs
    depth, asg, seeds, g = slabs[shard]
    with pytest.raises(ValueError, match="CUDA tensors"):
        K._launch_planefit(cfg, *operands(depth, asg, seeds), g)
    with pytest.raises(ValueError, match="has shape"):
        K._launch_planefit(cfg, *cpu_cases[1][0], g)


@pytest.mark.parametrize("sp,smem", [(2, 1536), (6, 13824), (8, 24576),
                                     (16, 98304)])
def test_plan(sp, smem):
    """A warp a seed, 8 seeds a block, the streams on grid z; three list
    planes of 4 sp^2 floats a warp (above 48 KB from sp 12 on, which the
    C entry opts into)."""
    plan = K.planefit_plan(47, 160, sp, nb=3)
    assert plan.grid == (940, 1, 3) and plan.threads == 256
    assert plan.smem == smem == K.SEEDS * 3 * 4 * sp * sp * 4


@pytest.mark.parametrize("sp,nb", [(1, 1), (17, 1), (8, 0), (8, 65536)])
def test_plan_refuses(sp, nb):
    with pytest.raises(ValueError):
        K.planefit_plan(47, 160, sp, nb)


def _bad(ops, what):
    """ops with one operand the launch does not take."""
    ops = list(ops)
    if what == "dtype":
        ops[0] = ops[0].double()
    elif what == "int assignment":
        ops[1] = ops[1].long()
    elif what == "shape":
        ops[2] = ops[2][:, :-1].contiguous()
    elif what == "vector shape":
        ops[5] = ops[5][..., :2].contiguous()
    elif what == "layout":
        ops[6] = ops[6].transpose(0, 1).contiguous().transpose(0, 1)
    elif what == "rank":
        ops[0] = ops[0][0]
    return ops


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("int assignment", TypeError),
    ("shape", ValueError), ("vector shape", ValueError),
    ("layout", ValueError), ("rank", ValueError),
    ("a CPU device", ValueError)])
def test_launch_checks_its_operands(cpu_cases, what, err):
    """The launch refuses what the kernel does not take before it touches a
    device; CPU operands it takes reach the stream, which wants CUDA."""
    cfg, (ops, _) = cpu_cases
    with pytest.raises(err):
        K._launch_planefit(cfg, *_bad(ops, what))


def test_wrapper_refuses_other_devices():
    cfg = small_config()
    ops = [torch.empty((cfg.padded_height, cfg.padded_width),
                       device="meta")] * 2
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.seed_planes(cfg, *ops, *([None] * 7))


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def boundary_seeds(cfg, depth, assignment, mean_depth, g=None):
    """Seeds with a member depth whose residual to the seed's mean depth
    lies within one ulp of +-huber_range: where a Huber test could round
    either way.  g: a slab's geometry."""
    hr = torch.tensor(cfg.profile.huber_range, dtype=torch.float32,
                      device=depth.device)
    ulp = torch.nextafter(hr, hr + 1) - hr
    g = g or S.device_geometry(cfg, depth.device)
    win = W.extract_windows(depth, cfg.sp_size)
    member = (W.extract_windows(assignment, cfg.sp_size)
              == g["flat_id"][..., None]) & g["in_image"] & (win > 0.05)
    near = ((mean_depth[..., None] - win).abs() - hr).abs() <= ulp
    return (near & member).any(-1)


def held_to_twin(cfg, ops, got, want, g=None) -> dict:
    """The tolerances of the module doc; returns what was seen.  g: a
    slab's geometry."""
    depth, assignment = ops[:2]
    seeds = dict(zip(FIELDS, ops[2:]))
    ok_k = (got[0] != seeds["norm"]).any(-1)
    ok_t = (want[0] != seeds["norm"]).any(-1)
    edge = boundary_seeds(cfg, depth, assignment, seeds["mean_depth"], g)
    differ = ok_k != ok_t
    assert not bool((differ & ~edge).any()), \
        f"ok differs on {int((differ & ~edge).sum())} seeds"
    both, neither = ok_k & ok_t, ~ok_k & ~ok_t
    for name, g in zip(OUTPUTS, got):
        assert torch.equal(g[neither], seeds[name][neither]), name
    cos = (got[0][both] * want[0][both]).sum(-1).double()
    one_minus_cos = float((1 - cos).max())
    pos_err = float((got[1][both] - want[1][both]).abs().max())
    md_err = float((got[2][both] - want[2][both]).abs().max())
    vc_err = float((got[3][both] - want[3][both]).abs().max())
    assert one_minus_cos <= TOL and pos_err <= TOL and md_err <= TOL \
        and vc_err <= TOL, (one_minus_cos, pos_err, md_err, vc_err)
    assert torch.equal(got[4], want[4])
    # DIVERGENCES #5
    angle = float(torch.rad2deg(torch.arccos(cos.clamp(-1, 1))).max())
    assert angle < 0.5 and pos_err < 2e-3
    return dict(fitted=int(both.sum()), boundary=int(edge.sum()),
                ok_differs=int(differ.sum()), one_minus_cos=one_minus_cos,
                pos_err=pos_err)


KITTI_POSES = [synthetic.forward_trajectory(9, step=0.4)[k]
               for k in (0, 8)] + [pitched(0.2, 6.0)]


@pytest.mark.card
@pytest.mark.parametrize("pose", range(len(KITTI_POSES)))
def test_kernel_matches_twin_at_kitti(card, pose):
    cfg = kitti_config()
    ops = operands(*segmented(cfg, KITTI_POSES[pose], card))
    K.reset_launch_counts()
    got = K.seed_planes(cfg, *ops)
    assert K.LAUNCHES["planefit"] == 1
    seen = held_to_twin(cfg, ops, got, N.seed_plane_fields(cfg, *ops))
    assert seen["fitted"] > 1000
    print(f"KITTI pose {pose}: {seen}")


@pytest.mark.card
@pytest.mark.parametrize("sp", [6, 8, 16])
def test_kernel_matches_twin_on_a_crop(card, sp):
    cfg = small_config(sp)
    ops = operands(*segmented(cfg, pitched(0.35, 8.0), card))
    seen = held_to_twin(cfg, ops, K.seed_planes(cfg, *ops),
                        N.seed_plane_fields(cfg, *ops))
    assert seen["fitted"] > 0
    print(f"120 x 56 at sp {sp}: {seen}")


@pytest.mark.card
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_kernel_matches_twin_on_a_slab(card, shard):
    """Four KITTI slabs (the first, one inside, the last): the kernel, told
    the slab's first column in the frame, against the twin on the slab's
    global pixel planes."""
    cfg = kitti_config()
    depth, asg, seeds, g = slab(cfg, KITTI_POSES[2], 4, shard, card)
    ops = operands(depth, asg, seeds)
    K.reset_launch_counts()
    got = K.seed_planes(cfg, *ops, g)
    assert K.LAUNCHES["planefit"] == 1
    seen = held_to_twin(cfg, ops, got,
                        N.seed_plane_fields(cfg, *ops, geom=g), g)
    assert seen["fitted"] > 300
    print(f"KITTI slab {shard} of 4: {seen}")


@pytest.mark.card
def test_slab_segmentation_one_launch_a_shard(card):
    """The frame-sharded segmentation of a KITTI frame in four slabs on one
    card: one launch a shard (each vmapped over the row's one stream), and
    the gathered seeds fitted and finite."""
    cfg = kitti_config()
    img, dep = synthetic.default_scene().render(cfg, KITTI_POSES[2],
                                                depth_noise=0.02, seed=7)
    image, depth = (torch.from_numpy(a).to(card)
                    for a in pad_frame(cfg, img, dep))
    K.reset_launch_counts()
    (seeds, _), *_ = FS.slab_segmentation(cfg, 4, image, depth)
    assert K.LAUNCHES["planefit"] == 4
    fitted = (seeds.norm != 0).any(-1)
    assert int(fitted.sum()) > 1000
    assert bool(torch.isfinite(seeds.pos).all())


@pytest.mark.card
def test_streams_and_vmap_one_launch(card):
    """B = 2 KITTI frames: one launch for both streams, directly and under
    torch.func.vmap, each stream torch.equal to the single-stream kernel."""
    cfg = kitti_config()
    cases = [operands(*segmented(cfg, KITTI_POSES[k], card)) for k in (0, 2)]
    batched = stacked(cases)
    K.reset_launch_counts()
    outs = [K.seed_planes(cfg, *batched),
            torch.func.vmap(lambda *a: K.seed_planes(cfg, *a))(*batched)]
    assert K.LAUNCHES["planefit"] == 2
    for b, ops in enumerate(cases):
        want = K.seed_planes(cfg, *ops)
        for got in outs:
            same(tuple(t[b] for t in got), want)


@pytest.mark.card
def test_in_a_captured_graph(card):
    """Captured in a CUDA graph and replayed over new inputs copied into
    its static operands, it equals the eager call."""
    cfg = kitti_config()
    first, second = (operands(*segmented(cfg, KITTI_POSES[k], card))
                     for k in (0, 1))
    static = [t.clone() for t in first]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.seed_planes(cfg, *static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.seed_planes(cfg, *static)
    for ops in (second, first):
        for s, t in zip(static, ops):
            s.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        same(out, K.seed_planes(cfg, *ops))


@pytest.mark.card
@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("int assignment", TypeError),
    ("shape", ValueError), ("vector shape", ValueError),
    ("layout", ValueError), ("rank", ValueError)])
def test_wrapper_refuses_on_the_card(card, what, err):
    cfg = small_config()
    ops = operands(*segmented(cfg, pitched(0.35, 8.0), card))
    with pytest.raises(err):
        K.seed_planes(cfg, *_bad(ops, what))


@pytest.mark.card
def test_fuse_frame_runs_the_kernel(card, monkeypatch):
    """The fuse step's plane fit is the kernel, one launch a frame, and
    never the twin."""
    from densesurfelmapping_tpu_torch.core.state import (FrameInput,
                                                         SurfelBank)
    from densesurfelmapping_tpu_torch.pipeline import fuse_step

    def twin(*a, **k):
        raise AssertionError("the plane fit ran its plain twin")

    cfg = kitti_config(surfel_capacity=1 << 16)
    bank = SurfelBank.empty(cfg.surfel_capacity, card)
    monkeypatch.setattr(N, "seed_plane_fields", twin)
    K.reset_launch_counts()
    for i, pose in enumerate(KITTI_POSES[:2]):
        img, dep = synthetic.default_scene().render(cfg, pose)
        pi, pd = pad_frame(cfg, img, dep)
        frame = FrameInput(
            image=torch.from_numpy(pi).to(card),
            depth=torch.from_numpy(pd).to(card),
            pose=torch.from_numpy(pose.astype(np.float32)).to(card),
            frame_index=torch.tensor(i, dtype=torch.int32, device=card))
        fuse_step.fuse_frame(cfg, bank, frame)
        assert K.LAUNCHES["planefit"] == i + 1
    assert int(bank.count) > 0
