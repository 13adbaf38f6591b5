"""The port's host I/O against the JAX package's on the same numpy inputs:
export writers byte-identical (binary and ASCII, native and numpy routes),
trajectory text identical, pose feeds and the stress feed equal, the native
pack bitwise equal to the numpy pack and to JAX's, the native BFS equal to
the Python walk, the PNG reader bitwise equal to PIL, the KITTI/TUM readers'
frames equal to JAX's (also through the PNG reader alone), and the viz
outputs byte-identical.  Every comparison is exact unless a tolerance is
named."""

import struct
import sys
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from densesurfelmapping_tpu import viz as jviz
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.core import geometry as jgeom
from densesurfelmapping_tpu.core import state as jstate
from densesurfelmapping_tpu.io import export as jexport
from densesurfelmapping_tpu.io import kitti as jkitti
from densesurfelmapping_tpu.io import posefeed as jfeed
from densesurfelmapping_tpu.io import stressfeed as jstress
from densesurfelmapping_tpu.io import tum as jtum
from densesurfelmapping_tpu.native import loader as jnative
import densesurfelmapping_tpu_torch.config as tcfg
from densesurfelmapping_tpu_torch import viz as tviz
from densesurfelmapping_tpu_torch.core import geometry as tgeom
from densesurfelmapping_tpu_torch.core import state as tstate
from densesurfelmapping_tpu_torch.io import export as texport
from densesurfelmapping_tpu_torch.io import kitti as tkitti
from densesurfelmapping_tpu_torch.io import png as tpng
from densesurfelmapping_tpu_torch.io import posefeed as tfeed
from densesurfelmapping_tpu_torch.io import stressfeed as tstress
from densesurfelmapping_tpu_torch.io import tum as ttum
from densesurfelmapping_tpu_torch.native import loader as tnative
from densesurfelmapping_tpu_torch.pipeline.pose_graph import PoseGraph

CAM = CameraIntrinsics(width=64, height=48, fx=60.0, fy=60.0, cx=31.5,
                       cy=23.5)


def sample_surfels(n=10, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[0] = (0.0, 0.0, 1.0)          # the degenerate tangent basis
    return dict(position=rng.normal(size=(n, 3)).astype(np.float32),
                normal=nrm.astype(np.float32),
                color=rng.uniform(-5, 260, n).astype(np.float32),
                size=rng.uniform(0.01, 0.1, n).astype(np.float32),
                weight=np.ones(n, np.float32),
                update_times=np.full(n, 6, np.int32),
                last_update=np.zeros(n, np.int32))


def random_poses(n, seed):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        p = np.eye(4)
        p[:3, :3] = q
        p[:3, 3] = rng.normal(size=3) * 5
        poses.append(p)
    return poses


def _jax_native_loaded() -> bool:
    """The JAX package's native library, loaded.  Its loader builds in
    place, so a process that tried while another test worker was linking
    it may have given up: let it try again."""
    for _ in range(5):
        if jnative.available():
            return True
        jnative._tried = False
        time.sleep(1.0)
    return False


def test_native_library_builds():
    assert tnative.available() and _jax_native_loaded()


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("kind", ["pcd", "ply"])
def test_writers_byte_identical(tmp_path, monkeypatch, kind, binary, route):
    if route == "numpy":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert tnative.available() and _jax_native_loaded()
    surfels = sample_surfels(12)
    paths = [str(tmp_path / f"{who}.{kind}") for who in ("jax", "port")]
    for mod, path in zip((jexport, texport), paths):
        save = mod.save_cloud_pcd if kind == "pcd" else mod.save_mesh_ply
        assert save(path, surfels, binary=binary) == 12
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) > 0
    if kind == "ply":
        np.testing.assert_array_equal(texport.load_ply_vertices(paths[1]),
                                      jexport.load_ply_vertices(paths[0]))


def test_empty_mesh_and_hexagons_match_jax(tmp_path):
    s = sample_surfels(7)
    np.testing.assert_array_equal(
        texport.hexagon_vertices(s["position"], s["normal"], s["size"]),
        jexport.hexagon_vertices(s["position"], s["normal"], s["size"]))
    empty = {k: v[:0] for k, v in s.items()}
    for mod, name in ((jexport, "j.ply"), (texport, "t.ply")):
        assert mod.save_mesh_ply(str(tmp_path / name), empty) == 0
    assert (tmp_path / "j.ply").read_bytes() \
        == (tmp_path / "t.ply").read_bytes()


@pytest.mark.parametrize("fmt", ["kitti", "tum"])
def test_trajectory_text_identical(tmp_path, fmt):
    poses = random_poses(6, 5) + [np.eye(4)]
    poses[-1][:3, :3] = np.diag([-1.0, -1.0, 1.0])   # trace < 0 branch
    stamps = [0.1 * i for i in range(len(poses))]
    out = []
    for mod, name in ((jexport, "j.txt"), (texport, "t.txt")):
        write = getattr(mod, f"save_trajectory_{fmt}")
        assert write(str(tmp_path / name), poses, stamps) == len(poses)
        out.append((tmp_path / name).read_text())
    assert out[0] == out[1]


def test_pose_helpers_match_jax():
    for pose in random_poses(5, 9):
        qj, tj = jgeom.matrix_to_quat_pos(pose)
        qt, tt = tgeom.matrix_to_quat_pos(pose)
        assert qj == qt and tj == tt
        np.testing.assert_array_equal(tgeom.pose_matrix(qt, tt),
                                      jgeom.pose_matrix(qj, tj))


def _messages(mod):
    poses = random_poses(7, 3)
    return [mod.PoseMessage(
        stamp=float(i), pose=p, is_keyframe=(i % 2 == 0),
        reference_index=i // 2,
        loop_path=[poses[j] for j in range(i // 2 + 1)] if i > 3 else None,
        loop_edges=[(i // 2, 0)] if i == 6 else []) for i, p in
        enumerate(poses)]


def _same_feed(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.stamp, x.is_keyframe, x.reference_index, x.loop_edges) \
            == (y.stamp, y.is_keyframe, y.reference_index, y.loop_edges)
        np.testing.assert_array_equal(x.pose, y.pose)
        assert (x.loop_path is None) == (y.loop_path is None)
        if x.loop_path is not None:
            np.testing.assert_array_equal(np.stack(x.loop_path),
                                          np.stack(y.loop_path))


def test_posefeed_roundtrip_matches_jax(tmp_path):
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jfeed.PoseFeed.save(pj, _messages(jfeed))
    tfeed.PoseFeed.save(pt, _messages(tfeed))
    _same_feed(tfeed.PoseFeed.load(pt), jfeed.PoseFeed.load(pj))
    # each package reads the other's file
    _same_feed(tfeed.PoseFeed.load(pj), jfeed.PoseFeed.load(pt))
    traj = tmp_path / "traj.txt"
    traj.write_text("# tum\n" + "".join(
        f"{0.1 * i} {i * 0.5} 0.2 -1 0.1 0.2 0.3 0.9\n" for i in range(5)))
    _same_feed(tfeed.PoseFeed.from_tum(str(traj), keyframe_every=2),
               jfeed.PoseFeed.from_tum(str(traj), keyframe_every=2))
    poses = random_poses(4, 1)
    _same_feed(tfeed.PoseFeed.from_poses(poses, keyframe_every=3),
               jfeed.PoseFeed.from_poses(poses, keyframe_every=3))


@pytest.mark.parametrize("moving", [False, True])
def test_make_seq00_like_matches_jax(moving):
    kw = dict(n_frames=60, keyframe_every=2, radius=6.0, drift_yaw=0.25 / 60,
              drift_trans=0.5 / 60, revisit_radius=1.5, moving_box=moving)
    j, t = jstress.make_seq00_like(**kw), tstress.make_seq00_like(**kw)
    assert (t.loop_frame, t.n_keyframes) == (j.loop_frame, j.n_keyframes)
    assert t.loop_frame > 0
    np.testing.assert_array_equal(np.stack(t.gt_poses), np.stack(j.gt_poses))
    _same_feed(t.feed, j.feed)
    assert len(t.scene.boxes) == len(j.scene.boxes)
    for a, b in zip(t.scene.boxes + [m.box for m in t.scene.movers],
                    j.scene.boxes + [m.box for m in j.scene.movers]):
        np.testing.assert_array_equal(a.lo, b.lo)
        np.testing.assert_array_equal(a.hi, b.hi)
    cfg = SurfelMapConfig(camera=CAM, surfel_capacity=256)
    for i in (0, 33):
        for a, b in zip(t.scene.render(cfg, t.gt_poses[i], time=float(i)),
                        j.scene.render(cfg, j.gt_poses[i], time=float(i))):
            np.testing.assert_array_equal(a, b)


def _frame(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-10, 280, (CAM.height, CAM.width)).astype(np.float32)
    dep = rng.uniform(0, 40, (CAM.height, CAM.width)).astype(np.float32)
    dep[0, 0], dep[1, 1], dep[2, 2] = np.inf, 0.0, 70000.0   # f16 overflow
    return img, dep


def test_native_pack_bitwise(monkeypatch):
    """The port's native pack equals its numpy pack and the JAX package's
    native pack, with and without the aux tail."""
    ref = SurfelMapConfig(camera=CAM, surfel_capacity=256, max_keyframes=8)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    img, dep = _frame(0)
    aux = tstate.pack_aux(np.eye(4), 3, np.arange(8) % 2 == 0, bf=1.5)
    native = tstate.pack_frame(cfg, img, dep)
    native_aux = tstate.pack_frame_with_aux(cfg, img, dep, aux)
    assert _jax_native_loaded()
    np.testing.assert_array_equal(native, jstate.pack_frame(ref, img, dep))
    np.testing.assert_array_equal(
        native_aux, jstate.pack_frame_with_aux(ref, img, dep, aux))
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "pack_frames_into", lambda *a: False)
    np.testing.assert_array_equal(native, tstate.pack_frame(cfg, img, dep))
    np.testing.assert_array_equal(
        native_aux, tstate.pack_frame_with_aux(cfg, img, dep, aux))


def test_native_bfs_matches_python_walk(monkeypatch):
    """A graph past the native dispatch size (512 keyframes): every root's
    window, native and Python, in the same order."""
    rng = np.random.default_rng(4)
    g = PoseGraph()
    for i in range(600):
        g.add_keyframe(np.eye(4), float(i), i - 1 if i else None)
    g.add_loop_edges([tuple(int(v) for v in rng.integers(0, 600, 2))
                      for _ in range(300)])
    roots = [0, 1, 17, 300, 599]
    native = [g.driftfree_window(r, 4) for r in roots]
    monkeypatch.setattr(tnative, "available", lambda: False)
    walk = [g.driftfree_window(r, 4) for r in roots]
    assert native == walk
    assert all(len(w) > 3 for w in native)


def _write_png_filtered(path, arr):
    """A PNG whose row y is filtered with type y % 5 (every type of the
    PNG specification, section 9, on every kind)."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    depth, ctype = (16, 0) if arr.dtype == np.uint16 else (
        8, 2 if arr.ndim == 3 else 0)
    rows = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).astype(np.int32).reshape(h, -1)
    bpp = rows.shape[1] // w
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, up, c))
        t = y % 5
        pred = (0, a, up, (a + up) >> 1, paeth)[t]
        out.append(bytes([t]) + ((x - pred) & 255).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    data = zlib.compress(b"".join(out))
    # the image data split over two IDAT chunks
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:])
                + chunk(b"IEND", b""))


def _png_cases(tmp_path):
    yy, xx = np.mgrid[0:37, 0:53]
    rng = np.random.default_rng(0)
    g = ((np.sin(xx / 5.0) + np.cos(yy / 3.0)) * 60 + 128
         + rng.normal(0, 6, xx.shape)).clip(0, 255).astype(np.uint8)
    rgb = np.stack([g, np.roll(g, 3, 1), 255 - g], -1)
    g16 = g.astype(np.uint16) * 211 + rng.integers(0, 200, g.shape,
                                                   dtype=np.uint16)
    cases = {}
    for name, arr in (("gray8", g), ("rgb8", rgb), ("gray16", g16)):
        cases[f"{name}_pil"] = tmp_path / f"{name}_pil.png"
        Image.fromarray(arr).save(cases[f"{name}_pil"])
        cases[f"{name}_filters"] = tmp_path / f"{name}_filters.png"
        _write_png_filtered(cases[f"{name}_filters"], arr)
    cases["rgb8_viz"] = tmp_path / "viz.png"       # filter type 0 only
    tviz.save_png(str(cases["rgb8_viz"]), rgb)
    return cases


def test_png_reader_matches_pil(tmp_path):
    """8-bit gray, 16-bit gray and RGB (and RGB to luma as PIL's
    convert("L")), PNGs of PIL's own filter choice, of every filter type,
    and of viz.save_png; other kinds raise."""
    for name, path in _png_cases(tmp_path).items():
        got = tpng.read_png(str(path))
        want = np.asarray(Image.open(path))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if got.dtype == np.uint8:
            np.testing.assert_array_equal(
                tpng.gray_u8(got), np.asarray(Image.open(path).convert("L")),
                err_msg=name)
    bad = tmp_path / "rgba.png"
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(bad)
    with pytest.raises(ValueError):
        tpng.read_png(str(bad))


def _block(monkeypatch, reader, *modules):
    """With reader "png_reader", make `modules` unimportable (as on a
    machine without cv2 and PIL)."""
    if reader == "png_reader":
        for name in modules:
            monkeypatch.setitem(sys.modules, name, None)


def make_kitti_root(tmp_path, n=3):
    root = tmp_path / "kitti"
    for d in ("image_0", "image_1", "depth_0"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 255, (CAM.height, CAM.width), np.uint8)
        Image.fromarray(img).save(root / "image_0" / f"{i:06d}.png")
        Image.fromarray(np.stack([img, 255 - img, img // 2], -1)).save(
            root / "image_1" / f"{i:06d}.png")
        disp = rng.uniform(-1, 60, (CAM.height, CAM.width)).astype(np.float32)
        np.save(root / "depth_0" / f"{i:06d}.npy", disp)
    (root / "poses.txt").write_text("".join(
        " ".join(f"{v:.6f}" for v in p[:3].reshape(-1)) + "\n"
        for p in random_poses(n, 2)))
    return root


def make_tum_root(tmp_path, n=4):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, dep_lines, gt_lines = [], [], []
    rng = np.random.default_rng(1)
    for i in range(n):
        t = 10.0 + i * 0.1
        img = rng.integers(0, 255, (CAM.height, CAM.width, 3), np.uint8)
        Image.fromarray(img).save(root / "rgb" / f"{t:.6f}.png")
        dep = rng.integers(0, 5 * 5000, (CAM.height, CAM.width),
                           dtype=np.uint16)
        dep[0, :5] = 0
        Image.fromarray(dep).save(root / "depth" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep_lines.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        gt_lines.append(f"{t:.6f} {0.02 * i:.3f} 0.1 0 0.1 0 0 0.99")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return root


def _same_frames(got, want, fields):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("reader", ["libraries", "png_reader"])
def test_kitti_sequence_matches_jax(tmp_path, monkeypatch, reader):
    """Gray left images, RGB right images (to luma); against JAX's cv2
    route, or, for the PNG reader, JAX's PIL route, which the reader
    follows."""
    root = make_kitti_root(tmp_path)
    _block(monkeypatch, reader, "cv2")
    want = {s: list(jkitti.KittiSequence(str(root), stereo=s))
            for s in (False, True)}
    _block(monkeypatch, reader, "PIL")
    for stereo in (False, True):
        got = list(tkitti.KittiSequence(str(root), stereo=stereo))
        _same_frames(got, want[stereo], ("index", "stamp", "image", "depth",
                                         "pose", "right_image"))
    assert tkitti.bf_for_sequence(2) == jkitti.bf_for_sequence(2)
    assert tkitti.bf_for_sequence(4) == jkitti.bf_for_sequence(4)


@pytest.mark.parametrize("reader", ["libraries", "png_reader"])
def test_tum_sequence_matches_jax(tmp_path, monkeypatch, reader):
    root = make_tum_root(tmp_path)
    want = list(jtum.TumSequence(str(root)))
    _block(monkeypatch, reader, "cv2", "PIL")
    got = list(ttum.TumSequence(str(root)))
    _same_frames(got, want, ("stamp", "image", "depth", "pose"))
    assert ttum.associate([(0.0, "a")], [(1.0, "b")]) == []


def test_viz_outputs_byte_identical(tmp_path):
    ref = SurfelMapConfig(camera=CAM, surfel_capacity=256)
    cfg = tcfg.SurfelMapConfig.from_json(ref.to_json())
    poses = random_poses(4, 7)
    edges = [(0, 3), (1, 2), (0, 99)]
    for mod, c, name in ((jviz, ref.camera, "j"), (tviz, cfg.camera, "t")):
        mod.save_camera_markers(str(tmp_path / f"{name}.ply"), poses, c,
                                scale=0.5, loop_edges=edges)
        mod.save_camera_markers(str(tmp_path / f"{name}_none.ply"), [], c)
    for suffix in (".ply", "_none.ply"):
        assert (tmp_path / f"j{suffix}").read_bytes() \
            == (tmp_path / f"t{suffix}").read_bytes()
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 300, (cfg.padded_height, cfg.padded_width))
    asg = rng.integers(0, 5, img.shape).astype(np.int32)
    norms = rng.normal(size=img.shape + (3,)).astype(np.float32)
    depth = rng.uniform(-1, 40, (CAM.height, CAM.width)).astype(np.float32)
    for args in ((ref, img, asg), (ref, img, asg, norms)):
        a = jviz.render_segmentation(*args)
        b = tviz.render_segmentation(cfg, *args[1:])
        np.testing.assert_array_equal(a, b)
    dj, dt = jviz.depth_colormap(depth, 30.0), tviz.depth_colormap(depth,
                                                                   30.0)
    np.testing.assert_array_equal(dj, dt)
    jviz.save_png(str(tmp_path / "j.png"), dj)
    tviz.save_png(str(tmp_path / "t.png"), dt)
    assert (tmp_path / "j.png").read_bytes() \
        == (tmp_path / "t.png").read_bytes()
