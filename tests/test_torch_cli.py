"""The port's CLI (`python -m densesurfelmapping_tpu_torch`) against the JAX
package's on the same arguments, with `--device cpu` (the plain PyTorch
paths).  Each JAX CLI run feeds one test.

Tolerances: checkpoint graph arrays, trajectories, camera markers and the
segmentation render exact; bank floats within 1e-5 (m for positions);
cloud positions within 1e-5 m; mesh vertices within 1e-5 m plus the 6
significant digits of the ASCII PLY (rtol 1e-5); fidelity MAE within
1e-4 m and coverage within 1e-3; the map depth render at most 1% of pixels
apart.
The JAX package's stereo CLI is never run here (too slow on the CPU): the
port's `--stereo --sgm` runs alone."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from densesurfelmapping_tpu import cli as jcli
from densesurfelmapping_tpu.config import CameraIntrinsics, SurfelMapConfig
from densesurfelmapping_tpu.io.posefeed import PoseFeed, PoseMessage
from densesurfelmapping_tpu_torch import cli as tcli
from densesurfelmapping_tpu_torch.io import export as texport

from test_cli_replay import cam_json as cam_json_64, make_kitti_root

torch.set_num_threads(1)

CAM_120 = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                           cy=27.5)
OUTPUTS = (".pcd", "_mesh.ply", "_cameras.ply", ".ckpt.npz", "_traj.txt",
           "_mapdepth.png", "_seg.png")
GRAPH_KEYS = ("kf_cam", "kf_loop", "kf_stamp", "kf_edges", "local_indices",
              "frames_fused", "bank_count")


def cam_json_120(tmp_path):
    p = tmp_path / "cam120.json"
    p.write_text(SurfelMapConfig(camera=CAM_120,
                                 surfel_capacity=8192).to_json())
    return str(p)


def run_both(tmp_path, capsys, argv):
    """Run argv through both CLIs (the port on the CPU) with --out under
    tmp_path/jax and tmp_path/port; returns {who: (out prefix, stdout)}."""
    res = {}
    for who, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        (tmp_path / who).mkdir()
        out = str(tmp_path / who / "m")
        assert main(argv + ["--out", out] + extra) == 0, who
        res[who] = (out, capsys.readouterr().out)
    return res


def line_json(stdout, prefix):
    line = next(ln for ln in stdout.splitlines() if ln.startswith(prefix))
    return json.loads(line[len(prefix):])


def line(stdout, prefix):
    return next(ln for ln in stdout.splitlines() if ln.startswith(prefix))


def same_checkpoint(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k in GRAPH_KEYS or a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert int(a["bank_count"]) > 0


def same_fidelity(got, want):
    assert got.keys() == want.keys()
    assert abs(got["coverage"] - want["coverage"]) <= 1e-3
    if "mae" in want:
        assert abs(got["mae"] - want["mae"]) <= 1e-4


def read_pcd(path):
    raw = open(path, "rb").read()
    _, data = raw.split(b"DATA binary\n")
    return np.frombuffer(data, "<f4").reshape(-1, 4)


def test_cli_synthetic_matches_jax(tmp_path, capsys):
    res = run_both(tmp_path, capsys, [
        "synthetic", "--frames", "6", "--kf-every", "2", "--eval",
        "--camera-json", cam_json_120(tmp_path)])
    (jo, jout), (to, tout) = res["jax"], res["port"]
    assert sorted(os.listdir(tmp_path / "jax")) \
        == sorted(os.listdir(tmp_path / "port")) \
        == sorted("m" + s for s in OUTPUTS)
    for s in OUTPUTS:
        assert os.path.getsize(to + s) > 0, s
    assert line(tout, "frames fused:") == line(jout, "frames fused:")
    saved_j, saved_t = line(jout, "saved "), line(tout, "saved ")
    assert saved_t.replace(to, "") == saved_j.replace(jo, "")
    np.testing.assert_allclose(read_pcd(to + ".pcd"), read_pcd(jo + ".pcd"),
                               rtol=0, atol=1e-5)
    assert len(read_pcd(to + ".pcd")) > 0
    np.testing.assert_allclose(texport.load_ply_vertices(to + "_mesh.ply"),
                               texport.load_ply_vertices(jo + "_mesh.ply"),
                               rtol=1e-5, atol=1e-5)
    same_checkpoint(to + ".ckpt.npz", jo + ".ckpt.npz")
    for s in ("_traj.txt", "_cameras.ply", "_seg.png"):
        assert open(to + s, "rb").read() == open(jo + s, "rb").read(), s
    dj = np.asarray(Image.open(jo + "_mapdepth.png"))
    dt = np.asarray(Image.open(to + "_mapdepth.png"))
    assert dj.shape == dt.shape
    assert (dj != dt).any(-1).mean() <= 0.01
    same_fidelity(line_json(tout, "fidelity: "), line_json(jout, "fidelity: "))
    cj, ct = line_json(jout, "cloud: "), line_json(tout, "cloud: ")
    assert ct.keys() == cj.keys()


def test_cli_stress_matches_jax(tmp_path, capsys):
    res = run_both(tmp_path, capsys, [
        "stress", "--frames", "40", "--radius", "6", "--kf-every", "2",
        "--camera-json", cam_json_64(tmp_path)])
    (jo, jout), (to, tout) = res["jax"], res["port"]
    assert line(tout, "stress feed:") == line(jout, "stress feed:")
    for key in ("fidelity pre-correction: ", "fidelity post-correction:"):
        same_fidelity(line_json(tout, key), line_json(jout, key))
    assert "mae" in line_json(tout, "fidelity post-correction:")
    assert line(tout, "frames fused:") == line(jout, "frames fused:")
    same_checkpoint(to + ".ckpt.npz", jo + ".ckpt.npz")
    assert open(to + "_traj.txt").read() == open(jo + "_traj.txt").read()


def test_cli_kitti_matches_jax(tmp_path, capsys):
    root, _ = make_kitti_root(tmp_path)
    res = run_both(tmp_path, capsys, [
        "kitti", "--root", str(root), "--kf-every", "2",
        "--camera-json", cam_json_64(tmp_path)])
    same_checkpoint(res["port"][0] + ".ckpt.npz", res["jax"][0] + ".ckpt.npz")


def test_cli_replay_matches_jax(tmp_path, capsys):
    """A recorded feed with a loop edge and a pose-graph correction on the
    last message (tests/test_cli_replay.py's), over the KITTI frames."""
    root, poses = make_kitti_root(tmp_path, n=5)
    shift = np.eye(4)
    shift[1, 3] = 0.25
    msgs = [PoseMessage(
        stamp=i / 5.0, pose=p, is_keyframe=True, reference_index=i,
        loop_path=[shift @ q for q in poses] if i == 4 else None,
        loop_edges=[(4, 0)] if i == 4 else []) for i, p in enumerate(poses)]
    feed = str(tmp_path / "feed.npz")
    PoseFeed.save(feed, msgs)
    res = run_both(tmp_path, capsys, [
        "replay", "--feed", feed, "--root", str(root),
        "--camera-json", cam_json_64(tmp_path)])
    same_checkpoint(res["port"][0] + ".ckpt.npz", res["jax"][0] + ".ckpt.npz")
    z = np.load(res["port"][0] + ".ckpt.npz")
    assert {(4, 0), (0, 4)} & set(map(tuple, z["kf_edges"]))


def test_cli_tum_matches_jax(tmp_path, capsys):
    """A generated TUM directory (RGB, 16-bit depth, ground truth)."""
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(1)
    h, w = 48, 64
    lists = {"rgb": [], "depth": [], "gt": []}
    for i in range(4):
        t = 10.0 + i * 0.1
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            root / "rgb" / f"{t:.6f}.png")
        dep = np.full((h, w), int(1.5 * 5000), np.uint16)
        dep[:4, :4] = 0
        Image.fromarray(dep).save(root / "depth" / f"{t:.6f}.png")
        lists["rgb"].append(f"{t:.6f} rgb/{t:.6f}.png")
        lists["depth"].append(f"{t:.6f} depth/{t:.6f}.png")
        lists["gt"].append(f"{t:.6f} {0.02 * i:.3f} 0 0 0 0 0 1")
    for name, key in (("rgb.txt", "rgb"), ("depth.txt", "depth"),
                      ("groundtruth.txt", "gt")):
        (root / name).write_text("\n".join(lists[key]) + "\n")
    cam = tmp_path / "tum.json"
    cam.write_text(SurfelMapConfig(
        camera=CameraIntrinsics(width=w, height=h, fx=60.0, fy=60.0,
                                cx=31.5, cy=23.5),
        surfel_capacity=8192, fuse_near=0.1, fuse_far=5.0).to_json())
    res = run_both(tmp_path, capsys, ["tum", "--root", str(root),
                                      "--camera-json", str(cam)])
    same_checkpoint(res["port"][0] + ".ckpt.npz", res["jax"][0] + ".ckpt.npz")


def test_cli_stereo_sgm_port(tmp_path):
    """synthetic --stereo --sgm through the port alone: depth from the
    census SGM matcher, every output written."""
    out = str(tmp_path / "s")
    assert tcli.main(["synthetic", "--frames", "2", "--stereo", "--sgm",
                      "--max-disparity", "48", "--kf-every", "2", "--eval",
                      "--camera-json", cam_json_120(tmp_path), "--out", out,
                      "--device", "cpu"]) == 0
    for s in OUTPUTS:
        assert os.path.getsize(out + s) > 0, s
    assert int(np.load(out + ".ckpt.npz")["bank_count"]) > 0


def test_cli_device_cuda_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["synthetic", "--frames", "1",
                   "--camera-json", cam_json_120(tmp_path)])


REQUIRED = {"synthetic": [], "stress": [], "kitti": ["--root", "r"],
            "tum": ["--root", "r"], "replay": ["--feed", "f"], "multi": [],
            "serve": [], "publish": [], "diagnose": []}


@pytest.mark.parametrize("cmd", sorted(REQUIRED))
def test_cli_flags_match_jax(monkeypatch, cmd):
    """Every flag of the subcommand parses to the JAX CLI's default; the
    port adds --device (default cuda)."""
    got = {}
    for who, mod in (("jax", jcli), ("port", tcli)):
        monkeypatch.setattr(
            mod, f"cmd_{cmd}",
            lambda args, who=who: got.update({who: vars(args)}))
        assert mod.main([cmd] + REQUIRED[cmd]) == 0
    want = {k: v for k, v in got["jax"].items() if k != "fn"}
    port = {k: v for k, v in got["port"].items() if k != "fn"}
    if cmd != "publish":      # the client owns no map and no device
        assert port.pop("device") == "cuda"
    assert port == want


def test_cli_diagnose_runs_on_cpu(monkeypatch, capsys):
    """`diagnose --device cpu` prints one JSON line with the JAX package's
    keys (the fuse probe on the 120 x 56 camera)."""
    from densesurfelmapping_tpu_torch import config as tcfg
    from densesurfelmapping_tpu_torch.utils import diagnostics
    cfg = tcfg.SurfelMapConfig.from_json(SurfelMapConfig(
        camera=CAM_120, surfel_capacity=8192).to_json())
    monkeypatch.setattr(diagnostics, "default_config", lambda: cfg)
    assert tcli.main(["diagnose", "--device", "cpu",
                      "--fuse-frames", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == {"backend", "dispatch_ms", "h2d_mbps", "fuse_ms",
                        "block_lies", "healthy"}
    assert got["backend"] == "cpu" and got["block_lies"] is False


def test_cli_diagnose_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tcli.main(["diagnose"])


@pytest.mark.parametrize("flags", [
    {}, dict(sgm=True, no_post_median=True, occlusion_fill=True, hier=True,
             max_disparity=64), dict(sgm=True, prior_rescue=True)])
def test_stereo_config_matches_jax(flags):
    from argparse import Namespace
    assert tcli._stereo_config(Namespace(**flags))._asdict() \
        == jcli._stereo_config(Namespace(**flags))._asdict()


def test_cli_trace_writes_chrome_trace(tmp_path):
    """--trace wraps the run in torch.profiler and writes a Chrome trace
    whose events include the driver's `dsm.*` stage annotations around the
    fuse step (the step's own phases annotate and stamp on a card only:
    `timing.phase` does nothing on the CPU)."""
    trace = tmp_path / "trace"
    assert tcli.main(["synthetic", "--frames", "2", "--trace", str(trace),
                      "--camera-json", cam_json_120(tmp_path),
                      "--device", "cpu"]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dsm.migrate", "dsm.pack", "dsm.stage", "dsm.launch",
            "dsm.fuse"} <= names


def test_cli_multi_on_the_cpu(tmp_path, capsys):
    """multi --device cpu on the 120 x 56 camera: per-session clouds and
    checkpoints, each session fusing every round; against the JAX CLI's
    multi on the same arguments, the same surfel count per session and
    positions within 1e-5 m."""
    argv = ["multi", "--streams", "2", "--frames", "3", "--kf-every", "2",
            "--camera-json", cam_json_120(tmp_path)]
    res = run_both(tmp_path, capsys, argv)
    for k in range(2):
        p, j = (np.load(f"{res[w][0]}_s{k}.ckpt.npz") for w in ("port",
                                                                 "jax"))
        assert int(p["frames_fused"]) == int(j["frames_fused"]) == 3
        assert int(p["bank_count"]) == int(j["bank_count"]) > 0
        np.testing.assert_allclose(np.sort(p["bank_position"], axis=0),
                                   np.sort(j["bank_position"], axis=0),
                                   atol=1e-5)
        assert os.path.getsize(f"{res['port'][0]}_s{k}.pcd") > 0
    assert "frames/s aggregate" in res["port"][1]
