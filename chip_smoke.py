"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):
  1. device  - a CUDA card is required; its name and power limit are printed
  2. build   - the SLIC kernels (densesurfelmapping_tpu_torch/csrc/slic.cu)
               are built with nvcc and loaded
  3. kernels - each kernel against its plain PyTorch twin on a KITTI-size
               frame of the synthetic scene, with the time per launch of both
  4. drive   - DeviceResidentMapping over 60 KITTI-size frames, steady state
               under torch.cuda.set_sync_debug_mode("error"): launch counts,
               no NaN, the ground-plane gate, compaction, the loop warp
  5. rate    - frames/s of the drive, unpipelined and pipelined
The last line is the JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

GROUND_GATE_M = 5e-3     # mean |y - ground| of stable ground surfels
WARP_TOL_M = 1e-4
N_FRAMES = 60


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi:")
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    from densesurfelmapping_tpu_torch.ops.cuda import build, slic
    t0 = time.perf_counter()
    slic._lib()
    say("build", f"slic.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("slic", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())


def scene_frame(config, pose, device):
    from densesurfelmapping_tpu_torch.core.state import compact_frame
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.pipeline.fuse_step import ingest_frame
    img, dep = synthetic.default_scene().render(config, pose)
    ci, cd = compact_frame(config, img, dep)     # the main path's encoding
    return ingest_frame(config, torch.from_numpy(ci).to(device),
                        torch.from_numpy(cd).to(device))


def phase_kernels(config, device) -> dict:
    """Each kernel against its plain twin on the same inputs; returns the
    per-kernel record (max error, kernel and plain ms)."""
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K

    image, depth = scene_frame(config, np.eye(4), device)
    inv_depth = torch.where(depth > 0.01, 1.0 / depth.clamp_min(1e-20), 0.0)
    seeds = S.initialize_seeds(config, image, depth)
    g = S.device_geometry(config, image.device)
    asg0 = torch.where(g["pixel_valid"], 0, -1).to(torch.int32)
    out = {}

    # B1: one sweep from the initial state: assignment and claims exact
    args = (config, image, inv_depth, asg0, seeds.x, seeds.y,
            seeds.mean_intensity, seeds.mean_depth, seeds.stable)
    ka, kc = K.slic_assign(*args)
    pa, pc = S.assign_sweep(*args)
    n_asg = int((ka != pa).sum())
    n_claim = int((kc != pc).sum())
    require(n_asg == 0 and n_claim == 0,
            f"slic_assign: {n_asg} assignments, {n_claim} claims differ")
    out["slic_assign"] = dict(
        max_abs_err=float((ka - pa).abs().max()),
        ms=cuda_time_ms(lambda: K.slic_assign(*args)),
        plain_ms=cuda_time_ms(lambda: S.assign_sweep(*args)))
    say("kernels", f"slic_assign: assignment and claims exact "
        f"({ka.numel()} px, {kc.numel()} seeds)")

    # B2: sums over the sweep's assignment
    sargs = (config, image, depth, ka)
    ks, ps = K.slic_centroid(*sargs), S.seed_sums(*sargs)
    err = max(float((a - b).abs().max()) for a, b in zip(ks, ps))
    for a, b in zip(ks, ps):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    out["slic_centroid"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: K.slic_centroid(*sargs)),
        plain_ms=cuda_time_ms(lambda: S.seed_sums(*sargs)))
    say("kernels", f"slic_centroid: six sums within rtol 1e-5 / atol 1e-3 "
        f"(max abs err {err:.3g})")

    # B3: the five Huber steps from the sums' mean
    n, nd, sum_d = ps[0], ps[4], ps[5]
    hargs = (config, depth, ka, sum_d / nd.clamp_min(1.0), nd <= 0)
    km, pm = K.slic_huber(*hargs), S.huber_mean_depth(*hargs)
    err = float((km - pm).abs().max())
    require(err <= 1e-4, f"slic_huber: mean depth off by {err} m")
    require(bool(torch.isfinite(km).all()), "slic_huber: non-finite mean")
    out["slic_huber"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: K.slic_huber(*hargs)),
        plain_ms=cuda_time_ms(lambda: S.huber_mean_depth(*hargs)))
    say("kernels", f"slic_huber: mean depth within 1e-4 m "
        f"(max abs err {err:.3g} m, {int((n > 0).sum())} seeds with pixels)")

    # whole SLIC: kernels against the plain path
    _, a_k = S.run_slic(config, image, depth, use_kernels=True)
    _, a_p = S.run_slic(config, image, depth, use_kernels=False)
    frac = float((a_k != a_p).float().mean())
    require(frac < 0.01, f"run_slic: {frac:.4%} of pixels differ")
    say("kernels", f"run_slic kernels vs plain: {frac:.4%} of pixels differ "
        f"(bound 1%)")
    for name, rec in out.items():
        say("kernels", f"{name}: {1e3 * rec['ms']:.1f} us/launch, plain "
            f"twin {1e3 * rec['plain_ms']:.1f} us")
    return out


def make_frames(config, n_frames: int):
    from densesurfelmapping_tpu_torch.io import synthetic
    scene = synthetic.default_scene()
    poses = synthetic.forward_trajectory(n_frames + 3, step=0.4)[:n_frames]
    return [scene.render(config, p) + (p,) for p in poses]


def drive(config, frames, device, pipelined: bool, sync_checked: bool):
    """Feed the frames through DeviceResidentMapping (keyframe every 2nd
    frame); returns (driver, frames/s to a device synchronize)."""
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    drv = DeviceResidentMapping(config, device=device, pipelined=pipelined)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_checked:
        # any host-device synchronisation in the steady feed raises
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i, (img, dep, pose) in enumerate(frames):
            drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
            drv.feed_image(float(i), img)
            drv.feed_depth(float(i), dep)
        drv.flush()
    finally:
        if sync_checked:
            torch.cuda.set_sync_debug_mode(0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    fps = len(frames) / (time.perf_counter() - t0)
    drv.close()
    return drv, fps


def check_map(rows: dict, drv, ground_y: float) -> dict:
    """No NaN; stable ground surfels on the true plane; compaction ran."""
    live = rows["update_times"] > 0
    require(live.sum() > 0, "the map is empty")
    for k in ("position", "normal", "size", "weight"):
        require(bool(np.isfinite(rows[k]).all()), f"NaN/Inf in bank.{k}")
    ground = (rows["update_times"] >= 5) & (np.abs(rows["normal"][:, 1]) > 0.9)
    require(ground.sum() > 0, "no stable ground surfels")
    err = float(np.abs(rows["position"][ground, 1] - ground_y).mean())
    require(err < GROUND_GATE_M,
            f"ground-plane error {err} m >= {GROUND_GATE_M} m")
    require(drv.compactions > 0, "compaction never ran")
    return dict(live=int(live.sum()), ground=int(ground.sum()),
                ground_err_m=err, compactions=drv.compactions)


def check_warp(drv) -> float:
    """A loop_path shifting every keyframe by one translation must move
    every live surfel by exactly that translation."""
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    before = bank_to_numpy(drv.bank)
    shift = np.eye(4)
    shift[:3, 3] = (0.25, -0.5, 1.0)
    loop_path = [shift @ kf.cam_pose for kf in drv.graph.keyframes]
    drv.feed_pose(1e6, shift @ drv.graph.keyframes[-1].cam_pose,
                  loop_path=loop_path)
    after = bank_to_numpy(drv.bank)
    live = before["update_times"] > 0
    moved = after["position"][live] - before["position"][live]
    err = float(np.abs(moved - shift[:3, 3]).max())
    require(err < WARP_TOL_M, f"loop warp off by {err} m")
    return err


def main() -> None:
    smi = phase_device()
    device = torch.device("cuda")
    phase_build()

    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K

    records = phase_kernels(kitti_config(), device)

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    t0 = time.perf_counter()
    frames = make_frames(cfg, N_FRAMES)
    say("drive", f"rendered {len(frames)} frames {cfg.height}x{cfg.width} "
        f"in {time.perf_counter() - t0:.1f} s")
    drive(cfg, frames[:4], device, pipelined=False, sync_checked=False)

    K.reset_launch_counts()
    drv, fps = drive(cfg, frames, device, pipelined=False, sync_checked=True)
    launches = dict(K.LAUNCHES)
    say("drive", f"kernel launches in the drive: {launches}")
    require(all(v > 0 for v in launches.values()),
            "a SLIC kernel was not launched on the main path")
    rows_a = bank_to_numpy(drv.bank)
    stats = check_map(rows_a, drv, synthetic.default_scene().ground_y)
    say("drive", f"map: {stats['live']} live surfels, {stats['ground']} "
        f"stable ground surfels, mean |y - ground| "
        f"{stats['ground_err_m']:.3e} m (bound {GROUND_GATE_M}), "
        f"{stats['compactions']} compactions; steady feed raised no "
        f"host-device sync")
    say("drive", f"loop warp: every live surfel moved by the shift within "
        f"{check_warp(drv):.2e} m (bound {WARP_TOL_M})")

    drv_p, fps_p = drive(cfg, frames, device, pipelined=True,
                         sync_checked=False)
    rows_p = bank_to_numpy(drv_p.bank)
    require(len(rows_p["color"]) == len(rows_a["color"]),
            "pipelined drive: bank count differs")
    for k, v in rows_a.items():
        require(bool(np.allclose(rows_p[k], v, atol=1e-5)),
                f"pipelined drive: bank.{k} differs")
    say("rate", f"{N_FRAMES} frames: {fps:.2f} frames/s unpipelined, "
        f"{fps_p:.2f} frames/s pipelined, same map ({smi})")

    kernels = []
    for name, line in (("slic_assign", 241), ("slic_centroid", 330),
                       ("slic_huber", 397)):
        rec = records[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="densesurfelmapping_tpu_torch/csrc/slic.cu",
            replaces=f"densesurfelmapping_tpu/ops/pallas/slic.py:{line}",
            launches=launches[name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
