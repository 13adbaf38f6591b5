"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --only multi-kernels,multi   (a partial run: the
        build and the named phases, no result line)

Phases (each prints a line; any failure raises and exits non-zero):
  1. device  - a CUDA card is required; its name and power limit are printed
  2. build   - the SLIC and SGM kernels (densesurfelmapping_tpu_torch/csrc/
               slic.cu, sgm.cu) are built with nvcc, in parallel, and loaded
  3. kernels - each SLIC kernel against its plain PyTorch twin on the inputs
               of every run_slic sweep over a KITTI-size frame of the
               synthetic scene and over a 120 x 56 frame at sp 6 and 16,
               then its time per launch at KITTI and B1's device
               operations per call
  4. sgm     - each SGM kernel against its plain twin on a KITTI-size stereo
               pair, 8 and 4 paths, on a 61 x 97 crop with 37 disparities
               from 3, and on a 24 x 1800 strip (bitwise, f32 and bf16
               carries); B4 also on the pair's volume with D = 128 from 0
               and on the crop with D = 150 (its line-kernel route); the
               whole disparity map with and without the kernels, B5's
               occupancy (its launch is cooperative), and the time per
               launch of kernel and twin (B4's two families apart)
  5. drive   - depth-fed DeviceResidentMapping over 60 KITTI-size frames,
               steady state under torch.cuda.set_sync_debug_mode("error"):
               launch counts, no NaN, the ground-plane gate, compaction, the
               loop warp
  6. rate    - frames/s of the depth-fed drive, unpipelined and pipelined
  7. stereo  - stereo-resident DeviceResidentMapping (the CLI's synthetic
               --stereo --sgm flow) over 30 KITTI-size pairs under the sync
               check: B5/B6 once per frame, no NaN, compaction, the depth
               check against the rendered depth, the peak device memory; the
               fused-census, plain and materialized-volume (B4) matchers build
               the same map, and the materialized drive's peak memory
  8. multi-kernels - B1-B3 with the stream axis: over every run_slic sweep
               of 4 distinct KITTI frames (and 3 frames of 120 x 56 at sp 6
               and 16) one launch for all streams, each stream equal to the
               single-frame kernel (torch.equal) and to the plain twin;
               device us per launch at B = 1 and B = 4
  9. multi   - MultiSessionMapping, 4 streams at the CLI's width (capacity
               2^21) over 24 rounds under the sync check: each SLIC kernel
               3x per round (not x B), no NaN, compaction, each session equal
               to a solo DeviceResidentMapping (1e-5 m), a loop warp of
               session 0 moving it alone, pipelined == eager; aggregate
               frames/s at B = 1, 2, 4, device ms, ops and idle share per
               round, peak device memory
 10. multi-stereo - 2 stereo streams x 8 rounds (--sgm): B5/B6 once per
               stream and round, maps equal to solo stereo drives (1e-4 m)
 11. cli     - the port's CLI in this process (cli.main, --device cuda) on
               KITTI-size frames: the native library is required; the
               host pack timed native vs numpy; synthetic --loop --eval
               (the seven outputs, MAE < 0.3 m, 3 SLIC launches of each
               kernel per frame + 3 for the segmentation render),
               synthetic --stereo --sgm --eval (MAE < 0.5 m, B5/B6 once per
               frame), stress --frames 120 --radius 15 (post-correction MAE
               below pre-correction), kitti and replay over a generated
               KITTI-layout directory read by io/png.py with cv2 and PIL
               unimportable (banks equal to a directly fed
               DeviceResidentMapping within 1e-5 m); multi --streams 4
               --frames 20 and multi --streams 2 --frames 8 --stereo --sgm
               (per-session outputs, launches per round), serve in a
               subprocess fed by publish --save --shutdown over a unix
               socket (a non-empty mesh), and an in-process MappingServer
               over a CUDA DeviceResidentMapping equal to a direct feed
               (1e-5 m); writes under build/cli/
 12. profile - device ms/frame of the stereo drive by fuse-step scope and
               of the SGM and SLIC kernels
A kernel's time is its device time from the profiler's records of that
kernel (`kernel_time`), printed beside the wrapper's host time per call; a
plain twin's is CUDA events around its calls.  The last lines are the
{"kernels": [...]} JSON, the nvidia-smi line, and the JSON object
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

GROUND_GATE_M = 5e-3     # mean |y - ground| of stable ground surfels
WARP_TOL_M = 1e-4
N_FRAMES = 60
N_STEREO_FRAMES = 30
BASELINE_M = 0.54        # KITTI stereo baseline (the CLI's --baseline)
# Depth check of one stereo frame against the rendered depth (1-25 m).  The
# JAX package's compute_depth_stereo on the same frame at a quarter of KITTI
# size on the CPU reads coverage 0.6042 and median relative error 0.02357
# (tests/test_torch_stereo_fuse.py::test_depth_check_bounds_from_jax): the
# error bound is 1.5x that value (no looser than 5%), the coverage floor
# that value / 1.5.
DEPTH_REL_ERR_BOUND = 0.03535
DEPTH_COVERAGE_FLOOR = 0.4028
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor op/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() in ms, by CUDA events around `reps` calls (the
    plain twins: many small ops, where the host may set the pace)."""
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


def kernel_time(fn, names, reps: int = 20, warmup: int = 3,
                drop: int = 2) -> dict:
    """Device time of the kernels that one call of fn() launches, from the
    profiler's kernel records whose name contains one of `names` (a call's
    time is the sum of its records, one per name), over `reps` calls after
    `warmup`.  The profiler may drop a record at the edge of its window (one
    of 20 or of 100 on the H100), so up to `drop` calls may go uncounted;
    now and then it drops more (11 of 100 once; 4 of 20 in three windows
    in a row once), and such a window is measured again, up to three
    windows in all.

    Returns per_us (each counted call's device us), us / us_min / us_max,
    all_us (device us per call of every operation fn() ran: fills, copies
    and memsets beside the kernel), ops (device operations per call, the
    kernels included) and host_us (host us per call, measured apart: the
    wrapper's checks, allocations and launch, no synchronize).
    Events around the wrapper would time the host's enqueue rate whenever
    the kernel is shorter than the wrapper's host work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        recs = [sorted((e for e in dev if n in e.name),
                       key=lambda e: e.time_range.start) for n in names]
        calls = min(len(r) for r in recs)
        if reps - drop <= calls and max(len(r) for r in recs) <= reps:
            break
    require(reps - drop <= calls and max(len(r) for r in recs) <= reps,
            f"profiler: {[len(r) for r in recs]} records of {names} for "
            f"{reps} calls, in three windows")
    per = [sum(r[i].time_range.elapsed_us() for r in recs)
           for i in range(calls)]
    other = sum(e.time_range.elapsed_us() for e in dev
                if not any(n in e.name for n in names))
    us = sum(per) / calls
    return dict(per_us=per, us=us, us_min=min(per), us_max=max(per),
                host_us=host_us, all_us=us + other / reps,
                ops=len(dev) / reps)


def timed(rec: dict, t: dict, plain_ms: float) -> dict:
    """`rec` with the kernel's device time as `ms` and its timing record."""
    return dict(rec, ms=t["us"] / 1e3, plain_ms=plain_ms, time=t)


def time_line(name: str, rec: dict) -> str:
    t = rec["time"]
    return (f"{name}: device {t['us']:.2f} us/launch (min {t['us_min']:.2f}, "
            f"max {t['us_max']:.2f}; profiler kernel records, "
            f"{len(t['per_us'])} launches), all {t['ops']:.2f} device ops "
            f"of a call {t['all_us']:.2f} us, wrapper host "
            f"{t['host_us']:.1f} us/call; "
            f"plain twin {1e3 * rec['plain_ms']:.1f} us (CUDA events); bound "
            f"{1e3 * rec['bound_ms']:.2f} us ({rec['bound_by']})")


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


def bound(nbytes: float, ops: float) -> dict:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the f32 peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def phase_build() -> None:
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from densesurfelmapping_tpu_torch.ops.cuda import build, sgm, slic

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {name: pool.submit(timed, mod._lib)
                for name, mod in (("slic", slic), ("sgm", sgm))}
        secs = {name: f.result() for name, f in futs.items()}
    for name in ("slic", "sgm"):
        say("build", f"{name}.cu built and loaded in {secs[name]:.1f} s")
        for line in build.build_logs.get(name, "").splitlines():
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


def slic_config(sp: int):
    """The 120 x 56 frame of tests/test_pallas_slic.py at seed pitch sp."""
    from densesurfelmapping_tpu_torch.config import (
        DRIVE_PROFILE, CameraIntrinsics, SurfelMapConfig)
    cam = CameraIntrinsics(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                           cy=27.5)
    return SurfelMapConfig(camera=cam, profile=DRIVE_PROFILE,
                           surfel_capacity=4096, sp_size=sp)


def slic_inputs(config, device):
    """The synthetic scene's frame at the identity pose, its inverse depth,
    the initial seeds and the initial assignment (run_slic's start)."""
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    image, depth = scene_frame(config, np.eye(4), device)
    inv_depth = torch.where(depth > 0.01, 1.0 / depth.clamp_min(1e-20), 0.0)
    seeds = S.initialize_seeds(config, image, depth)
    g = S.device_geometry(config, image.device)
    asg = torch.where(g["pixel_valid"], 0, -1).to(torch.int32)
    return image, depth, inv_depth, seeds, asg


def slic_diffs(config, device) -> dict:
    """Each SLIC kernel against its plain twin on the inputs of every sweep
    of the plain run_slic over `slic_inputs`: B1's assignments and claims
    that differ (summed over the sweeps) and its largest seed-id difference,
    B2's largest error and whether it holds rtol 1e-5 / atol 1e-3, B3's
    largest error and whether its means are finite; then the share of
    pixels where the whole run_slic with the kernels differs from the plain
    one."""
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K
    image, depth, inv_depth, seeds, asg = slic_inputs(config, device)
    d = dict(assign_px=0, claims=0, assign_err=0, sums_err=0.0,
             sums_close=True, huber_err=0.0, huber_finite=True)
    for _ in range(config.sp_iters):
        args = (config, image, inv_depth, asg, seeds.x, seeds.y,
                seeds.mean_intensity, seeds.mean_depth, seeds.stable)
        (ka, kc), (pa, pc) = K.slic_assign(*args), S.assign_sweep(*args)
        d["assign_px"] += int((ka != pa).sum())
        d["claims"] += int((kc != pc).sum())
        d["assign_err"] = max(d["assign_err"], int((ka - pa).abs().max()))
        sargs = (config, image, depth, pa)
        ks, ps = K.slic_centroid(*sargs), S.seed_sums(*sargs)
        for a, b in zip(ks, ps):
            d["sums_err"] = max(d["sums_err"], float((a - b).abs().max()))
            d["sums_close"] &= bool(torch.allclose(a, b, rtol=1e-5,
                                                   atol=1e-3))
        hargs = (config, depth, pa, ps[5] / ps[4].clamp_min(1.0), ps[4] <= 0)
        km = K.slic_huber(*hargs)
        d["huber_err"] = max(d["huber_err"], float(
            (km - S.huber_mean_depth(*hargs)).abs().max()))
        d["huber_finite"] &= bool(torch.isfinite(km).all())
        # on along the plain path
        asg = pa
        seeds = S.update_seeds(config, seeds.replace(
            stable=seeds.stable & ~pc), asg, image, depth)
    _, a_k = S.run_slic(config, image, depth, use_kernels=True)
    _, a_p = S.run_slic(config, image, depth, use_kernels=False)
    d["run_slic_frac"] = float((a_k != a_p).float().mean())
    return d


def check_slic(config, device) -> dict:
    """slic_diffs within the bounds: B1 exact, B2 rtol 1e-5 / atol 1e-3, B3
    1e-4 m, run_slic under 1% of pixels."""
    d = slic_diffs(config, device)
    tag = (f"{config.height} x {config.width}, sp {config.sp_size}, "
           f"{config.sp_iters} sweeps")
    require(d["assign_px"] == 0 and d["claims"] == 0,
            f"slic_assign ({tag}): {d['assign_px']} assignments, "
            f"{d['claims']} claims differ")
    require(d["sums_close"], f"slic_centroid ({tag}): sums off by "
            f"{d['sums_err']}")
    require(d["huber_err"] <= 1e-4 and d["huber_finite"],
            f"slic_huber ({tag}): mean depth off by {d['huber_err']} m")
    require(d["run_slic_frac"] < 0.01, f"run_slic ({tag}): "
            f"{d['run_slic_frac']:.4%} of pixels differ")
    say("kernels", f"{tag}: slic_assign assignment and claims exact, "
        f"slic_centroid within rtol 1e-5 / atol 1e-3 (max abs err "
        f"{d['sums_err']:.3g}), slic_huber within 1e-4 m (max abs err "
        f"{d['huber_err']:.3g} m); run_slic kernels vs plain "
        f"{d['run_slic_frac']:.4%} of pixels differ (bound 1%)")
    return d


def phase_kernels(config, device) -> dict:
    """Each SLIC kernel against its plain twin over run_slic's sweeps, then
    its device time on the first sweep's inputs; returns the per-kernel
    record (max error, device and plain ms, bound)."""
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K

    d = check_slic(config, device)
    # sp 6: (sp/2)^2 = 9 has no exact reciprocal; sp 16: the wrappers' top
    for sp in (6, 16):
        check_slic(slic_config(sp), device)
    image, depth, inv_depth, seeds, asg0 = slic_inputs(config, device)
    g = S.device_geometry(config, device)
    hw, n_seeds = image.numel(), seeds.x.numel()
    out = {}
    # B1: one sweep from the initial state
    args = (config, image, inv_depth, asg0, seeds.x, seeds.y,
            seeds.mean_intensity, seeds.mean_depth, seeds.stable)
    # the candidates the gate admits (at most 2 x 2 of the 3 x 3)
    n_cand = sum(int(m.sum()) for m in g["in_range"].values())
    # reads image, inverse depth, assignment, four seed planes and the
    # stable flags; writes the assignment and the bool claims; ~20 f32
    # operations per admitted candidate
    ba = (4 * hw * 4 + n_seeds * (4 * 4 + 1 + 1), n_cand * 20)
    out["slic_assign"] = timed(dict(
        max_abs_err=float(d["assign_err"]), bound_args=ba, **bound(*ba)),
        kernel_time(lambda: K.slic_assign(*args), ("slic_assign_kernel",)),
        cuda_time_ms(lambda: S.assign_sweep(*args)))
    # B2: sums over the sweep's assignment
    asg1, _ = S.assign_sweep(*args)
    sargs = (config, image, depth, asg1)
    # reads image, depth, assignment; writes six seed planes; six adds per
    # pixel
    ba = (3 * hw * 4 + 6 * n_seeds * 4, 6 * hw)
    out["slic_centroid"] = timed(dict(
        max_abs_err=d["sums_err"], bound_args=ba, **bound(*ba)),
        kernel_time(lambda: K.slic_centroid(*sargs),
                    ("slic_centroid_kernel",)),
        cuda_time_ms(lambda: S.seed_sums(*sargs)))
    # B3: the five Huber steps from the sums' mean
    _, _, _, _, nd, sum_d = S.seed_sums(*sargs)
    hargs = (config, depth, asg1, sum_d / nd.clamp_min(1.0), nd <= 0)
    # reads depth, assignment, the mean and the latch; writes the mean;
    # five steps of ~8 operations per pixel
    ba = (2 * hw * 4 + n_seeds * (4 + 1 + 4), 5 * 8 * hw)
    out["slic_huber"] = timed(dict(
        max_abs_err=d["huber_err"], bound_args=ba, **bound(*ba)),
        kernel_time(lambda: K.slic_huber(*hargs), ("slic_huber_kernel",)),
        cuda_time_ms(lambda: S.huber_mean_depth(*hargs)))
    for name, rec in out.items():
        say("kernels", time_line(name, rec))
    # B1 zeroes its bool claims with a memset and writes them itself: two
    # device operations per call (a fill, the kernel and a compare before)
    ops = out["slic_assign"]["time"]["ops"]
    require(ops <= 2.0, f"slic_assign: {ops} device operations per call > 2")
    return out


def stereo_pair(config, pose):
    """Left/right u8 renders of the synthetic scene (the right camera
    BASELINE_M along the camera x axis, as the CLI's --stereo) and the
    left view's rendered depth."""
    from densesurfelmapping_tpu_torch.io import synthetic
    scene = synthetic.default_scene()
    rp = np.array(pose, np.float64).copy()
    rp[:3, 3] += rp[:3, 0] * BASELINE_M
    li, ld = scene.render(config, pose)
    ri, _ = scene.render(config, rp)
    u8 = lambda x: np.clip(x, 0, 255).astype(np.uint8)   # noqa: E731
    return u8(li), u8(ri), ld


def sgm_config():
    """The CLI's `--sgm` matcher: census cost, 8 paths, fused census."""
    from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
    return StereoConfig(max_disparity=128, aggregation="sgm")


def phase_sgm_kernels(device) -> dict:
    """B4-B6 against their plain twins on a KITTI-size pair; returns the
    per-kernel record."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops import sgm as P
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K

    cfg = kitti_config()
    scfg = sgm_config()
    li, ri, _ = stereo_pair(cfg, synthetic.forward_trajectory(
        N_STEREO_FRAMES + 3, step=0.4)[0])
    left = torch.from_numpy(li).to(device).float()
    right = torch.from_numpy(ri).to(device).float()
    cl, cr = S._census(left, scfg.census_radius), S._census(
        right, scfg.census_radius)
    min_d = scfg.min_disparity
    n_d = scfg.max_disparity - min_d
    p1, p2 = scfg.sgm_p1, scfg.sgm_p2
    rolls = (0, 1, -1)
    h, w = cl.shape
    cells = n_d * h * w
    out = {}

    def same(name, a, b):
        require(a.shape == b.shape and bool(torch.equal(a, b)),
                f"{name}: kernel differs from its plain twin (max abs err "
                f"{float((a - b).abs().max())})")

    def census_checks(tag, cl, cr, min_d, n_d, v_rolls):
        """B6, B5 and their sum against the twins, f32 and bf16 carries:
        bitwise."""
        for bf16 in (True, False):
            kx = K.census_x(cl, cr, p1, p2, min_d, n_d, bf16)
            px = P.census_x_family(cl, cr, p1, p2, min_d, n_d, bf16)
            same(f"sgm_census_x {tag} bf16={bf16}", kx, px)
            ky = K.census_y(cl, cr, torch.zeros_like(kx), v_rolls, p1, p2,
                            min_d, bf16)
            py = P.census_y_family(cl, cr, v_rolls, p1, p2, min_d, n_d, bf16)
            same(f"sgm_census_y {tag} bf16={bf16}", ky, py)
            same(f"census_aggregate {tag} bf16={bf16}",
                 K.census_aggregate(cl, cr, v_rolls, p1, p2, min_d, n_d,
                                    bf16), px + py)
        say("sgm", f"census_aggregate (B6 + B5) equals its plain twin bitwise "
            f"on {tag}: f32 ({n_d}, {cl.shape[0]}, {cl.shape[1]}), min_d "
            f"{min_d}, {2 + 2 * len(v_rolls)} paths, f32 and bf16 carries")

    # B6, B5 and their sum on the KITTI pair (8 and 4 paths) and on a crop
    # whose sides are not multiples of 16 or 32 (bands of 7 columns, lanes
    # and bands with padding), with another disparity range
    census_checks("the KITTI pair", cl, cr, min_d, n_d, rolls)
    census_checks("the KITTI pair", cl, cr, min_d, n_d, (0,))
    crop = (slice(150, 211), slice(300, 397))          # 61 x 97
    ccl, ccr = cl[crop].contiguous(), cr[crop].contiguous()
    for v_rolls in (rolls, (0,)):
        census_checks("a 61 x 97 crop", ccl, ccr, 3, 37, v_rolls)
    # wider than KITTI: B5's bands hold 28 columns, two per warp (its
    # general column loop; one column per warp everywhere above)
    wcl, wcr = (torch.cat([c[150:174], c[150:174, :559]], 1).contiguous()
                for c in (cl, cr))
    require(K.census_y_plan(*wcl.shape, 37, 3, K._sms(device)).cpw > 1,
            "the wide strip does not give B5 two columns per warp")
    for v_rolls in (rolls, (0,)):
        census_checks("a 24 x 1800 strip", wcl, wcr, 3, 37, v_rolls)
    # B5 runs the matcher's roll sets only; a one-way diagonal set raises
    try:
        K.census_y(ccl, ccr, torch.zeros((37, *ccl.shape), device=device),
                   (0, 1), p1, p2, 3)
    except ValueError:
        pass
    else:
        raise AssertionError("sgm_census_y took the roll set (0, 1)")
    for g in (3, 1):
        blocks, per_sm, sms = K.census_y_occupancy(h, w, n_d, g)
        plan = K.census_y_plan(h, w, n_d, g, sms)
        say("sgm", f"sgm_census_y {2 + 2 * g} paths: {blocks} blocks of "
            f"{plan.threads} threads, {plan.ncols} columns and {plan.smem} B "
            f"shared memory each; {per_sm} fit an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor) x {sms} SMs")
        require(blocks <= per_sm * sms, "sgm_census_y: the cooperative "
                "launch cannot hold every band at once")

    # B4 on materialized census volumes, both families (the y family with
    # 8 and 4 paths), both carries: the KITTI pair's volume (n_d 127 from
    # 1), the same pair with D = 128 from 0 (the census config that takes
    # the materialized branch), the 61 x 97 crop (n_d 37 from 3), and the
    # crop with D = 150 (128 < D: the line kernel and its combine pass)
    def axis_checks(tag, vol, min_d):
        vx = vol.permute(2, 1, 0).contiguous()     # scan over x
        vy = vol.permute(1, 2, 0).contiguous()     # scan over y
        route = K.axis_plan(*vx.shape, (0,), K._sms(device)).route
        for bf16 in (False, True):
            for v, r, entry in ((vx, (0,), "x"), (vy, rolls, "y"),
                                (vy, (0,), "y")):
                same(f"sgm_axis_scan {tag} {entry} rolls {r} bf16={bf16}",
                     K.axis_scan(v, r, p1, p2, bf16, entry, min_d),
                     P.axis_scan(v, r, p1, p2, bf16, entry, min_d))
        say("sgm", f"sgm_axis_scan (B4, {route} route) equals its plain twin "
            f"bitwise on {tag}: D {vol.shape[0]} from {min_d}, x family and "
            f"y family of 8 and 4 paths, f32 and bf16 carries")
        return vx, vy

    vx, vy = axis_checks("the KITTI census volume",
                         S._census_volume(cl, cr, min_d, n_d), min_d)
    scans = ((vx, (0,), "x"), (vy, rolls, "y"))
    axis_checks("the KITTI census volume, D = 128",
                S._census_volume(cl, cr, 0, 128), 0)
    axis_checks("a 61 x 97 crop", S._census_volume(ccl, ccr, 3, 37), 3)
    require(K.axis_plan(97, 61, 150, rolls).route == "lines",
            "D = 150 does not take the line kernel")
    axis_checks("a 61 x 97 crop, D = 150", S._census_volume(ccl, ccr, 3, 150),
                3)
    # D <= 128 takes the matcher's roll sets only; a one-way set raises
    try:
        K.axis_scan(vy, (0, 1), p1, p2, False, "y", min_d)
    except ValueError:
        pass
    else:
        raise AssertionError("sgm_axis_scan took the roll set (0, 1)")

    # B4 on a SAD volume: bitwise against the twin of its own update
    # grouping cost + (cand - Lmin); against the scan path's grouping
    # (cost + cand) - Lmin each orientation may move by one bf16 step
    sad = S._cost_volume(left, right, scfg._replace(cost="sad"))
    sad_err = 0.0
    for v, r, entry in ((sad.permute(2, 1, 0).contiguous(), (0,), "x"),
                        (sad.permute(1, 2, 0).contiguous(), rolls, "y")):
        k = K.axis_scan(v, r, p1, p2, False, entry, min_d)
        same(f"sgm_axis_scan sad {entry}", k,
             P.axis_scan(v, r, p1, p2, False, entry, min_d))
        ref = S._axis_scan(v, r, p1, p2, False, entry, min_d)
        rel = float(((k - ref).abs() / ref.abs().clamp_min(1.0)).max())
        require(rel <= 2.0 ** -7, f"sgm_axis_scan sad {entry}: relative "
                f"error {rel} against the scan grouping > 2^-7")
        sad_err = max(sad_err, float((k - ref).abs().max()))
    say("sgm", f"sgm_axis_scan on a SAD volume: bitwise vs its twin; vs the "
        f"scan grouping max abs err {sad_err:.4g} (bound: one bf16 step "
        f"per orientation, relative 2^-7)")

    # the whole disparity map: kernels against the plain path
    d_k = S.disparity(left, right, scfg)
    d_p = S.disparity(left, right, scfg._replace(sgm_pallas=False))
    require(bool(torch.equal(d_k, d_p)), "disparity: kernel and plain maps "
            "differ")
    say("sgm", f"disparity() with the kernels equals the plain path; "
        f"{float((d_k > 0).float().mean()):.4f} of pixels valid")

    # time per launch; the plain twins run fewer reps
    buf = torch.zeros((n_d, h, w), dtype=torch.float32, device=device)
    census_bytes = 2 * h * w * 4
    out["sgm_census_x"] = timed(dict(
        max_abs_err=0.0,
        # reads two census images, writes the x family; ~10 operations per
        # (pixel, plane) and orientation (xor, popcount, the d+-1 min, +P1,
        # two mins, +P2, -Lmin, +cost, the Lmin reduction)
        **bound(census_bytes + cells * 4, 2 * cells * 10)),
        kernel_time(lambda: K.census_x(cl, cr, p1, p2, min_d, n_d),
                    ("census_x_kernel",)),
        cuda_time_ms(lambda: P.census_x_family(cl, cr, p1, p2, min_d, n_d),
                     reps=2, warmup=1))
    out["sgm_census_y"] = timed(dict(
        max_abs_err=0.0,
        # reads two census images and the x family, writes the sum; three
        # directions per orientation
        **bound(census_bytes + 2 * cells * 4, 6 * cells * 10)),
        kernel_time(lambda: K.census_y(cl, cr, buf, rolls, p1, p2, min_d),
                    ("census_y_kernel",)),
        cuda_time_ms(lambda: P.census_y_family(cl, cr, rolls, p1, p2, min_d,
                                               n_d), reps=2, warmup=1))
    # B4 launches twice per frame on the materialized branch: the x family
    # (axis_line_kernel) and the y family of 8 paths (axis_band_kernel).
    # Each family is timed and printed apart; the record's per-launch time
    # and bound are the mean of the two
    fam = {}
    for (v, r, e), kname in zip(scans, ("axis_line_kernel",
                                        "axis_band_kernel")):
        t = kernel_time(lambda: K.axis_scan(v, r, p1, p2, False, e, min_d),
                        (kname,))
        fam[e] = timed(dict(
            # reads the bf16 volume, writes the f32 sum; 2 len(r) paths
            **bound(cells * 2 + cells * 4, 2 * len(r) * cells * 10)), t,
            cuda_time_ms(lambda: P.axis_scan(v, r, p1, p2, False, e, min_d),
                         reps=1, warmup=1))
        say("sgm", time_line(f"sgm_axis_scan {e} family ({kname})", fam[e]))
    t_b4 = {k: (fam["x"]["time"][k] + fam["y"]["time"][k]) / 2
            for k in fam["x"]["time"] if k != "per_us"}
    t_b4["per_us"] = [(a + b) / 2 for a, b in zip(fam["x"]["time"]["per_us"],
                                                  fam["y"]["time"]["per_us"])]
    out["sgm_axis_scan"] = timed(dict(
        max_abs_err=0.0,
        bound_ms=(fam["x"]["bound_ms"] + fam["y"]["bound_ms"]) / 2,
        bound_by=("bytes" if fam["x"]["bound_by"] == fam["y"]["bound_by"]
                  == "bytes" else "operations")), t_b4,
        (fam["x"]["plain_ms"] + fam["y"]["plain_ms"]) / 2)
    for name in ("sgm_census_x", "sgm_census_y", "sgm_axis_scan"):
        say("sgm", time_line(name, out[name]))
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


def make_pairs(config, n_frames: int):
    from densesurfelmapping_tpu_torch.io import synthetic
    poses = synthetic.forward_trajectory(n_frames + 3, step=0.4)[:n_frames]
    return [stereo_pair(config, p) + (p,) for p in poses]


def drive_stereo(config, pairs, device, scfg, sync_checked: bool):
    """Feed stereo pairs through DeviceResidentMapping with the on-device
    matcher (keyframe every 2nd frame); returns (driver, frames/s to a
    device synchronize)."""
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    drv = DeviceResidentMapping(config, device=device)
    drv.enable_stereo(bf=config.camera.fx * BASELINE_M, stereo_config=scfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_checked:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i, (li, ri, _, pose) in enumerate(pairs):
            drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
            drv.feed_stereo(float(i), li, ri)
        drv.flush()
    finally:
        if sync_checked:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fps = len(pairs) / (time.perf_counter() - t0)
    drv.close()
    return drv, fps


def depth_check(config, pair, device) -> tuple:
    """compute_depth_stereo on one pair against its rendered depth (1-25
    m): (coverage, median relative error)."""
    from densesurfelmapping_tpu_torch.pipeline.fuse_step import (
        compute_depth_stereo)
    li, ri, ld, _ = pair
    bf = torch.tensor(config.camera.fx * BASELINE_M, device=device)
    depth, _ = compute_depth_stereo(
        config, sgm_config(), torch.from_numpy(li).to(device).float(),
        torch.from_numpy(ri).to(device).float(), bf)
    depth = depth.cpu().numpy()
    sel = (ld >= 1.0) & (ld <= 25.0)
    ok = sel & (depth > 0)
    rel = np.abs(depth[ok] - ld[ok]) / ld[ok]
    return float(ok.sum() / sel.sum()), float(np.median(rel))


def same_bank(a: dict, b: dict) -> bool:
    return len(a["color"]) == len(b["color"]) and all(
        np.array_equal(a[k], b[k]) for k in a)


def phase_stereo(device) -> tuple:
    """The stereo-resident drive: returns the SGM launch counts of the
    fused drive and of the materialized-branch drive, and the rendered
    pairs."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as KS
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    scfg = sgm_config()
    t0 = time.perf_counter()
    pairs = make_pairs(cfg, N_STEREO_FRAMES)
    say("stereo", f"rendered {len(pairs)} pairs {cfg.height}x{cfg.width} in "
        f"{time.perf_counter() - t0:.1f} s")
    drive_stereo(cfg, pairs[:2], device, scfg, sync_checked=False)

    K.reset_launch_counts()
    KS.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    drv, fps = drive_stereo(cfg, pairs, device, scfg, sync_checked=True)
    peak = torch.cuda.max_memory_allocated()
    slic_n, sgm_n = dict(K.LAUNCHES), dict(KS.LAUNCHES)
    say("stereo", f"peak device memory of the drive: {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated)")
    say("stereo", f"kernel launches in the drive: {sgm_n}, {slic_n}")
    require(sgm_n["sgm_census_x"] == sgm_n["sgm_census_y"] == len(pairs)
            and sgm_n["sgm_axis_scan"] == 0,
            "stereo drive: B5/B6 not launched once per frame")
    require(all(v == cfg.sp_iters * len(pairs) for v in slic_n.values()),
            f"stereo drive: the SLIC kernels were not launched "
            f"{cfg.sp_iters}x per frame")
    rows = bank_to_numpy(drv.bank)
    live = rows["update_times"] > 0
    require(live.sum() > 0, "stereo drive: the map is empty")
    for k in ("position", "normal", "size", "weight"):
        require(bool(np.isfinite(rows[k]).all()), f"NaN/Inf in bank.{k}")
    require(drv.compactions > 0, "stereo drive: compaction never ran")
    ground = (rows["update_times"] >= 5) & (np.abs(rows["normal"][:, 1])
                                            > 0.9)
    gerr = float(np.abs(rows["position"][ground, 1]
                        - synthetic.default_scene().ground_y).mean()) \
        if ground.any() else float("nan")
    say("stereo", f"{len(pairs)} pairs: {fps:.2f} frames/s (to a device "
        f"synchronize), {int(live.sum())} live surfels, {int(ground.sum())} "
        f"stable ground surfels with mean |y - ground| {gerr:.3e} m, "
        f"{drv.compactions} compactions; steady feed raised no host-device "
        f"sync")

    cov, err = depth_check(cfg, pairs[0], device)
    require(err <= DEPTH_REL_ERR_BOUND and cov >= DEPTH_COVERAGE_FLOOR,
            f"depth check: coverage {cov:.4f} (floor "
            f"{DEPTH_COVERAGE_FLOOR}), median relative error {err:.4f} "
            f"(bound {DEPTH_REL_ERR_BOUND})")
    say("stereo", f"depth check, frame 0: coverage {cov:.4f} (floor "
        f"{DEPTH_COVERAGE_FLOOR}), median relative error {err:.5f} (bound "
        f"{DEPTH_REL_ERR_BOUND})")

    # the first 4 frames: fused kernels, plain path, materialized branch
    KS.reset_launch_counts()
    fused, _ = drive_stereo(cfg, pairs[:4], device, scfg, False)
    require(KS.LAUNCHES["sgm_census_x"] == 4, "fused drive: B6 count")
    plain, _ = drive_stereo(cfg, pairs[:4], device,
                            scfg._replace(sgm_pallas=False), False)
    KS.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mat, _ = drive_stereo(cfg, pairs[:4], device,
                          scfg._replace(sgm_fused_census=False), False)
    mat_peak = torch.cuda.max_memory_allocated()
    mat_n = dict(KS.LAUNCHES)
    say("stereo", f"materialized-branch drive, 4 pairs: launches {mat_n}; "
        f"peak device memory {mat_peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated)")
    require(mat_n["sgm_axis_scan"] == 8 and mat_n["sgm_census_x"] == 0,
            "materialized drive: B4 not launched twice per frame")
    rf = bank_to_numpy(fused.bank)
    require(same_bank(rf, bank_to_numpy(plain.bank)),
            "fused-kernel and plain stereo maps differ")
    require(same_bank(rf, bank_to_numpy(mat.bank)),
            "fused and materialized stereo maps differ")
    say("stereo", f"4 pairs: fused census (B6+B5), plain twins and the "
        f"materialized volume (B4) build the same map "
        f"({int((rf['update_times'] > 0).sum())} live surfels)")
    return dict(sgm_n, sgm_axis_scan=mat_n["sgm_axis_scan"]), pairs


CLI_DIR = "build/cli"
CLI_OUTPUTS = (".pcd", "_mesh.ply", "_cameras.ply", ".ckpt.npz",
               "_traj.txt", "_mapdepth.png", "_seg.png")
LOOP_MAE_M = 0.3       # the verify recipe's gates for these two commands
STEREO_MAE_M = 0.5
KITTI_BANK_TOL_M = 1e-5
N_KITTI_FRAMES = 8


def run_cli(argv) -> tuple:
    """The port's cli.main(argv) in this process, its stdout captured and
    echoed under [cli]; returns (exit code, stdout, wall s)."""
    import contextlib
    import io
    from densesurfelmapping_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    say("cli", f"$ python -m densesurfelmapping_tpu_torch {' '.join(argv)}"
        f"  -> rc {rc}, {wall:.1f} s")
    for ln in buf.getvalue().splitlines():
        say("cli", "  " + ln)
    return rc, buf.getvalue(), wall


def cli_line(out: str, prefix: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith(prefix))


def cli_json(out: str, prefix: str) -> dict:
    return json.loads(cli_line(out, prefix)[len(prefix):])


def frames_fused(out: str) -> int:
    return int(cli_line(out, "frames fused:").split(",")[0].split()[-1])


def write_gray_png(path: str, img: np.ndarray) -> None:
    """8-bit gray PNG, filter type 0, in a few lines of zlib."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def counted(fn):
    """fn() with every kernel count set to 0 just before and read just
    after; returns (fn's result, {kernel: launches})."""
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as KS
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K
    K.reset_launch_counts()
    KS.reset_launch_counts()
    res = fn()
    return res, dict(K.LAUNCHES, **KS.LAUNCHES)


def phase_cli(device, drive_frames) -> dict:
    """The port's CLI end to end on the card (cli.main in this process, the
    default --device cuda): the loop scene with --eval, --stereo --sgm with
    --eval, the radius-15 stress run, kitti + replay over a generated
    KITTI-layout directory, multi (depth-fed and --stereo --sgm), serve in
    a subprocess fed by publish, and an in-process MappingServer against a
    direct feed of `drive_frames`.  Returns the kernel launches of its runs."""
    import importlib.util
    import os
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core import state as S
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import png, synthetic
    from densesurfelmapping_tpu_torch.io.kitti import bf_for_sequence
    from densesurfelmapping_tpu_torch.io.posefeed import PoseFeed
    from densesurfelmapping_tpu_torch.native import loader as native
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)

    t_phase = time.perf_counter()
    # the card's path packs and writes through the native library: no numpy
    # fallback may pass silently here
    require(native.available(), "the native library (g++ build of "
            "native/surfel_native.cpp) is not available")
    libs = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL")}
    say("cli", "native library built and loaded; image libraries: "
        + ", ".join(f"{m} {'present' if v else 'absent'}"
                    for m, v in libs.items())
        + "; kitti and replay below read their PNGs with io/png.py (cv2 "
        "and PIL made unimportable for those two runs)")
    os.makedirs(CLI_DIR, exist_ok=True)
    cfg = kitti_config()
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # the host pack of one KITTI frame: native encoder against numpy
    img, dep = synthetic.default_scene().render(cfg, np.eye(4))
    aux = S.pack_aux(np.eye(4), 0, np.zeros(cfg.max_keyframes, bool))

    def numpy_pack():
        ci, cd = S.compact_frame(cfg, img, dep)
        out = np.empty(3 * ci.size + aux.size, np.uint8)
        out[:3 * ci.size] = np.concatenate([ci.reshape(-1),
                                            cd.reshape(-1).view(np.uint8)])
        out[3 * ci.size:] = aux
        return out

    require(np.array_equal(S.pack_frame_with_aux(cfg, img, dep, aux),
                           numpy_pack()), "native pack != numpy pack")
    pack_ms = {}
    for name, fn in (("native", lambda: S.pack_frame_with_aux(
            cfg, img, dep, aux)), ("numpy", numpy_pack)):
        fn()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        pack_ms[name] = 1e3 * (time.perf_counter() - t0) / 50
    say("cli", f"host pack of one KITTI frame + aux (pack_frame_with_aux): "
        f"native {pack_ms['native']:.3f} ms, numpy {pack_ms['numpy']:.3f} ms "
        f"(mean of 50, host clock; bitwise equal)")

    # 2. the loop scene with --eval (the verify recipe's command)
    loop = f"{CLI_DIR}/loop"
    (rc, out, _), n = counted(lambda: run_cli(
        ["synthetic", "--frames", "60", "--loop", "--kf-every", "2", "--eval",
         "--out", loop]))
    add(n)
    require(rc == 0, f"synthetic --loop: rc {rc}")
    for suffix in CLI_OUTPUTS:
        require(os.path.exists(loop + suffix)
                and os.path.getsize(loop + suffix) > 0,
                f"synthetic --loop: {loop + suffix} missing or empty")
    ckpt = np.load(loop + ".ckpt.npz")
    require(int(ckpt["bank_count"]) > 0, "loop checkpoint: empty bank")
    fid = cli_json(out, "fidelity: ")
    require(fid.get("mae", float("inf")) < LOOP_MAE_M,
            f"synthetic --loop: fidelity MAE {fid.get('mae')} >= {LOOP_MAE_M}")
    fused = frames_fused(out)
    want = cfg.sp_iters * (fused + 1)      # + the _seg.png render
    require(all(n[k] == want for k in ("slic_assign", "slic_centroid",
                                       "slic_huber"))
            and n["sgm_census_x"] == n["sgm_census_y"] == 0,
            f"synthetic --loop: launches {n}, want {want} of each SLIC "
            f"kernel ({fused} frames + the segmentation render)")
    say("cli", f"synthetic --loop: rc 0, the seven outputs written, "
        f"{int(ckpt['bank_count'])} surfels in the checkpoint, MAE "
        f"{fid['mae']} m (< {LOOP_MAE_M}); launches {n}")

    # 3. stereo-resident, census SGM
    st = f"{CLI_DIR}/stereo"
    (rc, out, _), n = counted(lambda: run_cli(
        ["synthetic", "--frames", "40", "--stereo", "--sgm", "--kf-every",
         "2", "--eval", "--out", st]))
    add(n)
    require(rc == 0, f"synthetic --stereo --sgm: rc {rc}")
    fid = cli_json(out, "fidelity: ")
    require(fid.get("mae", float("inf")) < STEREO_MAE_M,
            f"synthetic --stereo --sgm: MAE {fid.get('mae')} >= "
            f"{STEREO_MAE_M}")
    fused = frames_fused(out)
    require(n["sgm_census_x"] == n["sgm_census_y"] == fused
            and n["sgm_axis_scan"] == 0,
            f"synthetic --stereo --sgm: launches {n}, want B5/B6 once for "
            f"each of {fused} frames")
    require(n["slic_assign"] == cfg.sp_iters * (fused + 1),
            f"synthetic --stereo --sgm: SLIC launches {n}")
    say("cli", f"synthetic --stereo --sgm: rc 0, MAE {fid['mae']} m "
        f"(< {STEREO_MAE_M}); launches {n}")

    # 4. the loop-closure stress run, depth-fed.  120 frames: at 48 the
    # post-correction MAE read above the pre-correction one on the card (the
    # two average different eval frames); the host renders this scene at
    # ~1.3 s a frame, ~170 s of the phase
    (rc, out, _), n = counted(lambda: run_cli(
        ["stress", "--frames", "120", "--radius", "15", "--kf-every", "2",
         "--out", f"{CLI_DIR}/stress"]))
    add(n)
    require(rc == 0, f"stress: rc {rc}")
    pre = cli_json(out, "fidelity pre-correction: ")
    post = cli_json(out, "fidelity post-correction:")
    require(post["mae"] < pre["mae"], f"stress: post-correction MAE "
            f"{post['mae']} not below pre-correction {pre['mae']}")
    require(n["slic_assign"] > 0, f"stress: launches {n}")
    say("cli", f"stress: rc 0, MAE pre {pre['mae']} -> post {post['mae']} m; "
        f"launches {n}")

    # 5. kitti over a generated KITTI-layout directory, then replay
    root = f"{CLI_DIR}/kitti_seq"
    for d in ("image_0", "depth_0"):
        os.makedirs(f"{root}/{d}", exist_ok=True)
    bf = bf_for_sequence(0)
    scene = synthetic.default_scene()
    poses = synthetic.forward_trajectory(N_KITTI_FRAMES, step=0.4)
    frames = []
    for i, pose in enumerate(poses):
        img, dep = scene.render(cfg, pose)
        img = np.clip(img, 0, 255).astype(np.uint8)
        write_gray_png(f"{root}/image_0/{i:06d}.png", img)
        with np.errstate(divide="ignore"):
            disp = np.where(dep > 0, bf / dep, 0.0).astype(np.float32)
        np.save(f"{root}/depth_0/{i:06d}.npy", disp)
        # the depth as KittiSequence computes it from the disparity
        with np.errstate(divide="ignore", invalid="ignore"):
            d = bf / disp
        frames.append((img, np.where(np.isfinite(d) & (d > 0), d, 0.0)
                       .astype(np.float32)))
    with open(f"{root}/poses.txt", "w") as f:
        for p in poses:
            f.write(" ".join(repr(float(v)) for v in p[:3].reshape(-1))
                    + "\n")
    feed = PoseFeed.from_poses(poses, stamps=[i / 5.0 for i in
                                              range(len(poses))],
                               keyframe_every=2)
    feed_path = f"{CLI_DIR}/kitti_feed.npz"
    PoseFeed.save(feed_path, feed.messages)
    # the readers try cv2, then PIL, then io/png.py: make the first two
    # unimportable so that the decoder runs on every machine
    blocked = {m: sys.modules.pop(m, None) for m in ("cv2", "PIL")}
    sys.modules.update(dict.fromkeys(blocked))
    try:
        for i, (img, _) in enumerate(frames):
            require(np.array_equal(png.read_png(
                f"{root}/image_0/{i:06d}.png"), img), "io/png.py misread "
                f"image_0/{i:06d}.png")
        (rc, _, _), n = counted(lambda: run_cli(
            ["kitti", "--root", root, "--kf-every", "2",
             "--out", f"{CLI_DIR}/kitti"]))
        add(n)
        (rc_r, _, _), n_r = counted(lambda: run_cli(
            ["replay", "--feed", feed_path, "--root", root, "--out",
             f"{CLI_DIR}/replay"]))
        add(n_r)
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    require(rc == 0 and n["slic_assign"] > 0, f"kitti: rc {rc}, launches "
            f"{n}")
    require(rc_r == 0 and n_r["slic_assign"] > 0, f"replay: rc {rc_r}, "
            f"launches {n_r}")

    def drive_direct(messages):
        """DeviceResidentMapping fed the frames' arrays directly: pose
        messages as kitti builds them, or a recorded feed's."""
        drv = DeviceResidentMapping(cfg, device=device)
        for i, (img, dep) in enumerate(frames):
            if messages is None:
                drv.feed_pose(i / 5.0, poses[i], is_keyframe=(i % 2 == 0))
            else:
                m = messages[i]
                drv.feed_pose(m.stamp, m.pose, loop_path=m.loop_path,
                              loop_edges=m.loop_edges,
                              is_keyframe=m.is_keyframe,
                              reference_index=m.reference_index)
            drv.feed_image(i / 5.0, img)
            drv.feed_depth(i / 5.0, dep)
        rows = bank_to_numpy(drv.bank)
        drv.close()
        return rows

    def bank_err(path, direct):
        z = np.load(path)
        require(int(z["bank_count"]) == len(direct["color"]) > 0,
                f"{path}: {int(z['bank_count'])} surfels, the direct drive "
                f"{len(direct['color'])}")
        for k in ("update_times", "last_update"):
            require(np.array_equal(z[f"bank_{k}"], direct[k]),
                    f"{path}: bank {k} differs from the direct drive")
        return max(float(np.abs(z[f"bank_{k}"] - direct[k]).max())
                   for k in ("position", "normal", "color", "size",
                             "weight"))

    err = bank_err(f"{CLI_DIR}/kitti.ckpt.npz", drive_direct(None))
    require(err <= KITTI_BANK_TOL_M, f"kitti: bank off the direct drive's "
            f"by {err}")
    err_r = bank_err(f"{CLI_DIR}/replay.ckpt.npz",
                     drive_direct(feed.messages))
    require(err_r <= KITTI_BANK_TOL_M, f"replay: bank off the direct "
            f"drive's by {err_r}")
    say("cli", f"kitti and replay over {N_KITTI_FRAMES} KITTI-size frames "
        f"read from PNG (io/png.py, exact) + disparity files: rc 0, banks "
        f"equal to a DeviceResidentMapping fed the same arrays (max abs err "
        f"{err:.3g} / "
        f"{err_r:.3g}, bound {KITTI_BANK_TOL_M})")

    # 6. multi: 4 streams, 20 rounds; per-session clouds and checkpoints
    mp = f"{CLI_DIR}/multi"
    (rc, out, _), n = counted(lambda: run_cli(
        ["multi", "--streams", "4", "--frames", "20", "--out", mp]))
    add(n)
    require(rc == 0, f"multi: rc {rc}")
    for k in range(4):
        for suffix in (".pcd", ".ckpt.npz"):
            path = f"{mp}_s{k}{suffix}"
            require(os.path.exists(path) and os.path.getsize(path) > 0,
                    f"multi: {path} missing or empty")
        require(int(np.load(f"{mp}_s{k}.ckpt.npz")["frames_fused"]) == 20,
                f"multi: session {k} did not fuse 20 frames")
    require(all(n[k] == cfg.sp_iters * 20 for k in ("slic_assign",
                                                    "slic_centroid",
                                                    "slic_huber")),
            f"multi: launches {n}, want {cfg.sp_iters * 20} of each SLIC "
            f"kernel (one per sweep for the 4 streams)")
    say("cli", f"multi --streams 4 --frames 20: rc 0, per-session clouds "
        f"and checkpoints written; launches {n}")

    # 7. the stereo fleet through the CLI
    ms = f"{CLI_DIR}/multi_stereo"
    (rc, out, _), n = counted(lambda: run_cli(
        ["multi", "--streams", "2", "--frames", "8", "--stereo", "--sgm",
         "--out", ms]))
    add(n)
    require(rc == 0, f"multi --stereo: rc {rc}")
    require(n["sgm_census_x"] == n["sgm_census_y"] == 16
            and n["slic_assign"] == cfg.sp_iters * 8,
            f"multi --stereo --sgm: launches {n}, want B5/B6 16 (2 streams "
            f"x 8 rounds) and {cfg.sp_iters * 8} of each SLIC kernel")
    for k in range(2):
        require(int(np.load(f"{ms}_s{k}.ckpt.npz")["bank_count"]) > 0,
                f"multi --stereo: session {k}'s map is empty")
    say("cli", f"multi --streams 2 --frames 8 --stereo --sgm: rc 0; "
        f"launches {n}")

    # 8. serve in a subprocess (the default --device cuda), fed by publish
    # in this process over a unix socket
    sock = f"{CLI_DIR}/s.sock"
    if os.path.exists(sock):
        os.unlink(sock)
    mesh = f"{CLI_DIR}/published_mesh.ply"
    served = f"{CLI_DIR}/served"
    for path in (mesh, served + "_mesh.ply"):
        if os.path.exists(path):
            os.unlink(path)
    server = subprocess.Popen(
        [sys.executable, "-m", "densesurfelmapping_tpu_torch", "serve",
         "--socket", sock, "--out", served],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        while not os.path.exists(sock):
            if server.poll() is not None or time.perf_counter() - t0 > 120:
                server.kill()
                raise AssertionError(f"serve did not start: "
                                     f"{server.communicate()[0]}")
            time.sleep(0.1)
        rc, out, _ = run_cli(["publish", "--socket", sock, "--frames", "20",
                              "--save", mesh, "--shutdown"])
        s_out, _ = server.communicate(timeout=300)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    for ln in s_out.splitlines():
        say("cli", "  serve| " + ln)
    require(rc == 0 and server.returncode == 0,
            f"publish rc {rc}, serve rc {server.returncode}")
    require(os.path.getsize(mesh) > 0 and os.path.getsize(
        served + "_mesh.ply") > 0, "serve/publish: a saved mesh is empty")
    with open(mesh) as f:
        n_vert = next(int(ln.split()[-1]) for ln in f
                      if ln.startswith("element vertex"))
    require(n_vert > 0, "serve/publish: the saved mesh has no vertex")
    say("cli", f"serve (subprocess, --device cuda) fed by publish --frames "
        f"20 over {sock}: both rc 0, the saved mesh has {n_vert} vertices, "
        f"the shutdown autosave written")

    # 9. in-process: a MappingServer over a CUDA DeviceResidentMapping
    # gives the bank of a direct feed of the same messages
    from densesurfelmapping_tpu_torch.io import bridge
    import threading

    def bridge_feed(target, i):
        img, dep, pose = drive_frames[i]
        target.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        target.feed_image(float(i), img)
        target.feed_depth(float(i), dep)

    direct = DeviceResidentMapping(cfg, device=device)
    for i in range(N_KITTI_FRAMES):
        bridge_feed(direct, i)
    via = DeviceResidentMapping(cfg, device=device)
    bsock = f"{CLI_DIR}/b.sock"
    if os.path.exists(bsock):
        os.unlink(bsock)
    with bridge.MappingServer(via, bsock) as srv:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        with bridge.MappingClient(bsock) as client:
            for i in range(N_KITTI_FRAMES):
                img, dep, pose = drive_frames[i]
                client.publish_pose(float(i), pose, is_keyframe=(i % 2 == 0))
                client.publish_image(float(i), img)
                client.publish_depth(float(i), dep)
            m = client.metrics()["metrics"]
    require(m["frames_fused"] == N_KITTI_FRAMES, f"bridge: fused {m}")
    a, b = bank_to_numpy(direct.bank), bank_to_numpy(via.bank)
    require(len(a["color"]) == len(b["color"]) > 0 and np.array_equal(
        a["update_times"], b["update_times"]), "bridge: banks differ")
    berr = max(float(np.abs(a[k] - b[k]).max()) for k in
               ("position", "normal", "color", "size", "weight"))
    require(berr <= KITTI_BANK_TOL_M, f"bridge: bank off by {berr}")
    say("cli", f"MappingServer over a CUDA DeviceResidentMapping, "
        f"{N_KITTI_FRAMES} KITTI frames over a unix socket: the bank equals "
        f"a direct feed's (max abs err {berr:.3g}, bound {KITTI_BANK_TOL_M})")

    say("cli", f"phase wall time {time.perf_counter() - t_phase:.1f} s; "
        f"launches in its runs {total}")
    return total


N_STREAMS = 4           # the CLI's `multi --streams` default
N_ROUNDS = 24           # rounds of the fleet drive: 27 renders, not 96
N_STEREO_ROUNDS = 8
FLEET_TOL_M = 1e-5      # the JAX fleet's own tolerance against solo drivers
STEREO_FLEET_TOL_M = 1e-4


def batch_inputs(config, device, n: int):
    """n distinct frames of the synthetic scene (forward_trajectory, 0.4 m
    apart) stacked on a leading stream axis, with each frame's seeds and
    the initial assignment: run_slic's start for every stream."""
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    frames = [scene_frame(config, p, device)
              for p in synthetic.forward_trajectory(n, step=0.4)]
    image = torch.stack([f[0] for f in frames])
    depth = torch.stack([f[1] for f in frames])
    inv_depth = torch.where(depth > 0.01, 1.0 / depth.clamp_min(1e-20), 0.0)
    seeds = [S.initialize_seeds(config, i, d) for i, d in frames]
    g = S.device_geometry(config, device)
    asg = torch.where(g["pixel_valid"], 0, -1).to(torch.int32).expand(
        n, -1, -1).contiguous()
    return image, depth, inv_depth, seeds, asg


def stacked(seeds, name):
    return torch.stack([getattr(s, name) for s in seeds])


def one_launch(name, fn):
    """fn() with kernel `name` launched exactly once for all streams."""
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K
    n0 = K.LAUNCHES[name]
    out = fn()
    require(K.LAUNCHES[name] - n0 == 1, f"{name}: a batched call launched "
            f"{K.LAUNCHES[name] - n0} times")
    return out


def check_multi_slic(config, device, n: int) -> dict:
    """Over every sweep of the plain run_slic on n distinct frames: each
    batched B1/B2/B3 call launches once, each stream's output equals the
    single-frame kernel on that stream's frame (torch.equal), and holds
    against the plain twin under check_slic's contracts (B1 exact, B2
    rtol 1e-5 / atol 1e-3, B3 1e-4 m).  Returns the largest errors."""
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K
    image, depth, inv_depth, seeds, asg = batch_inputs(config, device, n)
    tag = (f"{n} streams of {config.height} x {config.width}, sp "
           f"{config.sp_size}, {config.sp_iters} sweeps")
    d = dict(sums_err=0.0, huber_err=0.0)
    for _ in range(config.sp_iters):
        names = ("x", "y", "mean_intensity", "mean_depth", "stable")
        bargs = (image, inv_depth, asg) + tuple(stacked(seeds, k)
                                                for k in names)
        ka, kc = one_launch("slic_assign",
                            lambda: K.slic_assign(config, *bargs))
        sums, plain_sums = [], []
        for k in range(n):
            args = tuple(a[k] for a in bargs)
            sa, sc = K.slic_assign(config, *args)
            pa, pc = S.assign_sweep(config, *args)
            require(torch.equal(ka[k], sa) and torch.equal(kc[k], sc),
                    f"slic_assign ({tag}): stream {k} differs from the "
                    f"single-frame kernel")
            require(torch.equal(ka[k], pa) and torch.equal(kc[k], pc),
                    f"slic_assign ({tag}): stream {k} differs from the "
                    f"plain twin")
        ks = one_launch("slic_centroid",
                        lambda: K.slic_centroid(config, image, depth, ka))
        for k in range(n):
            one = K.slic_centroid(config, image[k], depth[k], ka[k])
            ps = S.seed_sums(config, image[k], depth[k], ka[k])
            for a, b, c in zip(ks, one, ps):
                require(torch.equal(a[k], b), f"slic_centroid ({tag}): "
                        f"stream {k} differs from the single-frame kernel")
                d["sums_err"] = max(d["sums_err"],
                                    float((a[k] - c).abs().max()))
                require(bool(torch.allclose(a[k], c, rtol=1e-5, atol=1e-3)),
                        f"slic_centroid ({tag}): stream {k} off the twin")
            plain_sums.append(ps)
            sums.append(ps[5] / ps[4].clamp_min(1.0))
        mean0 = torch.stack(sums)
        conv = torch.stack([ps[4] <= 0 for ps in plain_sums])
        km = one_launch("slic_huber",
                        lambda: K.slic_huber(config, depth, ka, mean0, conv))
        for k in range(n):
            hargs = (config, depth[k], ka[k], mean0[k], conv[k])
            require(torch.equal(km[k], K.slic_huber(*hargs)),
                    f"slic_huber ({tag}): stream {k} differs from the "
                    f"single-frame kernel")
            d["huber_err"] = max(d["huber_err"], float(
                (km[k] - S.huber_mean_depth(*hargs)).abs().max()))
        require(d["huber_err"] <= 1e-4, f"slic_huber ({tag}): off the twin "
                f"by {d['huber_err']} m")
        asg = ka
        seeds = [S.update_seeds(config, s.replace(stable=s.stable & ~kc[k]),
                                asg[k], image[k], depth[k])
                 for k, s in enumerate(seeds)]
    say("multi-kernels", f"{tag}: one launch of each kernel per sweep for "
        f"all streams; every stream equals the single-frame kernel "
        f"(torch.equal) and its twin (B1 exact, B2 max abs err "
        f"{d['sums_err']:.3g}, B3 {d['huber_err']:.3g} m)")
    return d


def phase_multi_kernels(device, records: dict) -> dict:
    """B1-B3 with the stream axis: the checks of check_multi_slic at KITTI
    (N_STREAMS frames) and at sp 6 and 16 on the 120 x 56 frame, then
    device us per launch at B = 1 and B = N_STREAMS (kernel_time) beside
    the bound at B streams (B x one frame's bytes and operations).
    Returns {kernel: batched record}."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K
    cfg = kitti_config()
    d = check_multi_slic(cfg, device, N_STREAMS)
    for sp in (6, 16):
        check_multi_slic(slic_config(sp), device, 3)
    image, depth, inv_depth, seeds, asg = batch_inputs(cfg, device,
                                                       N_STREAMS)
    names = ("x", "y", "mean_intensity", "mean_depth", "stable")
    bargs = (image, inv_depth, asg) + tuple(stacked(seeds, k) for k in names)
    asg1, _ = K.slic_assign(cfg, *bargs)
    sums = K.slic_centroid(cfg, image, depth, asg1)
    hargs = (depth, asg1, sums[5] / sums[4].clamp_min(1.0), sums[4] <= 0)
    calls = {
        "slic_assign": lambda b: K.slic_assign(cfg, *(a[:b] for a in bargs)),
        "slic_centroid": lambda b: K.slic_centroid(cfg, image[:b],
                                                   depth[:b], asg1[:b]),
        "slic_huber": lambda b: K.slic_huber(cfg, *(a[:b] for a in hargs)),
    }
    errs = dict(slic_assign=0.0, slic_centroid=d["sums_err"],
                slic_huber=d["huber_err"])
    out = {}
    for name, call in calls.items():
        # 50 calls, up to 10 uncounted: the profiler dropped 4 of 20
        # records of B2 at B = 1 in three windows in a row once (H100)
        t1 = kernel_time(lambda: call(1), (name + "_kernel",), reps=50,
                         drop=10)
        tb = kernel_time(lambda: call(N_STREAMS), (name + "_kernel",),
                         reps=50, drop=10)
        rec = records[name]
        b = bound(*(N_STREAMS * x for x in rec["bound_args"]))
        out[name] = dict(streams=N_STREAMS, us_1=t1["us"],
                         us_n=tb["us"], us_n_min=tb["us_min"],
                         us_n_max=tb["us_max"], ops_n=tb["ops"],
                         host_us_n=tb["host_us"], max_abs_err=errs[name],
                         **b)
        say("multi-kernels", f"{name}: device {t1['us']:.2f} us/launch at "
            f"B = 1, {tb['us']:.2f} us/launch at B = {N_STREAMS} (min "
            f"{tb['us_min']:.2f}, max {tb['us_max']:.2f}; "
            f"{tb['us'] / N_STREAMS:.2f} us a stream), {tb['ops']:.2f} device "
            f"ops a call, wrapper host {tb['host_us']:.1f} us; bound at B = "
            f"{N_STREAMS} {1e3 * b['bound_ms']:.2f} us ({b['bound_by']})")
    return out


def fleet_rows(multi, k: int) -> dict:
    """Every allocated row of session k."""
    return multi.session_surfels(k, min_updates=0)


def drive_fleet(config, frames, device, n_streams: int, rounds: int,
                pipelined: bool = False, sync_checked: bool = False):
    """MultiSessionMapping over `rounds` rounds: stream k fuses frames k,
    k + 1, ... (keyframe every 2nd round); returns (fleet, aggregate
    frames/s to a device synchronize)."""
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)
    multi = MultiSessionMapping(config, n_streams, pipelined=pipelined,
                                device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_checked:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(rounds):
            for k in range(n_streams):
                img, dep, pose = frames[k + i]
                multi.feed_pose(k, float(i), pose, is_keyframe=(i % 2 == 0))
                multi.feed_image(k, float(i), img)
                multi.feed_depth(k, float(i), dep)
            multi.step()
        multi.flush_rounds()
    finally:
        if sync_checked:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    fps = n_streams * rounds / (time.perf_counter() - t0)
    multi.close()
    return multi, fps


def same_rows_within(a: dict, b: dict, tol: float, what: str) -> float:
    """Equal live-surfel counts and column-sorted positions within tol (the
    comparison of tests/test_multi_session.py); returns the max error."""
    la, lb = a["update_times"] > 0, b["update_times"] > 0
    require(la.sum() == lb.sum() > 0, f"{what}: {int(la.sum())} live "
            f"surfels against {int(lb.sum())}")
    err = float(np.abs(np.sort(a["position"][la], axis=0)
                       - np.sort(b["position"][lb], axis=0)).max())
    require(err <= tol, f"{what}: positions off by {err} m (bound {tol})")
    return err


def phase_multi(device, frames, smi: str) -> dict:
    """The multi-session fleet at the CLI's width: MultiSessionMapping(
    kitti_config(surfel_capacity=1<<21, compact_interval=16), 4 streams,
    device="cuda"); stream k fuses frames k ... k + 23 of the drive's
    forward_trajectory renders.  Checks launches, NaN, compaction, each
    session against a solo DeviceResidentMapping, a loop warp on session 0
    alone and pipelined == eager; measures the aggregate frames/s at
    B = 1, 2, 4, device ops, ms and idle share per round and the peak
    device memory.  Returns the SLIC launches of the checked drive."""
    from torch.profiler import ProfilerActivity, profile
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy

    cfg = kitti_config(surfel_capacity=1 << 21, compact_interval=16)
    B = N_STREAMS
    require(len(frames) >= B - 1 + N_ROUNDS, "too few rendered frames")
    for b in (1, 2, B):                  # warm-up: allocator, first calls
        drive_fleet(cfg, frames, device, b, 2)
    torch.cuda.reset_peak_memory_stats()
    (multi, fps4), n = counted(lambda: drive_fleet(
        cfg, frames, device, B, N_ROUNDS, sync_checked=True))
    peak = torch.cuda.max_memory_allocated()
    say("multi", f"{B} streams x {N_ROUNDS} rounds: kernel launches {n}; "
        f"steady feed raised no host-device sync; peak device memory "
        f"{peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated; banks "
        f"{B} x 2^21 rows)")
    want = cfg.sp_iters * N_ROUNDS
    require(all(n[k] == want for k in ("slic_assign", "slic_centroid",
                                       "slic_huber"))
            and n["sgm_census_x"] == n["sgm_census_y"] == 0,
            f"fleet: SLIC kernels not launched {cfg.sp_iters}x per round "
            f"(want {want} each, not x {B}): {n}")
    require(multi.compactions > 0, "fleet: compaction never ran")
    rows = [fleet_rows(multi, k) for k in range(B)]
    for k, r in enumerate(rows):
        for f in ("position", "normal", "size", "weight"):
            require(bool(np.isfinite(r[f]).all()),
                    f"fleet session {k}: NaN/Inf in bank.{f}")
    errs = []
    for k in range(B):
        solo, _ = drive(cfg, frames[k:k + N_ROUNDS], device,
                        pipelined=False, sync_checked=False)
        errs.append(same_rows_within(rows[k], bank_to_numpy(solo.bank),
                                     FLEET_TOL_M, f"fleet session {k} vs "
                                     f"a solo DeviceResidentMapping"))
        del solo
    say("multi", f"each session equals a solo DeviceResidentMapping fed "
        f"the same {N_ROUNDS} frames: live surfels "
        f"{[int((r['update_times'] > 0).sum()) for r in rows]}, max abs "
        f"position err {max(errs):.3g} m (bound {FLEET_TOL_M}); "
        f"{multi.compactions} compactions")

    # a loop correction of session 0 moves session 0 alone
    s0 = multi.sessions[0]
    shift = np.eye(4)
    shift[:3, 3] = (0.25, -0.5, 1.0)
    multi.feed_pose(0, 1e6, shift @ s0.graph.keyframes[-1].cam_pose,
                    loop_path=[shift @ kf.cam_pose
                               for kf in s0.graph.keyframes])
    after = [fleet_rows(multi, k) for k in range(B)]
    live = rows[0]["update_times"] > 0
    werr = float(np.abs(after[0]["position"][live]
                        - rows[0]["position"][live] - shift[:3, 3]).max())
    require(werr < WARP_TOL_M, f"fleet loop warp: session 0 off by {werr}")
    for k in range(1, B):
        require(same_bank(after[k], rows[k]),
                f"fleet loop warp moved session {k}")
    say("multi", f"loop warp of session 0: every live surfel moved by the "
        f"shift within {werr:.2e} m (bound {WARP_TOL_M}); sessions 1-{B - 1} "
        f"unchanged")

    piped, fps_p = drive_fleet(cfg, frames, device, B, N_ROUNDS,
                               pipelined=True)
    for k in range(B):
        pr = fleet_rows(piped, k)
        require(len(pr["color"]) == len(rows[k]["color"]) and all(
            np.allclose(pr[f], rows[k][f], atol=1e-5) for f in pr),
            f"pipelined fleet: session {k} differs from the eager fleet")
    del piped, multi

    rates = {}
    for b in (1, 2, B):
        fps = sorted(drive_fleet(cfg, frames, device, b, N_ROUNDS)[1]
                     for _ in range(3))
        rates[b] = fps
        runs = ", ".join(f"{x:.2f}" for x in fps)
        say("multi", f"B = {b}: aggregate {fps[1]:.2f} frames/s (median of "
            f"3 drives of {N_ROUNDS} rounds: {runs}; {fps[1] / b:.2f} per "
            f"stream)")
    say("multi", f"pipelined B = {B}: {fps_p:.2f} frames/s, same maps as "
        f"eager; sync-checked eager drive {fps4:.2f} ({smi})")

    # device work per round at B streams, under the profiler
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)
    prof_fleet = MultiSessionMapping(cfg, B, device=device)
    n_prof = 8

    def round_(i):
        for k in range(B):
            img, dep, pose = frames[k + i]
            prof_fleet.feed_pose(k, float(i), pose, is_keyframe=(i % 2 == 0))
            prof_fleet.feed_image(k, float(i), img)
            prof_fleet.feed_depth(k, float(i), dep)
        prof_fleet.step()

    for i in range(2):
        round_(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + n_prof):
            round_(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, busy_us = device_activity(prof.events())
    kern = {p: sum(e.time_range.elapsed_us() for e in dev if p in e.name)
            / n_prof / 1e3 for p in ("slic_assign_kernel",
                                     "slic_centroid_kernel",
                                     "slic_huber_kernel")}
    say("multi", f"B = {B}, {n_prof} rounds under the profiler: wall "
        f"{1e3 * wall / n_prof:.2f} ms/round, device busy "
        f"{busy_us / n_prof / 1e3:.2f} ms/round, idle share "
        f"{1 - busy_us / 1e6 / wall:.3f}, {len(dev) / n_prof:.0f} device "
        f"operations/round; SLIC kernels ms/round "
        + ", ".join(f"{k} {v:.4f}" for k, v in kern.items()))
    return dict(launches=n, rates=rates)


def phase_multi_stereo(device, pairs) -> dict:
    """The stereo fleet: 2 streams x N_STEREO_ROUNDS rounds of pairs with
    the CLI's --sgm matcher under the sync check; B5/B6 once per stream and
    round, the SLIC kernels once per sweep and round, each session's map
    equal to a solo stereo DeviceResidentMapping within 1e-4 m."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    B, R = 2, N_STEREO_ROUNDS

    def run(sync_checked, rounds):
        multi = MultiSessionMapping(cfg, B, device=device)
        multi.enable_stereo(bf=cfg.camera.fx * BASELINE_M,
                            stereo_config=sgm_config())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sync_checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(rounds):
                for k in range(B):
                    li, ri, _, pose = pairs[k + i]
                    multi.feed_pose(k, float(i), pose,
                                    is_keyframe=(i % 2 == 0))
                    multi.feed_stereo(k, float(i), li, ri)
                multi.step()
        finally:
            if sync_checked:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return multi, B * rounds / (time.perf_counter() - t0)

    run(False, 1)
    (multi, fps), n = counted(lambda: run(True, R))
    require(n["sgm_census_x"] == n["sgm_census_y"] == B * R
            and n["sgm_axis_scan"] == 0,
            f"stereo fleet: B5/B6 not once per stream and round: {n}")
    require(all(n[k] == cfg.sp_iters * R for k in ("slic_assign",
                                                   "slic_centroid",
                                                   "slic_huber")),
            f"stereo fleet: SLIC kernels not {cfg.sp_iters}x per round: {n}")
    errs = []
    for k in range(B):
        solo, _ = drive_stereo(cfg, pairs[k:k + R], device, sgm_config(),
                               False)
        errs.append(same_rows_within(
            fleet_rows(multi, k), bank_to_numpy(solo.bank),
            STEREO_FLEET_TOL_M, f"stereo fleet session {k} vs a solo "
            f"stereo DeviceResidentMapping"))
    say("multi-stereo", f"{B} streams x {R} rounds: {fps:.2f} frames/s "
        f"aggregate (to a device synchronize); launches {n}; steady feed "
        f"raised no host-device sync; each session equals a solo stereo "
        f"drive within {max(errs):.3g} m (bound {STEREO_FLEET_TOL_M})")
    return n


def device_activity(events) -> tuple:
    """The profiler's device records (kernels, copies and sets, not the
    device-side spans of the record_function scopes), in time order, and
    the us during which the device ran any of them (the union of their
    intervals)."""
    from torch.autograd import DeviceType
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for e in device:
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy_us += max(0.0, hi - lo)
        end = max(end, hi)
    return device, busy_us


def phase_profile(device) -> None:
    """Device time per frame of the stereo drive by fuse-step scope (a
    measurement: it prints what the profiler reports and checks nothing)."""
    from torch.profiler import ProfilerActivity, profile
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    pairs = make_pairs(cfg, 8)
    drv = DeviceResidentMapping(cfg, device=device)
    drv.enable_stereo(bf=cfg.camera.fx * BASELINE_M,
                      stereo_config=sgm_config())

    def feed(i):
        li, ri, _, pose = pairs[i]
        drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        drv.feed_stereo(float(i), li, ri)

    for i in range(2):
        feed(i)
    torch.cuda.synchronize()
    n = len(pairs) - 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, len(pairs)):
            feed(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    drv.close()

    from torch.autograd import DeviceType
    events = prof.events()
    device, busy_us = device_activity(events)
    say("profile", f"{n} stereo frames under the profiler: wall "
        f"{1e3 * wall / n:.2f} ms/frame, device busy {busy_us / n / 1e3:.2f} "
        f"ms/frame, idle share {1 - busy_us / 1e6 / wall:.3f}, "
        f"{len(device) / n:.0f} device operations/frame")
    for key in ("stereo", "superpixel", "fuse", "initialize"):
        # host-side scope: its device time is that of the work it launched
        scope = [e for e in events if e.name == key
                 and e.device_type == DeviceType.CPU]
        say("profile", f"scope {key}: device "
            f"{sum(e.device_time_total for e in scope) / n / 1e3:.3f} "
            f"ms/frame, host "
            f"{sum(e.cpu_time_total for e in scope) / n / 1e3:.3f} ms/frame")
    by_name: dict = {}
    for e in device:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        say("profile", f"device op {name[:70]}: {t / n / 1e3:.3f} ms/frame, "
            f"{c / n:.1f}/frame")
    # the SGM and SLIC kernels (outside the scopes: they launch through
    # ctypes)
    for part in ("census_x_kernel", "census_y_kernel", "slic_assign_kernel",
                 "slic_centroid_kernel", "slic_huber_kernel"):
        t = sum(v[0] for k, v in by_name.items() if part in k)
        c = sum(v[1] for k, v in by_name.items() if part in k)
        say("profile", f"kernel {part}: {t / n / 1e3:.4f} ms/frame, "
            f"{c / n:.1f}/frame")


PHASES = ("kernels", "sgm", "drive", "stereo", "multi-kernels", "multi",
          "multi-stereo", "cli", "profile")


def main() -> None:
    """Every phase, in order; `--only a,b` runs the build and the named
    phases alone (a partial run: it prints no result line)."""
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))
        require(only <= set(PHASES), f"unknown phases {only - set(PHASES)}")
    elif len(sys.argv) > 1:
        raise SystemExit(f"usage: {sys.argv[0]} [--only "
                         f"{','.join(PHASES)}]")

    t_start = time.perf_counter()
    t_mark = [t_start]

    def run(name):
        return only is None or name in only

    def lap(name):
        now = time.perf_counter()
        say("time", f"{name}: {now - t_mark[0]:.1f} s (script "
            f"{now - t_start:.1f} s)")
        t_mark[0] = now

    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    lap("build")

    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import synthetic

    records = {}
    if run("kernels") or run("multi-kernels"):
        records.update(phase_kernels(kitti_config(), device))
    lap("kernels")
    if run("sgm"):
        records.update(phase_sgm_kernels(device))
        lap("sgm")

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    t0 = time.perf_counter()
    frames = make_frames(cfg, N_FRAMES)
    say("drive", f"rendered {len(frames)} frames {cfg.height}x{cfg.width} "
        f"in {time.perf_counter() - t0:.1f} s")
    launches = dict.fromkeys(("slic_assign", "slic_centroid", "slic_huber",
                              "sgm_axis_scan", "sgm_census_y",
                              "sgm_census_x"), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    if run("drive"):
        drive(cfg, frames[:4], device, pipelined=False, sync_checked=False)
        (drv, fps), n = counted(lambda: drive(cfg, frames, device,
                                              pipelined=False,
                                              sync_checked=True))
        add(n)
        say("drive", f"kernel launches in the drive: {n}")
        require(all(n[k] == cfg.sp_iters * drv.frames_fused == cfg.sp_iters
                    * N_FRAMES for k in ("slic_assign", "slic_centroid",
                                         "slic_huber")),
                f"the SLIC kernels were not launched {cfg.sp_iters}x per "
                f"frame on the main path")
        rows_a = bank_to_numpy(drv.bank)
        stats = check_map(rows_a, drv, synthetic.default_scene().ground_y)
        say("drive", f"map: {stats['live']} live surfels, {stats['ground']} "
            f"stable ground surfels, mean |y - ground| "
            f"{stats['ground_err_m']:.3e} m (bound {GROUND_GATE_M}), "
            f"{stats['compactions']} compactions; steady feed raised no "
            f"host-device sync")
        say("drive", f"loop warp: every live surfel moved by the shift "
            f"within {check_warp(drv):.2e} m (bound {WARP_TOL_M})")

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
        del drv, drv_p
    lap("drive (renders included)")

    pairs = None
    if run("stereo") or run("multi-stereo"):
        n, pairs = phase_stereo(device)
        add(n)
        lap("stereo")
    batched = {}
    if run("multi-kernels"):
        batched = phase_multi_kernels(device, records)
        lap("multi-kernels")
    if run("multi"):
        add(phase_multi(device, frames, smi)["launches"])
        lap("multi")
    if run("multi-stereo"):
        add(phase_multi_stereo(device, pairs))
        lap("multi-stereo")
    if run("cli"):
        add(phase_cli(device, frames))
        lap("cli")
    if run("profile"):
        phase_profile(device)
        lap("profile")
    if only is not None:
        say("done", f"partial run of {sorted(only)}: launches {launches}")
        return

    kernels = []
    for name, src, line in (
            ("slic_assign", "slic", 241), ("slic_centroid", "slic", 330),
            ("slic_huber", "slic", 397), ("sgm_axis_scan", "sgm", 181),
            ("sgm_census_y", "sgm", 382), ("sgm_census_x", "sgm", 497)):
        rec = records[name]
        entry = dict(
            name=name, route="cuda",
            source=f"densesurfelmapping_tpu_torch/csrc/{src}.cu",
            replaces=f"densesurfelmapping_tpu/ops/pallas/{src}.py:{line}",
            launches=launches[name], max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=None)
        if name in batched:
            # the stream axis: one launch for the fleet's streams
            b = batched[name]
            entry["batched"] = dict(
                route="grid z = stream", streams=b["streams"],
                ms_1=b["us_1"] / 1e3, ms=b["us_n"] / 1e3,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=b["max_abs_err"])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
