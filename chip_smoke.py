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
  5. drive   - depth-fed DeviceResidentMapping over 60 KITTI-size frames
               (the fuse step replayed from a captured CUDA graph), the
               steady feed after the first frame under
               torch.cuda.set_sync_debug_mode("error"): launch counts, no
               NaN, the ground-plane gate, compaction, the loop warp
  6. rate    - frames/s of the depth-fed drive, unpipelined and pipelined
  7. stereo  - stereo-resident DeviceResidentMapping (the CLI's synthetic
               --stereo --sgm flow) over 30 KITTI-size pairs under the sync
               check: B5/B6 once per frame, no NaN, compaction, the depth
               check against the rendered depth, the peak device memory; the
               fused-census, plain and materialized-volume (B4) matchers build
               the same map, and the materialized drive's peak memory
  8. graph   - the drivers' captured programs (fuse_step.StepGraph and
               BankGraph) against eager references of the same drivers: B5
               captured alone keeps its cooperative attribute; the depth-fed
               (60 frames) and stereo (30 pairs) drives under the sync check
               after the first frame, a drive recapturing as max_keyframes
               grows 4 -> 16, a drive resumed from a checkpoint mid-drive and
               the 4-stream fleet, each torch.equal to its eager twin, with
               compaction and the loop warp replayed from their graphs;
               frames/s graphed vs eager (median of 3), host ms by stage,
               device busy/idle and operations per frame, capture ms and
               graph memory; the host-pool SurfelMapping (fuse step,
               compaction, migration append and extract, active warp on
               graphs) over the 60 frames with the compact and the padded
               upload, the 30 pairs with --sgm and 4 pairs of the B4
               matcher, each torch.equal (bank) and equal (pool) to its
               eager twin, its reads of the device confined to stats
               frames and migrations, graphed vs eager frames/s
  9. multi-kernels - B1-B3 with the stream axis: over every run_slic sweep
               of 4 distinct KITTI frames (and 3 frames of 120 x 56 at sp 6
               and 16) one launch for all streams, each stream equal to the
               single-frame kernel (torch.equal) and to the plain twin;
               device us per launch at B = 1 and B = 4; then B4-B6 with the
               stream axis on 4 KITTI pairs and a 61 x 97 crop of 3 (8 and
               4 paths, f32 and bf16 carries, B4 on the census volumes):
               one launch for all streams, each stream torch.equal to the
               single-stream kernel and the twin, the wrappers under
               torch.func.vmap equal to the batched call; device us per
               launch at B = 1 and B = 4
 10. multi   - MultiSessionMapping, 4 streams at the CLI's width (capacity
               2^21) over 24 rounds under the sync check: each SLIC kernel
               3x per round (not x B), no NaN, compaction, each session equal
               to a solo DeviceResidentMapping (1e-5 m), a loop warp of
               session 0 moving it alone, pipelined == eager; aggregate
               frames/s at B = 1, 2, 4, device ms, ops and idle share per
               round, peak device memory
 11. multi-stereo - the stereo fleet (--sgm), its round (the per-stream
               stereo step under torch.func.vmap) replayed from one
               captured graph, at 2 and 4 streams x 8 rounds: each session
               torch.equal to the eager fleet's, B5/B6 once per round for
               all streams and B1-B3 3x per round (profiler records), at B
               = 2 equal to solo stereo drives (1e-4 m); aggregate frames/s
               graphed vs eager, graph pool and peak memory; the
               materialized branch at B = 2 (B4 2x per round, graphed ==
               eager)
 12. batch   - fuse_frames_scan over 8 KITTI frames against 8 eager steps
               (torch.equal); fuse_frames_looped (K = 8, 8 laps: one lap
               captured in a CUDA graph and replayed) against the eager
               loop (trace and bank torch.equal), each SLIC kernel 3x per
               step in the profiler's records; the replay's device frames/s
               beside the eager loop's, and the call's peak memory
 13. sharded - the sharded drivers on a (1, 2) mesh of this card (2
               virtual shards), their mesh programs replayed from captured
               graphs, each torch.equal on every shard to an eager
               reference on the eager mesh programs before and after a
               loop warp, and equal to the dense drive within 1e-4 m:
               ShardedDeviceResidentMapping, 24 frames under the sync
               check after the first, replicated (SLIC 3x per frame per
               shard) and frame-sharded (the slabs run the plain SLIC
               functions), stereo over 4 pairs (B5/B6 once per frame per
               shard); ShardedSurfelMapping over the 60 host-pool frames,
               its reads confined to the stats, counts and extracts (pool
               arrays equal too); launches by the profiler's records,
               replays, captures, each MemPool's MiB (the dense host
               pool's too), graphed and eager frames/s (median of 3);
               sharded_sgm_disparity's graph on 2 shards (a 61 x 97 crop
               and KITTI size): its replays == its eager call == the
               replicated plain disparity; each virtual shard's passes run
               on a stream of its own (`sharding.cells`), forked and joined
               inside the graphs
 13b. multicard - on a machine with 2 or more cards (else one line saying
               so): the sharded drivers on make_mesh(n) and make_mesh(2 n)
               over every card, each mesh program one CUDA graph over the
               cards, torch.equal on every shard to the eager mesh
               programs on the same cards and to the same mesh on virtual
               shards of card 0, before and after a loop warp, == the
               dense drive (1e-4 m); per-card launches by the profiler's
               records, B5 cooperative on every card, the sharded SGM,
               make_mesh(n, data=2), entry.dryrun_multichip(n) and (2 n);
               graphed, eager and one-card virtual frames/s, busy ms, pool
               and peak MiB per card, the peer links
 14. cli     - the port's CLI in this process (cli.main, --device cuda) on
               KITTI-size frames: the native library is required; the
               host pack timed native vs numpy; synthetic --loop --eval
               (the seven outputs, MAE < 0.3 m, 3 SLIC launches of each
               kernel per frame + 3 for the segmentation render), the same
               with --host-pool (MAE < 0.3 m),
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
               (1e-5 m), and diagnose --fuse-frames 15 (every key,
               backend cuda, block_lies false); writes under build/cli/
 15. profile - device ms/frame of the stereo drive by fuse-step scope and
               of the SGM and SLIC kernels (the eager reference: a graph
               replay enters no profiler scope)
A replayed graph launches its kernels without calling their wrappers: the
launch checks of graphed runs read the profiler's kernel records beside the
wrappers' counts (`executed`, `check_runs`).  A kernel's time is its device
time from the profiler's records of that kernel (`kernel_time`), printed
beside the wrapper's host time per call; a plain twin's is CUDA events
around its calls.  The last lines are the
{"kernels": [...]} JSON, the nvidia-smi line, and the JSON object
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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


def drive(config, frames, device, pipelined: bool, sync_checked: bool,
          cls=None):
    """Feed the frames through DeviceResidentMapping (or `cls`, e.g. the
    eager reference of `eager_classes`; keyframe every 2nd frame); returns
    (driver, steady frames/s, `feed`)."""
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    drv = (cls or DeviceResidentMapping)(config, device=device,
                                         pipelined=pipelined)
    fps = feed(drv, frames, sync_checked)
    drv.close()
    return drv, fps


def steady(first, rest, flush, sync_checked: bool, n: int) -> float:
    """first(), then rest() under the sync check if asked (any host-device
    synchronisation there raises), flush() after each: the first frame or
    round captures the driver's step, which synchronises like a jit's first
    call, so the steady feed starts after it.  Returns the frames/s of
    rest() (n frames) to a device synchronize."""
    first()
    flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sync_checked:
        torch.cuda.set_sync_debug_mode("error")
    try:
        rest()
        flush()
    finally:
        if sync_checked:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def feed(drv, frames, sync_checked: bool) -> float:
    """Feed depth frames to a driver (keyframe every 2nd frame): the first
    frame, then the steady feed under the sync check if asked; returns the
    steady feed's frames/s (`steady`)."""
    def one(i):
        img, dep, pose = frames[i]
        drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        drv.feed_image(float(i), img)
        drv.feed_depth(float(i), dep)

    def rest():
        for i in range(1, len(frames)):
            one(i)

    return steady(lambda: one(0), rest, drv.flush, sync_checked,
                  len(frames) - 1)


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
    every live surfel by exactly that translation: the bank's and, for a
    host-pool driver, the inactive pool's."""
    before = drv._bank_host()
    pool_before = drv.pool.all_surfels()["position"]
    shift = np.eye(4)
    shift[:3, 3] = (0.25, -0.5, 1.0)
    loop_path = [shift @ kf.cam_pose for kf in drv.graph.keyframes]
    drv.feed_pose(1e6, shift @ drv.graph.keyframes[-1].cam_pose,
                  loop_path=loop_path)
    after = drv._bank_host()
    live = before["update_times"] > 0
    moved = [after["position"][live] - before["position"][live],
             drv.pool.all_surfels()["position"] - pool_before]
    err = float(max(np.abs(m - shift[:3, 3]).max(initial=0.0)
                    for m in moved))
    require(err < WARP_TOL_M, f"loop warp off by {err} m")
    return err


def make_pairs(config, n_frames: int):
    from densesurfelmapping_tpu_torch.io import synthetic
    poses = synthetic.forward_trajectory(n_frames + 3, step=0.4)[:n_frames]
    return [stereo_pair(config, p) + (p,) for p in poses]


def drive_stereo(config, pairs, device, scfg, sync_checked: bool,
                 cls=None):
    """Feed stereo pairs through DeviceResidentMapping (or `cls`) with the
    on-device matcher (keyframe every 2nd frame); returns (driver, steady
    frames/s)."""
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    drv = (cls or DeviceResidentMapping)(config, device=device)
    fps = feed_pairs(drv, pairs, scfg, sync_checked)
    drv.close()
    return drv, fps


def feed_pairs(drv, pairs, scfg, sync_checked: bool) -> float:
    """enable_stereo (KITTI baseline) and feed stereo pairs to a driver as
    `feed` feeds depth frames; returns the steady feed's frames/s."""
    drv.enable_stereo(bf=drv.config.camera.fx * BASELINE_M,
                      stereo_config=scfg)

    def one(i):
        li, ri, _, pose = pairs[i]
        drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        drv.feed_stereo(float(i), li, ri)

    def rest():
        for i in range(1, len(pairs)):
            one(i)

    return steady(lambda: one(0), rest, drv.flush, sync_checked,
                  len(pairs) - 1)


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
    """The stereo-resident drive: returns the device runs of the kernels
    in the fused drive and of B4 in the materialized-branch drive, and the
    rendered pairs."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import synthetic

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    scfg = sgm_config()
    t0 = time.perf_counter()
    pairs = make_pairs(cfg, N_STEREO_FRAMES)
    say("stereo", f"rendered {len(pairs)} pairs {cfg.height}x{cfg.width} in "
        f"{time.perf_counter() - t0:.1f} s")
    drive_stereo(cfg, pairs[:2], device, scfg, sync_checked=False)

    torch.cuda.reset_peak_memory_stats()
    (drv, fps), ex = executed(lambda: drive_stereo(cfg, pairs, device, scfg,
                                                   sync_checked=True))
    peak = torch.cuda.max_memory_allocated()
    say("stereo", f"peak device memory of the drive: {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated; the graph's capture included)")
    say("stereo", f"kernel launches in the drive: wrapper calls "
        f"{ex['calls']}, device runs {ex['runs']} (profiler kernel "
        f"records), {ex['captures']} graph captured")
    require(ex["captures"] == 1, f"stereo drive: {ex['captures']} captures")
    check_runs(ex, dict(sgm_census_x=1, sgm_census_y=1, sgm_axis_scan=0,
                        **{k: cfg.sp_iters for k in SLIC}),
               len(pairs), "stereo drive")
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
        f"sync (frames/s of the steady feed under the profiler)")

    cov, err = depth_check(cfg, pairs[0], device)
    require(err <= DEPTH_REL_ERR_BOUND and cov >= DEPTH_COVERAGE_FLOOR,
            f"depth check: coverage {cov:.4f} (floor "
            f"{DEPTH_COVERAGE_FLOOR}), median relative error {err:.4f} "
            f"(bound {DEPTH_REL_ERR_BOUND})")
    say("stereo", f"depth check, frame 0: coverage {cov:.4f} (floor "
        f"{DEPTH_COVERAGE_FLOOR}), median relative error {err:.5f} (bound "
        f"{DEPTH_REL_ERR_BOUND})")

    # the first 4 frames: fused kernels, plain path, materialized branch
    (fused, _), exf = executed(lambda: drive_stereo(cfg, pairs[:4], device,
                                                    scfg, False))
    check_runs(exf, dict(sgm_census_x=1), 4, "fused drive")
    plain, _ = drive_stereo(cfg, pairs[:4], device,
                            scfg._replace(sgm_pallas=False), False)
    torch.cuda.reset_peak_memory_stats()
    (mat, _), exm = executed(lambda: drive_stereo(
        cfg, pairs[:4], device, scfg._replace(sgm_fused_census=False),
        False))
    mat_peak = torch.cuda.max_memory_allocated()
    say("stereo", f"materialized-branch drive, 4 pairs: wrapper calls "
        f"{exm['calls']}, device runs {exm['runs']}; peak device memory "
        f"{mat_peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    check_runs(exm, dict(sgm_axis_scan=2, sgm_census_x=0, sgm_census_y=0),
               4, "materialized drive (B4 twice per frame)")
    rf = bank_to_numpy(fused.bank)
    require(same_bank(rf, bank_to_numpy(plain.bank)),
            "fused-kernel and plain stereo maps differ")
    require(same_bank(rf, bank_to_numpy(mat.bank)),
            "fused and materialized stereo maps differ")
    say("stereo", f"4 pairs: fused census (B6+B5), plain twins and the "
        f"materialized volume (B4) build the same map "
        f"({int((rf['update_times'] > 0).sum())} live surfels)")
    return dict(ex["runs"], sgm_axis_scan=exm["runs"]["sgm_axis_scan"]), pairs


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


# each wrapper's kernels, by the names of the profiler's kernel records
KERNEL_RECORDS = {
    "slic_assign": ("slic_assign_kernel",),
    "slic_centroid": ("slic_centroid_kernel",),
    "slic_huber": ("slic_huber_kernel",),
    "sgm_axis_scan": ("axis_line_kernel", "axis_band_kernel",
                      "scan_lines_kernel"),
    "sgm_census_y": ("census_y_kernel",),
    "sgm_census_x": ("census_x_kernel",)}


def raw_device_records(prof) -> list:
    """A profiler window's device records (kernels, copies and sets, not
    the scopes' device spans), raw: parsing them into FunctionEvents
    (`prof.events()`) takes seconds of host time per 100k records, and a
    drive leaves 100k-200k."""
    from torch.autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def device_record_names(prof) -> list:
    """(card, name) of each of a profiler window's device records."""
    return [(e.device_index(), e.name()) for e in raw_device_records(prof)]


class Records(list):
    """(card, name) of a window's device records, with the window's graph
    launches: `launches`, the host's cudaGraphLaunch records, and `lost`,
    those of them of whose replay the profiler kept no device record at
    all (a replay runs hundreds of operations, the kernels of the six
    wrappers among them; every graph node's record carries its launch's
    correlation id)."""
    launches = 0
    lost = 0


def fill_records(out: Records, prof) -> None:
    from torch.autograd import DeviceType
    seen, graphs = set(), set()
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            out.append((e.device_index(), e.name()))
            seen.add(e.correlation_id())
        elif "GraphLaunch" in e.name():
            graphs.add(e.correlation_id())
    out.launches, out.lost = len(graphs), len(graphs - seen)


# A counting window's edges.  The profiler keeps only the device records
# that it finds inside its window, and when the host is busy it may drop
# the records of whole graph replays as out of range (kineto's
# "Out-of-range" count), although the window synchronised on them: once
# the records of 17 frames of a 60-frame graphed drive, next to an edge;
# once, with the edges padded, those of 42 of its 60 frames.  So the body
# of a counting window starts and ends EDGE_PAD_S of host time away from
# the window's edges, and a window counts the graph launches whose replay
# left no record (`Records.lost`).
EDGE_PAD_S = 0.75


@contextlib.contextmanager
def device_records():
    """A profiler window over the body, which starts and ends EDGE_PAD_S
    from the window's edges; yields a `Records` that holds, after the
    block, (card, name) of the body's device records and its graph
    launches."""
    from torch.profiler import ProfilerActivity, profile
    names = Records()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_PAD_S)
        yield names
        torch.cuda.synchronize()
        time.sleep(EDGE_PAD_S)
    fill_records(names, prof)


def executed(fn):
    """fn() under the profiler (`device_records`), with every kernel count
    and the count of captured graphs set to 0 just before and read just
    after.  Returns (fn's result, {"calls": each wrapper's launches,
    "runs": each kernel's device runs by the profiler's kernel records,
    "card_runs": the same for each card, "captures": fuse steps captured,
    "programs": other bank programs captured (compaction, migration,
    warps: no kernel of the six runs in them), "launches" / "lost": the
    window's graph launches and those whose replay left no record}).  A
    captured step calls each wrapper twice per capture (the warm-up and
    the capture itself) and never again: its replays launch the kernels
    from the graph, and only the profiler sees them."""
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    with device_records() as records:
        for kind in FS.CAPTURES:
            FS.CAPTURES[kind] = 0
        res, calls = counted(fn)
    cards = sorted({c for c, _ in records})

    def runs_on(on):
        return {k: sum(any(p in n for p in parts)
                       for c, n in records if on(c))
                for k, parts in KERNEL_RECORDS.items()}
    return res, dict(calls=calls, runs=runs_on(lambda c: True),
                     card_runs={card: runs_on(lambda c: c == card)
                                for card in cards},
                     captures=FS.CAPTURES["steps"],
                     programs=FS.CAPTURES["programs"],
                     launches=records.launches, lost=records.lost)


def runs_floor(want: int, per_replay: int, lost: int) -> int:
    """The fewest device runs that a count of `want` may show: a replay
    that left no record (`Records.lost`, which also counts the bank
    programs' replays) takes its `per_replay` runs with it, and of the
    rest the profiler may miss a few records, near a window's edges, which
    `device_records` keeps the body away from, and on a long window of
    graph replays a buffer of them (on an H100, 3 of each SLIC kernel's 93
    in a 30-pair stereo drive, none in 6-pair drives): up to 5% (at least
    2), none extra."""
    left = want - per_replay * lost
    return max(left - max(2, left // 20), 0)


def check_runs(ex: dict, per: dict, steps: int, what: str,
               eager: int = 0) -> None:
    """A run of `steps` graph replays and `eager` eager steps over
    ex["captures"] captures: each kernel k of `per` launched per[k] times
    a step, so its wrapper was called per[k] (2 captures + eager) times
    and it ran per[k] (steps + captures + eager) times (a capture's
    warm-up runs, the capture itself does not).  The wrapper count is
    exact; the device runs are bounded by `runs_floor`, and a kernel of
    the run shows at least one.  That every replay ran every kernel is
    shown by the graphed map's equality with the eager one (the `graph`
    phase)."""
    c, lost = ex["captures"], ex["lost"]
    require(steps == 0 or lost < ex["launches"],
            f"{what}: {ex['launches']} graph launches, none of whose "
            f"replays left a device record")
    for k, n in per.items():
        calls, runs = n * (2 * c + eager), n * (steps + c + eager)
        require(ex["calls"][k] == calls
                and max(runs_floor(runs, n, lost), min(n, 1))
                <= ex["runs"][k] <= runs,
                f"{what}: {k} wrapper calls {ex['calls'][k]} (want "
                f"{calls}), device runs {ex['runs'][k]} (want {runs}; "
                f"{steps} replays, {c} captures, {eager} eager steps; "
                f"{ex['launches']} graph launches, {lost} of them left no "
                f"device record)")


@functools.lru_cache(maxsize=1)
def eager_classes():
    """The eager references of the graphed drivers, whose captured programs
    run op by op on the uploaded inputs, as they ran before they were
    captured: DeviceResidentMapping and MultiSessionMapping with the
    depth-fed and stereo steps (`fuse_step.fuse_frame_onebuf` /
    `fuse_frame_stereo_onebuf`, `multistream.batched_onebuf_step` /
    `batched_stereo_onebuf_step`), compaction and the loop warp
    (`fusion.compact_bank`, `warp_ops.warp_bank_by_pose`, the batched
    ones); the host-pool SurfelMapping with its fuse steps
    (`fuse_frame_compact`, `fuse_frame`, `fuse_frame_stereo_packed`),
    compaction, the migration append and extract and the active warp."""
    from densesurfelmapping_tpu_torch.core.state import (
        FrameInput, compact_frame, pad_frame)
    from densesurfelmapping_tpu_torch.ops import fusion, migration
    from densesurfelmapping_tpu_torch.ops import warp as warp_ops
    from densesurfelmapping_tpu_torch.parallel import multistream
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    from densesurfelmapping_tpu_torch.pipeline.driver import (
        SurfelMapping, _StereoPair)
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)

    class EagerDriver(DeviceResidentMapping):
        def _fuse_packed(self, buf):
            with self.timer.stage("dispatch"):
                _, stats = FS.fuse_frame_onebuf(self.config, self.bank,
                                                self._upload(buf))
            self._fused(stats)

        def _fuse_stereo_packed(self, buf):
            with self.timer.stage("dispatch"):
                _, stats = FS.fuse_frame_stereo_onebuf(
                    self.config, self._stereo_cfg, self._stereo_filter,
                    self.bank, self._upload(buf))
            self._fused(stats)

        def _do_compact(self):
            fusion.compact_bank(self.bank)
            self.compactions += 1

        def _apply_pose_warp(self, wstack, mstack):
            warp_ops.warp_bank_by_pose(
                self.bank, self._to_device(wstack), self._to_device(mstack),
                self._to_device(self._window_np), self._first_local)

    class EagerFleet(MultiSessionMapping):
        def _run_round(self, cfg, src):
            with self.timer.stage("upload"):
                payload = self._upload(src)
            with self.timer.stage("dispatch"):
                if self._stereo_cfg is not None:
                    return multistream.batched_stereo_onebuf_step(
                        cfg, self._stereo_cfg, self._stereo_filter,
                        self.banks, payload)
                return multistream.batched_onebuf_step(cfg, self.banks,
                                                       payload)

        def compact(self):
            self._flush_round()
            multistream.batched_compact(self.banks)
            self.compactions += 1

        def _apply_warps(self, wstack, mstack, masks, firsts):
            multistream.batched_warp(*(self.banks,) + tuple(
                torch.from_numpy(a).to(self.device)
                for a in (wstack, mstack, masks, firsts)))

    class EagerHostPool(SurfelMapping):
        def _fuse_frame(self, image, depth, pose, ref_index):
            pose_dev = self._to_device(
                np.asarray(pose, np.float32).reshape(4, 4))
            index = self._to_device(np.array(ref_index, np.int32))
            if isinstance(depth, _StereoPair):
                _, stats = FS.fuse_frame_stereo_packed(
                    self.config, self._stereo_cfg, self._stereo_filter,
                    self.bank, self._to_device(depth.buf), pose_dev, index,
                    self._to_device(np.array(self._stereo_bf, np.float32)))
            elif self.config.compact_upload:
                ci, cd = compact_frame(self.config, image, depth)
                _, stats = FS.fuse_frame_compact(
                    self.config, self.bank, self._to_device(ci),
                    self._to_device(cd), pose_dev, index)
            else:
                pi, pd = pad_frame(self.config,
                                   np.asarray(image, np.float32),
                                   np.asarray(depth, np.float32))
                _, stats = FS.fuse_frame(self.config, self.bank, FrameInput(
                    image=self._to_device(pi), depth=self._to_device(pd),
                    pose=pose_dev, frame_index=index))
            self._fuse_epilogue(stats)

        def _do_compact(self):
            fusion.compact_bank(self.bank)
            self.compactions += 1

        def _extract_chunk(self, ids):
            buf, n = migration.extract_by_pose(
                self.bank, self._to_device(ids), self.config.migration_buffer)
            n = int(n)
            if n == 0:
                return {}, 0
            return {k: v[:n].cpu().numpy() for k, v in buf.items()}, n

        def _append_hostslab(self, padded, n):
            mask = torch.arange(self.config.migration_buffer,
                                device=self.device) < n
            fusion.append_new(self.bank, {k: self._to_device(v)
                                          for k, v in padded.items()}, mask)

        def _apply_active_warp(self, warp):
            warp_ops.warp_active(self.bank, self._to_device(
                np.asarray(warp, np.float32)))

    return EagerDriver, EagerFleet, EagerHostPool


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

    # diagnose: one JSON line with the JAX package's keys
    (rc, out, _), ex = executed(lambda: run_cli(["diagnose", "--fuse-frames",
                                                 "15"]))
    add(ex["runs"])
    diag = json.loads(out.strip().splitlines()[-1])
    require(rc == 0 and set(diag) == {"backend", "dispatch_ms", "h2d_mbps",
                                      "fuse_ms", "block_lies", "healthy"},
            f"diagnose: rc {rc}, keys {sorted(diag)}")
    require(diag["backend"] == "cuda" and diag["block_lies"] is False,
            f"diagnose: {diag}")
    require(ex["captures"] == 1, f"diagnose: {ex['captures']} captures")
    check_runs(ex, {k: cfg.sp_iters for k in SLIC}, 17,
               "diagnose (one replay of the captured step per fused frame, "
               "17 frames)")
    say("cli", f"diagnose on the card: {json.dumps(diag)}; one graph "
        f"captured, device runs {ex['runs']}")

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
    (rc, out, _), ex = executed(lambda: run_cli(
        ["synthetic", "--frames", "60", "--loop", "--kf-every", "2", "--eval",
         "--out", loop]))
    add(ex["runs"])
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
    # + the _seg.png render, eager
    check_runs(ex, dict(sgm_census_x=0, sgm_census_y=0,
                        **{k: cfg.sp_iters for k in SLIC}), fused,
               f"synthetic --loop ({fused} frames + the segmentation "
               f"render)", eager=1)
    say("cli", f"synthetic --loop: rc 0, the seven outputs written, "
        f"{int(ckpt['bank_count'])} surfels in the checkpoint, MAE "
        f"{fid['mae']} m (< {LOOP_MAE_M}); {ex['captures']} graph(s) "
        f"captured, device runs {ex['runs']}")

    # the same with the host-pool driver (SurfelMapping on its graphs)
    hp = f"{CLI_DIR}/loop_host_pool"
    (rc, out, _), ex = executed(lambda: run_cli(
        ["synthetic", "--frames", "60", "--loop", "--kf-every", "2", "--eval",
         "--host-pool", "--out", hp]))
    add(ex["runs"])
    require(rc == 0, f"synthetic --loop --host-pool: rc {rc}")
    fid = cli_json(out, "fidelity: ")
    require(fid.get("mae", float("inf")) < LOOP_MAE_M,
            f"synthetic --loop --host-pool: fidelity MAE {fid.get('mae')} "
            f">= {LOOP_MAE_M}")
    fused = frames_fused(out)
    require(ex["captures"] == 1, f"synthetic --loop --host-pool: "
            f"{ex['captures']} fuse steps captured")
    check_runs(ex, dict(sgm_census_x=0, sgm_census_y=0,
                        **{k: cfg.sp_iters for k in SLIC}), fused,
               f"synthetic --loop --host-pool ({fused} frames + the "
               f"segmentation render)", eager=1)
    say("cli", f"synthetic --loop --host-pool: rc 0, MAE {fid['mae']} m "
        f"(< {LOOP_MAE_M}); 1 fuse step and {ex['programs']} bank "
        f"program(s) captured, device runs {ex['runs']}")

    # 3. stereo-resident, census SGM
    st = f"{CLI_DIR}/stereo"
    (rc, out, _), ex = executed(lambda: run_cli(
        ["synthetic", "--frames", "40", "--stereo", "--sgm", "--kf-every",
         "2", "--eval", "--out", st]))
    add(ex["runs"])
    require(rc == 0, f"synthetic --stereo --sgm: rc {rc}")
    fid = cli_json(out, "fidelity: ")
    require(fid.get("mae", float("inf")) < STEREO_MAE_M,
            f"synthetic --stereo --sgm: MAE {fid.get('mae')} >= "
            f"{STEREO_MAE_M}")
    fused = frames_fused(out)
    check_runs(ex, dict(sgm_census_x=1, sgm_census_y=1, sgm_axis_scan=0),
               fused, f"synthetic --stereo --sgm (B5/B6 once for each of "
               f"{fused} frames)")
    check_runs(ex, {k: cfg.sp_iters for k in SLIC}, fused,
               "synthetic --stereo --sgm (+ the segmentation render)",
               eager=1)
    say("cli", f"synthetic --stereo --sgm: rc 0, MAE {fid['mae']} m "
        f"(< {STEREO_MAE_M}); {ex['captures']} graph(s) captured, device "
        f"runs {ex['runs']}")

    # 4. the loop-closure stress run, depth-fed.  120 frames: at 48 the
    # post-correction MAE read above the pre-correction one on the card (the
    # two average different eval frames); the host renders this scene at
    # ~1.3 s a frame, ~170 s of the phase
    (rc, out, _), ex = executed(lambda: run_cli(
        ["stress", "--frames", "120", "--radius", "15", "--kf-every", "2",
         "--out", f"{CLI_DIR}/stress"]))
    add(ex["runs"])
    require(rc == 0, f"stress: rc {rc}")
    pre = cli_json(out, "fidelity pre-correction: ")
    post = cli_json(out, "fidelity post-correction:")
    require(post["mae"] < pre["mae"], f"stress: post-correction MAE "
            f"{post['mae']} not below pre-correction {pre['mae']}")
    require(ex["calls"]["slic_assign"] > 0 and ex["runs"]["slic_assign"]
            > ex["calls"]["slic_assign"], f"stress: launches {ex}")
    say("cli", f"stress: rc 0, MAE pre {pre['mae']} -> post {post['mae']} m; "
        f"{ex['captures']} graph(s) captured, device runs {ex['runs']}")

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
        (rc, _, _), ex = executed(lambda: run_cli(
            ["kitti", "--root", root, "--kf-every", "2",
             "--out", f"{CLI_DIR}/kitti"]))
        add(ex["runs"])
        (rc_r, _, _), ex_r = executed(lambda: run_cli(
            ["replay", "--feed", feed_path, "--root", root, "--out",
             f"{CLI_DIR}/replay"]))
        add(ex_r["runs"])
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    for tag, code, e in (("kitti", rc, ex), ("replay", rc_r, ex_r)):
        require(code == 0 and e["calls"]["slic_assign"] > 0
                and e["runs"]["slic_assign"] > 0,
                f"{tag}: rc {code}, launches {e}")

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
    (rc, out, _), ex = executed(lambda: run_cli(
        ["multi", "--streams", "4", "--frames", "20", "--out", mp]))
    add(ex["runs"])
    require(rc == 0, f"multi: rc {rc}")
    for k in range(4):
        for suffix in (".pcd", ".ckpt.npz"):
            path = f"{mp}_s{k}{suffix}"
            require(os.path.exists(path) and os.path.getsize(path) > 0,
                    f"multi: {path} missing or empty")
        require(int(np.load(f"{mp}_s{k}.ckpt.npz")["frames_fused"]) == 20,
                f"multi: session {k} did not fuse 20 frames")
    require(ex["captures"] == 1, f"multi: {ex['captures']} captures")
    check_runs(ex, {k: cfg.sp_iters for k in SLIC}, 20,
               "multi (one launch per sweep for the 4 streams, the round "
               "replayed from one graph)")
    say("cli", f"multi --streams 4 --frames 20: rc 0, per-session clouds "
        f"and checkpoints written; device runs {ex['runs']}")

    # 7. the stereo fleet through the CLI: its round replayed from a graph
    ms = f"{CLI_DIR}/multi_stereo"
    (rc, out, _), ex = executed(lambda: run_cli(
        ["multi", "--streams", "2", "--frames", "8", "--stereo", "--sgm",
         "--out", ms]))
    add(ex["runs"])
    require(rc == 0, f"multi --stereo: rc {rc}")
    require(ex["captures"] == 1, f"multi --stereo: {ex['captures']} "
            f"captures")
    check_runs(ex, dict(sgm_census_x=1, sgm_census_y=1, sgm_axis_scan=0,
                        **{k: cfg.sp_iters for k in SLIC}), 8,
               "multi --stereo --sgm (B5/B6 once and SLIC "
               f"{cfg.sp_iters}x per round for both streams, 8 rounds)")
    for k in range(2):
        require(int(np.load(f"{ms}_s{k}.ckpt.npz")["bank_count"]) > 0,
                f"multi --stereo: session {k}'s map is empty")
    say("cli", f"multi --streams 2 --frames 8 --stereo --sgm: rc 0; the "
        f"round replayed from 1 graph, device runs {ex['runs']}")

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
    """fn() with kernel `name` (SLIC or SGM) launched exactly once for all
    streams."""
    from densesurfelmapping_tpu_torch.ops.cuda import sgm, slic
    counts = (slic if name in slic.LAUNCHES else sgm).LAUNCHES
    n0 = counts[name]
    out = fn()
    require(counts[name] - n0 == 1, f"{name}: a batched call launched "
            f"{counts[name] - n0} times")
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

# the stream axis of each SGM kernel (the summary's "batched" route)
SGM_STREAM_ROUTES = {
    "sgm_census_x": "grid y = stream",
    "sgm_census_y": "2 nbands blocks (one per SM) walk the streams",
    "sgm_axis_scan": "line kernel grid y = stream; band kernel's blocks walk "
                     "the streams",
}


def check_multi_sgm(tag, cl, cr, min_d: int, n_d: int) -> None:
    """B6, B5 (8 and 4 paths) and B4 (x family, y family of 8 and 4 paths,
    on the materialized census volumes) with a leading stream axis, f32 and
    bf16 carries: one launch for all streams, each stream torch.equal to
    the single-stream kernel and to the plain twin; the wrappers under
    torch.func.vmap (the fleet's round) equal the explicit batched call."""
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops import sgm as P
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K
    scfg = sgm_config()
    p1, p2 = scfg.sgm_p1, scfg.sgm_p2
    n = cl.shape[0]

    def same(what, a, b):
        require(a.shape == b.shape and bool(torch.equal(a, b)),
                f"{what} ({tag}): differs (max abs err "
                f"{float((a - b).abs().max())})")

    for bf16 in (False, True):
        kx = one_launch("sgm_census_x", lambda: K.census_x(
            cl, cr, p1, p2, min_d, n_d, bf16))
        for k in range(n):
            same(f"sgm_census_x stream {k} bf16={bf16} vs single",
                 kx[k], K.census_x(cl[k], cr[k], p1, p2, min_d, n_d, bf16))
            same(f"sgm_census_x stream {k} bf16={bf16} vs twin", kx[k],
                 P.census_x_family(cl[k], cr[k], p1, p2, min_d, n_d, bf16))
        for v_rolls in ((0, 1, -1), (0,)):
            ky = one_launch("sgm_census_y", lambda: K.census_y(
                cl, cr, torch.zeros_like(kx), v_rolls, p1, p2, min_d, bf16))
            for k in range(n):
                same(f"sgm_census_y {v_rolls} stream {k} bf16={bf16} vs "
                     f"single", ky[k], K.census_y(
                         cl[k], cr[k], torch.zeros_like(kx[k]), v_rolls, p1,
                         p2, min_d, bf16))
                same(f"sgm_census_y {v_rolls} stream {k} bf16={bf16} vs "
                     f"twin", ky[k], P.census_y_family(
                         cl[k], cr[k], v_rolls, p1, p2, min_d, n_d, bf16))
            agg = functools.partial(K.census_aggregate, v_rolls=v_rolls,
                                    p1=p1, p2=p2, min_d=min_d, n_d=n_d,
                                    carry_bf16=bf16)
            vm = one_launch("sgm_census_y", lambda: one_launch(
                "sgm_census_x", lambda: torch.func.vmap(agg)(cl, cr)))
            same(f"census_aggregate {v_rolls} bf16={bf16} under vmap", vm,
                 kx + ky)
            # census_y under vmap adds into the batched out in place
            out = kx.clone()
            vy = one_launch("sgm_census_y", lambda: torch.func.vmap(
                lambda a, b, o: K.census_y(a, b, o, v_rolls, p1, p2, min_d,
                                           bf16))(cl, cr, out))
            same(f"census_y {v_rolls} bf16={bf16} under vmap", vy, vm)
            same(f"census_y {v_rolls} bf16={bf16} under vmap, in place",
                 out, vm)
    say("multi-kernels", f"sgm_census_x (B6) and sgm_census_y (B5, 8 and 4 "
        f"paths) on {tag}: one launch for the {n} streams, each stream "
        f"torch.equal to the single-stream kernel and the twin, f32 and bf16 "
        f"carries; census_aggregate under torch.func.vmap == the batched "
        f"call")
    vols = torch.stack([S._census_volume(cl[k], cr[k], min_d, n_d)
                        for k in range(n)])
    vx = vols.permute(0, 3, 2, 1).contiguous()     # scan over x
    vy = vols.permute(0, 2, 3, 1).contiguous()     # scan over y
    del vols
    for bf16 in (False, True):
        for v, r, e in ((vx, (0,), "x"), (vy, (0, 1, -1), "y"),
                        (vy, (0,), "y")):
            kb = one_launch("sgm_axis_scan", lambda: K.axis_scan(
                v, r, p1, p2, bf16, e, min_d))
            for k in range(n):
                # a stream's volume on its own, 16-byte aligned for the
                # single-stream launch
                one = v[k].clone()
                same(f"sgm_axis_scan {e} {r} stream {k} bf16={bf16} vs "
                     f"single", kb[k], K.axis_scan(one, r, p1, p2, bf16, e,
                                                   min_d))
                same(f"sgm_axis_scan {e} {r} stream {k} bf16={bf16} vs "
                     f"twin", kb[k], P.axis_scan(one, r, p1, p2, bf16, e,
                                                 min_d))
            vm = one_launch("sgm_axis_scan", lambda: torch.func.vmap(
                functools.partial(K.axis_scan, rolls=r, p1=p1, p2=p2,
                                  carry_bf16=bf16, entry=e,
                                  min_d=min_d))(v))
            same(f"sgm_axis_scan {e} {r} bf16={bf16} under vmap", vm, kb)
    say("multi-kernels", f"sgm_axis_scan (B4) on {tag}'s census volumes: x "
        f"family, y family of 8 and 4 paths, one launch for the {n} "
        f"streams, each stream torch.equal to the single-stream kernel and "
        f"the twin, f32 and bf16 carries; under torch.func.vmap == the "
        f"batched call")


def phase_multi_sgm(device) -> dict:
    """B4-B6 with the stream axis: the checks of check_multi_sgm on
    N_STREAMS KITTI pairs (n_d 127 from 1) and on a 61 x 97 crop of 3 of
    them (n_d 37 from 3), then device us per launch at B = 1 and B =
    N_STREAMS (kernel_time; B4's two families apart, the record their
    mean) beside the bound at B streams (B x one frame's bytes and
    operations), the wrapper's host us and the device operations of a
    call.  Returns {kernel: batched record}."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K
    cfg = kitti_config()
    scfg = sgm_config()
    census = []
    for pose in synthetic.forward_trajectory(N_STREAMS, step=0.4):
        li, ri, _ = stereo_pair(cfg, pose)
        census.append([S._census(torch.from_numpy(x).to(device).float(),
                                 scfg.census_radius) for x in (li, ri)])
    cl = torch.stack([c[0] for c in census])
    cr = torch.stack([c[1] for c in census])
    min_d = scfg.min_disparity
    n_d = scfg.max_disparity - min_d
    p1, p2 = scfg.sgm_p1, scfg.sgm_p2
    check_multi_sgm(f"{N_STREAMS} KITTI pairs", cl, cr, min_d, n_d)
    crop = (slice(0, 3), slice(150, 211), slice(300, 397))     # 61 x 97
    check_multi_sgm("a 61 x 97 crop of 3 pairs", cl[crop].contiguous(),
                    cr[crop].contiguous(), 3, 37)
    wide = check_wide_route(cl[crop][:2].contiguous(),
                            cr[crop][:2].contiguous())

    h, w = cl.shape[-2:]
    cells = n_d * h * w
    census_bytes = 2 * h * w * 4
    rolls = (0, 1, -1)
    vols = torch.stack([S._census_volume(cl[k], cr[k], min_d, n_d)
                        for k in range(N_STREAMS)])
    scans = {"x": (vols.permute(0, 3, 2, 1).contiguous(), (0,),
                   "axis_line_kernel"),
             "y": (vols.permute(0, 2, 3, 1).contiguous(), rolls,
                   "axis_band_kernel")}
    del vols
    buf = torch.zeros((N_STREAMS, n_d, h, w), dtype=torch.float32,
                      device=device)
    # (call of b streams, kernel records, one frame's bytes and operations,
    # as phase_sgm_kernels counts them)
    calls = {
        "sgm_census_x": (lambda b: K.census_x(cl[:b], cr[:b], p1, p2, min_d,
                                              n_d), ("census_x_kernel",),
                         (census_bytes + cells * 4, 2 * cells * 10)),
        "sgm_census_y": (lambda b: K.census_y(cl[:b], cr[:b], buf[:b],
                                              rolls, p1, p2, min_d),
                         ("census_y_kernel",),
                         (census_bytes + 2 * cells * 4, 6 * cells * 10)),
    }
    for e, (v, r, kname) in scans.items():
        calls[f"sgm_axis_scan {e}"] = (
            lambda b, v=v, r=r, e=e: K.axis_scan(v[:b], r, p1, p2, False, e,
                                                 min_d),
            (kname,), (cells * 2 + cells * 4, 2 * len(r) * cells * 10))
    times = {}
    for name, (call, kernels, one_frame) in calls.items():
        # 50 calls, up to 10 uncounted, as for B1-B3 above: the profiler
        # kept 16 of 20 records of B6 at B = 1 in three windows in a row
        # once (H100)
        t1 = kernel_time(lambda: call(1), kernels, reps=50, drop=10)
        tb = kernel_time(lambda: call(N_STREAMS), kernels, reps=50, drop=10)
        b = bound(*(N_STREAMS * x for x in one_frame))
        times[name] = dict(us_1=t1["us"], us_n=tb["us"],
                           us_n_min=tb["us_min"], us_n_max=tb["us_max"],
                           ops_n=tb["ops"], host_us_n=tb["host_us"], **b)
        say("multi-kernels", f"{name}: device {t1['us']:.2f} us/launch at "
            f"B = 1, {tb['us']:.2f} us/launch at B = {N_STREAMS} (min "
            f"{tb['us_min']:.2f}, max {tb['us_max']:.2f}; "
            f"{tb['us'] / N_STREAMS:.2f} us a stream), {tb['ops']:.2f} device "
            f"ops a call, wrapper host {tb['host_us']:.1f} us; bound at B = "
            f"{N_STREAMS} {1e3 * b['bound_ms']:.2f} us ({b['bound_by']})")
    fx, fy = times.pop("sgm_axis_scan x"), times.pop("sgm_axis_scan y")
    times["sgm_axis_scan"] = dict(
        {k: (fx[k] + fy[k]) / 2 for k in fx if k != "bound_by"},
        bound_by=("bytes" if fx["bound_by"] == fy["bound_by"] == "bytes"
                  else "operations"))
    out = {name: dict(t, streams=N_STREAMS, max_abs_err=0.0,
                      route=SGM_STREAM_ROUTES[name])
           for name, t in times.items()}
    out["sgm_axis_scan"]["wide_route"] = wide
    return out


WIDE_D = 150             # B4's wide route (128 < D <= 1024): the crop's D
WIDE_KERNELS = ("scan_lines_kernel", "combine_axis_kernel")


def check_wide_route(cl, cr) -> dict:
    """B4's wide route with a stream axis on the 61 x 97 crop of 2 pairs
    at D = WIDE_D from 3: x family and y family of 8 and 4 paths, f32 and
    bf16 carries, one call for both streams: each stream torch.equal to
    the single-stream call and to the twin, under torch.func.vmap == the
    batched call; 2 device launches a call (the line kernel and the
    combine pass, the profiler's records) whatever the streams; device us
    a call at B = 1 and B = 2 (the y family of 8 paths).  Returns those
    times."""
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops import sgm as P
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K
    scfg = sgm_config()
    p1, p2 = scfg.sgm_p1, scfg.sgm_p2
    n = cl.shape[0]
    vols = torch.stack([S._census_volume(cl[k], cr[k], 3, WIDE_D)
                        for k in range(n)])
    scans = ((vols.permute(0, 3, 2, 1).contiguous(), (0,), "x"),
             (vols.permute(0, 2, 3, 1).contiguous(), (0, 1, -1), "y"),
             (vols.permute(0, 2, 3, 1).contiguous(), (0,), "y"))
    del vols
    for v, r, e in scans:
        require(K.axis_plan(*v.shape[1:], r, K._sms(v.device),
                            n).route == "lines",
                f"D = {WIDE_D} does not take the wide route")
    calls = 0
    with device_records() as records:
        for bf16 in (False, True):
            for v, r, e in scans:
                kb = one_launch("sgm_axis_scan", lambda: K.axis_scan(
                    v, r, p1, p2, bf16, e, 3))
                calls += 1
                for k in range(n):
                    for what, want in (
                            ("single", K.axis_scan(v[k].clone(), r, p1, p2,
                                                   bf16, e, 3)),
                            ("twin", P.axis_scan(v[k], r, p1, p2, bf16, e,
                                                 3))):
                        require(bool(torch.equal(kb[k], want)),
                                f"wide sgm_axis_scan {e} {r} bf16={bf16} "
                                f"stream {k} != {what}")
                vm = torch.func.vmap(functools.partial(
                    K.axis_scan, rolls=r, p1=p1, p2=p2, carry_bf16=bf16,
                    entry=e, min_d=3))(v)
                require(bool(torch.equal(vm, kb)), f"wide sgm_axis_scan "
                        f"{e} {r} bf16={bf16} under vmap != batched")
                calls += 1 + n       # the vmap's call and the singles
    # each call runs each of the two kernels once: the profiler may miss a
    # record or two of a window (`runs_floor`)
    launched = {k: sum(k in name for _, name in records)
                for k in WIDE_KERNELS}
    require(all(runs_floor(calls, 1, records.lost) <= v <= calls
                for v in launched.values()), f"wide route: device records "
            f"{launched} for {calls} calls, want one of each a call")
    v, r, _ = scans[1]
    t = {b: kernel_time(lambda b=b: K.axis_scan(v[:b], r, p1, p2, False,
                                                "y", 3), WIDE_KERNELS)
         for b in (1, n)}
    say("multi-kernels", f"sgm_axis_scan (B4) wide route, D = {WIDE_D} "
        f"on the 61 x 97 crop of {n} pairs: one call for the {n} streams "
        f"(scan_lines_kernel grid z = stream, one combine pass), each "
        f"stream torch.equal to the single-stream call and the twin, x and "
        f"y families of 8 and 4 paths, f32 and bf16 carries, under vmap == "
        f"the batched call; device records {launched} for {calls} calls "
        f"(one of each kernel a call); "
        f"y family of 8 paths: device {t[1]['us']:.2f} us a call at B = 1, "
        f"{t[n]['us']:.2f} at B = {n} (min {t[n]['us_min']:.2f}, max "
        f"{t[n]['us_max']:.2f}); scratch {4 * 2 * 3 * n * 61 * 97 * WIDE_D} "
        f"B at B = {n}")
    return dict(streams=n, d=WIDE_D, us_1=t[1]["us"], us_n=t[n]["us"])


def fleet_rows(multi, k: int) -> dict:
    """Every allocated row of session k."""
    return multi.session_surfels(k, min_updates=0)


def drive_fleet(config, frames, device, n_streams: int, rounds: int,
                pipelined: bool = False, sync_checked: bool = False,
                cls=None):
    """MultiSessionMapping (or `cls`) over `rounds` rounds: stream k fuses
    frames k, k + 1, ... (keyframe every 2nd round); the first round, then
    the steady rounds under the sync check if asked.  Returns (fleet,
    aggregate frames/s of the steady rounds, `steady`)."""
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)
    multi = (cls or MultiSessionMapping)(config, n_streams,
                                         pipelined=pipelined, device=device)

    def round_(i):
        for k in range(n_streams):
            img, dep, pose = frames[k + i]
            multi.feed_pose(k, float(i), pose, is_keyframe=(i % 2 == 0))
            multi.feed_image(k, float(i), img)
            multi.feed_depth(k, float(i), dep)
        multi.step()

    def rest():
        for i in range(1, rounds):
            round_(i)

    fps = steady(lambda: round_(0), rest, multi.flush_rounds, sync_checked,
                 n_streams * (rounds - 1))
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
    (multi, fps4), ex = executed(lambda: drive_fleet(
        cfg, frames, device, B, N_ROUNDS, sync_checked=True))
    peak = torch.cuda.max_memory_allocated()
    say("multi", f"{B} streams x {N_ROUNDS} rounds: wrapper calls "
        f"{ex['calls']}, device runs {ex['runs']}, {ex['captures']} graph "
        f"captured; steady feed raised no host-device sync; peak device "
        f"memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated; "
        f"banks {B} x 2^21 rows, the capture's scratch clone included)")
    require(ex["captures"] == 1, f"fleet: {ex['captures']} captures")
    check_runs(ex, dict(sgm_census_x=0, sgm_census_y=0,
                        **{k: cfg.sp_iters for k in SLIC}), N_ROUNDS,
               f"fleet (SLIC {cfg.sp_iters}x per round, not x {B})")
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
        f"unpipelined; sync-checked drive under the profiler {fps4:.2f} "
        f"({smi}; steady rounds, after the first)")

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
    return dict(launches=ex["runs"], rates=rates)


def stereo_round(multi, pairs, n_streams: int):
    """round_(i): stream k of a stereo fleet fuses pair k + i (keyframe
    every 2nd round)."""
    def round_(i):
        for k in range(n_streams):
            li, ri, _, pose = pairs[k + i]
            multi.feed_pose(k, float(i), pose, is_keyframe=(i % 2 == 0))
            multi.feed_stereo(k, float(i), li, ri)
        multi.step()
    return round_


def drive_stereo_fleet(config, pairs, device, n_streams: int, rounds: int,
                       sync_checked: bool = False, cls=None,
                       scfg=None) -> tuple:
    """A stereo MultiSessionMapping (or `cls`) with the CLI's --sgm matcher
    (or `scfg`) over `rounds` rounds: stream k fuses pairs k, k + 1, ...
    (keyframe every 2nd round); the first round (its capture), then the
    steady rounds under the sync check if asked.  Returns (fleet, aggregate
    frames/s of the steady rounds)."""
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)
    multi = (cls or MultiSessionMapping)(config, n_streams, device=device)
    multi.enable_stereo(bf=config.camera.fx * BASELINE_M,
                        stereo_config=scfg or sgm_config())
    round_ = stereo_round(multi, pairs, n_streams)

    def rest():
        for i in range(1, rounds):
            round_(i)

    fps = steady(lambda: round_(0), rest, multi.flush_rounds, sync_checked,
                 n_streams * (rounds - 1))
    return multi, fps


def phase_multi_stereo(device, pairs, smi: str) -> dict:
    """The stereo fleet with the CLI's --sgm matcher, its round replayed
    from one captured graph (`multistream.graphed_stereo_onebuf_step`), at
    B = 2 and 4 streams x N_STEREO_ROUNDS rounds under the sync check after
    the first round: each session torch.equal to the eager fleet's
    (`eager_classes`); B5 and B6 once per round for all streams (the
    matcher runs under the round's vmap, as the JAX fleet's) and the SLIC
    kernels once per sweep (3 times) per round, by the profiler's kernel
    records; at B = 2 each session within 1e-4 m of a solo stereo
    DeviceResidentMapping.  Then a B = 2 drive of the materialized branch
    (`sgm_fused_census=False`): B4 twice per round (x and y family, each
    one batched launch), graphed == eager.  Measures aggregate frames/s
    graphed and eager (median of N_RATE), the graphed round's wall and
    device busy ms, idle share and device operations (N_PROF rounds under
    the profiler), the capture, the graph pool and the peak device memory.
    Returns the device runs of the kernels in its graphed drives."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.parallel.multistream import stream_bank
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)

    _, EagerFleet, _ = eager_classes()
    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    R = N_STEREO_ROUNDS
    total: dict = {}
    for B in (2, 4):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (g, _), ex = executed(lambda: drive_stereo_fleet(
            cfg, pairs, device, B, R, sync_checked=True))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        held = pool_mib(g._graph_pool) * 2**20
        for k, v in ex["runs"].items():
            total[k] = total.get(k, 0) + v
        require(ex["captures"] == 1, f"stereo fleet B={B}: "
                f"{ex['captures']} captures")
        check_runs(ex, dict(sgm_census_x=1, sgm_census_y=1, sgm_axis_scan=0,
                            **{k: cfg.sp_iters for k in SLIC}), R,
                   f"stereo fleet B={B} (B5/B6 once for the {B} streams, "
                   f"SLIC {cfg.sp_iters}x per round)")
        e, e_fps = drive_stereo_fleet(cfg, pairs, device, B, R,
                                      cls=EagerFleet)
        for k in range(B):
            require(same_banks(stream_bank(g.banks, k),
                               stream_bank(e.banks, k)),
                    f"stereo fleet B={B}: graphed session {k} != the eager "
                    f"fleet's (torch.equal)")
        errs = []
        if B == 2:
            for k in range(B):
                solo, _ = drive_stereo(cfg, pairs[k:k + R], device,
                                       sgm_config(), False)
                errs.append(same_rows_within(
                    fleet_rows(g, k), bank_to_numpy(solo.bank),
                    STEREO_FLEET_TOL_M, f"stereo fleet session {k} vs a solo "
                    f"stereo DeviceResidentMapping"))
        capture_ms = g._round.capture_ms
        del g, e
        # the eager reference's drive is the first eager sample
        fps = {"graphed": [], "eager": [e_fps]}
        for _ in range(N_RATE):
            for name, cls in (("graphed", MultiSessionMapping),
                              ("eager", EagerFleet)):
                if len(fps[name]) < N_RATE:
                    fps[name].append(drive_stereo_fleet(
                        cfg, pairs, device, B, R, cls=cls)[1])
        med = {k: sorted(v)[1] for k, v in fps.items()}
        f = MultiSessionMapping(cfg, B, device=device)
        f.enable_stereo(bf=cfg.camera.fx * BASELINE_M,
                        stereo_config=sgm_config())
        say("multi-stereo", prof_line(
            f"B = {B} graphed, {N_PROF} rounds under the profiler after 2",
            profiled(stereo_round(f, pairs, B), 2, N_PROF), "round"))
        del f
        solo = (f"; each session within {max(errs):.3g} m of a solo stereo "
                f"drive (bound {STEREO_FLEET_TOL_M})" if errs else "")
        say("multi-stereo", f"B = {B} streams x {R} rounds (2^19 rows per "
            f"stream): each session torch.equal to the eager fleet's; 1 "
            f"round capture ({capture_ms:.1f} ms, warm-up + capture, host "
            f"clock), device runs {ex['runs']} (B5/B6 once and each SLIC "
            f"kernel {cfg.sp_iters}x per round for the {B} streams); steady "
            f"rounds raised no host-device sync{solo}")
        say("multi-stereo", f"B = {B}: aggregate {med['graphed']:.2f} "
            f"frames/s graphed, {med['eager']:.2f} eager (median of {N_RATE} "
            f"drives of {R} rounds, steady after the first: graphed "
            + ", ".join(f"{x:.2f}" for x in sorted(fps["graphed"]))
            + "; eager " + ", ".join(f"{x:.2f}" for x in sorted(fps["eager"]))
            + f"); graph pool {held / 2**20:.1f} MiB, peak device memory "
            f"{peak:.1f} MiB above what was allocated (banks, capture and "
            f"drive; torch.cuda.max_memory_allocated) ({smi})")

    # the materialized branch: B4's x and y family, each one batched
    # launch per round
    B = 2
    mcfg = sgm_config()._replace(sgm_fused_census=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (g, fps), ex = executed(lambda: drive_stereo_fleet(
        cfg, pairs, device, B, R, sync_checked=True, scfg=mcfg))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    add_runs(total, ex["runs"])
    require(ex["captures"] == 1, f"materialized stereo fleet: "
            f"{ex['captures']} captures")
    check_runs(ex, dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=2,
                        **{k: cfg.sp_iters for k in SLIC}), R,
               f"materialized stereo fleet B={B} (B4 2x, SLIC "
               f"{cfg.sp_iters}x per round)")
    e, _ = drive_stereo_fleet(cfg, pairs, device, B, R, cls=EagerFleet,
                              scfg=mcfg)
    for k in range(B):
        require(same_banks(stream_bank(g.banks, k), stream_bank(e.banks, k)),
                f"materialized stereo fleet: graphed session {k} != the "
                f"eager fleet's (torch.equal)")
    say("multi-stereo", f"materialized branch (sgm_fused_census=False), B = "
        f"{B} x {R} rounds: each session torch.equal to the eager fleet's; "
        f"device runs {ex['runs']} (B4 2x per round for both streams); "
        f"{fps:.2f} frames/s graphed (one drive); peak device memory "
        f"{peak:.1f} MiB above what was allocated ({smi})")
    del g, e
    return total


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
    measurement: it prints what the profiler reports and checks nothing).
    The scopes are host-side `record_function` spans, which a graph replay
    does not enter, so this profiles the eager reference drive
    (`eager_classes`) of the same frames; the `graph` phase profiles the
    graphed drive for its wall time, idle share and operations."""
    from torch.profiler import ProfilerActivity, profile
    from densesurfelmapping_tpu_torch.config import kitti_config

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    pairs = make_pairs(cfg, 8)
    drv = eager_classes()[0](cfg, device=device)
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
    say("profile", f"{n} stereo frames of the eager reference under the "
        f"profiler: wall "
        f"{1e3 * wall / n:.2f} ms/frame, device busy {busy_us / n / 1e3:.2f} "
        f"ms/frame, idle share {1 - busy_us / 1e6 / wall:.3f}, "
        f"{len(device) / n:.0f} device operations/frame")
    for key in ("dsm.stereo_aggregate", "dsm.stereo_wta", "dsm.depth_filter",
                "dsm.superpixel", "dsm.planefit", "dsm.fuse", "dsm.append"):
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


N_GROW = 24             # frames of the recapturing drive: 12 keyframes
                        # grow max_keyframes 4 -> 8 -> 16 (3 captures)
N_RESUME = 12           # frames before and after the checkpoint load
N_RATE = 3              # drives per rate: median and spread
N_PROF = 8              # profiled frames (rounds), after 2 unprofiled


def same_banks(a, b) -> bool:
    """torch.equal on every bank field and on count."""
    from densesurfelmapping_tpu_torch.core.state import FIELDS
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in FIELDS + ("count",))


def graph_kernel_nodes(fn) -> list:
    """fn() (run once first, outside the capture) captured into a CUDA
    graph kept for inspection: (grid x, block x, cooperative attribute) of
    each kernel node, read through the driver API."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return [node[:3] for node in kernel_nodes(graph)]


def kernel_nodes(graph) -> list:
    """(grid x, block x, cooperative attribute, CUDA context) of each
    kernel node of a graph kept for inspection (keep_graph=True), read
    through the driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(err, what):
        require(err == 0, f"{what} failed with CUDA driver error {err}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:                      # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func, gridDim x y z, blockDim x y z,
        # shared bytes, params, extra, kern, then the context at byte 64
        params = (ctypes.c_ubyte * 128)()
        ok(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params),
           "cuGraphKernelNodeGetParams_v2")
        value = (ctypes.c_ubyte * 64)()          # CUlaunchAttributeValue
        ok(cu.cuGraphKernelNodeGetAttribute(ctypes.c_void_p(node), 2, value),
           "cuGraphKernelNodeGetAttribute(COOPERATIVE)")
        word = [int.from_bytes(bytes(b[i:i + n]), "little")
                for b, i, n in ((params, 8, 4), (params, 20, 4),
                                (value, 0, 4), (params, 64, 8))]
        out.append(tuple(word))
    return out


def card_contexts(cards) -> dict:
    """{primary CUDA context: card index} of the given cards (PyTorch runs
    each card on its primary context)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    out = {}
    for k in cards:
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        require(cu.cuDeviceGet(ctypes.byref(dev), k) == 0
                and cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)
                == 0, f"no primary context of card {k}")
        out[ctx.value] = k
    return out


def profiled(step, n_warm: int, n: int) -> dict:
    """step(i) for i < n_warm, then n more under the profiler: wall ms,
    device busy ms and device operations per step, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(n_warm):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, busy_us = device_activity(prof.events())
    return dict(wall_ms=1e3 * wall / n, busy_ms=busy_us / n / 1e3,
                idle=1 - busy_us / 1e6 / wall, ops=len(dev) / n)


def prof_line(tag: str, p: dict, unit: str = "frame") -> str:
    return (f"{tag}: wall {p['wall_ms']:.2f} ms/{unit}, device busy "
            f"{p['busy_ms']:.2f} ms/{unit}, idle share {p['idle']:.3f}, "
            f"{p['ops']:.0f} device operations/{unit}")


def steps_of(drv, frames, pairs=None, streams: int = 0):
    """step(i) feeding frame (pair, fleet round) i to a driver, and its
    flush."""
    def depth(i):
        img, dep, pose = frames[i]
        drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        drv.feed_image(float(i), img)
        drv.feed_depth(float(i), dep)

    def stereo(i):
        li, ri, _, pose = pairs[i]
        drv.feed_pose(float(i), pose, is_keyframe=(i % 2 == 0))
        drv.feed_stereo(float(i), li, ri)

    def round_(i):
        for k in range(streams):
            img, dep, pose = frames[k + i]
            drv.feed_pose(k, float(i), pose, is_keyframe=(i % 2 == 0))
            drv.feed_image(k, float(i), img)
            drv.feed_depth(k, float(i), dep)
        drv.step()

    if streams:
        return round_, drv.flush_rounds
    return (stereo if pairs is not None else depth), drv.flush


def first_step_memory(drv, step, flush) -> dict:
    """The first step of a fresh driver (warm-up and capture of its
    graph): peak device memory allocated above what was allocated before,
    and the device memory the driver's graph pool holds after it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(0)
    flush()
    torch.cuda.synchronize()
    return dict(peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                pool_mib=pool_mib(drv._graph_pool))


@contextlib.contextmanager
def captures_timed():
    """Within, every graph capture starts after a device synchronize, and
    the host seconds of the capture itself (its warm-up run and the
    capture) are summed into the yielded list's one entry, so that a rate
    can take a capture at a program's first use out of a steady feed; the
    drain of the work queued before it stays in the rate."""
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    spent = [0.0]
    capture = FS.capture

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return capture(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0

    FS.capture = timed
    try:
        yield spent
    finally:
        FS.capture = capture


def rated(make, frames, pairs, streams: int, n: int) -> tuple:
    """A fresh driver's steady feed of steps 1..n-1 after its first step:
    (frames/s with the graph captures in the feed taken out (`captures_
    timed`: compaction's, at its first use), host ms per frame or round by
    StageTimer stage)."""
    from densesurfelmapping_tpu_torch.utils.timing import StageTimer
    drv = make()
    step, flush = steps_of(drv, frames, pairs, streams)
    step(0)
    flush()
    torch.cuda.synchronize()
    drv.timer = StageTimer()
    with captures_timed() as spent:
        t0 = time.perf_counter()
        for i in range(1, n):
            step(i)
        flush()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0 - spent[0]
    return max(streams, 1) * (n - 1) / secs, drv.timer.means_ms()


HOST_POOL_LOOP = 40     # this frame's keyframe links back to keyframe 1
HOST_POOL_SLACK = 1 << 12   # compaction_slack of the host-pool drives
N_B4_PAIRS = 4          # pairs of the host-pool drive of the B4 matcher
HOST_POOL_READS = ("sync_stats", "_bank_count", "_extract_chunk")


@contextlib.contextmanager
def reads_allowed(drv, names=HOST_POOL_READS):
    """Within the sync check, let the driver's methods `names` and every
    graph capture synchronise: the reads the host-pool driver makes by
    design (the stats and the bank's count at stats frames, the match
    count of a migration: the JAX driver makes the same reads) and a
    capture's first-call synchronisation; the rest of the feed must raise
    none.  Yields {name: calls}, "capture" included."""
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    calls = dict.fromkeys(names + ("capture",), 0)

    def allow(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return run

    for name in names:
        setattr(drv, name, allow(name, getattr(drv, name)))
    capture = FS.capture
    FS.capture = allow("capture", capture)
    try:
        yield calls
    finally:
        FS.capture = capture
        for name in names:
            delattr(drv, name)


def host_pool_feeder(drv, frames, pairs=None):
    """one(i): feed depth frame (or stereo pair) i to a host-pool driver,
    keyframe every 2nd frame; frame HOST_POOL_LOOP's keyframe carries a
    loop edge back to keyframe 1, which brings its window's keyframes back
    from the pool (the migration append)."""
    def one(i):
        kf = i % 2 == 0
        edges = [(i // 2, 1)] if kf and i == HOST_POOL_LOOP else ()
        if pairs is not None:
            li, ri, _, pose = pairs[i]
            drv.feed_pose(float(i), pose, is_keyframe=kf, loop_edges=edges)
            drv.feed_stereo(float(i), li, ri)
            return
        img, dep, pose = frames[i]
        drv.feed_pose(float(i), pose, is_keyframe=kf, loop_edges=edges)
        drv.feed_image(float(i), img)
        drv.feed_depth(float(i), dep)
    return one


def drive_host_pool(cls, config, device, frames, pairs=None, scfg=None,
                    sync_checked=False, mesh=None) -> tuple:
    """A host-pool driver (over `mesh` if given: the sharded one) over the
    frames (or pairs), the feed after the first frame under the sync check
    if asked, with the driver's reads allowed (`reads_allowed`).  Returns
    (driver, steady frames/s with the graph captures in the feed taken out
    (`captures_timed`), host ms per frame by StageTimer stage, {read:
    calls, "frames": frames after the first, "reading": those of them that
    read the device})."""
    from densesurfelmapping_tpu_torch.utils.timing import StageTimer
    drv = (cls(config, device=device) if mesh is None
           else cls(config, mesh))
    if scfg is not None:
        drv.enable_stereo(bf=config.camera.fx * BASELINE_M,
                          stereo_config=scfg)
    one = host_pool_feeder(drv, frames, pairs)
    n = len(pairs if pairs is not None else frames)
    reading = [0]
    # captures_timed outside reads_allowed: its synchronize runs with the
    # sync check off
    with captures_timed() as spent, reads_allowed(drv) as calls:
        def first():
            one(0)
            drv.timer = StageTimer()
            spent.append(spent[0])      # the first frame's capture

        def rest():
            for i in range(1, n):
                before = sum(calls.values())
                one(i)
                reading[0] += sum(calls.values()) > before

        fps = steady(first, rest, lambda: None, sync_checked, n - 1)
    secs = (n - 1) / fps - (spent[0] - spent[1])
    return (drv, (n - 1) / secs, drv.timer.means_ms(),
            dict(calls, frames=n - 1, reading=reading[0]))


def same_pool(a, b) -> bool:
    """The two host pools hold the same slabs, array for array."""
    return set(a.slabs) == set(b.slabs) and all(
        np.array_equal(a.slabs[k][f], b.slabs[k][f])
        for k in a.slabs for f in a.slabs[k])


def phase_graph_host_pool(device, frames, pairs, smi: str) -> dict:
    """The host-pool SurfelMapping on its graphs (fuse step, compaction,
    migration append and extract, active warp) against its eager reference
    (`eager_classes`): the depth-fed drive over the frames with the compact
    upload and with the padded f32 upload, the stereo drive over the pairs
    with the CLI's --sgm matcher, and N_B4_PAIRS pairs with the
    materialized matcher (B4), each under the sync check with the
    driver's reads allowed; the bank torch.equal and the pool's arrays
    equal, before and after a loop warp; graphed and eager frames/s
    (median of N_RATE), host ms by stage, captures.  Returns the device
    runs of the kernels in its graphed drives."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping

    _, _, EagerHostPool = eager_classes()
    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16,
                       compaction_slack=HOST_POOL_SLACK)
    scfg = sgm_config()
    slic = {k: cfg.sp_iters for k in SLIC}
    no_sgm = dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=0)
    total: dict = {}
    drives = (
        ("depth-fed, compact upload", cfg, frames, None, None,
         dict(no_sgm, **slic)),
        ("depth-fed, padded f32 upload",
         dataclasses.replace(cfg, compact_upload=False), frames, None, None,
         dict(no_sgm, **slic)),
        ("stereo --sgm", cfg, None, pairs, scfg,
         dict(slic, sgm_census_x=1, sgm_census_y=1, sgm_axis_scan=0)),
        ("stereo, materialized volume (B4)", cfg, None, pairs[:N_B4_PAIRS],
         scfg._replace(sgm_fused_census=False),
         dict(slic, sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=2)))
    for tag, c, fr, pr, sc, per in drives:
        n = len(pr if pr is not None else fr)
        (g, _, _, reads), ex = executed(lambda: drive_host_pool(
            SurfelMapping, c, device, fr, pr, sc, sync_checked=True))
        for k, v in ex["runs"].items():
            total[k] = total.get(k, 0) + v
        require(ex["captures"] == 1, f"host pool {tag}: {ex['captures']} "
                f"fuse steps captured")
        check_runs(ex, per, n, f"host pool {tag}")
        e, e_fps, e_stages, _ = drive_host_pool(EagerHostPool, c, device,
                                                fr, pr, sc)
        require(same_banks(g.bank, e.bank) and same_pool(g.pool, e.pool),
                f"host pool {tag}: graphed != eager (bank torch.equal, pool "
                f"arrays equal)")
        rows = g._bank_host()
        for k in ("position", "normal", "size", "weight"):
            require(bool(np.isfinite(rows[k]).all()),
                    f"host pool {tag}: NaN/Inf in bank.{k}")
        werr = check_warp(g)
        check_warp(e)
        require(same_banks(g.bank, e.bank) and same_pool(g.pool, e.pool),
                f"host pool {tag}: after the loop warp graphed != eager")
        replays = {name: getattr(g, f"_{name}_graph").replays for name in
                   ("compact", "extract", "append", "warp")}
        require(replays["warp"] == 1 and replays["compact"] == g.compactions,
                f"host pool {tag}: replays {replays}, {g.compactions} "
                f"compactions")
        if n > HOST_POOL_LOOP:     # the full depth-fed drives
            require(g.compactions > 0 and replays["extract"] > 0
                    and replays["append"] > 0 and len(g.pool) > 0,
                    f"host pool {tag}: compaction, migration or "
                    f"re-activation missing: replays {replays}, pool "
                    f"{len(g.pool)}")
        # the eager reference's drive is the first eager sample
        fps = {"graphed": [], "eager": [e_fps]}
        stages = {"eager": e_stages}
        for _ in range(N_RATE):
            for name, cls in (("graphed", SurfelMapping),
                              ("eager", EagerHostPool)):
                if len(fps[name]) < N_RATE:
                    _, r, stages[name], _ = drive_host_pool(cls, c, device,
                                                            fr, pr, sc)
                    fps[name].append(r)
        med = {k: sorted(v)[1] for k, v in fps.items()}
        say("graph", f"host pool {tag}, {n} frames: bank torch.equal and "
            f"pool ({len(g.pool)} surfels, {len(g.pool.slabs)} keyframes) "
            f"equal to the eager reference's, before and after a loop warp "
            f"(within {werr:.2e} m of the shift); replays {replays} "
            f"({g.compactions} compactions); captures: 1 fuse step "
            f"({(g._stereo_graph or g._fuse_graph).capture_ms:.1f} ms) + "
            f"{ex['programs']} bank programs in the feed; device runs "
            f"{ex['runs']}; sync check: {reads['frames'] - reads['reading']} "
            f"of {reads['frames']} frames after the first read nothing, the "
            f"rest only in {', '.join(f'{k} x{reads[k]}' for k in HOST_POOL_READS + ('capture',))}")
        for name in fps:
            say("graph", f"host pool {tag} {name}: {med[name]:.2f} frames/s "
                f"(median of {N_RATE} drives, steady after the first frame"
                f", graph captures taken out: "
                + ", ".join(f"{x:.2f}" for x in sorted(fps[name]))
                + f"); host ms per frame by stage: "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            sorted(stages[name].items())) + f" ({smi})")
        del g, e
    return total


def phase_graph(device, frames, pairs, smi: str) -> dict:
    """The drivers' captured steps (`fuse_step.StepGraph`) against their
    eager references (`eager_classes`): B5's cooperative node under
    capture; the depth-fed drive (60 frames) and the stereo drive (30
    pairs) under the sync check after the first frame, torch.equal to the
    eager drives, with the map, warp and launch checks; a drive whose
    keyframes outgrow max_keyframes (recaptures mid-drive) and a drive
    resumed from a checkpoint mid-drive, each torch.equal to its eager
    twin; the 4-stream fleet, each session torch.equal to the eager
    fleet's.  Measures graphed against eager frames/s (median of 3 drives),
    host ms by stage, device busy/idle share and operations per frame,
    capture ms, captures per drive and each graph's memory.  Returns the
    device runs of the kernels in its graphed runs."""
    import os
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import bank_to_numpy
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.models import stereo as ST
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as KS
    from densesurfelmapping_tpu_torch.parallel.multistream import stream_bank
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping)
    from densesurfelmapping_tpu_torch.pipeline.multi_session import (
        MultiSessionMapping)

    Eager, EagerFleet, _ = eager_classes()
    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    cfg_f = kitti_config(surfel_capacity=1 << 21, compact_interval=16)
    scfg = sgm_config()
    ground_y = synthetic.default_scene().ground_y
    slic = {k: cfg.sp_iters for k in SLIC}
    no_sgm = dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=0)
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # B5 alone in a CUDA graph: the cooperative launch stays cooperative
    li, ri, _, _ = pairs[0]
    cl = ST._census(torch.from_numpy(li).to(device).float(),
                    scfg.census_radius)
    cr = ST._census(torch.from_numpy(ri).to(device).float(),
                    scfg.census_radius)
    n_d = scfg.max_disparity - scfg.min_disparity
    acc = torch.zeros((n_d, *cl.shape), device=device)
    nodes = graph_kernel_nodes(lambda: KS.census_y(
        cl, cr, acc, (0, 1, -1), scfg.sgm_p1, scfg.sgm_p2,
        scfg.min_disparity, True))
    coop = [nd for nd in nodes if nd[2] == 1]
    require(len(coop) == 1, f"B5 captured: kernel nodes (grid, block, "
            f"cooperative) {nodes}, want one cooperative node")
    say("graph", f"B5 (census_y, 8 paths) captured alone: kernel nodes "
        f"(grid x, block x, cooperative) {nodes}: the cooperative attribute "
        f"survives the capture (cuGraphKernelNodeGetAttribute), so every "
        f"replay launches the bands co-resident, or fails")

    # the depth-fed drive: graphed (the driver) against eager
    (g, _), ex = executed(lambda: drive(cfg, frames, device, False, True))
    add(ex["runs"])
    require(ex["captures"] == 1, f"depth-fed: {ex['captures']} captures")
    check_runs(ex, dict(no_sgm, **slic), len(frames), "graphed depth-fed")
    e, _ = drive(cfg, frames, device, False, False, cls=Eager)
    require(same_banks(g.bank, e.bank), "graphed depth-fed drive != the "
            "eager drive (torch.equal)")
    st = check_map(bank_to_numpy(g.bank), g, ground_y)
    werr = check_warp(g)
    check_warp(e)
    require(same_banks(g.bank, e.bank), "after the loop warp: graphed != "
            "eager")
    replays = (g._compact_graph.replays, g._pose_warp_graph.replays)
    require(replays == (g.compactions, 1) and g.compactions > 0,
            f"depth-fed: compaction and warp replays {replays}, want "
            f"({g.compactions}, 1)")
    say("graph", f"depth-fed, {len(frames)} frames: every bank field "
        f"torch.equal to the eager drive's, before and after the loop warp "
        f"(within {werr:.2e} m of the shift); {st['live']} live, ground "
        f"err {st['ground_err_m']:.3e} m; compaction replayed "
        f"{replays[0]} times and the loop warp {replays[1]} time from their "
        f"graphs ({ex['programs']} bank program captured in the feed, the "
        f"warp's at the loop); 1 step capture "
        f"({g._fuse_graph.capture_ms:.1f} ms), wrapper calls {ex['calls']}, "
        f"device runs {ex['runs']}; steady feed raised no host-device sync")

    # the stereo drive
    (gs, _), ex = executed(lambda: drive_stereo(cfg, pairs, device, scfg,
                                                True))
    add(ex["runs"])
    require(ex["captures"] == 1, f"stereo: {ex['captures']} captures")
    check_runs(ex, dict(slic, sgm_census_x=1, sgm_census_y=1,
                        sgm_axis_scan=0), len(pairs), "graphed stereo")
    es, _ = drive_stereo(cfg, pairs, device, scfg, False, cls=Eager)
    require(same_banks(gs.bank, es.bank), "graphed stereo drive != the "
            "eager drive (torch.equal)")
    rows = bank_to_numpy(gs.bank)
    require((rows["update_times"] > 0).sum() > 0 and gs.compactions > 0,
            "graphed stereo: empty map or no compaction")
    for k in ("position", "normal", "size", "weight"):
        require(bool(np.isfinite(rows[k]).all()), f"stereo: NaN in {k}")
    swerr = check_warp(gs)
    say("graph", f"stereo, {len(pairs)} pairs: every bank field torch.equal "
        f"to the eager drive's; B5 and B6 once per replay; loop warp within "
        f"{swerr:.2e} m; 1 capture ({gs._stereo_graph.capture_ms:.1f} ms), "
        f"device runs {ex['runs']}; steady feed raised no host-device sync")

    # keyframes outgrow max_keyframes: two recaptures mid-drive
    small = dataclasses.replace(cfg, max_keyframes=4)
    (gr, _), ex = executed(lambda: drive(small, frames[:N_GROW], device,
                                         False, False))
    add(ex["runs"])
    require(gr.config.max_keyframes == 16 and ex["captures"] == 3,
            f"growth: max_keyframes {gr.config.max_keyframes}, "
            f"{ex['captures']} captures (want 16, 3)")
    check_runs(ex, slic, N_GROW, "recapturing drive")
    er, _ = drive(small, frames[:N_GROW], device, False, False, cls=Eager)
    require(same_banks(gr.bank, er.bank), "recapturing drive != eager")
    say("graph", f"max_keyframes 4 -> 16 over {N_GROW} frames: 3 captures "
        f"(P = 4, 8, 16), the bank torch.equal to the eager twin's")

    # a checkpoint load mid-drive
    os.makedirs("build/graph", exist_ok=True)

    def resumed(cls, tag):
        first = cls(cfg, device=device)
        feed(first, frames[:N_RESUME], False)
        path = f"build/graph/resume_{tag}.npz"
        first.save_checkpoint(path)
        drv = cls(cfg, device=device)
        drv.load_checkpoint(path)
        feed(drv, frames[N_RESUME:2 * N_RESUME], False)
        return drv

    gc, ex = executed(lambda: resumed(DeviceResidentMapping, "graphed"))
    add(ex["runs"])
    require(ex["captures"] == 2 and gc._fuse_graph.bank is gc.bank,
            f"resumed drive: {ex['captures']} captures (want one per "
            f"driver), graph bank is the loaded bank "
            f"{gc._fuse_graph.bank is gc.bank}")
    check_runs(ex, slic, 2 * N_RESUME, "resumed drive")
    require(same_banks(gc.bank, resumed(Eager, "eager").bank),
            "resumed drive != eager")
    say("graph", f"checkpoint saved after {N_RESUME} frames, loaded into a "
        f"new driver, {N_RESUME} more frames: the step recaptured against "
        f"the loaded bank, torch.equal to the eager twin")

    # the fleet: one graph per round for the 4 streams
    (gf, _), ex = executed(lambda: drive_fleet(
        cfg_f, frames, device, N_STREAMS, N_ROUNDS, sync_checked=True))
    add(ex["runs"])
    require(ex["captures"] == 1, f"fleet: {ex['captures']} captures")
    check_runs(ex, dict(no_sgm, **slic), N_ROUNDS, "graphed fleet")
    ef, _ = drive_fleet(cfg_f, frames, device, N_STREAMS, N_ROUNDS,
                        cls=EagerFleet)
    shift = np.eye(4)
    shift[:3, 3] = (0.25, -0.5, 1.0)
    for m in (gf, ef):      # a loop warp of session 0, batched
        kfs = m.sessions[0].graph.keyframes
        m.feed_pose(0, 1e6, shift @ kfs[-1].cam_pose,
                    loop_path=[shift @ kf.cam_pose for kf in kfs])
    for k in range(N_STREAMS):
        require(same_banks(stream_bank(gf.banks, k), stream_bank(ef.banks, k)),
                f"graphed fleet session {k} != the eager fleet's")
    replays = (gf._compact_graph.replays, gf._warp_graph.replays)
    require(replays == (gf.compactions, 1) and gf.compactions > 0,
            f"fleet: compaction and warp replays {replays}, want "
            f"({gf.compactions}, 1)")
    say("graph", f"fleet, {N_STREAMS} streams x {N_ROUNDS} rounds and a "
        f"loop warp of session 0: each session torch.equal to the eager "
        f"fleet's; 1 round capture ({gf._round.capture_ms:.1f} ms), the "
        f"batched compaction replayed {replays[0]} time(s) and the batched "
        f"warp {replays[1]} time from their graphs; device runs "
        f"{ex['runs']}; steady rounds raised no host-device sync")
    del g, e, gs, es, gr, er, gc, gf, ef

    # rates, host stages, device profile and memory: graphed against eager
    kinds = (
        ("depth-fed", lambda c: c(cfg, device=device), frames, None, 0,
         len(frames)),
        ("stereo", lambda c: c(cfg, device=device), frames, pairs, 0,
         len(pairs)),
        (f"fleet B={N_STREAMS}", lambda c: c(cfg_f, N_STREAMS, device=device),
         frames, None, N_STREAMS, N_ROUNDS))
    for tag, make, fr, pr, streams, n in kinds:
        classes = ((MultiSessionMapping, EagerFleet) if streams
                   else (DeviceResidentMapping, Eager))

        def build(cls, make=make, pr=pr):
            drv = make(cls)
            if pr is not None:
                drv.enable_stereo(bf=cfg.camera.fx * BASELINE_M,
                                  stereo_config=scfg)
            return drv

        fps = {"graphed": [], "eager": []}
        stages = {}
        for _ in range(N_RATE):
            for name, cls in zip(("graphed", "eager"), classes):
                r, stages[name] = rated(lambda: build(cls), fr, pr, streams,
                                        n)
                fps[name].append(r)
        for name in fps:
            runs = sorted(fps[name])
            say("graph", f"{tag} {name}: {runs[1]:.2f} frames/s (median of "
                f"{N_RATE} drives of {n} {'rounds' if streams else 'frames'}"
                f", steady after the first, graph captures taken out: "
                + ", ".join(f"{x:.2f}" for x in runs)
                + f"); host ms per {'round' if streams else 'frame'} by "
                f"stage: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                       sorted(stages[name].items())))
        for name, cls in zip(("graphed", "eager"), classes):
            drv = build(cls)
            step, _ = steps_of(drv, fr, pr, streams)
            say("graph", prof_line(f"{tag} {name}, {N_PROF} "
                                   f"{'rounds' if streams else 'frames'} "
                                   f"under the profiler",
                                   profiled(step, 2, N_PROF),
                                   "round" if streams else "frame"))
        drv = build(classes[0])
        step, flush = steps_of(drv, fr, pr, streams)
        mem = first_step_memory(drv, step, flush)
        graph = drv._round if streams else (drv._stereo_graph if pr is not None
                                            else drv._fuse_graph)
        say("graph", f"{tag} graph: capture {graph.capture_ms:.1f} ms "
            f"(warm-up on a scratch bank + capture, host clock), peak "
            f"device memory of the first step {mem['peak_mib']:.1f} MiB "
            f"above what was allocated, graph pool {mem['pool_mib']:.1f} "
            f"MiB after it ({smi})")
    return total


N_BATCH = 8             # K: frames of the batch phase's stack
N_LAPS = 8              # n_loops of the looped replay
N_SHARDED = 24          # frames of the sharded drives
N_SHARDED_STEREO = 4    # pairs of the sharded stereo drive
SHARDED_TOL_M = 1e-4    # the JAX package's sharded == dense tolerance
SLIC = ("slic_assign", "slic_centroid", "slic_huber")


def slic_records(records) -> dict:
    """Kernel records of each SLIC kernel among a window's device records
    ((card, name) each, `device_records`)."""
    return {k: sum(f"{k}_kernel" in n for _, n in records) for k in SLIC}


def phase_batch(device, frames) -> dict:
    """The batch replay paths on the card: fuse_frames_scan against eager
    steps, fuse_frames_looped (one lap captured in a CUDA graph, replayed)
    against the eager loop, and the replay's device frames/s beside the
    eager loop's.  Returns the kernel launches."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.core.state import (FIELDS, SurfelBank,
                                                          compact_frame)
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS

    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    ci, cd = zip(*(compact_frame(cfg, img, dep)
                   for img, dep, _ in frames[:N_BATCH]))
    imgs = torch.from_numpy(np.stack(ci)).to(device)
    deps = torch.from_numpy(np.stack(cd)).to(device)
    poses = torch.from_numpy(np.stack(
        [p for _, _, p in frames[:N_BATCH]]).astype(np.float32)).to(device)
    idx = torch.arange(N_BATCH, dtype=torch.int32, device=device)
    keys = FIELDS + ("count",)

    def empty():
        return SurfelBank.empty(cfg.surfel_capacity, device)

    def same(a, b):
        return all(torch.equal(getattr(a, k), getattr(b, k)) for k in keys)

    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # fuse_frames_scan == N eager fuse_frame_compact calls
    scan = empty()
    (_, stats), n = counted(lambda: FS.fuse_frames_scan(
        cfg, scan, imgs, deps, poses, idx))
    add(n)
    eager = empty()
    for i in range(N_BATCH):
        FS.fuse_frame_compact(cfg, eager, imgs[i], deps[i], poses[i], idx[i])
    require(same(scan, eager), "fuse_frames_scan != eager steps")
    require(all(n[k] == cfg.sp_iters * N_BATCH for k in SLIC),
            f"fuse_frames_scan: SLIC launches {n}")
    say("batch", f"fuse_frames_scan over {N_BATCH} KITTI frames == "
        f"{N_BATCH} eager fuse_frame_compact calls (torch.equal, every "
        f"field); n_new per frame {stats['n_new'].tolist()}")

    # the eager loop: step t fuses frame t mod K with frame index t
    steps = N_LAPS * N_BATCH
    loop = empty()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace_e = []
    for t in range(steps):
        i = t % N_BATCH
        FS.fuse_frame_compact(cfg, loop, imgs[i], deps[i], poses[i],
                              torch.full((), t, dtype=torch.int32,
                                         device=device))
        trace_e.append(loop.count.clone())
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    trace_e = torch.stack(trace_e)

    # fuse_frames_looped: the graph, under the profiler (its records show
    # each SLIC kernel 3x per step: the warm-up lap and every replay)
    graph = empty()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with device_records() as names:
        (_, trace_g), n = counted(lambda: FS.fuse_frames_looped(
            cfg, N_LAPS, graph, imgs, deps, poses))
    peak = torch.cuda.max_memory_allocated() - base
    recs = slic_records(names)
    add(recs)
    require(torch.equal(trace_g, trace_e), "looped replay: trace differs "
            "from the eager loop")
    require(same(graph, loop), "looped replay: bank differs from the eager "
            "loop")
    want = cfg.sp_iters * N_BATCH * (N_LAPS + 1)
    require(all(want - 2 <= recs[k] <= want for k in SLIC),
            f"profiler records of the SLIC kernels {recs}, expected {want} "
            f"each (3 per step: the warm-up lap + {N_LAPS} replays)")
    say("batch", f"fuse_frames_looped (K = {N_BATCH}, n_loops = {N_LAPS}): "
        f"trace and bank == the eager loop (torch.equal); live count "
        f"{trace_g[0].item()} -> {trace_g[-1].item()}; profiler records "
        f"per SLIC kernel {recs} (3 per step over the warm-up lap and "
        f"{N_LAPS} replays); wrapper launches {n} (warm-up + capture); "
        f"peak device memory of the call {peak / 2**20:.1f} MiB above "
        f"the {base / 2**20:.1f} MiB already allocated")

    # the replay's device rate: one lap captured, n_loops replays between
    # CUDA events (the host enqueues one replay per lap)
    timed_bank = empty()
    lap = FS.LapGraph(cfg, timed_bank, imgs, deps, poses, N_LAPS)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(N_LAPS):
        lap.replay()
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replay_ms = start.elapsed_time(stop)
    require(same(timed_bank, loop), "timed replay: bank differs")
    say("batch", f"{steps} steps: graph replay {1e3 * steps / replay_ms:.2f} "
        f"frames/s device ({replay_ms / steps:.3f} ms/step by CUDA events "
        f"around {N_LAPS} replays; host wall {1e3 * wall / steps:.3f} "
        f"ms/step), eager loop {steps / eager_s:.2f} frames/s "
        f"({1e3 * eager_s / steps:.3f} ms/step to a synchronize)")
    return total


def sharded_rows_of(rows: dict) -> dict:
    """The live rows of host rows, sorted by position (the order differs
    between layouts)."""
    live = rows["update_times"] > 0
    order = np.lexsort(rows["position"][live].T[::-1])
    return {k: v[live][order] for k, v in rows.items()}


def sharded_rows(drv) -> dict:
    """A driver's live bank rows, sorted."""
    return sharded_rows_of(drv._bank_host())


def same_map(a: dict, b: dict, what: str) -> float:
    require(len(a["color"]) == len(b["color"]) > 0,
            f"{what}: {len(a['color'])} vs {len(b['color'])} surfels")
    for k in ("position", "normal", "size", "weight"):
        require(bool(np.isfinite(a[k]).all()), f"{what}: NaN/Inf in {k}")
    require(bool(np.array_equal(a["update_times"], b["update_times"])),
            f"{what}: update_times differ")
    err = float(max(np.abs(a[k] - b[k]).max() for k in ("position",
                                                          "normal")))
    require(err <= SHARDED_TOL_M, f"{what}: off by {err} m")
    return err


def pool_mib_by_card(pool) -> dict:
    """The device memory each card's `torch.cuda.MemPool` of a driver's
    pools (`fuse_step.graph_pool`: {card: MemPool}) holds, MiB."""
    card = {tuple(p.id): str(d) for d, p in pool.items()}
    held = dict.fromkeys(card.values(), 0.0)
    for seg in torch.cuda.memory_snapshot():
        d = card.get(tuple(seg.get("segment_pool_id", ())))
        if d is not None:
            held[d] += seg["total_size"] / 2**20
    return held


def pool_mib(pool) -> float:
    """The device memory a driver's pools hold on all their cards, MiB."""
    return sum(pool_mib_by_card(pool).values())


def pools_line(drv) -> str:
    return (f"steps' pool {pool_mib(drv._graph_pool):.1f} MiB, bank "
            f"programs' pool {pool_mib(drv._bank_pool):.1f} MiB")


@functools.lru_cache(maxsize=1)
def sharded_eager_classes():
    """The eager references of the sharded drivers: their mesh programs
    (`parallel/sharding.py`, `parallel/frame_sharding.py`) called op by op
    on the uploaded inputs, as the drivers ran them before they were
    captured: ShardedDeviceResidentMapping's depth-fed and stereo steps,
    compaction and pose warp; ShardedSurfelMapping's padded and stereo
    steps, compaction, the migration extract and append and the active
    warp."""
    from densesurfelmapping_tpu_torch.core.state import (FIELDS, FrameInput,
                                                         pad_frame)
    from densesurfelmapping_tpu_torch.parallel import frame_sharding as FSH
    from densesurfelmapping_tpu_torch.parallel import sharding as SH
    from densesurfelmapping_tpu_torch.parallel.multistream import (
        unpack_payload)
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        ShardedDeviceResidentMapping)
    from densesurfelmapping_tpu_torch.pipeline.driver import _StereoPair
    from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
        ShardedSurfelMapping)

    class EagerSharded(ShardedDeviceResidentMapping):
        def _fuse_packed(self, buf):
            hw3 = 3 * self.config.height * self.config.width
            with self.timer.stage("dispatch"):
                frames, poses, refs, _, masks = unpack_payload(
                    self._upload(buf)[None], hw3)
                make = (FSH.sharded_fuse_frame_framestage_windowed_packed
                        if self.frame_sharded
                        else SH.sharded_fuse_frame_windowed_packed)
                _, stats = make(self.config, self.mesh)(
                    self.bank, frames, poses, refs, masks)
            self._fused(stats)

        def _fuse_stereo_packed(self, buf):
            hw2 = 2 * self.config.height * self.config.width
            with self.timer.stage("dispatch"):
                step = SH.sharded_fuse_frame_stereo_windowed_packed(
                    self.config, self._stereo_cfg, self._stereo_filter,
                    self.mesh)
                _, stats = step(self.bank, *unpack_payload(
                    self._upload(buf)[None], hw2))
            self._fused(stats)

        def _do_compact(self):
            SH.sharded_compact(self.config, self.mesh)(self.bank)
            self.compactions += 1

        def _apply_pose_warp(self, wstack, mstack):
            SH.sharded_warp_by_pose(self.config, self.mesh)(
                self.bank, self._to_device(wstack[None]),
                self._to_device(mstack[None]),
                self._to_device(self._window_np[None]),
                self._to_device(np.full(1, self._first_local, np.int64)))

    class EagerShardedPool(ShardedSurfelMapping):
        def _fuse_frame(self, image, depth, pose, ref_index):
            pose_dev = self._to_device(np.asarray(pose, np.float32)[None])
            refs = self._to_device(np.full(1, ref_index, np.int32))
            if isinstance(depth, _StereoPair):
                step = SH.sharded_fuse_frame_stereo(
                    self.config, self._stereo_cfg, self._stereo_filter,
                    self.mesh)
                _, stats = step(self.bank, self._to_device(depth.buf[None]),
                                pose_dev, refs, self._to_device(
                                    np.full(1, self._stereo_bf, np.float32)))
            else:
                pi, pd = pad_frame(self.config,
                                   np.asarray(image, np.float32),
                                   np.asarray(depth, np.float32))
                frames = FrameInput(image=self._to_device(pi[None]),
                                    depth=self._to_device(pd[None]),
                                    pose=pose_dev, frame_index=refs)
                _, stats = SH.sharded_fuse_frame(self.config, self.mesh)(
                    self.bank, SH.shard_frames(self.mesh, frames))
            self._fuse_epilogue(stats)

        def _do_compact(self):
            SH.sharded_compact(self.config, self.mesh)(self.bank)
            self.compactions += 1

        def _extract_chunk(self, ids):
            _, bufs, ns = SH.sharded_extract_by_pose(
                self.config, self.mesh, self._per_chunk)(
                    self.bank, self._to_device(ids))
            ns = ns[0].cpu().numpy()
            n = int(ns.sum())
            if n == 0:
                return {}, 0
            host = {k: np.concatenate([
                v[0].cpu().numpy().reshape(
                    (self.n_shards, self._per_chunk)
                    + tuple(v.shape[2:]))[s, :ns[s]]
                for s in range(self.n_shards)]) for k, v in bufs.items()}
            if (ns == self._per_chunk).any():
                return host, self.config.migration_buffer
            return host, min(n, self.config.migration_buffer - 1)

        def _append_hostslab(self, padded, n):
            owner = np.arange(n) % self.n_shards
            fields, ns = {}, np.zeros((1, self.n_shards), np.int32)
            for k in FIELDS:
                rows = padded[k][:n]
                out = np.zeros((1, self.n_shards, self._per_chunk)
                               + rows.shape[1:], rows.dtype)
                for s in range(self.n_shards):
                    part = rows[owner == s]
                    out[0, s, :len(part)] = part
                    ns[0, s] = len(part)
                fields[k] = self._to_device(out.reshape(
                    (1, -1) + rows.shape[1:]))
            SH.sharded_append(self.config, self.mesh, self._per_chunk)(
                self.bank, fields, self._to_device(ns))

        def _apply_active_warp(self, warp):
            SH.sharded_warp_active(self.config, self.mesh)(
                self.bank, self._to_device(np.asarray(warp, np.float32)[None]))

    return EagerSharded, EagerShardedPool


def same_sharded(a, b) -> bool:
    """torch.equal on every shard's bank, field by field and count (b's
    shard copied to a's card where the two meshes differ)."""
    from densesurfelmapping_tpu_torch.core.state import FIELDS
    return (a.n_streams, a.n_shards) == (b.n_streams, b.n_shards) and all(
        torch.equal(getattr(x, k), getattr(y, k).to(x.device))
        for ra, rb in zip(a.shards, b.shards) for x, y in zip(ra, rb)
        for k in FIELDS + ("count",))


def median_line(tag: str, runs: list, what: str) -> str:
    runs = sorted(runs)
    return (f"{tag}: {runs[len(runs) // 2]:.2f} frames/s (median of "
            f"{len(runs)} drives of {what}, steady after the first, graph "
            f"captures taken out: " + ", ".join(f"{x:.2f}" for x in runs)
            + ")")


def phase_sharded(device, frames, pairs, smi: str) -> dict:
    """The sharded drivers on a (1, 2) mesh of this one card (2 virtual
    shards), replaying their mesh programs from captured graphs, each
    against an eager reference of the same driver on the eager mesh
    programs (`sharded_eager_classes`): torch.equal on every shard's bank
    (the host pool's arrays equal), before and after a loop warp, and
    within 1e-4 m of the dense drive: ShardedDeviceResidentMapping,
    replicated and frame-sharded, depth-fed under the sync check, and
    stereo; ShardedSurfelMapping over the 60 host-pool frames with its
    reads allowed.  Launches by the profiler's kernel records; graphed and
    eager frames/s (median of N_RATE); replays, captures and each MemPool's
    MiB.  The sharded SGM's graph replay == its eager call == the
    replicated plain disparity.  Then `rows_check` on a (2, 2) mesh of
    the card: 4 streams, 2 a data row.  Returns the device runs of the
    kernels in the graphed drives."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.models import stereo as ST
    from densesurfelmapping_tpu_torch.parallel import sgm_sharding
    from densesurfelmapping_tpu_torch.parallel.sharding import (capture_plan,
                                                                make_mesh)
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping, ShardedDeviceResidentMapping)
    from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping
    from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
        ShardedSurfelMapping)

    EagerSharded, EagerShardedPool = sharded_eager_classes()
    cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    mesh = make_mesh(2)
    n_sh = mesh.shape["surfel"]
    label = f"{n_sh} virtual shards on one card ({smi})"
    say("sharded", f"mesh {mesh}: {label}")
    plan = capture_plan(mesh)
    say("sharded", "capture plan: " + "; ".join(
        f"{d}: lane {c['lane']}, cells {c['cells']} on cell streams "
        f"{c['streams']}" for d, c in plan["cards"].items())
        + ": each shard's passes on a stream of its own, forked from the "
        "card's lane and joined back (`sharding.cells`), in the graphs and "
        "the eager mesh programs alike")
    slic = {k: cfg.sp_iters * n_sh for k in SLIC}
    no_sgm = dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=0)
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def make(kind, cls=None):
        if kind == "dense":
            return (cls or DeviceResidentMapping)(cfg, device=device)
        return (cls or ShardedDeviceResidentMapping)(
            cfg, mesh, frame_sharded=(kind == "frame-sharded"))

    def graphs_run(drv, what):
        require(drv.graphed, f"{what}: the driver is not graphed")
        replays = (drv._compact_graph.replays,
                   drv._pose_warp_graph.replays)
        require(replays == (drv.compactions, 1) and drv.compactions > 0,
                f"{what}: compaction and warp replays {replays}, want "
                f"({drv.compactions}, 1)")
        return replays

    # depth-fed: replicated and frame-sharded
    drive_frames = frames[:N_SHARDED]
    maps, rates = {}, {}
    for kind in ("dense", "sharded", "frame-sharded"):
        feed(make(kind), drive_frames[:2], sync_checked=False)   # warm-up
        drv = make(kind)
        _, ex = executed(lambda: feed(drv, drive_frames, sync_checked=True))
        maps[kind] = sharded_rows(drv)
        if kind == "dense":      # the reference (graphed; the graph phase)
            continue
        add(ex["runs"])
        per = dict(no_sgm, **(dict.fromkeys(SLIC, 0)
                              if kind == "frame-sharded" else slic))
        require(ex["captures"] == 1, f"{kind}: {ex['captures']} steps "
                f"captured, want 1")
        check_runs(ex, per, N_SHARDED, f"sharded {kind}")
        e = make(kind, EagerSharded)
        feed(e, drive_frames, sync_checked=False)
        require(same_sharded(drv.bank, e.bank), f"{kind}: graphed != the "
                f"eager mesh programs (torch.equal, every shard)")
        err = same_map(maps[kind], maps["dense"], kind)
        werr = check_warp(drv)
        check_warp(e)
        require(same_sharded(drv.bank, e.bank), f"{kind}: after the loop "
                f"warp graphed != eager")
        replays = graphs_run(drv, kind)
        why = ("3 per frame per shard" if per["slic_assign"] else "the "
               "slabs run the plain SLIC functions, as the JAX package's "
               "XLA path does")
        say("sharded", f"{kind} drive, {N_SHARDED} KITTI frames, graphed, "
            f"under the sync check after the first frame: every shard "
            f"torch.equal to the eager mesh programs' before and after a "
            f"loop warp (within {werr:.2e} m of the shift); "
            f"{len(maps[kind]['color'])} surfels == the dense drive's within "
            f"{err:.3g} m (bound {SHARDED_TOL_M}); captures: 1 step "
            f"({drv._fuse_graph.capture_ms:.1f} ms) + {ex['programs']} bank "
            f"program in the feed; replays: step {drv._fuse_graph.replays}, "
            f"compaction {replays[0]}, pose warp {replays[1]}; device runs "
            f"{dict((k, ex['runs'][k]) for k in SLIC)} ({why}); "
            f"{pools_line(drv)}")
        del drv, e
    for kind in ("sharded", "frame-sharded"):
        drv = make(kind)
        step, _ = steps_of(drv, drive_frames)
        say("sharded", prof_line(f"{kind} graphed, {N_PROF} frames under "
                                 f"the profiler", profiled(step, 2, N_PROF)))
        del drv
    for kind in ("dense", "sharded", "frame-sharded"):
        classes = (("graphed", None),) if kind == "dense" else (
            ("graphed", None), ("eager", EagerSharded))
        for name, cls in classes:
            runs = [rated(lambda: make(kind, cls), drive_frames, None, 0,
                          N_SHARDED)[0] for _ in range(N_RATE)]
            rates[(kind, name)] = sorted(runs)[N_RATE // 2]
            say("sharded", median_line(f"{kind} {name}", runs,
                                       f"{N_SHARDED} frames") + f" ({label})")

    # stereo: the matcher once per shard and frame
    pairs = pairs[:N_SHARDED_STEREO]
    scfg = sgm_config()
    smaps = {}
    for kind in ("dense", "sharded"):
        feed_pairs(make(kind), pairs[:2], scfg, sync_checked=False)
        drv = make(kind)
        _, ex = executed(lambda: feed_pairs(drv, pairs, scfg,
                                            sync_checked=True))
        add(ex["runs"])
        k_sh = 1 if kind == "dense" else n_sh
        check_runs(ex, dict(sgm_census_x=k_sh, sgm_census_y=k_sh,
                            sgm_axis_scan=0,
                            **{k: cfg.sp_iters * k_sh for k in SLIC}),
                   N_SHARDED_STEREO, f"{kind} stereo drive")
        smaps[kind] = sharded_rows(drv)
        if kind == "dense":
            continue
        require(ex["captures"] == 1, f"sharded stereo: {ex['captures']} "
                f"steps captured")
        e = make(kind, EagerSharded)
        feed_pairs(e, pairs, scfg, sync_checked=False)
        require(same_sharded(drv.bank, e.bank), "sharded stereo: graphed != "
                "the eager mesh programs")
        werr = check_warp(drv)
        check_warp(e)
        require(same_sharded(drv.bank, e.bank), "sharded stereo: after the "
                "loop warp graphed != eager")
        stereo_replays = drv._stereo_graph.replays
        stereo_pools = pools_line(drv)
        del drv, e
    err = same_map(smaps["sharded"], smaps["dense"], "sharded stereo")
    say("sharded", f"stereo ({N_SHARDED_STEREO} pairs, --sgm), graphed, "
        f"under the sync check after the first pair: every shard torch.equal "
        f"to the eager mesh programs' before and after a loop warp (within "
        f"{werr:.2e} m); {len(smaps['sharded']['color'])} surfels == the "
        f"dense stereo drive's within {err:.3g} m; B5/B6 once per pair per "
        f"shard (profiler records); step replays {stereo_replays}; "
        f"{stereo_pools}")

    def stereo_make(cls):
        def build():
            drv = make("sharded", cls)
            drv.enable_stereo(bf=cfg.camera.fx * BASELINE_M,
                              stereo_config=scfg)
            return drv
        return build

    step, _ = steps_of(stereo_make(None)(), None, pairs)
    say("sharded", prof_line(f"sharded stereo graphed, "
                             f"{N_SHARDED_STEREO - 2} pairs under the "
                             f"profiler", profiled(step, 2,
                                                   N_SHARDED_STEREO - 2)))
    for name, cls in (("graphed", None), ("eager", EagerSharded)):
        runs = [rated(stereo_make(cls), None, pairs, 0,
                      N_SHARDED_STEREO)[0] for _ in range(N_RATE)]
        say("sharded", median_line(f"sharded stereo {name}", runs,
                                   f"{N_SHARDED_STEREO} pairs")
            + f" ({label})")

    # the host-pool driver over the mesh against its eager reference and
    # the dense host-pool SurfelMapping, fed the same padded f32 frames
    hp_cfg = dataclasses.replace(cfg, compaction_slack=HOST_POOL_SLACK,
                                 compact_upload=False)
    d = drive_host_pool(SurfelMapping, hp_cfg, device, frames)[0]
    say("sharded", f"dense host-pool SurfelMapping (padded upload), "
        f"{len(frames)} frames: {pools_line(d)} ({smi})")
    (g, _, _, reads), ex = executed(lambda: drive_host_pool(
        ShardedSurfelMapping, hp_cfg, device, frames, sync_checked=True,
        mesh=mesh))
    add(ex["runs"])
    require(ex["captures"] == 1 and g.graphed, f"sharded host pool: "
            f"{ex['captures']} steps captured, graphed {g.graphed}")
    check_runs(ex, dict(no_sgm, **slic), len(frames), "sharded host pool")
    e = drive_host_pool(EagerShardedPool, hp_cfg, device, frames,
                        mesh=mesh)[0]
    require(same_sharded(g.bank, e.bank) and same_pool(g.pool, e.pool),
            "sharded host pool: graphed != the eager mesh programs (banks "
            "torch.equal, pool arrays equal)")
    err = max(same_map(sharded_rows(g), sharded_rows(d),
                       "sharded host pool bank"),
              same_map(sharded_rows_of(g.pool.all_surfels()),
                       sharded_rows_of(d.pool.all_surfels()),
                       "sharded host pool pool"))
    # the mesh step compacts each shard's slab every frame (the JAX
    # design), so no stats frame asks for a compaction within these
    # frames: the driver's compaction runs once here, from its graph
    for drv in (g, e):
        drv._do_compact()
    werr = check_warp(g)
    check_warp(e)
    require(same_sharded(g.bank, e.bank) and same_pool(g.pool, e.pool),
            "sharded host pool: after a compaction and the loop warp "
            "graphed != eager")
    replays = {name: getattr(g, f"_{name}_graph").replays for name in
               ("fuse", "compact", "extract", "append", "warp")}
    require(replays["warp"] == 1 and replays["compact"] == g.compactions
            and g.compactions > 0 and replays["extract"] > 0
            and replays["append"] > 0 and len(g.pool) > 0,
            f"sharded host pool: replays {replays}, {g.compactions} "
            f"compactions, pool {len(g.pool)}")
    say("sharded", f"ShardedSurfelMapping (host pool, padded upload), "
        f"{len(frames)} KITTI frames (migrations and the re-activation of "
        f"`host_pool_feeder`), graphed: banks torch.equal and pool "
        f"({len(g.pool)} surfels) equal to the eager mesh programs', before "
        f"and after a compaction and a loop warp (within {werr:.2e} m); "
        f"bank and pool == "
        f"the dense host-pool SurfelMapping's within {err:.3g} m (bound "
        f"{SHARDED_TOL_M}); replays {replays} ({g.compactions} "
        f"compactions); captures: 1 step "
        f"({g._fuse_graph.capture_ms:.1f} ms) + {ex['programs']} bank "
        f"programs; sync check: {reads['frames'] - reads['reading']} of "
        f"{reads['frames']} frames after the first read nothing, the rest "
        f"only in " + ", ".join(f"{k} x{reads[k]}" for k in
                                HOST_POOL_READS + ("capture",))
        + f"; {pools_line(g)}")
    del d, g, e
    for name, cls in (("dense graphed", SurfelMapping),
                      ("sharded graphed", ShardedSurfelMapping),
                      ("sharded eager", EagerShardedPool)):
        runs = [drive_host_pool(cls, hp_cfg, device, frames,
                                mesh=None if cls is SurfelMapping
                                else mesh)[1] for _ in range(N_RATE)]
        say("sharded", median_line(f"host pool {name}", runs,
                                   f"{len(frames)} frames") + f" ({label})")

    # sharded_sgm_disparity: the graph replay == the eager call == the
    # replicated plain disparity
    scfg_p = scfg._replace(sgm_pallas=False)
    for tag, (li, ri, _, _) in (("61 x 97 crop", pairs[0]),
                                ("KITTI", pairs[0])):
        left = torch.from_numpy(li).to(device).float()
        right = torch.from_numpy(ri).to(device).float()
        if tag != "KITTI":
            left, right = left[100:161, 300:397], right[100:161, 300:397]
            cfg_c = scfg_p._replace(max_disparity=40, min_disparity=3)
        else:
            cfg_c = scfg_p
        h, w = left.shape
        want = ST.disparity(left, right, cfg_c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = sgm_sharding.sharded_sgm_disparity(mesh, cfg_c, h, w)(
            left, right)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        graph = sgm_sharding.graphed_sharded_sgm_disparity(mesh, cfg_c, h, w)
        first = graph(left, right).clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = graph(left, right)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        require(graph.graphed and graph.replays == 2,
                f"sharded SGM ({tag}): graphed {graph.graphed}, replays "
                f"{graph.replays}")
        require(torch.equal(first, eager) and torch.equal(got, eager)
                and torch.equal(got, want), f"sharded_sgm_disparity "
                f"({tag}): replay != eager call != replicated plain")
        say("sharded", f"sharded_sgm_disparity {tag} ({h} x {w}, "
            f"{cfg_c.max_disparity - cfg_c.min_disparity} disparities, "
            f"{cfg_c.sgm_paths} paths) on {n_sh} shards: the graph's "
            f"replays == its eager call == replicated (torch.equal), valid "
            f"{float((want > 0).float().mean()):.3f}; eager {eager_s:.3f} s, "
            f"capture {graph.capture_ms / 1e3:.3f} s, replay {replay_s:.3f} "
            f"s (plain scans; {label})")
        del graph

    # several streams on a data row: a (2, 2) mesh of this card, 4 streams
    add(rows_check(cfg, make_mesh(4, data=2), frames, pairs, "sharded"))
    return total


def sync_all() -> None:
    """Wait for every card."""
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def busy_by_card(records) -> dict:
    """{card: ms during which it ran any of the raw device records (the
    union of their intervals)}."""
    spans: dict = {}
    for e in records:
        spans.setdefault(e.device_index(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    out = {}
    for card, iv in sorted(spans.items()):
        busy, end = 0, float("-inf")
        for lo, hi in sorted(iv):
            busy += max(0, hi - max(lo, end))
            end = max(end, hi)
        out[card] = busy / 1e6
    return out


def profiled_cards(step, n_warm: int, n: int) -> dict:
    """step(i) for i < n_warm, then n more under the profiler: wall ms per
    step and each card's device busy ms per step."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(n_warm):
        step(i)
    sync_all()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n):
            step(i)
        sync_all()
        wall = time.perf_counter() - t0
    busy = busy_by_card(raw_device_records(prof))
    return dict(wall_ms=1e3 * wall / n,
                busy_ms={c: v / n for c, v in busy.items()})


def cards_line(p: dict, unit: str = "frame") -> str:
    return (f"wall {p['wall_ms']:.2f} ms/{unit}, device busy ms/{unit} by "
            f"card " + ", ".join(f"cuda:{c} {v:.2f}"
                                 for c, v in p["busy_ms"].items()))


def mesh_kernel_nodes(fn, devices) -> list:
    """fn() (run once first) captured as a mesh program is, one capture
    over the cards of `devices` (the home first) with a memory pool on
    each (`fuse_step.capture`), the graph kept for inspection: (card,
    grid x, block x, cooperative attribute) of each kernel node, the card
    by the node's context."""
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    fn()
    sync_all()
    home = devices[0]
    pools = FS.graph_pool(devices)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(home), torch.cuda.graph(
            graph, pool=pools[home].id, stream=torch.cuda.Stream(home),
            capture_error_mode="thread_local"), \
            FS.capture_pools(pools, devices[1:]):
        fn()
    ctx = card_contexts([d.index for d in devices])
    return [(ctx.get(c), grid, block, coop)
            for grid, block, coop, c in kernel_nodes(graph)]


def link_lines(n_cards: int) -> list:
    """The peer-access matrix, `nvidia-smi topo -m` and `nvlink -s` (or
    what they print instead), and the copy rate card 0 -> k and back
    (256 MiB, host clock to a synchronize of both, median of 5)."""
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n_cards)] for i in range(n_cards)]
    out = [f"peer access (torch.cuda.can_device_access_peer): {peer}"]
    for args in (("topo", "-m"), ("nvlink", "-s")):
        r = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, timeout=60)
        text = (r.stdout.strip() or r.stderr.strip() or "(no output)")
        out.append(f"nvidia-smi {' '.join(args)} (exit {r.returncode}): "
                   + " | ".join(text.splitlines()[:12]))
    rates = []
    for k in range(1, n_cards):
        for src, dst in ((0, k), (k, 0)):
            a = torch.empty(256 << 20, dtype=torch.uint8, device=f"cuda:{src}")
            b = torch.empty_like(a, device=f"cuda:{dst}")
            b.copy_(a)
            times = []
            for _ in range(5):
                sync_all()
                t0 = time.perf_counter()
                b.copy_(a)
                torch.cuda.synchronize(src)
                torch.cuda.synchronize(dst)
                times.append(time.perf_counter() - t0)
            rates.append(f"{src}->{dst} "
                         f"{(256 << 20) / sorted(times)[2] / 1e9:.1f}")
            del a, b
    out.append("peer copy GB/s (256 MiB, median of 5): " + ", ".join(rates))
    return out


ROW_STREAMS = 4          # streams of the rows check: 2 a data row
ROW_FRAMES = 4           # its depth-fed frames
ROW_PAIRS = 3            # its stereo pairs


def row_payloads(cfg, frames, pairs, t: int, stereo: bool) -> torch.Tensor:
    """(ROW_STREAMS, payload bytes) u8 of the rows check's step t: stream
    b fuses frame 6 b + t, or pair (b + t) mod len(pairs), as frame
    index t: every stream its own poses."""
    from densesurfelmapping_tpu_torch.core.state import (
        pack_aux, pack_frame_with_aux, pack_stereo_pair,
        pack_stereo_with_aux)
    mask = np.ones(cfg.max_keyframes, bool)
    rows = []
    for b in range(ROW_STREAMS):
        if stereo:
            li, ri, _, pose = pairs[(b + t) % len(pairs)]
            rows.append(pack_stereo_with_aux(
                cfg, pack_stereo_pair(cfg, li, ri),
                pack_aux(pose, t, mask, bf=cfg.camera.fx * BASELINE_M)))
        else:
            img, dep, pose = frames[6 * b + t]
            rows.append(pack_frame_with_aux(cfg, img, dep,
                                            pack_aux(pose, t, mask)))
    return torch.from_numpy(np.stack(rows))


def same_stream(a, b: int, solo) -> bool:
    """Stream b of the sharded banks `a` torch.equal to stream 0 of
    `solo`, shard by shard, every field and the count."""
    from densesurfelmapping_tpu_torch.core.state import FIELDS
    return a.n_shards == solo.n_shards and all(
        torch.equal(getattr(x, k), getattr(y, k).to(x.device))
        for x, y in zip(a.shards[b], solo.shards[0])
        for k in FIELDS + ("count",))


def check_card_runs(ex: dict, per_cell: dict, on_card: dict, steps: int,
                    what: str) -> None:
    """Each card's device runs (the records' device index) of a graphed
    drive of `steps` replays after one capture: per_cell[k] a step on
    each of its cells (`on_card`: card index -> cells), bounded below by
    `runs_floor`."""
    for card, cells_here in on_card.items():
        got = ex["card_runs"].get(card, {})
        for k, v in per_cell.items():
            want = v * cells_here * (steps + 1)
            require(max(runs_floor(want, v * cells_here, ex["lost"]),
                        min(v, 1)) <= got.get(k, 0) <= want,
                    f"{what}: cuda:{card} ran {k} {got.get(k, 0)} times, "
                    f"want {want} ({v} per step on each of its {cells_here} "
                    f"cells)")


def steady_rate(step, loads, streams: int) -> float:
    """Aggregate frames/s of step(payload) over loads[1:], after loads[0]
    (a graph's capture), to a synchronize of every card."""
    step(loads[0])
    sync_all()
    t0 = time.perf_counter()
    for p in loads[1:]:
        step(p)
    sync_all()
    return streams * (len(loads) - 1) / (time.perf_counter() - t0)


def rows_bank_programs(cfg, mesh, g_banks, e_banks) -> str:
    """One warp by pose, one compaction, one extract and one append, each
    a graph (`sharding.graphed_*`) on g_banks against the eager mesh
    program on e_banks (per-stream inputs): every cell torch.equal after
    each, the extract's buffers and counts too."""
    from densesurfelmapping_tpu_torch.core.state import FIELDS
    from densesurfelmapping_tpu_torch.ops.migration import MAX_REMOVE_POSES
    from densesurfelmapping_tpu_torch.parallel import sharding as SH
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    B, P, n = g_banks.n_streams, cfg.max_keyframes, mesh.shape["surfel"]
    home = mesh.device(0, 0)
    rng = np.random.default_rng(3)
    warps = np.tile(np.eye(4, dtype=np.float32), (B, P, 1, 1))
    warps[:, :4, :3, 3] = rng.normal(scale=0.1, size=(B, 4, 3))
    moved = np.zeros((B, P), bool)
    moved[:, :3] = True
    masks = np.zeros((B, P), bool)
    masks[:, 2:4] = True
    firsts = np.full(B, 2, np.int64)
    ids = np.full(MAX_REMOVE_POSES, -1, np.int32)
    ids[:2] = (0, 1)
    per = 256
    one = g_banks.shards[0][0]
    slab = [rng.integers(1, 9, (B, n * per) + getattr(one, k).shape[1:])
            .astype(str(getattr(one, k).dtype).split(".")[1])
            for k in FIELDS]
    ns = rng.integers(0, per + 1, (B, n)).astype(np.int32)
    pool = FS.graph_pool(mesh.devices())

    def dev(*args):
        return [torch.from_numpy(a).to(home) for a in args]

    progs = (
        ("warp by pose", SH.graphed_warp_by_pose(cfg, mesh, g_banks, pool),
         lambda: SH.sharded_warp_by_pose(cfg, mesh)(
             e_banks, *dev(warps, moved, masks, firsts)),
         (warps, moved, masks, firsts)),
        ("compact", SH.graphed_compact(cfg, mesh, g_banks, pool),
         lambda: SH.sharded_compact(cfg, mesh)(e_banks), ()),
        ("extract", SH.graphed_extract_by_pose(cfg, mesh, g_banks, per,
                                               pool),
         lambda: SH.sharded_extract_by_pose(cfg, mesh, per)(
             e_banks, *dev(ids))[1:], (ids,)),
        ("append", SH.graphed_append(cfg, mesh, g_banks, per, pool),
         lambda: SH.sharded_append(cfg, mesh, per)(
             e_banks, dict(zip(FIELDS, dev(*slab))), *dev(ns)),
         tuple(slab) + (ns,)))
    extracted = 0
    for name, graph, eager, args in progs:
        got = graph(*args)
        want = eager()
        require(graph.graphed, f"rows: the {name} program is not graphed")
        require(same_sharded(g_banks, e_banks),
                f"rows: the {name} graph != the eager mesh program")
        if name == "extract":
            require(torch.equal(got[1], want[1]) and all(
                torch.equal(got[0][k], want[0][k]) for k in FIELDS),
                "rows: the extract graph's buffers != the eager program's")
            extracted = int(got[1].sum())
    require(extracted > 0, "rows: the extract matched nothing")
    return (f"bank programs on the same mesh: warp by pose, compaction, "
            f"extract ({extracted} rows) and append graphed, each "
            f"torch.equal on every cell to the eager mesh program (per-"
            f"stream inputs); bank programs' pool {pool_mib(pool):.1f} MiB")


def rows_check(cfg, mesh, frames, pairs, phase: str) -> dict:
    """ROW_STREAMS streams, 2 a data row, on `mesh` (2 data rows): each
    cell one batched bank of its row's streams and each mesh program one
    torch.func.vmap per cell over them.  The graphed depth-fed step
    (`graphed_fuse_frame_windowed_packed`, ROW_FRAMES frames) and stereo
    step (`graphed_fuse_frame_stereo_windowed_packed`, the CLI's --sgm
    matcher: fused census, ROW_PAIRS pairs): launches by the profiler's
    records, in all and on each card (per cell and step: each SLIC kernel
    sp_iters times, B5 and B6 once), where a loop over the streams would
    launch ROW_STREAMS / 2 times as many; stats and every cell torch.equal
    to the eager mesh program's; each stream torch.equal (banks and stats)
    to the same stream driven alone through the same graph on a one-row
    mesh of its row's cells; then `rows_bank_programs`.  Prints graphed
    and eager aggregate frames/s (steady, after the capture; no target)
    and the step pool's MiB.  Returns the graphed drives' device runs."""
    from densesurfelmapping_tpu_torch.parallel import sharding as SH
    from densesurfelmapping_tpu_torch.parallel.multistream import (
        unpack_payload)
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS
    scfg = sgm_config()
    home = mesh.device(0, 0)
    plan = SH.capture_plan(mesh)
    on_card = {d.index: len(c["cells"]) for d, c in plan["cards"].items()}
    n_cells = sum(on_card.values())
    label = (f"{mesh.shape} mesh {[[str(d) for d in r] for r in mesh.grid]}"
             f", {ROW_STREAMS} streams (2 a row)")
    total: dict = {}
    for kind in ("depth-fed", "stereo"):
        stereo = kind == "stereo"
        n = ROW_PAIRS if stereo else ROW_FRAMES
        loads = [row_payloads(cfg, frames, pairs, t, stereo)
                 for t in range(n)]
        fb = (2 if stereo else 3) * cfg.height * cfg.width

        def graph(m, banks):
            pool = FS.graph_pool(m.devices())
            if stereo:
                return SH.graphed_fuse_frame_stereo_windowed_packed(
                    cfg, scfg, True, m, banks, pool), pool
            return SH.graphed_fuse_frame_windowed_packed(cfg, m, banks,
                                                         pool), pool

        fn = (SH.sharded_fuse_frame_stereo_windowed_packed(cfg, scfg, True,
                                                           mesh)
              if stereo else SH.sharded_fuse_frame_windowed_packed(cfg,
                                                                   mesh))

        def eager(banks, payload):
            args = unpack_payload(payload.to(home), fb)
            return fn(banks, *(args if stereo else args[:3] + args[4:]))[1]

        g_banks = SH.replicate_banks(mesh, cfg, ROW_STREAMS)
        step, pool = graph(mesh, g_banks)
        g_stats, ex = executed(lambda: [
            {k: v.clone() for k, v in step(p).items()} for p in loads])
        add_runs(total, ex["runs"])
        per_cell = dict(
            {k: cfg.sp_iters for k in SLIC}, sgm_axis_scan=0,
            **dict.fromkeys(("sgm_census_x", "sgm_census_y"), int(stereo)))
        require(step.graphed and ex["captures"] == 1, f"rows {kind}: "
                f"graphed {step.graphed}, {ex['captures']} captures")
        check_runs(ex, {k: v * n_cells for k, v in per_cell.items()}, n,
                   f"rows {kind}")
        check_card_runs(ex, per_cell, on_card, n, f"rows {kind}")
        e_banks = SH.replicate_banks(mesh, cfg, ROW_STREAMS)
        for t, p in enumerate(loads):
            want = eager(e_banks, p)
            require(all(torch.equal(g_stats[t][k], want[k]) for k in want),
                    f"rows {kind}: frame {t} stats != the eager program's")
        require(same_sharded(g_banks, e_banks)
                and (g_banks.counts() > 0).all(),
                f"rows {kind}: graphed != the eager mesh program")
        for b in range(ROW_STREAMS):
            solo = SH.Mesh([mesh.grid[b * mesh.shape["data"]
                                      // ROW_STREAMS]])
            s_banks = SH.replicate_banks(solo, cfg, 1)
            s_step, _ = graph(solo, s_banks)
            for t, p in enumerate(loads):
                got = s_step(p[b:b + 1])
                require(all(torch.equal(g_stats[t][k][b:b + 1],
                                        got[k].to(home)) for k in got),
                        f"rows {kind}: stream {b} frame {t} stats != the "
                        f"stream alone")
            require(same_stream(g_banks, b, s_banks), f"rows {kind}: "
                    f"stream {b} != the same stream alone on {solo}")
            del s_step, s_banks
        g_fps = steady_rate(graph(mesh, SH.replicate_banks(
            mesh, cfg, ROW_STREAMS))[0], loads, ROW_STREAMS)
        r_banks = SH.replicate_banks(mesh, cfg, ROW_STREAMS)
        e_fps = steady_rate(lambda p: eager(r_banks, p), loads, ROW_STREAMS)
        unit = "pairs" if stereo else "frames"
        say(phase, f"rows {kind}, {label}, {n} {unit} at {cfg.height} x "
            f"{cfg.width}: graphed == the eager mesh "
            f"program (stats and every cell torch.equal); each stream "
            f"torch.equal to the stream alone on a one-row mesh of its "
            f"row's cells; device runs {ex['runs']} ({per_cell} per cell "
            f"and step on {n_cells} cells, "
            + ", ".join(f"cuda:{c} {k} cells" for c, k in on_card.items())
            + f"; {ex['launches']} graph launches, {ex['lost']} left no "
            f"record); aggregate {g_fps:.2f} frames/s graphed, {e_fps:.2f} "
            f"eager ({n - 1} steady steps); step pool {pool_mib(pool):.1f} "
            f"MiB")
        if not stereo:
            say(phase, f"rows, {label}: " + rows_bank_programs(
                cfg, mesh, g_banks, e_banks))
        del step, g_banks, e_banks, r_banks
    return total


def phase_multicard(frames, pairs, smi: str) -> dict:
    """The sharded drivers on meshes over every card of this machine
    (`make_mesh(n)`: one cell per card; `make_mesh(2 n)`: two per card),
    each mesh program one captured graph over the cards: against the eager
    mesh programs on the same cards and the same mesh shape on virtual
    shards of card 0 (torch.equal on every shard, before and after a loop
    warp; the host pool's arrays equal too) and the dense drive (1e-4 m):
    ShardedDeviceResidentMapping replicated, frame-sharded (24 frames
    under the sync check after the first) and stereo (4 pairs);
    ShardedSurfelMapping over the 60 host-pool frames (reads allowed);
    launches by the profiler's records on each card; B5's cooperative
    node on every card; the sharded SGM's replay == its eager call == the
    plain replicated disparity; `make_mesh(n, data=2)`;
    `entry.dryrun_multichip(n)` and `(2 n)`; graphed, eager and one-card
    virtual-shard frames/s (median of 3), device busy ms per card, each
    card's pool MiB and peak memory, the peer links.  On one card it
    prints that it needs 2 or more and returns nothing.  Returns the
    device runs of the kernels in the graphed drives."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        say("multicard", f"needs 2 or more cards; this machine has "
            f"{n_cards}: not run")
        return {}
    return multicard_checks(n_cards, frames, pairs)


def multicard_checks(n_cards: int, frames, pairs) -> dict:
    """The body of `phase_multicard` over cards 0 .. n_cards - 1 (with
    n_cards = 1 it runs on one card, every mesh virtual)."""
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.entry import dryrun_multichip
    from densesurfelmapping_tpu_torch.models import stereo as ST
    from densesurfelmapping_tpu_torch.parallel import sgm_sharding
    from densesurfelmapping_tpu_torch.parallel.sharding import (capture_plan,
                                                                make_mesh)
    from densesurfelmapping_tpu_torch.pipeline.device_driver import (
        DeviceResidentMapping, ShardedDeviceResidentMapping)
    from densesurfelmapping_tpu_torch.pipeline.driver import SurfelMapping
    from densesurfelmapping_tpu_torch.pipeline.sharded_driver import (
        ShardedSurfelMapping)

    EagerSharded, EagerShardedPool = sharded_eager_classes()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    cards_label = "; ".join(f"cuda:{k} {c}" for k, c in enumerate(cards))
    say("multicard", f"{n_cards} cards: {cards_label}")
    for line in link_lines(n_cards):
        say("multicard", line)
    home = torch.device("cuda", 0)
    cfg = kitti_config(surfel_capacity=1 << 21, compact_interval=16)
    hp_cfg = dataclasses.replace(cfg, compaction_slack=HOST_POOL_SLACK,
                                 compact_upload=False)
    scfg = sgm_config()
    drive_frames = frames[:N_SHARDED]
    pairs = pairs[:N_SHARDED_STEREO]
    slic = dict.fromkeys(SLIC, cfg.sp_iters)
    no_sgm = dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=0)
    per_cell = {"sharded": dict(no_sgm, **slic),
                "frame-sharded": dict(no_sgm, **dict.fromkeys(SLIC, 0)),
                "stereo": dict(slic, sgm_census_x=1, sgm_census_y=1,
                               sgm_axis_scan=0)}
    total: dict = {}

    def make(kind, mesh, cls=None):
        return (cls or ShardedDeviceResidentMapping)(
            cfg, mesh, frame_sharded=(kind == "frame-sharded"))

    def run(kind, drv, checked=False):
        if kind == "stereo":
            feed_pairs(drv, pairs, scfg, checked)
        else:
            feed(drv, drive_frames, checked)
        return drv

    def stereo(drv):
        drv.enable_stereo(bf=cfg.camera.fx * BASELINE_M, stereo_config=scfg)
        return drv

    def rate(kind, mesh, cls=None) -> float:
        """Steady frames/s of a fresh drive of `kind` over `mesh`."""
        if kind == "host pool":
            return drive_host_pool(cls or ShardedSurfelMapping, hp_cfg,
                                   home, frames, mesh=mesh)[1]
        if kind == "stereo":
            return rated(lambda: stereo(make(kind, mesh, cls)), None, pairs,
                         0, len(pairs))[0]
        return rated(lambda: make(kind, mesh, cls), drive_frames, None, 0,
                     N_SHARDED)[0]

    fed = {"stereo": f"{len(pairs)} pairs",
           "host pool": f"{len(frames)} frames"}

    if n_cards % 2 == 0:
        add_runs(total, rows_check(cfg, make_mesh(n_cards, data=2), frames,
                                   pairs, "multicard"))
    for n in (n_cards, 2 * n_cards):
        out = dryrun_multichip(n)
        say("multicard", f"entry.dryrun_multichip({n}) on every card: {out}")

    # the dense references on card 0
    dense = {}
    for kind in ("sharded", "stereo"):
        d = run(kind, DeviceResidentMapping(cfg, device=home))
        dense[kind] = sharded_rows(d)
    dense["frame-sharded"] = dense["sharded"]
    dense_pool = drive_host_pool(SurfelMapping, hp_cfg, home, frames)[0]
    dense_rows = (sharded_rows(dense_pool),
                  sharded_rows_of(dense_pool.pool.all_surfels()))
    del d, dense_pool

    for n_cells in (n_cards, 2 * n_cards):
        mesh = make_mesh(n_cells)
        virtual = make_mesh(n_cells, devices=home)
        plan = capture_plan(mesh)
        on_card = {d.index: len(c["cells"]) for d, c in plan["cards"].items()}
        label = f"{n_cells} cells on {n_cards} cards"
        require(plan["graphed"], f"{label}: not graphed")
        say("multicard", f"{label}: capture plan: home {plan['home']}; "
            + "; ".join(f"{d}: lane {c['lane']}, pool {c['pool']}, cells "
                        f"{c['cells']} on cell streams {c['streams']}"
                        for d, c in plan["cards"].items()))
        for kind in ("sharded", "frame-sharded", "stereo"):
            for k in range(n_cards):
                torch.cuda.reset_peak_memory_stats(k)
            drv, ex = executed(lambda: run(kind, make(kind, mesh), True))
            sync_all()
            peak = {k: torch.cuda.max_memory_allocated(k) / 2**20
                    for k in range(n_cards)}
            add_runs(total, ex["runs"])
            steps = len(pairs) if kind == "stereo" else N_SHARDED
            require(drv.graphed and ex["captures"] == 1,
                    f"{label} {kind}: graphed {drv.graphed}, "
                    f"{ex['captures']} steps captured")
            check_runs(ex, {k: v * n_cells
                            for k, v in per_cell[kind].items()}, steps,
                       f"{label} {kind}")
            check_card_runs(ex, per_cell[kind], on_card, steps,
                            f"{label} {kind}")
            e = run(kind, make(kind, mesh, EagerSharded))
            v = run(kind, make(kind, virtual))
            require(same_sharded(drv.bank, e.bank), f"{label} {kind}: "
                    f"graphed != the eager mesh programs on the same cards")
            require(same_sharded(drv.bank, v.bank), f"{label} {kind}: "
                    f"!= the same mesh on virtual shards of one card")
            err = same_map(sharded_rows(drv), dense[kind],
                           f"{label} {kind}")
            werr = check_warp(drv)
            check_warp(e)
            check_warp(v)
            require(same_sharded(drv.bank, e.bank)
                    and same_sharded(drv.bank, v.bank),
                    f"{label} {kind}: after the loop warp graphed != eager "
                    f"!= virtual")
            replays = (drv._compact_graph.replays,
                       drv._pose_warp_graph.replays)
            require(replays[1] == 1 and replays[0] == drv.compactions,
                    f"{label} {kind}: compaction/warp replays {replays}")
            step = drv._stereo_graph if kind == "stereo" else drv._fuse_graph
            coop = ""
            if kind == "stereo":
                nodes = mesh_kernel_nodes(
                    lambda: step.fn(step.bank, *step.inputs), mesh.devices())
                coops = [(c, gx, bx) for c, gx, bx, co in nodes if co]
                per = {card: sum(c == card for c, _, _ in coops)
                       for card in on_card}
                require(per == on_card, f"{label}: cooperative kernel "
                        f"nodes by card {per}, want one B5 per cell "
                        f"{on_card}")
                coop = (f"; B5's node cooperative in the mesh graph on "
                        f"every card ({per} by card, grid x block "
                        f"{sorted({(gx, bx) for _, gx, bx in coops})})")
            ran = {c: {k: n for k, n in r.items() if per_cell[kind][k]}
                   for c, r in sorted(ex["card_runs"].items())}
            say("multicard", f"{label}, {kind} drive ({steps} "
                f"{'pairs' if kind == 'stereo' else 'frames'}), graphed "
                f"under the sync check after the first: every shard "
                f"torch.equal to the eager mesh programs' on the same "
                f"cards and to the same mesh on {n_cells} virtual shards "
                f"of cuda:0, before and after a loop warp (within "
                f"{werr:.2e} m); {len(sharded_rows(drv)['color'])} surfels "
                f"== the dense drive's within {err:.3g} m; capture "
                f"{step.capture_ms:.1f} ms; device runs by card {ran}"
                f"{coop}; steps' pool MiB by card "
                f"{pool_mib_by_card(drv._graph_pool)}, bank programs' "
                f"{pool_mib_by_card(drv._bank_pool)}; peak MiB by card "
                + ", ".join(f"cuda:{k} {m:.1f}" for k, m in peak.items()))
            del drv, e, v

        # the host-pool driver over the mesh
        (g, _, _, reads), ex = executed(lambda: drive_host_pool(
            ShardedSurfelMapping, hp_cfg, home, frames, sync_checked=True,
            mesh=mesh))
        add_runs(total, ex["runs"])
        require(g.graphed and ex["captures"] == 1, f"{label} host pool: "
                f"graphed {g.graphed}, {ex['captures']} steps captured")
        check_runs(ex, {k: cfg.sp_iters * n_cells for k in SLIC},
                   len(frames), f"{label} host pool")
        e = drive_host_pool(EagerShardedPool, hp_cfg, home, frames,
                            mesh=mesh)[0]
        v = drive_host_pool(ShardedSurfelMapping, hp_cfg, home, frames,
                            mesh=virtual)[0]

        def pools_equal():
            return (same_sharded(g.bank, e.bank) and same_pool(g.pool, e.pool)
                    and same_sharded(g.bank, v.bank)
                    and same_pool(g.pool, v.pool))
        require(pools_equal(), f"{label} host pool: graphed != eager != "
                f"virtual (banks torch.equal, pool arrays equal)")
        err = max(same_map(sharded_rows(g), dense_rows[0],
                           f"{label} host pool bank"),
                  same_map(sharded_rows_of(g.pool.all_surfels()),
                           dense_rows[1], f"{label} host pool pool"))
        for drv in (g, e, v):
            drv._do_compact()
        werr = check_warp(g)
        check_warp(e)
        check_warp(v)
        require(pools_equal(), f"{label} host pool: after a compaction and "
                f"the loop warp graphed != eager != virtual")
        replays = {name: getattr(g, f"_{name}_graph").replays for name in
                   ("fuse", "compact", "extract", "append", "warp")}
        say("multicard", f"{label}, ShardedSurfelMapping (host pool, padded "
            f"upload) over {len(frames)} frames, graphed: banks torch.equal "
            f"and pool ({len(g.pool)} surfels) equal to the eager mesh "
            f"programs' and to {n_cells} virtual shards of cuda:0, before "
            f"and after a compaction and a loop warp (within {werr:.2e} "
            f"m); == the dense host pool within {err:.3g} m; replays "
            f"{replays}; sync check: {reads['frames'] - reads['reading']} "
            f"of {reads['frames']} frames after the first read nothing, "
            f"the rest only in " + ", ".join(
                f"{k} x{reads[k]}" for k in HOST_POOL_READS + ("capture",))
            + f"; steps' pool MiB by card {pool_mib_by_card(g._graph_pool)}"
            f", bank programs' {pool_mib_by_card(g._bank_pool)}")
        del g, e, v

        # the sharded SGM: replay == eager call == plain == virtual replay
        # (KITTI size on one cell per card: each capture takes seconds)
        scfg_p = scfg._replace(sgm_pallas=False)
        for tag in ("61 x 97 crop", "KITTI")[:2 if n_cells == n_cards
                                             else 1]:
            li, ri = pairs[0][0], pairs[0][1]
            left = torch.from_numpy(li).to(home).float()
            right = torch.from_numpy(ri).to(home).float()
            cfg_c = scfg_p
            if tag != "KITTI":
                left, right = left[100:161, 300:397], right[100:161, 300:397]
                cfg_c = scfg_p._replace(max_disparity=40, min_disparity=3)
            h, w = left.shape
            want = ST.disparity(left, right, cfg_c)
            sync_all()
            t0 = time.perf_counter()
            eager = sgm_sharding.sharded_sgm_disparity(mesh, cfg_c, h, w)(
                left, right)
            sync_all()
            eager_s = time.perf_counter() - t0
            graph = sgm_sharding.graphed_sharded_sgm_disparity(mesh, cfg_c,
                                                               h, w)
            first = graph(left, right).clone()
            sync_all()
            t0 = time.perf_counter()
            got = graph(left, right)
            sync_all()
            replay_s = time.perf_counter() - t0
            vgraph = sgm_sharding.graphed_sharded_sgm_disparity(
                virtual, cfg_c, h, w)
            vgot = vgraph(left, right)
            require(graph.graphed and graph.replays == 2,
                    f"{label} sharded SGM ({tag}): graphed {graph.graphed}")
            require(torch.equal(first, eager) and torch.equal(got, eager)
                    and torch.equal(got, want) and torch.equal(got, vgot),
                    f"{label} sharded_sgm_disparity ({tag}): replay != "
                    f"eager != plain != virtual")
            say("multicard", f"{label}, sharded_sgm_disparity {tag} ({h} x "
                f"{w}): the replays == the eager call == the replicated "
                f"plain disparity == the virtual-shard replay (torch.equal);"
                f" eager {eager_s:.3f} s, capture {graph.capture_ms / 1e3:.3f}"
                f" s, replay {replay_s:.3f} s, pool MiB by card "
                f"{pool_mib_by_card(graph.pool)} (plain scans)")
            del graph, vgraph

        # rates: graphed and eager over the cards, graphed on one card
        kinds = (("sharded", "host pool", "frame-sharded", "stereo")
                 if n_cells == n_cards else ("sharded",))
        for kind in kinds:
            eager = EagerShardedPool if kind == "host pool" else EagerSharded
            for name, on, cls in (
                    ("graphed", mesh, None), ("eager", mesh, eager),
                    (f"one card, {n_cells} virtual shards", virtual, None)):
                runs = [rate(kind, on, cls) for _ in range(N_RATE)]
                say("multicard", median_line(
                    f"{label} {kind} {name}", runs,
                    fed.get(kind, f"{N_SHARDED} frames"))
                    + f" ({cards_label})")
        for kind in ("sharded", "stereo") if n_cells == n_cards else (
                "sharded",):
            drv = make(kind, mesh)
            if kind == "stereo":
                stereo(drv)
            step, _ = steps_of(drv, drive_frames,
                               pairs if kind == "stereo" else None)
            n_prof = len(pairs) - 2 if kind == "stereo" else N_PROF
            say("multicard", f"{label} {kind} graphed, {n_prof} "
                f"{'pairs' if kind == 'stereo' else 'frames'} under the "
                f"profiler: " + cards_line(profiled_cards(step, 2, n_prof)))
            del drv

    return total


def add_runs(total: dict, runs: dict) -> None:
    for k, v in runs.items():
        total[k] = total.get(k, 0) + v


PHASES = ("kernels", "sgm", "drive", "stereo", "graph", "multi-kernels",
          "multi", "multi-stereo", "batch", "sharded", "multicard", "cli",
          "profile")


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
    batched = {}
    if run("multi-kernels"):
        # every kernel timing runs before the first captured graph
        batched = phase_multi_kernels(device, records)
        batched.update(phase_multi_sgm(device))
        lap("multi-kernels")

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
        (drv, _), ex = executed(lambda: drive(cfg, frames, device,
                                              pipelined=False,
                                              sync_checked=True))
        add(ex["runs"])
        say("drive", f"kernel launches in the drive: wrapper calls "
            f"{ex['calls']}, device runs {ex['runs']} (profiler kernel "
            f"records), {ex['captures']} graph captured, {ex['launches']} "
            f"graph launches ({ex['lost']} left no device record)")
        require(ex["captures"] == 1 and drv.frames_fused == N_FRAMES,
                f"depth-fed drive: {ex['captures']} captures, "
                f"{drv.frames_fused} frames")
        check_runs(ex, dict(sgm_census_x=0, sgm_census_y=0, sgm_axis_scan=0,
                            **{k: cfg.sp_iters for k in SLIC}), N_FRAMES,
                   f"depth-fed drive (SLIC {cfg.sp_iters}x per frame)")
        rows_a = bank_to_numpy(drv.bank)
        stats = check_map(rows_a, drv, synthetic.default_scene().ground_y)
        say("drive", f"map: {stats['live']} live surfels, {stats['ground']} "
            f"stable ground surfels, mean |y - ground| "
            f"{stats['ground_err_m']:.3e} m (bound {GROUND_GATE_M}), "
            f"{stats['compactions']} compactions; steady feed raised no "
            f"host-device sync")
        say("drive", f"loop warp: every live surfel moved by the shift "
            f"within {check_warp(drv):.2e} m (bound {WARP_TOL_M})")

        _, fps = drive(cfg, frames, device, pipelined=False,
                       sync_checked=False)
        drv_p, fps_p = drive(cfg, frames, device, pipelined=True,
                             sync_checked=False)
        rows_p = bank_to_numpy(drv_p.bank)
        require(len(rows_p["color"]) == len(rows_a["color"]),
                "pipelined drive: bank count differs")
        for k, v in rows_a.items():
            require(bool(np.allclose(rows_p[k], v, atol=1e-5)),
                    f"pipelined drive: bank.{k} differs")
        say("rate", f"{N_FRAMES} frames: {fps:.2f} frames/s unpipelined, "
            f"{fps_p:.2f} frames/s pipelined (the steady feed after the "
            f"first frame), same map ({smi})")
        del drv, drv_p
    lap("drive (renders included)")

    pairs = None
    if run("stereo") or run("multi-stereo"):
        n, pairs = phase_stereo(device)
        add(n)
        lap("stereo")
    if run("graph"):
        if pairs is None:
            pairs = make_pairs(cfg, N_STEREO_FRAMES)
        add(phase_graph(device, frames, pairs, smi))
        add(phase_graph_host_pool(device, frames, pairs, smi))
        lap("graph")
    if run("multi"):
        add(phase_multi(device, frames, smi)["launches"])
        lap("multi")
    if run("multi-stereo"):
        add(phase_multi_stereo(device, pairs, smi))
        lap("multi-stereo")
    if run("batch"):
        add(phase_batch(device, frames))
        lap("batch")
    if run("sharded") or run("multicard"):
        if pairs is None:
            pairs = make_pairs(cfg, N_SHARDED_STEREO)
    if run("sharded"):
        add(phase_sharded(device, frames, pairs, smi))
        lap("sharded")
    if run("multicard"):
        add(phase_multicard(frames, pairs, smi))
        lap("multicard")
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
            launches=launches[name],
            launches_counted_by="device runs: the profiler's kernel records "
            "of each run of the main paths (a graph replay launches the "
            "kernels without calling their wrappers); eager runs: the "
            "wrappers' counts",
            max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=None)
        if name in batched:
            # the stream axis: one launch for the fleet's streams
            b = batched[name]
            entry["batched"] = dict(
                route=b.get("route", "grid z = stream"),
                streams=b["streams"],
                ms_1=b["us_1"] / 1e3, ms=b["us_n"] / 1e3,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=b["max_abs_err"])
            if "wide_route" in b:
                w = b["wide_route"]
                entry["batched"]["wide_route"] = dict(
                    route="scan_lines_kernel grid z = stream + one combine "
                    "pass", streams=w["streams"], d=w["d"],
                    ms_1=w["us_1"] / 1e3, ms=w["us_n"] / 1e3)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
