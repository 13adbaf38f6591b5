"""Time the PyTorch port's SGM kernels at KITTI size on one NVIDIA GPU by
their device time, for one or more copies of the port, each in a process of
its own, in the order given: B6 (`census_x`), B5 (`census_y`, 8 and 4
paths) and B4 (`axis_scan` on the materialized census volume, its x family
and its y family of 8 and of 4 paths), all with f32 carries.

    python3 experiments/torch_sgm_time.py [ROOT ...]

ROOT is a directory holding a `densesurfelmapping_tpu_torch/` package (this
repository, or a copy unpacked with `git archive`); the default is this
repository.  Each copy builds its own kernels (under ROOT/build/kernels/).
Name the copies in an interleaved order (A B B A): a card's clocks drift
between processes, so compare copies only within one run of this script.

The inputs are chip_smoke.py's `sgm` phase inputs: the census images of the
synthetic scene's first KITTI-size stereo pair (1241 x 376, 127 disparities
from 1) and their cost volume.  A call's device time is the sum of the
profiler's records of the kernels it launches (this repository's
`chip_smoke.kernel_time`), over ROUNDS rounds of REPS calls after WARMUP;
B4's kernels are found by name in either design (PR 2's line kernel and
combine pass, or the warp-step kernels).  Each process prints one JSON
line: the root, the card and its power limit as nvidia-smi prints them, and
for each call the median, min and max device us per call over all calls,
each round's mean and the wrapper's host us per call; for B4 also the peak
device memory of one call (`torch.cuda.max_memory_allocated`, the volume
and out included), and the peak device memory of chip_smoke.py's
materialized-branch drive (`sgm_fused_census=False`, B4 twice a frame)
over its first DRIVE_PAIRS stereo pairs.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROUNDS, REPS, WARMUP = 3, 100, 5
DRIVE_PAIRS = 4
BASELINE_M = 0.54
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# B4's kernels in either design; a call's time sums those it launches
AXIS_KERNELS = {"x": ("axis_line_kernel",), "y": ("axis_band_kernel",)}
AXIS_KERNELS_LINES = ("scan_lines_kernel", "combine_axis_kernel")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K

    if not torch.cuda.is_available():
        raise SystemExit("torch_sgm_time: no CUDA card")
    cs = _chip_smoke()
    cfg = kitti_config()
    scfg = S.StereoConfig(max_disparity=128, aggregation="sgm")
    pose = synthetic.forward_trajectory(33, step=0.4)[0]
    right_pose = np.array(pose, np.float64).copy()
    right_pose[:3, 3] += right_pose[:3, 0] * BASELINE_M
    scene = synthetic.default_scene()
    census = []
    for p in (pose, right_pose):
        img, _ = scene.render(cfg, p)
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        census.append(S._census(torch.from_numpy(u8).cuda().float(),
                                scfg.census_radius))
    cl, cr = census
    min_d = scfg.min_disparity
    n_d = scfg.max_disparity - min_d
    p1, p2 = scfg.sgm_p1, scfg.sgm_p2
    buf = torch.zeros((n_d, *cl.shape), dtype=torch.float32, device="cuda")
    vol = S._census_volume(cl, cr, min_d, n_d)
    vx = vol.permute(2, 1, 0).contiguous()
    vy = vol.permute(1, 2, 0).contiguous()
    warp_b4 = hasattr(K, "axis_plan")      # the redesigned B4
    calls = {
        "census_x": (lambda: K.census_x(cl, cr, p1, p2, min_d, n_d),
                     ("census_x_kernel",)),
        "census_y_8path": (lambda: K.census_y(cl, cr, buf, (0, 1, -1), p1,
                                              p2, min_d),
                           ("census_y_kernel",)),
        "census_y_4path": (lambda: K.census_y(cl, cr, buf, (0,), p1, p2,
                                              min_d),
                           ("census_y_kernel",)),
        "axis_scan_x": (lambda: K.axis_scan(vx, (0,), p1, p2, False, "x",
                                            min_d),
                        AXIS_KERNELS["x"] if warp_b4 else AXIS_KERNELS_LINES),
        "axis_scan_y": (lambda: K.axis_scan(vy, (0, 1, -1), p1, p2, False,
                                            "y", min_d),
                        AXIS_KERNELS["y"] if warp_b4 else AXIS_KERNELS_LINES),
        "axis_scan_y_4path": (lambda: K.axis_scan(vy, (0,), p1, p2, False,
                                                  "y", min_d),
                              AXIS_KERNELS["x"] if warp_b4
                              else AXIS_KERNELS_LINES),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = dict(root=root, card=smi)
    for name, (fn, kernels) in calls.items():
        rounds = [cs.kernel_time(fn, kernels, reps=REPS, warmup=WARMUP)
                  for _ in range(ROUNDS)]
        per = [u for r in rounds for u in r["per_us"]]
        rec[name] = dict(
            kernels=list(kernels), median_us=statistics.median(per),
            min_us=min(per), max_us=max(per),
            round_mean_us=[r["us"] for r in rounds],
            host_us=[r["host_us"] for r in rounds])
        if name.startswith("axis_scan"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            rec[name]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    drive_cfg = kitti_config(surfel_capacity=1 << 19, compact_interval=16)
    pairs = cs.make_pairs(drive_cfg, DRIVE_PAIRS)
    mat = scfg._replace(sgm_fused_census=False)
    cs.drive_stereo(drive_cfg, pairs[:2], torch.device("cuda"), mat, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cs.drive_stereo(drive_cfg, pairs, torch.device("cuda"), mat, False)
    rec["materialized_drive_peak_mib"] = (torch.cuda.max_memory_allocated()
                                          / 2**20)
    print(json.dumps(rec), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    rc = 0
    for root in sys.argv[1:] or [HERE]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root])
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
