"""Time the PyTorch port's census SGM kernels, B6 (`census_x`) and B5
(`census_y`), at KITTI size on one NVIDIA GPU, for one or more copies of the
port, each in a process of its own, in the order given.

    python3 experiments/torch_sgm_time.py [ROOT ...]

ROOT is a directory holding a `densesurfelmapping_tpu_torch/` package (this
repository, or a copy unpacked with `git archive`); the default is this
repository.  Each copy builds its own kernels (under ROOT/build/kernels/).
Name the copies in an interleaved order (A B B A): a card's clocks drift
between processes, so compare copies only within one run of this script.

The inputs are chip_smoke.py's `sgm` phase inputs: the census images of the
synthetic scene's first KITTI-size stereo pair (1241 x 376, 127 disparities
from 1).  Each process prints one JSON line: the root, the card and its
power limit as nvidia-smi prints them, and for census_x and census_y (8 and
4 paths), f32 carries, the mean us per launch of ROUNDS rounds of REPS
launches, each timed with CUDA events after WARMUP launches.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROUNDS, REPS, WARMUP = 3, 100, 5
BASELINE_M = 0.54


def time_us(torch, fn) -> list:
    for _ in range(WARMUP):
        fn()
    out = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(1e3 * start.elapsed_time(stop) / REPS)
    return out


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = dict(
        root=root, card=smi,
        census_x_us=time_us(torch, lambda: K.census_x(cl, cr, p1, p2, min_d,
                                                      n_d)),
        census_y_8path_us=time_us(torch, lambda: K.census_y(
            cl, cr, buf, (0, 1, -1), p1, p2, min_d)),
        census_y_4path_us=time_us(torch, lambda: K.census_y(
            cl, cr, buf, (0,), p1, p2, min_d)))
    print(json.dumps(rec), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = 0
    for root in sys.argv[1:] or [here]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root])
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
