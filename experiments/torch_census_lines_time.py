"""Time the census aggregate at KITTI size and D' 191 (the d192 cell's
matcher) on one NVIDIA GPU: the materialized route against the census
route, both in one process.

    python3 experiments/torch_census_lines_time.py

old, as `sgm_fused_census=False` runs it (`models/stereo._sgm_aggregate`):
the (191, 376, 1241) bf16 census volume (`_census_volume`), then for each
family its permuted `.contiguous()` copy and B4's wide route on it
(`axis_scan`: `scan_lines_kernel` + `combine_axis_kernel`), then the sum.
new (`census_aggregate` above 128 planes): for each family one
`sgm_census_lines` call, the same two kernels reading the Hamming cost from
the two census images, then the sum.

Pieces: `volume` (the build alone), `old_x` / `new_x` (the x family: copy
and B4 on the volume / census-fed B4), `old_y` / `new_y` (the y family of 8
paths), `old` / `new` (the whole aggregate: volume, both families, sum).
Each piece is captured in a CUDA graph, as the benchmark's stereo step
replays it, and timed replay by replay with CUDA events; each pair visits
old / new / new / old, REPS replays a visit, ROUNDS rounds: the median of
300 replays a piece.  The inputs are the census images of the synthetic
scene's first KITTI-size stereo pair (f32 carries, min_d 1).  Prints one
JSON line: the card and its power limit as nvidia-smi prints them, whether
new equals old bitwise, each family's bound (the two census images read and
the f32 family written once at 3.35 TB/s), per piece the median, min and
max us a replay, the device ops of one eager call (profiler records) and
the peak device memory one eager call adds.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys

ROUNDS, REPS, WARMUP = 2, 75, 3
N_D, MIN_D, P1, P2 = 191, 1, 1.0, 8.0
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.io import synthetic
    from densesurfelmapping_tpu_torch.models import stereo as S
    from densesurfelmapping_tpu_torch.ops.cuda import sgm as K

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = smoke.phase_device()
    cfg = kitti_config()
    pose = synthetic.forward_trajectory(3, step=0.4)[0]
    right = np.array(pose, np.float64)
    right[:3, 3] += right[:3, 0] * 0.54
    scene = synthetic.default_scene()
    cl, cr = [S._census(torch.from_numpy(np.clip(
        scene.render(cfg, p)[0], 0, 255).astype(np.uint8)).cuda().float(),
        2) for p in (pose, right)]
    h, w = cl.shape
    rolls = (0, 1, -1)

    def old_x(vol):
        return K.axis_scan(vol.permute(2, 1, 0).contiguous(), (0,), P1, P2,
                           False, "x", MIN_D)

    def old_y(vol):
        return K.axis_scan(vol.permute(1, 2, 0).contiguous(), rolls, P1, P2,
                           False, "y", MIN_D)

    def new(_):
        return K.census_aggregate(cl, cr, rolls, P1, P2, MIN_D, N_D)

    def old(_):
        return S._sgm_aggregate(S._census_volume(cl, cr, MIN_D, N_D), P1,
                                P2, 8, use_kernels=True, min_d=MIN_D)

    vol = S._census_volume(cl, cr, MIN_D, N_D)

    def new_family(entry, rs):
        return lambda _: K._census_lines_family(cl, cr, rs, entry, P1, P2,
                                                MIN_D, N_D, False)

    pieces = {
        "volume": lambda _: S._census_volume(cl, cr, MIN_D, N_D),
        "old_x": old_x, "new_x": new_family("x", (0,)),
        "old_y": old_y, "new_y": new_family("y", rolls),
        "old": old, "new": new}
    same = {k: bool(torch.equal(pieces["old_" + k](vol),
                                pieces["new_" + k](None)))
            for k in ("x", "y")}
    same["aggregate"] = bool(torch.equal(old(None), new(None)))

    ops, peak = {}, {}
    for name, fn in pieces.items():
        fn(vol)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(vol)
            torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
        ops[name] = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)

    graphs = {}
    for name, fn in pieces.items():
        fn(vol)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(vol)
        graphs[name] = g
    start = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    stop = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    times = {k: [] for k in pieces}

    def visit(name):
        g = graphs[name]
        for _ in range(WARMUP):
            g.replay()
        for i in range(REPS):
            start[i].record()
            g.replay()
            stop[i].record()
        torch.cuda.synchronize()
        times[name] += [1e3 * a.elapsed_time(b) for a, b in zip(start, stop)]

    for _ in range(ROUNDS):
        visit("volume")
        for a, b in (("old_x", "new_x"), ("old_y", "new_y"),
                     ("old", "new")):
            for name in (a, b, b, a):
                visit(name)
    fam_bytes = 2 * h * w * 4 + h * w * N_D * 4
    print(json.dumps({
        "card": smi, "shape": [N_D, h, w], "bitwise_equal": same,
        "bound_us_a_family": 1e6 * fam_bytes / smoke.HBM_BYTES_PER_S,
        "us_per_replay": {k: dict(median=statistics.median(t), min=min(t),
                                  max=max(t), n=len(t))
                          for k, t in times.items()},
        "device_ops_a_call": ops, "peak_bytes_a_call": peak}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        raise SystemExit(f"usage: {sys.argv[0]}")
    main()
