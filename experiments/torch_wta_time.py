"""Time the stereo matcher's WTA kernel (`csrc/wta.cu`) at KITTI size on one
NVIDIA GPU for each number of planes whose loads a thread issues before
their compare chains (`unroll`: 1, 4, 8, 16), in turns.

    python3 experiments/torch_wta_time.py

The input is chip_smoke.py's `wta` phase input: the census SGM aggregate
(8 paths, B6 + B5) of the synthetic scene's first KITTI-size stereo pair,
(127, 376, 1241) f32, 237 MB, larger than the card's 50 MB L2, so each
launch reads it from device memory.  A launch's time is CUDA events around
REPS back-to-back launches (the kernel runs far longer than the host takes
to launch it), in ROUNDS rounds that visit the variants forwards and back
(1 4 8 16 16 8 4 1 ...); every variant's outputs are checked torch.equal to
the default's first.  Prints one JSON line: the card and its power limit as
nvidia-smi prints them, the bound (the volume read once and six (H, W)
outputs written once at 3.35 TB/s), and per variant the median, min and
max us a launch over its rounds.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys

ROUNDS, REPS, WARMUP = 6, 50, 5
VARIANTS = (1, 4, 8, 16)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, HERE)
    import torch
    from densesurfelmapping_tpu_torch.ops.cuda import wta as K

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = smoke.phase_device()
    vol = smoke.wta_volumes(torch.device("cuda"), 1)[0]
    D, h, w = vol.shape

    def run(unroll):
        # every output but the prior's costs (no prior plane: None)
        return K._launch_wta_scan(vol, 1, True, 0.95, unroll=unroll)[:6]

    want = run(K.UNROLL)
    for u in VARIANTS:
        got = run(u)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"unroll {u}: outputs differ")
    times = {u: [] for u in VARIANTS}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for r in range(ROUNDS):
        for u in (VARIANTS if r % 2 == 0 else VARIANTS[::-1]):
            for _ in range(WARMUP):
                run(u)
            start.record()
            for _ in range(REPS):
                run(u)
            stop.record()
            torch.cuda.synchronize()
            times[u].append(1e3 * start.elapsed_time(stop) / REPS)
    nbytes = D * h * w * 4 + 6 * h * w * 4
    print(json.dumps({
        "card": smi, "shape": [D, h, w],
        "bound_us": 1e6 * nbytes / smoke.HBM_BYTES_PER_S,
        "us_per_launch": {str(u): dict(median=statistics.median(t),
                                       min=min(t), max=max(t))
                          for u, t in times.items()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        raise SystemExit(f"usage: {sys.argv[0]}")
    main()
