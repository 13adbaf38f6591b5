"""The port's window (`utils/timing.py`) over untraced and traced stretches of
the benchmark's cells, on one NVIDIA GPU.

    python3 experiments/torch_window.py [--cells kitti00_depth.replay,...]
        [--seed N] [--seconds 4] [--stretches utu] [--out PATH]

Each cell is set up and warmed up as `benchmark.harness.run_cell` does it,
then fed for one stretch of `--seconds` per letter of `--stretches`: `u`
untraced inside `timing.window()`, `t` under the benchmark's profiler
(`trace.profiled`, the window the profiler opens).  Each stretch ends on a
synchronize and reports the window's readings per fused frame
(`timing.last_window()`: host ms by stage, device ms by phase and between
replays, the mean device backlog) and its frames/s.  The untraced
stretches show what the profiler's own cost (CUPTI records every node of a
replayed graph) hides in the traced one.  Prints one JSON line, also
written to `--out`, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from benchmark import harness, trace  # noqa: E402
from densesurfelmapping_tpu_torch.utils import timing  # noqa: E402

CELLS = "kitti00_depth.replay,kitti00_stereo.replay"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def stretch(run, seconds: float, traced: bool) -> dict:
    """One stretch; its frames/s from its first feed to the synchronize
    after its last (the profiler's start and its processing left out)."""
    if traced:
        with trace.profiled():
            fused0, t0 = run.prog.fused(), time.perf_counter()
            trace.run_padded(run.frame, seconds)
            run.sync()
            s = time.perf_counter() - t0
    else:
        with timing.window():
            fused0, t0 = run.prog.fused(), time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                run.frame()
            run.sync()
            s = time.perf_counter() - t0
    w = timing.last_window()
    return dict(traced=traced, seconds=s,
                frames_per_s=(run.prog.fused() - fused0) / s,
                keyframes=len(run.prog.drv.graph),
                host_ms=w["host_ms"], device_ms=w["device_ms"],
                programs_ms=w["programs_ms"],
                between_replays_ms=w["between_replays_ms"],
                backlog_frames=w["backlog_frames"], frames=w["frames"],
                stamps=w["stamps"])


def cell_windows(cell: harness.Cell, seed: int, seconds: float,
                 stretches: str = "utu", device: str = "cuda") -> dict:
    run = harness.Run(cell, seed, device)
    run.warm_up()
    out = [stretch(run, seconds, k == "t") for k in stretches]
    run.free_program()
    return dict(cell=cell.name, seed=seed, stretches=out)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default=CELLS)
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--stretches", default="utu")
    p.add_argument("--out", default=os.path.join(HERE, "build",
                                                 "window.json"))
    a = p.parse_args()
    res = dict(card=card(), cells=[
        cell_windows(harness.load_cell(c), a.seed, a.seconds, a.stretches)
        for c in a.cells.split(",")])
    line = json.dumps(res)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
