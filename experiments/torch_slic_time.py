"""Time the PyTorch port's SLIC kernels, B1 (`slic_assign`), B2
(`slic_centroid`) and B3 (`slic_huber`), by their device time at KITTI size
on one NVIDIA GPU, for one or more copies of the port, each in a process of
its own, in the order given.

    python3 experiments/torch_slic_time.py [ROOT ...]

ROOT is a directory holding a `densesurfelmapping_tpu_torch/` package (this
repository, or a copy unpacked with `git archive`); the default is this
repository.  Each copy builds its own kernels (under ROOT/build/kernels/).
Name the copies in an interleaved order (A B B A): a card's clocks drift
between processes, so compare copies only within one run of this script.

The inputs are chip_smoke.py's `kernels` phase inputs (this repository's
chip_smoke.py, whatever the copy): the first sweep of run_slic on the
synthetic scene's KITTI-size frame (1241 x 376, padded 1280 x 376, 7520
seeds).  A kernel's device time comes from the profiler's records of that
kernel (`chip_smoke.kernel_time`), over ROUNDS rounds of REPS launches after
WARMUP.  Each process prints one JSON line: the root, the card and its power
limit as nvidia-smi prints them; for each kernel the median, min and max
device us per launch over all launches, each round's mean, the device us of
every operation a wrapper call runs, and the wrapper's host us per call;
ptxas's registers and spills of each kernel, when the process built them;
the SM clock nvidia-smi samples every 20 ms while the wrapper is called
back to back for CLOCK_S seconds (median and the card's maximum); the
device us per call when REPS calls replay back to back from a CUDA graph
(CUDA events around the replay: no host work between launches, every
operation of a call counted); and, on the KITTI frame and at sp 6 and 16 on chip_smoke.py's 120 x 56
frame, the copy's kernels against its plain twins over run_slic's sweeps
(`chip_smoke.slic_diffs`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROUNDS, REPS, WARMUP = 3, 100, 5
CLOCK_S = 1.0
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sm_clock_mhz(torch, fn) -> dict:
    """Median SM clock (MHz) that nvidia-smi samples while fn() runs back
    to back for CLOCK_S seconds, and the card's maximum SM clock."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()       # the sampler is running
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < CLOCK_S:
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        rest, _ = proc.communicate(timeout=30)
    samples = [[int(v) for v in line.split(",")]
               for line in (first + rest).splitlines() if line.strip()]
    return dict(median=statistics.median(s[0] for s in samples),
                max_sm=max(s[1] for s in samples), samples=len(samples))


def graph_us(torch, fn) -> float:
    """Device us per call of REPS calls captured in a CUDA graph and
    replayed back to back (CUDA events around one replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(stop) / REPS


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.ops import superpixel as S
    from densesurfelmapping_tpu_torch.ops.cuda import build
    from densesurfelmapping_tpu_torch.ops.cuda import slic as K

    if not torch.cuda.is_available():
        raise SystemExit("torch_slic_time: no CUDA card")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    cfg = kitti_config()
    image, depth, inv_depth, seeds, asg0 = cs.slic_inputs(cfg, dev)
    args = (cfg, image, inv_depth, asg0, seeds.x, seeds.y,
            seeds.mean_intensity, seeds.mean_depth, seeds.stable)
    asg1, _ = S.assign_sweep(*args)
    _, _, _, _, nd, sum_d = S.seed_sums(cfg, image, depth, asg1)
    calls = {
        "slic_assign": lambda: K.slic_assign(*args),
        "slic_centroid": lambda: K.slic_centroid(cfg, image, depth, asg1),
        "slic_huber": lambda: K.slic_huber(cfg, depth, asg1,
                                           sum_d / nd.clamp_min(1.0),
                                           nd <= 0),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = dict(root=root, card=smi)
    for name, fn in calls.items():
        rounds = [cs.kernel_time(fn, (f"{name}_kernel",), reps=REPS,
                                 warmup=WARMUP) for _ in range(ROUNDS)]
        per = [u for r in rounds for u in r["per_us"]]
        rec[name] = dict(
            median_us=statistics.median(per), min_us=min(per),
            max_us=max(per), round_mean_us=[r["us"] for r in rounds],
            all_ops_us=[r["all_us"] for r in rounds],
            host_us=[r["host_us"] for r in rounds],
            sm_clock_mhz=sm_clock_mhz(torch, fn))
        try:
            rec[name]["graph_us"] = graph_us(torch, fn)
        except RuntimeError as err:      # a capture the copy cannot do
            rec[name]["graph_us"] = f"not measured: {err}"
    # ptxas's registers and spills per kernel, when this process built it
    rec["ptxas"] = [line.split(":", 1)[-1].strip() for line in
                    build.build_logs.get("slic", "").splitlines()
                    if "Compiling entry" in line or "Used" in line
                    or "spill" in line]
    rec["check_kitti"] = cs.slic_diffs(cfg, dev)
    for sp in (6, 16):
        rec[f"check_sp{sp}"] = cs.slic_diffs(cs.slic_config(sp), dev)
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
