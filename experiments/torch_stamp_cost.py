"""What the port's tracer costs (`utils/timing.py`) on one NVIDIA GPU.

    python3 experiments/torch_stamp_cost.py [--replays 300] [--rounds 4]
        [--out PATH]

Device: the captured fuse step of the benchmark's two deployments
(`benchmark/configs/kitti00_depth.json` and `kitti00_stereo.json`: the
depth-fed one-buffer step and the census-SGM stereo step at KITTI size,
2^21 bank rows) replayed back to back, with its device stamps ("new") and
captured with `timing.phase` and `timing.replay_stamps` patched to no-ops
("old").  Each variant captures its graph once, on its own clone of one
warmed bank (30 frames of the synthetic scene fused), and replays one
payload; `--rounds` rounds of old, new, new, old each restore the bank to
the warmed state in place and time `--replays` replays by CUDA events (the
device us a replay: their time over their count).  The "new" runs read
their stamps back from the ring: stamps a replay and, for the last run,
device ms a replay by phase (`timing.phase_times`).

Host: the us a `StageTimer.stage` costs with no profiler, and while a
profiler records (the `dsm.<stage>` annotation and the window's total),
against a bare `perf_counter` pair; and `timing.count_frame` with the
window open (one event recorded, the finished ones queried).  Prints one
JSON line, also written to `--out`, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from densesurfelmapping_tpu_torch.config import SurfelMapConfig  # noqa: E402
from densesurfelmapping_tpu_torch.core.state import (  # noqa: E402
    SurfelBank, pack_aux, pack_frame_with_aux, pack_stereo_pair,
    pack_stereo_with_aux)
from densesurfelmapping_tpu_torch.io import synthetic  # noqa: E402
from densesurfelmapping_tpu_torch.models.stereo import (  # noqa: E402
    StereoConfig)
from densesurfelmapping_tpu_torch.pipeline import fuse_step  # noqa: E402
from densesurfelmapping_tpu_torch.utils import timing  # noqa: E402

BASELINE_M = 0.54          # KITTI's stereo baseline
WARM_FRAMES = 30
HOST_REPS = 20000


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return dict(name=torch.cuda.get_device_name(0), nvidia_smi=out.strip())


def deployment(name: str):
    doc = json.load(open(os.path.join(HERE, "benchmark", "configs",
                                      f"{name}.json")))
    cfg = SurfelMapConfig.from_json(json.dumps(doc["mapper"]))
    st = StereoConfig(**doc["stereo"]) if doc.get("stereo") else None
    return cfg, st


def payloads(cfg, st, n: int) -> list:
    """n one-buffer payloads of the synthetic scene along a straight
    drive, each frame its own keyframe in a window of all."""
    scene = synthetic.default_scene()
    mask = np.ones(cfg.max_keyframes, bool)
    bf = cfg.camera.fx * BASELINE_M
    out = []
    for i, pose in enumerate(synthetic.forward_trajectory(n, step=0.4)):
        aux = pack_aux(pose, i, mask, bf=bf if st else 0.0)
        img, dep = scene.render(cfg, pose)
        if st is None:
            out.append(pack_frame_with_aux(cfg, img, dep, aux))
            continue
        rp = np.array(pose, np.float64).copy()
        rp[:3, 3] += rp[:3, 0] * BASELINE_M
        right, _ = scene.render(cfg, rp)
        u8 = lambda x: np.clip(x, 0, 255).astype(np.uint8)  # noqa: E731
        out.append(pack_stereo_with_aux(
            cfg, pack_stereo_pair(cfg, u8(img), u8(right)), aux))
    return out


def step_graph(cfg, st, bank):
    if st is None:
        return fuse_step.graphed_fuse_frame_onebuf(cfg, bank)
    return fuse_step.graphed_fuse_frame_stereo_onebuf(cfg, st, True, bank)


def clone(bank: SurfelBank) -> SurfelBank:
    return SurfelBank(**{f: getattr(bank, f).clone()
                         for f in bank.__dataclass_fields__})


@contextlib.contextmanager
def unstamped_capture():
    """The "old" step: its phases and replay stamps patched to no-ops."""
    saved = timing.phase, timing.replay_stamps
    timing.phase = lambda name, device: contextlib.nullcontext()
    timing.replay_stamps = lambda name, device: contextlib.nullcontext()
    try:
        yield
    finally:
        timing.phase, timing.replay_stamps = saved


def cursor() -> int:
    return 0 if timing._ring is None else int(timing._ring.cursor.item())


def variant(cfg, st, base, payload, stamped: bool):
    """A step captured on its own clone of the base bank; "old" with its
    stamps patched out."""
    bank = clone(base)
    with contextlib.nullcontext() if stamped else unstamped_capture():
        step = step_graph(cfg, st, bank)
        step.load(torch.from_numpy(payload))
        step.replay()                  # the capture
    return bank, step


def time_replays(base, bank, step, n: int) -> tuple:
    """n replays from the base bank's state: (device us a replay, the
    ring's cursor before and after)."""
    for f in base.__dataclass_fields__:
        getattr(bank, f).copy_(getattr(base, f))
    step.replay()                      # warm
    torch.cuda.synchronize()
    c0 = cursor()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        step.replay()
    t1.record()
    torch.cuda.synchronize()
    return 1e3 * t0.elapsed_time(t1) / n, c0, cursor()


def device_ab(name: str, n: int, rounds: int) -> dict:
    cfg, st = deployment(name)
    pays = payloads(cfg, st, WARM_FRAMES + 1)
    base = SurfelBank.empty(cfg.surfel_capacity, "cuda")
    warm = step_graph(cfg, st, base)
    for p in pays[:WARM_FRAMES]:
        warm(torch.from_numpy(p))
    torch.cuda.synchronize()
    del warm
    steps = {k: variant(cfg, st, base, pays[-1], k == "new")
             for k in ("old", "new")}
    us = {"old": [], "new": []}
    stamps, phases = [], None
    for _ in range(rounds):
        for k in ("old", "new", "new", "old"):
            t, c0, c1 = time_replays(base, *steps[k], n)
            us[k].append(t)
            if k == "old":
                assert c1 == c0, "the old step wrote stamps"
                continue
            stamps.append((c1 - c0) / n)
            ring = timing._ring.entries.cpu().numpy()
            phases = timing.phase_times(timing.ring_entries(ring, c0, c1),
                                        timing._keys)
    pairs = [b / a - 1.0 for a, b in zip(us["old"], us["new"])]
    old, new = statistics.median(us["old"]), statistics.median(us["new"])
    return dict(deployment=name, replays=n, rounds=rounds, us=us,
                old_us=old, new_us=new, cost_share=new / old - 1.0,
                pair_shares=pairs, stamps_per_replay=stamps,
                phase_ms={k: 1e-6 * v / n
                          for k, v in phases["phases"].items()},
                between_ms=1e-6 * phases["between"] / n,
                live_rows=int(base.count.item()))


def per_call_us(fn, reps: int = HOST_REPS) -> float:
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e6 * (time.perf_counter() - t) / reps


def host_costs() -> dict:
    timer = timing.StageTimer()

    def bare():
        t0 = time.perf_counter()
        timer.totals["bare"] += time.perf_counter() - t0

    def staged():
        with timer.stage("x"):
            pass

    out = dict(bare_us=per_call_us(bare), stage_us=per_call_us(staged))
    dev = torch.device("cuda", 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        staged()                                   # opens the window
        out["stage_profiled_us"] = per_call_us(staged, 2000)
        out["count_frame_us"] = per_call_us(
            lambda: timing.count_frame(dev), 2000)
    staged()                                       # closes it
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--replays", type=int, default=300)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=os.path.join(HERE, "build",
                                                 "stamp_cost.json"))
    a = p.parse_args()
    res = dict(card=card(), host=host_costs(),
               device=[device_ab(n, a.replays, a.rounds)
                       for n in ("kitti00_depth", "kitti00_stereo")])
    line = json.dumps(res)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
