"""Time the PyTorch port's mesh steps with several streams on a data row,
on one NVIDIA GPU, for one or more copies of the port, each in a process
of its own, in the order given.

    python3 experiments/torch_rows_time.py [ROOT ...]

ROOT is a directory holding a `densesurfelmapping_tpu_torch/` package (this
repository, or a copy unpacked with `git archive`); the default is this
repository.  Each copy builds its own kernels (under ROOT/build/kernels/).
Name the copies in an interleaved order (A B B A): a card's clocks drift
between processes, so compare copies only within one run of this script.

The case is chip_smoke.py's rows check (this repository's chip_smoke.py,
whatever the copy): `kitti_config(surfel_capacity=1 << 19)`, a (2, 2) mesh
of the card (`make_mesh(4, data=2)`: 2 data rows of 2 virtual shards), 4
streams with distinct poses, 2 a row (`chip_smoke.row_payloads`), through
the graphed depth-fed step (`sharding.graphed_fuse_frame_windowed_packed`,
STEPS steps) and the graphed stereo step
(`sharding.graphed_fuse_frame_stereo_windowed_packed`, the CLI's --sgm
matcher, STEPS - 2 steps).  A copy whose mesh programs loop over the
streams launches each kernel once per stream and cell; one that vmaps them
once per cell.

Each process prints one JSON line: the root, the card and its power limit
as nvidia-smi prints them, and per step kind: each kernel's device runs
per step (the profiler's kernel records of the steady replays), aggregate
frames/s graphed and eager (each of RATES drives, steady after the first
step, to a synchronize), the profiled graphed step's wall and device busy
ms, its idle share and device operations per step, and the step graph's
memory pool MiB.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

STEPS, RATES = 8, 3
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from densesurfelmapping_tpu_torch.config import kitti_config
    from densesurfelmapping_tpu_torch.parallel import sharding as SH
    from densesurfelmapping_tpu_torch.parallel.multistream import (
        unpack_payload)
    from densesurfelmapping_tpu_torch.pipeline import fuse_step as FS

    if not torch.cuda.is_available():
        raise SystemExit("torch_rows_time: no CUDA card")
    cs = _chip_smoke()
    cfg = kitti_config(surfel_capacity=1 << 19)
    scfg = cs.sgm_config()
    mesh = SH.make_mesh(4, data=2)
    frames = cs.make_frames(cfg, 6 * 3 + STEPS)
    pairs = cs.make_pairs(cfg, 4)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec = dict(root=root, card=smi, mesh=str(mesh.shape),
               streams=cs.ROW_STREAMS)
    for kind in ("depth-fed", "stereo"):
        stereo = kind == "stereo"
        n = STEPS - 2 if stereo else STEPS
        loads = [cs.row_payloads(cfg, frames, pairs, t, stereo).cuda()
                 for t in range(n)]
        fb = (2 if stereo else 3) * cfg.height * cfg.width

        def graphed():
            banks = SH.replicate_banks(mesh, cfg, cs.ROW_STREAMS)
            pool = FS.graph_pool(mesh.devices())
            if stereo:
                return SH.graphed_fuse_frame_stereo_windowed_packed(
                    cfg, scfg, True, mesh, banks, pool), pool
            return SH.graphed_fuse_frame_windowed_packed(
                cfg, mesh, banks, pool), pool

        def eager():
            banks = SH.replicate_banks(mesh, cfg, cs.ROW_STREAMS)
            fn = (SH.sharded_fuse_frame_stereo_windowed_packed(
                cfg, scfg, True, mesh) if stereo
                else SH.sharded_fuse_frame_windowed_packed(cfg, mesh))

            def step(p):
                args = unpack_payload(p, fb)
                return fn(banks, *(args if stereo
                                   else args[:3] + args[4:]))[1]
            return step

        step, pool = graphed()
        step(loads[0])              # the capture
        torch.cuda.synchronize()
        with cs.device_records() as records:
            for p in loads[1:]:
                step(p)
        runs = {k: sum(any(part in name for part in parts)
                       for _, name in records) / (n - 1)
                for k, parts in cs.KERNEL_RECORDS.items()}
        prof = cs.profiled(lambda i: step(loads[i % n]), 1, n - 1)
        rec[kind] = dict(
            steps=n, runs_per_step=runs, lost_replays=records.lost,
            graphed_fps=[cs.steady_rate(graphed()[0], loads,
                                        cs.ROW_STREAMS)
                         for _ in range(RATES)],
            eager_fps=[cs.steady_rate(eager(), loads, cs.ROW_STREAMS)
                       for _ in range(RATES)],
            wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
            idle=prof["idle"], ops=prof["ops"], pool_mib=cs.pool_mib(pool))
        del step, pool
        torch.cuda.synchronize()
    print(json.dumps(rec), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    rc = 0
    for root in sys.argv[1:] or [HERE]:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root])
        print(f"# {root}: {time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
