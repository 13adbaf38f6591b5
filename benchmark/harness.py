"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything a cell needs is found by name: its entry in `BENCHMARK.json`,
the configuration's file (`configs/<config>.json`), the traffic mix
(`workloads/<traffic>.json`), the limits of the check
(`limits/<config>.json`) and one reader per metric (`metrics/<name>.py`).
A later configuration, mix or metric is new files and a new entry.

The program is driven as its CLI builds it: `DeviceResidentMapping` (the
graphed driver; `enable_stereo` for a configuration with a matcher), fed
through `feed_pose`, `feed_image` and `feed_depth` (or `feed_stereo`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, trace
from .traffic import BASELINE_M, Message, Mix, render_route, stream_for

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_S = 4.0            # the traced sub-window at the window's end


# ----------------------------------------------------------------------
# the cell, found by name
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: Mix
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if name in m["workloads"] if "workloads" in m] + \
        [m for m in spec["per_layer"]
         if "workloads" not in m and m["moves"] in moved]
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                config=json.loads((root / conf["file"]).read_text()),
                mix=Mix.load(BENCH / "workloads" / f"{w['traffic']}.json"),
                limits=json.loads((BENCH / "limits" /
                                   f"{w['config']}.json").read_text()),
                end_to_end=e2e, per_layer=per)


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------
# what the metric readers see
# ----------------------------------------------------------------------
@dataclasses.dataclass
class RunRecord:
    cell: str
    mix: Mix
    config: dict
    device_name: str
    setup_s: float = 0.0
    frames: int = 0                 # frames fused in the window
    window_s: float = 0.0
    feed_s: List[float] = dataclasses.field(default_factory=list)
    view: Optional[trace.DeviceView] = None


# ----------------------------------------------------------------------
# the program, driven through its feed API
# ----------------------------------------------------------------------
class Solo:
    """One camera into `DeviceResidentMapping`."""

    def __init__(self, cfg, stereo_cfg, device, frames):
        from densesurfelmapping_tpu_torch.pipeline.device_driver import \
            DeviceResidentMapping
        self.drv = DeviceResidentMapping(cfg, device=device)
        if stereo_cfg is not None:
            self.drv.enable_stereo(cfg.camera.fx * BASELINE_M, stereo_cfg)
        self.stereo = stereo_cfg is not None
        self.frames = frames

    @property
    def bank(self):
        return self.drv.bank

    def fused(self) -> int:
        return self.drv.frames_fused

    def feed_pose(self, m) -> None:
        self.drv.feed_pose(m.stamp, m.pose, loop_path=m.loop_path,
                           loop_edges=m.loop_edges,
                           is_keyframe=m.is_keyframe,
                           reference_index=m.reference_index)

    def feed_frame(self, m) -> None:
        r = m.frame_index
        if self.stereo:
            self.drv.feed_stereo(m.stamp, self.frames.images[r],
                                 self.frames.rights[r])
        else:
            self.drv.feed_image(m.stamp, self.frames.images[r])
            self.drv.feed_depth(m.stamp, self.frames.depths[r])


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------
class Run:
    """One run.  The check follows these frames (`compare`): frame 0 from
    an empty bank, the first compaction in the window, the run's first
    loop closure (in the warm-up) and the window's first, `samples` frames
    at times drawn from the seed across the window's untraced part, and
    the frame right after the window, from the state the whole window
    built."""

    def __init__(self, cell: Cell, seed: int, device: str):
        import torch
        from densesurfelmapping_tpu_torch.config import SurfelMapConfig
        from densesurfelmapping_tpu_torch.models.stereo import StereoConfig
        from densesurfelmapping_tpu_torch.native import loader
        self.cell, self.mix = cell, cell.mix
        self.device = torch.device(device)
        doc = cell.config
        self.cfg = SurfelMapConfig.from_json(json.dumps(doc["mapper"]))
        self.stereo_cfg = (StereoConfig(**doc["stereo"])
                           if doc.get("stereo") else None)
        t = time.perf_counter()
        self.frames = render_route(self.mix, self.cfg.camera, self.device,
                                   self.stereo_cfg is not None)
        self.render_s = time.perf_counter() - t
        if self.device.type == "cuda":
            # the render's scratch is no part of the program's peak
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.stream = stream_for(self.mix, self.frames.poses,
                                 seed % (1 << 63))
        # the pose graph's BFS goes native past 512 keyframes, inside the
        # window: build or load that library now
        loader.available()
        self.prog = Solo(self.cfg, self.stereo_cfg, self.device, self.frames)
        rng = np.random.default_rng([seed % (1 << 63), 7])
        self.sample_at = sorted(rng.uniform(0.0, 1.0, self.mix.samples))
        ci = self.cfg.compact_interval
        self.compaction = -(-(self.mix.warmup_frames + 1) // ci) * ci - 1
        # frame 0, compaction, 2 closures, the samples, the last: 2 copies
        # each, and a third before a closure's warp
        self.snaps = check.Snapshots(self.prog.bank,
                                     2 * (self.mix.samples + 5) + 2)
        self.taken: Dict[int, dict] = {}
        self.closures = 0                   # loop closures sampled
        self.log: List[Message] = []        # the messages fed, per frame
        self.i = 0                          # next frame index
        self.i0 = 0                         # the window's first frame
        # (keyframes, feed_pose s, start, feed s) of every frame
        self.pose_s: List[tuple] = []
        self.rec = RunRecord(cell.name, self.mix, doc,
                             torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def frame(self, sample: bool = False) -> float:
        """Feed frame self.i (a sample for the check if `sample`); returns
        its host seconds in the feed calls."""
        i = self.i
        with trace.span("generate"):
            m = self.stream.next()
        kinds = set()
        if sample or i == 0 or i == self.compaction:
            kinds.add("step")
        if m.closure and (self.closures == 0 or
                          (self.closures == 1 and i >= self.i0 > 0)):
            kinds.update({"step", "warp"})
            self.closures += 1
        snaps = {}
        if "warp" in kinds:
            snaps["s0"] = self.snaps.take(self.prog.bank)
        t0 = time.perf_counter()
        with trace.span("feed_pose"):
            self.prog.feed_pose(m)
        t1 = time.perf_counter()
        if kinds:
            snaps["s1"] = self.snaps.take(self.prog.bank)
        t2 = time.perf_counter()
        with trace.span("feed_frame"):
            self.prog.feed_frame(m)
        t3 = time.perf_counter()
        if kinds:
            snaps["s2"] = self.snaps.take(self.prog.bank)
            self.taken[i] = snaps
        m.loop_path = None     # the reference replays path_delta
        self.log.append(m)
        feed = (t1 - t0) + (t3 - t2)
        self.pose_s.append((len(self.stream.kf_est), t1 - t0, t0, feed))
        self.i += 1
        return feed

    # -- the phases ---------------------------------------------------
    def warm_up(self) -> None:
        for _ in range(self.mix.warmup_frames):
            self.frame()
        self.sync()

    def window(self, seconds: float, traced: bool) -> None:
        rec = self.rec
        fused0 = self.prog.fused()
        self.i0 = self.i
        host_until = seconds - (TRACE_S if traced else 0.0)
        due = [u * host_until for u in self.sample_at]
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            if el >= host_until:
                break
            sample = bool(due) and el >= due[0]
            if sample:
                due.pop(0)
            rec.feed_s.append(self.frame(sample))
        if traced:
            with trace.profiled() as w:
                trace.run_padded(self.frame, TRACE_S)
            rec.view = w.view
        self.sync()
        rec.window_s = time.perf_counter() - t0
        rec.frames = self.prog.fused() - fused0
        self.attempted = self.i - self.i0
        # outside the window: the next frame, a sample of the state the
        # whole window built (the largest pose graph and bank of the run)
        self.frame(sample=True)
        self.sync()

    # -- the check ------------------------------------------------------
    def free_program(self) -> None:
        import torch
        self.prog = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, lowp: bool = False) -> dict:
        """Replay the published messages through the reference's host
        bookkeeping and check every snapshotted frame; returns the worst
        `step_rows_off` and `warp_gap` and what each sample read."""
        import torch
        from .reference import step as ref_step
        from .reference.config import SurfelMapConfig as RefConfig
        from .reference.stereo import StereoConfig as RefStereo
        doc = self.cell.config
        rcfg = RefConfig.from_json(self.cfg.to_json())
        rstereo = RefStereo(**doc["stereo"]) if doc.get("stereo") else None
        bf = float(np.float32(rcfg.camera.fx * BASELINE_M))
        host = check.RefHost(rcfg.drift_free_poses, rcfg.max_keyframes)
        worst = dict(step_rows_off=0.0, warp_gap=0.0)
        samples = []
        fr = self.frames
        for i, m in enumerate(self.log):
            snaps = self.taken.get(i)
            warp, inputs = host.feed(m, want_frame=snaps is not None)
            if snaps is None:
                continue
            if "s0" in snaps and warp is not None:
                bank = check.to_bank(snaps["s0"], self.device)
                ref_step.warp_by_pose(
                    bank, torch.from_numpy(warp.warps),
                    torch.from_numpy(warp.moved),
                    torch.from_numpy(warp.mask), warp.first_local,
                    lowp=lowp)
                gap = check.warp_gap(check.to_bank(snaps["s1"], self.device),
                                     bank)
                worst["warp_gap"] = max(worst["warp_gap"], gap)
                samples.append(dict(frame=i, warp_gap=gap))
            bank = check.to_bank(snaps["s1"], self.device)
            r = m.frame_index
            pose = torch.from_numpy(inputs.pose)
            mask = torch.from_numpy(inputs.mask)
            if rstereo is not None:
                ref_step.fuse_stereo_frame(
                    rcfg, rstereo, bank, torch.from_numpy(fr.images[r]),
                    torch.from_numpy(fr.rights[r]), pose, inputs.ref, mask,
                    bf, lowp=lowp)
            else:
                ref_step.fuse_depth_frame(
                    rcfg, bank, torch.from_numpy(fr.images[r]),
                    torch.from_numpy(fr.depths[r]), pose, inputs.ref, mask,
                    lowp=lowp)
            if (i + 1) % rcfg.compact_interval == 0:
                ref_step.compact(bank)
            got = check.rows_off(check.to_bank(snaps["s2"], self.device),
                                 bank)
            worst["step_rows_off"] = max(worst["step_rows_off"],
                                         got["share"])
            samples.append(dict(frame=i, keyframes=int(inputs.ref) + 1,
                                **got))
        return dict(worst=worst, samples=samples)


def pose_fit(pose_s: List[tuple]) -> dict:
    """Least-squares line of `feed_pose`'s host us against the keyframes
    the pose graph holds: its slope is the loop-path pass's cost a
    keyframe (update_loop_path copies and compares every keyframe's pose
    each frame)."""
    if len(pose_s) < 10:
        return {}
    k = np.array([p[0] for p in pose_s], float)
    us = 1e6 * np.array([p[1] for p in pose_s])
    slope, icpt = np.polyfit(k, us, 1)
    t = np.array([p[2] for p in pose_s])
    feed = np.array([p[3] for p in pose_s])
    seg = np.floor((t - t[0]) / 5.0).astype(int)
    segments = [[int((seg == j).sum()),
                 round(1e3 * float(feed[seg == j].mean()), 3)]
                for j in range(seg.max() + 1) if (seg == j).any()]
    return dict(us_per_keyframe=float(slope), us_at_0=float(icpt),
                keyframes=[int(k[0]), int(k[-1])],
                median_us=float(np.median(us)),
                frames_and_feed_ms_per_5s=segments)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             lowp_control: bool = False) -> dict:
    """One run; returns the result object (the last line's contents) and,
    under "log", what goes to standard error."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, device)
    run.warm_up()
    run.rec.setup_s = time.perf_counter() - t_start
    run.window(seconds, traced)
    failed = max(0, run.attempted - run.rec.frames)
    peak = (torch.cuda.max_memory_allocated(run.device) - run.snaps.nbytes
            if run.device.type == "cuda" else 0)
    run.free_program()
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & {"jax", "jaxlib", "flax", "densesurfelmapping_tpu"})
    cmp = run.compare(lowp=lowp_control)
    rec = run.rec
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_doc = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                  "kind": rec.device_name, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    if traced:
        device_doc["busy_s"] = rec.view.busy_s
        device_doc["window_s"] = rec.view.window_s
    compared = {"frames_failed": {"value": failed, "limit": 0}}
    for name, limit in cell.limits.items():
        compared[name] = {"value": cmp["worst"][name], "limit": limit}
    correct = all(v["value"] <= v["limit"] for v in compared.values()) \
        and not found
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(failed), "metrics": metrics, "device": device_doc}
    if traced:
        out["breakdown"] = {"device_ops": [[n[:160], v] for n, v in
                                           rec.view.device_ops],
                            "idle_gaps": [list(x) for x in
                                          rec.view.idle_gaps]}
    out["compared"] = compared
    log = dict(samples=cmp["samples"], jax_modules=found,
               frames_fed=run.i, window_frames=rec.frames,
               setup_s=rec.setup_s, render_s=run.render_s,
               window_s=rec.window_s,
               feed_pose_fit=pose_fit(run.pose_s[run.i0:]))
    return dict(result=out, log=log)
