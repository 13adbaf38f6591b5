"""MultiSessionMapping: B concurrent mapping sessions on one GPU.

Counterpart of the JAX package's `pipeline/multi_session.py`: a serving mode
the reference cannot express (one ROS process = one session,
`ros_node.cpp:13-53`).  B independent camera streams share one pass of
device work per round: banks carry a leading stream axis, the windowed fuse
step runs under `torch.func.vmap` (`parallel/multistream.py`; the SLIC
kernels launch once per sweep for all streams), and every session keeps its
own host-side pose graph, sync buffers and active-window mask.  It uses the
zero-readback window-mask lifecycle of `DeviceResidentMapping` (see
pipeline/device_driver.py).

Serving lifecycle:

* dispatch — frames queue per session; a batched step fires when every
  session has a synchronized frame (`step_ready`), on `step(flush=True)`
  (absent sessions get a zero-depth no-op pad), or via `pump()`, which
  applies the flush-timeout policy: a ready frame older than
  `flush_timeout` seconds forces a padded step so one stalled stream cannot
  starve the fleet.
* capacity — banks compact on the fixed `config.compact_interval` schedule
  (a batched stable partition, no readbacks), and surfels dropped on a full
  tail are accumulated on the device and surfaced by `session_metrics()`
  with a saturation ratio, so operators can detect overflow.
* elasticity — `add_session()` / `remove_session(k)` re-batch the banks at
  runtime; removal returns the final map rows.
* persistence — per-session `save_cloud` / `save_mesh` / `save_checkpoint`
  / `load_checkpoint` match the solo drivers' export semantics
  (`save_cloud`/`save_mesh`, surfel_map.cpp:1153-1280) and the JAX
  package's checkpoint schema, key for key.
* stereo serving — `enable_stereo(bf)` switches the WHOLE fleet to raw
  stereo-pair input: the whole stereo step of one stream (map prior,
  on-device matcher, depth, fuse; `fuse_step.fuse_frame_stereo_onebuf`)
  runs under torch.func.vmap for all streams, one matcher pass per round
  (padded sessions ride an all-zero pair, which the textureless gate
  makes a no-op).
* uploads — a round's entire payload (B frames + B pose/ref/window aux
  blocks) is ONE (B, frame_bytes + aux_bytes) u8 copy per round, from
  pinned memory without blocking the host.
* dispatch — on the card the round is captured as a CUDA graph at its
  first use (`multistream.graphed_onebuf_step` and, in stereo mode,
  `graphed_stereo_onebuf_step`, where the JAX fleet jits
  `_batched_onebuf_step` / `_batched_stereo_onebuf_step`) and replayed once
  per round; so are the batched compaction and loop warp
  (`multistream.graphed_compact` / `graphed_warp`, the JAX fleet's
  `_batched_compact` / `_batched_warp`).  All of them are captured again
  when the payload's shape or the banks change (keyframe-capacity growth,
  `add_session` / `remove_session`, `load_checkpoint`) and when
  `enable_stereo` switches the round; they share one memory pool, and the
  round's stats are consumed in stream order right after its replay.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core import geometry
from ..core.state import AUX_HEAD_BYTES, FIELDS, pack_aux, pack_frame
from ..parallel import multistream
from . import fuse_step
from .pose_graph import PoseGraph


def _pack_batch(cfg, to_pack, rows) -> None:
    """Encode every ready stream's frame straight into its row view of the
    batched upload buffer (`native.pack_frames_into`: no stacking copies,
    one C++ thread per frame).  Falls back to per-frame packing when the
    native library or f32 dtypes are missing."""
    from ..native import loader as native
    imgs = [np.asarray(i) for _, i, _ in to_pack]
    deps = [np.asarray(d) for _, _, d in to_pack]
    if (all(i.dtype == np.float32 for i in imgs)
            and all(d.dtype == np.float32 for d in deps)
            and native.pack_frames_into(imgs, deps, rows)):
        return
    for (_, i, d), r in zip(to_pack, rows):
        r[:] = pack_frame(cfg, i, d)


class _Session:
    """Host state of one stream (pose graph, sync buffers, window mask)."""

    def __init__(self, config: SurfelMapConfig):
        self.graph = PoseGraph()
        self.image_buffer = collections.deque()
        self.depth_buffer = collections.deque()
        self.pose_buffer = collections.deque()
        self.window = np.zeros(config.max_keyframes, bool)
        self.first_local = 0
        self.last_ref = 0
        self.frames_fused = 0
        self.dropped = collections.Counter()
        self.pending_warp: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def grow_window(self, new_p: int) -> None:
        w = np.zeros(new_p, bool)
        w[:len(self.window)] = self.window
        self.window = w


class MultiSessionMapping:
    """B mapping sessions fused in one batched pass per round.

    device: where the banks live and the step runs.  The default "cuda"
    raises on a machine without a GPU rather than running on the CPU."""

    def __init__(self, config: SurfelMapConfig, n_streams: int,
                 flush_timeout: float = 0.1, pipelined: bool = False,
                 device="cuda"):
        self.config = config
        self.n_streams = n_streams
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        self.flush_timeout = float(flush_timeout)
        self.sessions = [_Session(config) for _ in range(n_streams)]
        self.banks = multistream.make_banks(config, n_streams, self.device)
        self._drop_accum = torch.zeros((n_streams,), dtype=torch.int32,
                                       device=self.device)
        self.stamp_tolerance = 1e-6
        self.rounds = 0
        self.compactions = 0
        from ..utils.timing import StageTimer
        self.timer = StageTimer()   # prep / upload / dispatch per round
        # pipelined rounds: the upload + dispatch of round r runs on a
        # worker thread while the main thread preps round r+1 (feeds, pose
        # graphs, windows, batched pack).  One-round lag; every bank
        # consumer calls _flush_round first, so observable state is
        # identical (tests pin equivalence).  Only the worker touches the
        # device during a round's flight: the main thread waits on the
        # future before any other device call.
        self._pipelined = bool(pipelined)
        self._dispatch_pool = (ThreadPoolExecutor(max_workers=1)
                               if pipelined else None)
        self._banks_fut = None
        # the captured round, compaction and warp and their memory pool
        self._graph_pool = fuse_step.graph_pool(self.device)
        self._round = self._compact_graph = self._warp_graph = None

        # fleet-wide on-device stereo front-end (enable_stereo/feed_stereo)
        self._stereo_cfg = None
        self._stereo_filter = True
        self._stereo_bf: Optional[float] = None

    def close(self) -> None:
        """Complete any in-flight round and stop the dispatch worker."""
        self._flush_round()
        if self._dispatch_pool is not None:
            self._dispatch_pool.shutdown()

    # ------------------------------------------------------------------
    # per-session feeds (same schema as SurfelMapping)
    # ------------------------------------------------------------------
    def feed_image(self, stream: int, stamp: float, image) -> None:
        self.sessions[stream].image_buffer.append(
            (float(stamp), image, time.monotonic()))

    def feed_depth(self, stream: int, stamp: float, depth) -> None:
        if self._stereo_cfg is not None:
            raise RuntimeError("fleet is in stereo mode; use feed_stereo")
        self.sessions[stream].depth_buffer.append(
            (float(stamp), depth, time.monotonic()))

    def enable_stereo(self, bf: float, stereo_config=None,
                      filter_depth: bool = True) -> None:
        """Switch the WHOLE fleet's depth source to the on-device stereo
        front-end (mixed fleets would need two passes per round, defeating
        the batching).  bf = fx * baseline, shared: the streams share the
        camera config."""
        from ..models.stereo import StereoConfig

        self._flush_round()
        self._stereo_cfg = stereo_config or StereoConfig()
        self._stereo_bf = float(bf)
        self._stereo_filter = bool(filter_depth)
        # the stereo round replaces the depth-fed one, which a stereo fleet
        # never replays: its graph is freed
        self._round = None

    def feed_stereo(self, stream: int, stamp: float, left, right) -> None:
        """Rectified pair for one stream; the left image is the fuse
        intensity.  Requires enable_stereo()."""
        if self._stereo_cfg is None:
            raise RuntimeError("feed_stereo before enable_stereo(bf=...)")
        from ..core.state import pack_stereo_pair

        buf = pack_stereo_pair(self.config, left, right)
        s = self.sessions[stream]
        now = time.monotonic()
        s.image_buffer.append((float(stamp), np.asarray(left), now))
        s.depth_buffer.append((float(stamp), buf, now))

    def feed_pose(self, stream: int, stamp: float, pose,
                  loop_path=None, loop_edges: Sequence = (),
                  is_keyframe: bool = False,
                  reference_index: Optional[int] = None) -> None:
        s = self.sessions[stream]
        pose = np.array(pose, np.float64)
        # same pose failure detection as the solo driver (driver.py)
        if pose.shape != (4, 4) or not np.isfinite(pose).all() \
                or abs(np.linalg.det(pose[:3, :3]) - 1.0) > 0.1:
            s.dropped["invalid_pose"] += 1
            return
        # and a reference keyframe never fed, as the solo driver does
        if reference_index is not None and not s.graph.knows(
                reference_index, is_keyframe or len(s.graph) == 0):
            s.dropped["unknown_reference"] += 1
            return
        if loop_path is not None and len(s.graph) > 0:
            if s.graph.update_loop_path(list(loop_path)):
                warps, moved = s.graph.pose_warps()
                s.pending_warp = (warps, moved)
                self._flush_warps()
                s.graph.commit_loop_poses()
        if is_keyframe or len(s.graph) == 0:
            link = None
            if len(s.graph) > 0:
                link = (reference_index if reference_index is not None
                        else len(s.graph) - 1)
            new_index = s.graph.add_keyframe(pose, stamp, link)
            if reference_index is None:
                reference_index = new_index
        if reference_index is None:
            reference_index = len(s.graph) - 1
        s.graph.add_loop_edges(loop_edges)
        ref_pose = s.graph.keyframes[int(reference_index)].cam_pose
        rel = geometry.invert_se3(ref_pose) @ pose
        s.pose_buffer.append(
            (float(stamp), rel, int(reference_index), time.monotonic()))

    # ------------------------------------------------------------------
    # batched stepping
    # ------------------------------------------------------------------
    def _session_ready_frame(self, s: _Session):
        while s.pose_buffer:
            stamp, rel, ref, t_arr = s.pose_buffer[0]
            img = self._front(s, s.image_buffer, stamp, "images")
            dep = self._front(s, s.depth_buffer, stamp, "depths")
            if img is None or dep is None:
                return None
            ready_at = max(t_arr, img[2], dep[2])
            return stamp, rel, ref, img[1], dep[1], ready_at
        return None

    def _front(self, s: _Session, buf, stamp, kind: str):
        while buf:
            t = buf[0][0]
            if t < stamp - self.stamp_tolerance:
                buf.popleft()
                s.dropped[kind] += 1      # stale frame, counted like driver.py
            elif abs(t - stamp) <= self.stamp_tolerance:
                return buf[0]
            else:
                return None
        return None

    def step_ready(self) -> bool:
        return all(self._session_ready_frame(s) is not None
                   for s in self.sessions)

    def pump(self, now: Optional[float] = None) -> int:
        """Serving dispatch policy: step while every session is ready; then,
        if any ready frame has been waiting longer than flush_timeout for
        the other streams, fire one padded step.  Returns frames fused."""
        fused = 0
        while self.step_ready():
            fused += self.step()
        if now is None:
            now = time.monotonic()
        oldest = None
        for s in self.sessions:
            r = self._session_ready_frame(s)
            if r is not None:
                oldest = r[5] if oldest is None else min(oldest, r[5])
        if oldest is not None and now - oldest > self.flush_timeout:
            fused += self.step(flush=True)
        return fused

    def _ensure_keyframe_capacity(self) -> None:
        """Grow the shared window-mask length when any session's pose graph
        outgrows it (same policy as DeviceResidentMapping): the aux block,
        and so the payload's shape, grows with it."""
        need = max((len(s.graph) for s in self.sessions), default=0)
        if need <= self.config.max_keyframes:
            return
        # an in-flight round runs the graph of the old payload shape
        self._flush_round()
        self._reset_graphs()
        new_p = self.config.max_keyframes
        while new_p < need:
            new_p *= 2
        self.config = dataclasses.replace(self.config, max_keyframes=new_p)
        for s in self.sessions:
            s.grow_window(new_p)

    def _new_payload(self, row_bytes: int) -> Tuple[np.ndarray, object]:
        """A fresh host buffer for one round (a pipelined round in flight
        may still read the previous one): pinned on a GPU, so the upload
        does not block the host.  Returns (numpy view, source to upload)."""
        t = torch.empty((self.n_streams, row_bytes), dtype=torch.uint8,
                        pin_memory=self.device.type == "cuda")
        return t.numpy(), t

    def _upload(self, src: torch.Tensor) -> torch.Tensor:
        """One host-to-device copy of the round's payload."""
        return src.to(self.device, non_blocking=True)

    def _reset_graphs(self) -> None:
        """Drop the captured programs: each is built again, against the
        current banks and payload shape, at its next use."""
        self._round = self._compact_graph = self._warp_graph = None

    def _run_round(self, cfg: SurfelMapConfig, src: torch.Tensor) -> dict:
        """Upload a round's payload and enqueue its step; returns the
        stats.  The payload is copied into the captured round's input (the
        stereo round in stereo mode, else the depth-fed one), which is then
        replayed."""
        if self._round is None:
            if self._stereo_cfg is not None:
                self._round = multistream.graphed_stereo_onebuf_step(
                    cfg, self._stereo_cfg, self._stereo_filter, self.banks,
                    self._graph_pool)
            else:
                self._round = multistream.graphed_onebuf_step(
                    cfg, self.banks, self._graph_pool)
        with self.timer.stage("upload"):
            self._round.load(src)
        with self.timer.stage("dispatch"):
            return self._round.replay()

    def step(self, flush: bool = False) -> int:
        """Fuse one frame per session in a single batched pass.

        Returns the number of real (non-padded) frames fused.  With
        flush=True, sessions without a synchronized frame get a zero-depth
        pad; otherwise requires step_ready()."""
        if not flush and not self.step_ready():
            raise RuntimeError("step() before step_ready(); "
                               "use flush=True to pad")
        self._ensure_keyframe_capacity()
        cfg = self.config
        h, w = cfg.height, cfg.width
        stereo = self._stereo_cfg is not None
        bf = self._stereo_bf or 0.0
        # the whole round rides as ONE (B, frame_bytes + aux_bytes) u8
        # payload = one host-to-device copy.  Stereo pads stay all-zero:
        # constant images produce no valid disparities, so a padded
        # session's step is a no-op by the matcher's textureless gate
        fb = (2 if stereo else 3) * h * w
        payload, src = self._new_payload(fb + AUX_HEAD_BYTES
                                         + cfg.max_keyframes)
        eye = np.eye(4, dtype=np.float32)
        fused_real = 0
        to_pack = []          # (slot, image, depth) for one batched encode
        with self.timer.stage("prep"):
            for k, s in enumerate(self.sessions):
                ready = self._session_ready_frame(s)
                if ready is None:
                    payload[k, :fb] = 0
                    payload[k, fb:] = pack_aux(eye, s.last_ref, s.window, bf)
                    continue
                stamp, rel, ref, img, dep, _ = ready
                window = s.graph.driftfree_window(ref, cfg.drift_free_poses)
                s.window[:] = False
                s.window[list(window)] = True
                s.first_local = min(window) if window else 0
                fuse_pose = s.graph.keyframes[ref].cam_pose @ rel
                if stereo:
                    payload[k, :fb] = dep
                else:
                    to_pack.append((k, img, dep))
                payload[k, fb:] = pack_aux(
                    np.asarray(fuse_pose, np.float32), ref, s.window, bf)
                s.last_ref = ref
                s.pose_buffer.popleft()
                s.image_buffer.popleft()
                s.depth_buffer.popleft()
                s.frames_fused += 1
                fused_real += 1
            if to_pack:
                _pack_batch(cfg, to_pack,
                            [payload[k, :fb] for k, _, _ in to_pack])

        if self._pipelined:
            # land the previous round, then hand this one to the worker:
            # its upload and enqueue overlap the caller's next feeds and
            # the next round's prep on the main thread
            self._flush_round()

            self._banks_fut = self._dispatch_pool.submit(self._run_round,
                                                         cfg, src)
            return fused_real
        self._post_dispatch(self._run_round(cfg, src))
        return fused_real

    def _post_dispatch(self, stats) -> None:
        if "n_dropped" in stats:
            # device-side accumulation (one small add, no readback)
            self._drop_accum += stats["n_dropped"].to(torch.int32)
        self.rounds += 1
        if self.rounds % self.config.compact_interval == 0:
            self.compact()

    def _flush_round(self) -> None:
        """Complete the one in-flight pipelined round, if any.  Every bank
        consumer (compact, warps, session management, readouts, checkpoint)
        calls this first: observable state matches the eager mode."""
        if self._banks_fut is None:
            return
        fut = self._banks_fut
        self._banks_fut = None
        self._post_dispatch(fut.result())

    def flush_rounds(self) -> None:
        """Public barrier: complete any pipelined in-flight round."""
        self._flush_round()

    def compact(self) -> None:
        """Batched hole-elimination repack of every session's bank
        (fixed-interval, zero-readback: the serving equivalent of
        DeviceResidentMapping's compaction schedule)."""
        self._flush_round()
        if self._compact_graph is None:
            self._compact_graph = multistream.graphed_compact(
                self.banks, self._graph_pool)
        self._compact_graph()
        self.compactions += 1

    def _flush_warps(self) -> None:
        """Apply pending loop-closure warps for every session in one
        batched device pass (identity for sessions without one)."""
        self._flush_round()                 # warp orders after every fuse
        self._ensure_keyframe_capacity()    # warps can outrun fuses
        P = self.config.max_keyframes
        wstack = np.tile(np.eye(4, dtype=np.float32),
                         (self.n_streams, P, 1, 1))
        mstack = np.zeros((self.n_streams, P), bool)
        masks = np.zeros((self.n_streams, P), bool)
        firsts = np.zeros(self.n_streams, np.int32)
        any_pending = False
        for k, s in enumerate(self.sessions):
            masks[k] = s.window
            firsts[k] = s.first_local
            if s.pending_warp is not None:
                warps, moved = s.pending_warp
                n = len(warps)
                wstack[k, :n] = warps.astype(np.float32)
                mstack[k, :n] = moved
                s.pending_warp = None
                any_pending = True
        if not any_pending:
            return
        self._apply_warps(wstack, mstack, masks, firsts)

    def _apply_warps(self, wstack: np.ndarray, mstack: np.ndarray,
                     masks: np.ndarray, firsts: np.ndarray) -> None:
        """Replay the batched warp's graph on the fleet's banks."""
        if self._warp_graph is None:
            self._warp_graph = multistream.graphed_warp(
                self.config, self.banks, self._graph_pool)
        self._warp_graph(wstack, mstack, masks, firsts)

    # ------------------------------------------------------------------
    # elastic session management
    # ------------------------------------------------------------------
    def add_session(self) -> int:
        """Attach a fresh session at runtime; returns its stream index."""
        self._flush_round()
        self.banks = multistream.concat_banks(
            self.banks, multistream.make_banks(self.config, 1, self.device))
        self._drop_accum = torch.cat([self._drop_accum, torch.zeros(
            (1,), dtype=torch.int32, device=self.device)])
        self.sessions.append(_Session(self.config))
        self.n_streams += 1
        self._reset_graphs()
        return self.n_streams - 1

    def remove_session(self, stream: int) -> dict:
        """Detach a session at runtime; returns its final map rows (the
        same selection `session_map_surfels` exports)."""
        rows = self.session_map_surfels(stream)   # flushes via _session_rows
        keep = [i for i in range(self.n_streams) if i != stream]
        self.banks = multistream.select_streams(self.banks, keep)
        self._drop_accum = self._drop_accum[keep]
        del self.sessions[stream]
        self.n_streams -= 1
        self._reset_graphs()
        return rows

    # ------------------------------------------------------------------
    # readout / observability (one transfer each; never on the hot path)
    # ------------------------------------------------------------------
    def _session_rows(self, stream: int) -> dict:
        self._flush_round()
        n = int(self.banks.count[stream])
        return {k: getattr(self.banks, k)[stream, :n].to(
            "cpu", copy=True).numpy() for k in FIELDS}

    def session_surfels(self, stream: int, min_updates: int = 1) -> dict:
        rows = self._session_rows(stream)
        sel = rows["update_times"] >= min_updates
        return {k: v[sel] for k, v in rows.items()}

    def _is_active_row(self, s: _Session, rows: dict) -> np.ndarray:
        lu = rows["last_update"]
        p = len(s.window)
        ok = (lu >= 0) & (lu < p)
        return ok & s.window[np.clip(lu, 0, p - 1)]

    def session_map_surfels(self, stream: int) -> dict:
        """Stable actives + live inactives: the save_cloud selection of the
        solo drivers (surfel_map.cpp:1153-1174)."""
        s = self.sessions[stream]
        rows = self._session_rows(stream)
        active = self._is_active_row(s, rows)
        live = rows["update_times"] > 0
        sel = (rows["update_times"] >= self.config.stable_update_times) \
            & active | (live & ~active)
        return {k: v[sel] for k, v in rows.items()}

    def save_cloud(self, stream: int, path: str, binary: bool = True) -> int:
        from ..io import export
        return export.save_cloud_pcd(path, self.session_map_surfels(stream),
                                     binary=binary)

    def save_mesh(self, stream: int, path: str, binary: bool = False) -> int:
        from ..io import export
        return export.save_mesh_ply(path, self.session_map_surfels(stream),
                                    binary=binary)

    def save_trajectory(self, stream: int, path: str,
                        fmt: str = "kitti") -> int:
        """Per-session loop-corrected keyframe trajectory (same formats as
        the solo drivers' save_trajectory)."""
        from ..io import export
        g = self.sessions[stream].graph
        poses = [k.loop_pose for k in g.keyframes]
        stamps = [k.stamp for k in g.keyframes]
        if fmt == "kitti":
            return export.save_trajectory_kitti(path, poses, stamps)
        if fmt == "tum":
            return export.save_trajectory_tum(path, poses, stamps)
        raise ValueError(f"unknown trajectory format {fmt!r}")

    def session_metrics(self) -> List[Dict[str, float]]:
        """Per-session observability: throughput, drop counters, bank
        saturation (count/capacity), and surfels dropped on a full tail
        since start (device-accumulated, exact)."""
        self._flush_round()
        counts = self.banks.count.cpu().numpy()
        drops = self._drop_accum.cpu().numpy()
        cap = self.config.surfel_capacity
        out = []
        for k, s in enumerate(self.sessions):
            out.append({
                "frames_fused": s.frames_fused,
                "surfel_count": int(counts[k]),
                "capacity": cap,
                "saturation": float(counts[k]) / cap,
                "surfels_dropped": int(drops[k]),
                **{f"dropped_{kk}": v for kk, v in s.dropped.items()},
            })
        return out

    # ------------------------------------------------------------------
    # per-session persistence (the JAX fleet's and DeviceResidentMapping's
    # .npz schema)
    # ------------------------------------------------------------------
    def save_checkpoint(self, stream: int, path: str) -> None:
        s = self.sessions[stream]
        rows = self._session_rows(stream)
        data = {f"bank_{k}": v for k, v in rows.items()}
        data["bank_count"] = np.int64(len(rows["color"]))
        g = s.graph
        data["kf_cam"] = np.stack([k.cam_pose for k in g.keyframes]) \
            if len(g) else np.zeros((0, 4, 4))
        data["kf_loop"] = np.stack([k.loop_pose for k in g.keyframes]) \
            if len(g) else np.zeros((0, 4, 4))
        data["kf_stamp"] = np.array([k.stamp for k in g.keyframes])
        edges = [(i, j) for i, k in enumerate(g.keyframes) for j in k.linked]
        data["kf_edges"] = np.array(edges, np.int64).reshape(-1, 2)
        data["local_indices"] = np.flatnonzero(s.window).astype(np.int64)
        data["frames_fused"] = np.int64(s.frames_fused)
        np.savez_compressed(path, **data)

    def load_checkpoint(self, stream: int, path: str) -> None:
        self._flush_round()
        s = _Session(self.config)
        z = np.load(path, allow_pickle=False)
        n = int(z["bank_count"])
        for cam, loop, stamp in zip(z["kf_cam"], z["kf_loop"], z["kf_stamp"]):
            idx = s.graph.add_keyframe(cam, float(stamp))
            s.graph.keyframes[idx].loop_pose = np.array(loop)
        for i, j in z["kf_edges"]:
            kf = s.graph.keyframes[int(i)]
            if int(j) not in kf.linked:
                kf.linked.append(int(j))
        s.frames_fused = int(z["frames_fused"])
        self.sessions[stream] = s
        self._ensure_keyframe_capacity()
        s.window[np.asarray(z["local_indices"], np.int64)] = True
        s.first_local = int(z["local_indices"].min()) \
            if len(z["local_indices"]) else 0
        s.last_ref = len(s.graph) - 1 if len(s.graph) else 0
        # this stream's slot; dead rows as SurfelBank.empty (last_update =
        # -1, not 0: 0 means "owned by keyframe 0" to the window gating)
        multistream.place_rows(self.banks, stream,
                               {k: z[f"bank_{k}"] for k in FIELDS}, n)
        self._reset_graphs()
