"""DeviceResidentMapping: the mapping driver with no steady-state
device-to-host traffic.

Counterpart of the JAX package's `pipeline/device_driver.py`.  The base
`SurfelMapping` reproduces the reference's architecture: inactive surfels
migrate to a host pool (`move_add_surfels`, `surfel_map.cpp:1456-1595`),
which forces blocking device-to-host reads at every migration.  This driver
keeps ALL surfels in the device bank and realizes the active/inactive
lifecycle as a (max_keyframes,) boolean window mask shipped with each frame:

* fuse gating — rows owned by out-of-window keyframes are frozen: never
  fused, never staleness/occlusion-killed (`ops/fusion.py` pose_mask);
* "migration" — updating the mask; reactivation on loop revisit is free;
* loop warp — one whole-bank pass: active rows take the first local
  pose's warp, frozen rows their own keyframe's warp
  (`ops/warp.warp_bank_by_pose`);
* compaction — fixed schedule (config.compact_interval), no reads;
* stats — never fetched in the feed loop; `sync_stats()` on demand only.

Each frame's whole payload (packed frame + pose/index/window aux) travels in
ONE host-to-device copy, from pinned memory without blocking the host, into
the static input buffer of the fuse step captured as a CUDA graph
(`fuse_step.StepGraph`, where the JAX driver dispatches a jitted step): one
graph per step signature, captured at its first frame, replayed once per
frame, and captured again where the JAX driver re-jits (keyframe-capacity
growth) and where the bank's tensors are replaced (a checkpoint load).
Compaction and the loop warp replay graphs of their own
(`fuse_step.BankGraph`, the JAX driver's jitted `compact_bank` and
`warp_bank_by_pose`), rebuilt with the step; both write the bank in
place.
Semantics match `SurfelMapping` (equivalence-tested); readouts
(export/eval/checkpoint) transfer the bank once, off the hot path.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core.state import (FIELDS, pack_aux, pack_frame_with_aux,
                          pack_stereo_with_aux)
from . import fuse_step
from .driver import SurfelMapping, _StereoPair


class DeviceResidentMapping(SurfelMapping):
    def __init__(self, config: SurfelMapConfig,
                 kitti_alignment: bool = False, device="cuda",
                 pipelined: bool = False):
        super().__init__(config, kitti_alignment, device)
        self._window_np = np.zeros(config.max_keyframes, bool)
        self._first_local = 0
        self._host_rows: Optional[dict] = None   # readout cache
        # pipelined feed: frame i's host pack runs on a worker thread while
        # the main thread uploads and enqueues frame i-1.  The fuse of a fed
        # frame lags the feed by one frame; every bank consumer flushes
        # first (see _flush_pending callers), so observable semantics are
        # identical (equivalence-tested).
        # BUFFER CONTRACT: the driver BORROWS the fed image/depth arrays
        # until the next driver call (the worker packs them after feed
        # returns) — callers must allocate fresh frames, never mutate a fed
        # buffer in place.
        self._pipelined = bool(pipelined)
        self._pack_pool = (ThreadPoolExecutor(max_workers=1)
                           if pipelined else None)
        self._pending = None   # future of the packed one-buffer payload

    def close(self) -> None:
        """Complete any in-flight frame and stop the pack worker."""
        self._flush_pending()
        if self._pack_pool is not None:
            self._pack_pool.shutdown()

    def _build_graphs(self) -> None:
        """(Re)build the captured programs, whose payload and warp inputs
        depend on config.max_keyframes and whose graphs write the current
        bank: the counterpart of the JAX driver's `_build_window_jits`
        (densesurfelmapping_tpu/pipeline/device_driver.py:72-79) and of its
        jitted compaction and pose warp.  Called again on keyframe-capacity
        growth and after a checkpoint load; each program is captured at its
        first use."""
        cfg, bank, pool = self.config, self.bank, self._bank_pool
        self._fuse_graph = fuse_step.graphed_fuse_frame_onebuf(
            cfg, bank, self._graph_pool)
        self._compact_graph = fuse_step.graphed_compact(bank, pool)
        self._pose_warp_graph = fuse_step.graphed_warp_bank_by_pose(
            cfg, bank, pool)
        self._stereo_graph = None
        if self._stereo_cfg is not None:
            self._build_stereo_graph()

    def _build_stereo_graph(self) -> None:
        """The stereo-resident step's graph (`_build_stereo_jit`,
        densesurfelmapping_tpu/pipeline/device_driver.py:80-83)."""
        self._stereo_graph = fuse_step.graphed_fuse_frame_stereo_onebuf(
            self.config, self._stereo_cfg, self._stereo_filter, self.bank,
            self._graph_pool)

    def _ensure_keyframe_capacity(self) -> None:
        """Grow max_keyframes to the next power of two when the pose graph
        outgrows the window-mask length, instead of crashing.  The mask is
        the only device-side object shaped by max_keyframes (the bank stores
        per-row keyframe indices, unbounded)."""
        if len(self.graph) <= self.config.max_keyframes:
            return
        # a pending pipelined frame holds an aux packed at the OLD length
        self._flush_pending()
        new_p = self.config.max_keyframes
        while new_p < len(self.graph):
            new_p *= 2
        self.config = dataclasses.replace(self.config, max_keyframes=new_p)
        # grow the live mask too: a loop warp can arrive before the next
        # _move_add_surfels rebuilds it at the new length
        w = np.zeros(new_p, bool)
        w[:len(self._window_np)] = self._window_np
        self._window_np = w
        self._build_graphs()

    # ------------------------------------------------------------------
    # migration == window-mask update (no device work at all)
    # ------------------------------------------------------------------
    def _move_add_surfels(self, ref_index: int) -> None:
        with self.timer.stage("bfs"):
            window = self.graph.driftfree_window(
                ref_index, self.config.drift_free_poses)
        self._ensure_keyframe_capacity()
        self.local_indices = set(window)
        # fresh allocation every frame: a pipelined pack of the previous
        # frame may still read the previous mask
        mask = np.zeros(self.config.max_keyframes, bool)
        mask[list(window)] = True
        self._window_np = mask
        self._first_local = min(window) if window else 0

    # ------------------------------------------------------------------
    # fuse with window gating; fixed-schedule compaction; no stat reads
    # ------------------------------------------------------------------
    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of the packed payload."""
        return self._staged(buf).to(self.device, non_blocking=True)

    def _fuse_frame(self, image, depth, pose, ref_index: int) -> None:
        aux = pack_aux(pose, ref_index, self._window_np,
                       bf=self._stereo_bf or 0.0)
        if isinstance(depth, _StereoPair):
            self._flush_pending()   # fuse order = feed order
            with self.timer.stage("pack"):
                buf = pack_stereo_with_aux(self.config, depth.buf, aux)
            self._fuse_stereo_packed(buf)
            return
        if self._pipelined:
            # submit THIS frame's pack to the worker, then run the PREVIOUS
            # frame: the pack overlaps the upload and the enqueue
            fut = self._pack_pool.submit(pack_frame_with_aux, self.config,
                                         image, depth, aux)
            self._flush_pending()
            self._pending = fut
            return
        with self.timer.stage("pack"):
            buf = pack_frame_with_aux(self.config, image, depth, aux)
        self._fuse_packed(buf)

    def _fuse_packed(self, buf: np.ndarray) -> None:
        self._fused(self._launch(self._fuse_graph, buf))

    def _fuse_stereo_packed(self, buf: np.ndarray) -> None:
        self._fused(self._launch(self._stereo_graph, buf))

    def _launch(self, step, buf: np.ndarray):
        """The payload's pinned staging copy (stage `stage`), then its
        upload and the step's replay (stage `launch`, which holds any wait
        on a full launch queue)."""
        with self.timer.stage("stage"):
            staged = self._staged(buf)
        with self.timer.stage("launch"):
            return step(staged)

    def _fused(self, stats) -> None:
        # on the card: the graph's static stats, which the next replay
        # overwrites (the JAX driver's sync_stats also reads only the
        # latest frame's)
        self._stats_dev = stats
        self._host_rows = None
        self.frames_fused += 1
        if self.frames_fused % self.config.compact_interval == 0:
            self._do_compact()

    def _flush_pending(self) -> None:
        """Run the one in-flight pipelined frame, if any.  Called by every
        consumer of `self.bank` (warp, readouts, checkpoint, stats) and
        before any event that must be ordered after the frame."""
        if self._pending is None:
            return
        fut = self._pending
        self._pending = None
        with self.timer.stage("pack"):
            buf = fut.result()
        self._fuse_packed(buf)

    def flush(self) -> None:
        """Public barrier: complete any pipelined in-flight frame."""
        self._flush_pending()

    def sync_stats(self):
        self._flush_pending()
        return super().sync_stats()

    # ------------------------------------------------------------------
    # loop warp: one whole-bank device pass
    # ------------------------------------------------------------------
    def _warp_surfels(self) -> None:
        self._flush_pending()   # warp must see every fed frame fused
        # poses can run ahead of fused frames, so capacity may need to grow
        # here, not just on the fuse path
        self._ensure_keyframe_capacity()
        warps, moved = self.graph.pose_warps()
        P = self.config.max_keyframes
        wstack = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
        mstack = np.zeros(P, bool)
        n = len(warps)
        wstack[:n] = warps.astype(np.float32)
        mstack[:n] = moved
        self._apply_pose_warp(wstack, mstack)
        self._host_rows = None
        self.graph.commit_loop_poses()

    def _apply_pose_warp(self, wstack: np.ndarray,
                         mstack: np.ndarray) -> None:
        self._pose_warp_graph(wstack, mstack, self._window_np,
                              np.int64(self._first_local))

    # ------------------------------------------------------------------
    # readouts: one bank transfer, split by the window mask
    # ------------------------------------------------------------------
    def _rows_host(self) -> dict:
        self._flush_pending()
        if self._host_rows is None:
            self._host_rows = self._bank_host()
        return self._host_rows

    def _is_active_row(self, rows: dict) -> np.ndarray:
        lu = rows["last_update"]
        ok = (lu >= 0) & (lu < self.config.max_keyframes)
        return ok & self._window_np[np.clip(lu, 0,
                                            self.config.max_keyframes - 1)]

    def active_surfels(self, min_updates=None) -> dict:
        if min_updates is None:
            min_updates = self.config.stable_update_times
        rows = self._rows_host()
        sel = (rows["update_times"] >= min_updates) \
            & self._is_active_row(rows)
        return {k: v[sel] for k, v in rows.items()}

    def inactive_surfels(self) -> dict:
        rows = self._rows_host()
        sel = (rows["update_times"] > 0) & ~self._is_active_row(rows)
        return {k: v[sel] for k, v in rows.items()}

    def memory_usage_kb(self) -> float:
        """The bank alone: this driver keeps no host pool."""
        return sum(t.numel() * t.element_size()
                   for _, t in self.bank.field_arrays()) / 1024.0

    def metrics(self) -> Dict[str, float]:
        self._flush_pending()
        out = super().metrics()
        rows = self._rows_host()
        live = rows["update_times"] > 0
        active = self._is_active_row(rows) & live
        out["active_count"] = int(active.sum())
        out["inactive_count"] = int((live & ~active).sum())
        return out

    # ------------------------------------------------------------------
    # checkpoint/resume: bank + graph (no pool state); the JAX package's
    # DeviceResidentMapping writes and reads the same .npz
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        rows = self._rows_host()
        data = {f"bank_{k}": v for k, v in rows.items()}
        data["bank_count"] = np.int64(len(rows["color"]))
        data.update(self._graph_arrays())
        np.savez_compressed(path, **data)

    def load_checkpoint(self, path: str) -> None:
        self._pending = None   # restored state supersedes in-flight work
        z = np.load(path, allow_pickle=False)
        self._load_bank(z)
        self._load_graph(z)
        self._ensure_keyframe_capacity()
        # the graphs wrote the replaced bank's tensors
        self._build_graphs()
        mask = np.zeros(self.config.max_keyframes, bool)
        mask[sorted(self.local_indices)] = True
        self._window_np = mask
        self._first_local = min(self.local_indices) \
            if self.local_indices else 0
        self._host_rows = None


class ShardedDeviceResidentMapping(DeviceResidentMapping):
    """DeviceResidentMapping over a device mesh: the window-mask lifecycle
    (no steady-state readbacks) with the bank split in row slabs over the
    mesh's "surfel" axis (`parallel/sharding.py`).

    Each frame's payload is the dense driver's one packed buffer, one
    pinned copy into the static input of the mesh step captured as a graph
    (`sharding.graphed_fuse_frame_windowed_packed`, the JAX driver's
    jitted `sharded_fuse_frame_windowed_packed`), decoded on the device, so
    sharded and dense drives fuse the same frames; fuse, loop warp and
    compaction run on every shard, each replayed from its graph and
    rebuilt where the dense driver rebuilds its graphs.  frame_sharded=True
    splits the superpixel/plane-fit stage by image columns over the shards
    (`parallel/frame_sharding.py`); the map is the same either way.  Stats
    stay on the device; the bank's count is read only by the readouts.  On
    a mesh over several cards each program is one graph over every card
    (`fuse_step.capture`), its memory in one pool per card."""

    def __init__(self, config: SurfelMapConfig, mesh,
                 kitti_alignment: bool = False, frame_sharded: bool = False):
        if mesh.shape["data"] != 1:
            raise ValueError("one session per data row")
        self.mesh = mesh
        self.n_shards = mesh.shape["surfel"]
        self.frame_sharded = bool(frame_sharded)
        super().__init__(config, kitti_alignment, device=mesh.device(0, 0))

    def _empty_bank(self):
        from ..parallel import sharding
        return sharding.replicate_banks(self.mesh, self.config, n_streams=1)

    def _build_graphs(self) -> None:
        """The mesh programs against the current banks, for the current
        max_keyframes: the depth-fed step (replicated or column-sharded
        frame stage), compaction and the pose warp (the JAX driver's jits
        of `sharded_fuse_frame_windowed_packed` or
        `sharded_fuse_frame_framestage_windowed_packed`, `sharded_compact`
        and `sharded_warp_by_pose`), and the stereo step once enabled."""
        from ..parallel import frame_sharding, sharding
        cfg, mesh, banks, pool = (self.config, self.mesh, self.bank,
                                  self._bank_pool)
        step = (frame_sharding.graphed_fuse_frame_framestage_windowed_packed
                if self.frame_sharded
                else sharding.graphed_fuse_frame_windowed_packed)
        self._fuse_graph = step(cfg, mesh, banks, self._graph_pool)
        self._compact_graph = sharding.graphed_compact(cfg, mesh, banks, pool)
        self._pose_warp_graph = sharding.graphed_warp_by_pose(cfg, mesh,
                                                              banks, pool)
        self._stereo_graph = None
        if self._stereo_cfg is not None:
            self._build_stereo_graph()

    def _build_stereo_graph(self) -> None:
        """`sharded_fuse_frame_stereo_windowed_packed` as a graph, built
        once per `enable_stereo` (and with the others)."""
        from ..parallel import sharding
        self._stereo_graph = \
            sharding.graphed_fuse_frame_stereo_windowed_packed(
                self.config, self._stereo_cfg, self._stereo_filter,
                self.mesh, self.bank, self._graph_pool)

    def _bank_count(self) -> int:
        return int(self.bank.counts().sum())

    def _bank_capacity(self) -> int:
        return self.n_shards * self.bank.rows_per_shard

    def _bank_host(self) -> dict:
        from .sharded_driver import gather_sharded_bank
        return gather_sharded_bank(self.bank, self.n_shards)

    def memory_usage_kb(self) -> float:
        return self.bank.nbytes() / 1024.0

    # save_checkpoint is inherited (dense gathered rows, `_bank_host`);
    # a checkpoint's rows load round-robin over the shards
    def _load_bank(self, z) -> None:
        from .sharded_driver import scatter_rows_to_sharded
        n = int(z["bank_count"])
        self.bank = scatter_rows_to_sharded(
            self.config, self.mesh, {k: z[f"bank_{k}"][:n] for k in FIELDS})
