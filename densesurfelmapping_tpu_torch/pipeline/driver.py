"""SurfelMapping: the host orchestrator around the fuse step.

Counterpart of the JAX package's `pipeline/driver.py` (the reference's
`SurfelMap` class, `surfel_map.h:48-148`): frame/pose buffering and timestamp
sync (`synchronize_msgs`, `surfel_map.cpp:103-203`), pose/loop ingestion
(`orb_results_input`, :205-365), active-window migration to a host pool
(`move_add_surfels`, :1456-1595), loop-closure warping (`warp_surfels`,
:791-824), readouts and checkpoint/resume.

The pose graph and buffers are tiny and live on the host; every per-surfel /
per-pixel operation runs on the driver's device.  Where the JAX driver
dispatches a jitted program (the fuse step of each upload, compaction, the
migration append and extract, the active warp), this driver replays the
program captured in a CUDA graph (`fuse_step.StepGraph` / `BankGraph`,
captured at its first use); each frame's payload (frame, pose, index, bf)
travels in one host-to-device copy from pinned memory.  The inactive pool's
warp (`warp_ops.warp_pool`) stays eager: its length changes with every call
(the JAX jit re-traces it per shape).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core import geometry
from ..core.state import (FIELDS, SurfelBank, bank_from_numpy, bank_to_numpy,
                          pack_aux, pack_frame_with_aux, pack_stereo_pair,
                          pack_stereo_with_aux, pad_frame)
from ..ops import migration, warp as warp_ops
from ..utils.timing import StageTimer
from . import fuse_step
from .inactive_pool import InactivePool
from .pose_graph import PoseGraph


class _StereoPair:
    """Depth-buffer marker: a packed u8 left/right pair whose depth is
    computed on the device inside the fuse step (enable_stereo)."""
    __slots__ = ("buf",)

    def __init__(self, buf: np.ndarray):
        self.buf = buf


class SurfelMapping:
    """End-to-end mapping system: feed images/depths/poses, read out maps.

    Input schema matches the reference's topic contract: intensity image +
    metric depth (0 = invalid) + per-frame pose with keyframe flag,
    reference-keyframe index, the full loop-corrected keyframe path, and
    loop-edge index pairs.

    device: where the bank lives and the fuse step runs.  The default
    "cuda" raises on a machine without a GPU rather than running on the CPU.
    """

    def __init__(self, config: SurfelMapConfig, kitti_alignment: bool = False,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.graph = PoseGraph()
        self.pool = InactivePool()
        self.bank = self._empty_bank()
        self.local_indices: Set[int] = set()
        self.timer = StageTimer()

        self._kitti_alignment = kitti_alignment
        self._alignment: Optional[np.ndarray] = None

        # (stamp, image) / (stamp, depth) / (stamp, rel_pose, ref_index)
        self.image_buffer = collections.deque()
        self.depth_buffer = collections.deque()
        self.pose_buffer = collections.deque()
        self.stamp_tolerance = 1e-6

        self.frames_fused = 0
        self.compactions = 0
        self.last_stats: Dict[str, int] = {}   # refreshed every stats sync
        self._stats_dev: Dict[str, torch.Tensor] = {}
        self.max_buffered = 5000   # reference queue depth (ros_node.cpp:24)
        self.dropped = collections.Counter()

        # on-device stereo front-end (enable_stereo/feed_stereo)
        self._stereo_cfg = None
        self._stereo_bf: Optional[float] = None
        self._stereo_filter = True

        # the captured programs (`_build_graphs`): the per-frame steps share
        # one memory pool and the bank programs another, so no bank
        # program's replay overwrites the stats a step left for sync_stats
        # (one pool per card of the bank: the sharded drivers' meshes)
        cards = fuse_step.devices_of(self.bank)
        self._graph_pool = fuse_step.graph_pool(cards)
        self._bank_pool = fuse_step.graph_pool(cards)
        self._fuse_graph = self._stereo_graph = None
        self._compact_graph = self._append_graph = None
        self._extract_graph = self._warp_graph = None
        self._build_graphs()

    def _empty_bank(self) -> SurfelBank:
        """The empty bank the driver starts from (the sharded drivers: a
        mesh's `ShardedBanks`)."""
        return SurfelBank.empty(self.config.surfel_capacity, self.device)

    def _compact_upload(self) -> bool:
        """Whether depth-fed frames travel as `pack_frame` bytes (u8 +
        f16) or as the padded f32 planes."""
        return self.config.compact_upload

    @property
    def graphed(self) -> bool:
        """Whether the driver's programs replay captured CUDA graphs: on
        one card or a mesh of cards (`parallel.sharding.graphed_mesh`),
        not on the CPU."""
        return self._fuse_graph.graphed

    def _build_graphs(self) -> None:
        """(Re)build the captured programs against the current bank, the
        counterparts of the JAX driver's jits (densesurfelmapping_tpu/
        pipeline/driver.py:47-56, :81-84, :139-141): the fuse step of the
        configured upload, compaction, the migration append and extract,
        and the active warp, each captured at its first use.  Called again
        after a checkpoint load (a graph holds the replaced bank's
        addresses); the subclasses build their own programs."""
        cfg, bank, pool = self.config, self.bank, self._bank_pool
        graphed = (fuse_step.graphed_fuse_frame_compact
                   if self._compact_upload() else fuse_step.graphed_fuse_frame)
        self._fuse_graph = graphed(cfg, bank, self._graph_pool)
        self._compact_graph = fuse_step.graphed_compact(bank, pool)
        self._append_graph = fuse_step.graphed_append(cfg, bank, pool)
        self._extract_graph = fuse_step.graphed_extract(cfg, bank, pool)
        self._warp_graph = fuse_step.graphed_warp_active(bank, pool)
        self._stereo_graph = None
        if self._stereo_cfg is not None:
            self._build_stereo_graph()

    def _build_stereo_graph(self) -> None:
        """The stereo-resident step's graph (the JAX driver's
        `_build_stereo_jit`)."""
        self._stereo_graph = fuse_step.graphed_fuse_frame_stereo_packed(
            self.config, self._stereo_cfg, self._stereo_filter, self.bank,
            self._graph_pool)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _staged(self, buf: np.ndarray) -> torch.Tensor:
        """A packed payload as a tensor to copy to the device: on a GPU a
        fresh pinned copy, so the copy does not block the host (the pinned
        allocator reuses a block only once the copies that read it are
        done)."""
        t = torch.from_numpy(buf)
        return t.pin_memory() if self.device.type == "cuda" else t

    # ------------------------------------------------------------------
    # inputs (reference: image_input/depth_input/orb_results_input)
    # ------------------------------------------------------------------
    def _check_frame(self, kind: str, arr: np.ndarray) -> None:
        """Shape validation up front (failure detection the reference
        lacks)."""
        expect = (self.config.height, self.config.width)
        if np.shape(arr) != expect:
            raise ValueError(
                f"{kind} shape {np.shape(arr)} != camera {expect}")

    def feed_image(self, stamp: float, image: np.ndarray) -> None:
        self._check_frame("image", image)
        self.image_buffer.append((float(stamp), image))
        self._trim_buffers()
        self._synchronize()

    def enable_stereo(self, bf: float, stereo_config=None,
                      filter_depth: bool = True) -> None:
        """Switch the depth source to the on-device stereo front-end:
        `feed_stereo(stamp, left, right)` replaces feed_image + feed_depth.
        bf = fx * baseline (the `depth = bf / disparity` contract of
        kitti_publisher's publisher.py:40)."""
        from ..models.stereo import StereoConfig

        self._stereo_cfg = stereo_config or StereoConfig()
        self._stereo_bf = float(bf)
        self._stereo_filter = bool(filter_depth)
        self._build_stereo_graph()

    def feed_stereo(self, stamp: float, left: np.ndarray,
                    right: np.ndarray) -> None:
        """Rectified stereo pair at `stamp`; pairs with feed_pose like
        feed_image + feed_depth (the left image is the fuse intensity).
        Requires enable_stereo()."""
        if self._stereo_cfg is None:
            raise RuntimeError("feed_stereo before enable_stereo(bf=...)")
        self._check_frame("left", left)
        self._check_frame("right", right)
        buf = pack_stereo_pair(self.config, left, right)
        self.image_buffer.append((float(stamp), np.asarray(left)))
        self.depth_buffer.append((float(stamp), _StereoPair(buf)))
        self._trim_buffers()
        self._synchronize()

    def feed_depth(self, stamp: float, depth: np.ndarray) -> None:
        self._check_frame("depth", depth)
        depth = np.asarray(depth)
        finite = np.isfinite(depth)
        if not finite.all():
            depth = np.where(finite, depth, 0.0)
            self.dropped["nonfinite_depth_px"] += int((~finite).sum())
        self.depth_buffer.append((float(stamp), depth))
        self._trim_buffers()
        self._synchronize()

    def _trim_buffers(self) -> None:
        """Bound buffer growth (the reference used 5000-deep ROS queues,
        `ros_node.cpp:24-31`); oldest entries drop first."""
        for name, buf in (("images", self.image_buffer),
                          ("depths", self.depth_buffer),
                          ("poses", self.pose_buffer)):
            while len(buf) > self.max_buffered:
                buf.popleft()
                self.dropped[name] += 1

    def feed_pose(self, stamp: float, pose: np.ndarray,
                  loop_path: Optional[Sequence[np.ndarray]] = None,
                  loop_edges: Sequence[Tuple[int, int]] = (),
                  is_keyframe: bool = False,
                  reference_index: Optional[int] = None) -> None:
        """Pose/loop ingestion (`orb_results_input`, surfel_map.cpp:205-365).

        pose: 4x4 Twc of the CURRENT frame. loop_path: loop-corrected poses
        of ALL keyframes so far (same raw frame as pose). loop_edges:
        keyframe index pairs. reference_index: this frame's reference
        keyframe (defaults to the newest; a new keyframe references itself).
        A pose whose reference_index names no keyframe fed (nor the new
        one) is dropped and counted in `dropped["unknown_reference"]`;
        the JAX package's driver raises IndexError there.
        """
        pose = np.array(pose, np.float64)
        # a NaN/Inf or non-rigid pose would poison the whole pose graph:
        # drop it instead
        if pose.shape != (4, 4) or not np.isfinite(pose).all():
            self.dropped["invalid_pose"] += 1
            return
        if abs(np.linalg.det(pose[:3, :3]) - 1.0) > 0.1:
            self.dropped["invalid_pose"] += 1
            return
        # a reference keyframe never fed drops the pose too, where the JAX
        # driver raises IndexError: one malformed message from a live
        # front-end must not end the session
        if reference_index is not None and not self.graph.knows(
                reference_index, is_keyframe or len(self.graph) == 0):
            self.dropped["unknown_reference"] += 1
            return
        if self._kitti_alignment:
            if self._alignment is None:
                self._alignment = geometry.kitti_alignment(pose)
            pose = self._alignment @ pose
            if loop_path is not None:
                loop_path = [self._alignment @ np.asarray(p, np.float64)
                             for p in loop_path]

        loop_changed = False
        if loop_path is not None and len(self.graph) > 0:
            with self.timer.stage("loop_path"):
                loop_changed = self.graph.update_loop_path(list(loop_path))
        if loop_changed:
            with self.timer.stage("warp"):
                self._warp_surfels()

        if is_keyframe or len(self.graph) == 0:
            # link the new keyframe to its reference; default to the newest
            # existing keyframe
            link_to = None
            if len(self.graph) > 0:
                link_to = (reference_index if reference_index is not None
                           else len(self.graph) - 1)
            new_index = self.graph.add_keyframe(pose, stamp, link_to)
            self.local_indices.add(new_index)
            if reference_index is None:
                reference_index = new_index
        if reference_index is None:
            reference_index = len(self.graph) - 1

        # edges are recorded AFTER keyframe insertion, so same-message edges
        # naming the new keyframe register immediately (a divergence from
        # the reference, surfel_map.cpp:289-316 running before :318-353)
        self.graph.add_loop_edges(loop_edges)

        ref_pose = self.graph.keyframes[int(reference_index)].cam_pose
        rel = geometry.invert_se3(ref_pose) @ pose
        self.pose_buffer.append((float(stamp), rel, int(reference_index)))
        self._synchronize()

    # ------------------------------------------------------------------
    # sync + fuse (reference: synchronize_msgs, surfel_map.cpp:103-203)
    # ------------------------------------------------------------------
    def _match_front(self, buffer, stamp, name):
        while buffer:
            t = buffer[0][0]
            if t < stamp - self.stamp_tolerance:
                buffer.popleft()
                self.dropped[name] += 1   # pre-pose data, never fused
            elif abs(t - stamp) <= self.stamp_tolerance:
                return buffer[0]
            else:
                return None
        return None

    def _synchronize(self) -> None:
        while self.pose_buffer:
            stamp, rel, ref = self.pose_buffer[0]
            img = self._match_front(self.image_buffer, stamp, "images")
            dep = self._match_front(self.depth_buffer, stamp, "depths")
            if img is None or dep is None:
                return
            fuse_pose = self.graph.keyframes[ref].cam_pose @ rel
            with self.timer.stage("migrate"):
                self._move_add_surfels(ref)
            with self.timer.stage("fuse"):
                self._fuse_frame(img[1], dep[1], fuse_pose, ref)
            self.pose_buffer.popleft()
            self.image_buffer.popleft()
            self.depth_buffer.popleft()

    def _fuse_frame(self, image, depth, pose, ref_index: int) -> None:
        """Pack the frame, pose, index and bf into one payload and replay
        the step of its kind: the stereo step, the compact step or the
        padded f32 step (`_build_graphs`)."""
        aux = pack_aux(pose, ref_index, np.zeros(0, bool),
                       bf=self._stereo_bf or 0.0)
        if isinstance(depth, _StereoPair):
            step = self._stereo_graph
            buf = pack_stereo_with_aux(self.config, depth.buf, aux)
        else:
            step = self._fuse_graph
            if self._compact_upload():
                buf = pack_frame_with_aux(self.config, image, depth, aux)
            else:
                planes = pad_frame(self.config,
                                   np.asarray(image, np.float32),
                                   np.asarray(depth, np.float32))
                buf = np.concatenate([p.reshape(-1).view(np.uint8)
                                      for p in planes] + [aux])
        self._fuse_epilogue(step(self._staged(buf)))

    def _fuse_epilogue(self, stats) -> None:
        # device values (on the card the step graph's static stats, which
        # its next replay overwrites); synced on stats frames
        self._stats_dev = stats
        self.frames_fused += 1
        if self.frames_fused % self.config.stats_interval == 0:
            self.sync_stats()
            self._maybe_compact()

    def sync_stats(self) -> Dict[str, int]:
        """Blocking device->host fetch of the latest fuse-step stats."""
        if self._stats_dev:
            self.last_stats = {k: int(v) for k, v in self._stats_dev.items()}
        return self.last_stats

    def _maybe_compact(self) -> None:
        """Repack the bank when dead holes exceed the slack or the tail
        lacks headroom for the frames until the next stats sync."""
        st = self.last_stats
        count = self._bank_count()
        live = st.get("n_live", 0) + st.get("n_new", 0)
        slab = self.config.new_capacity
        margin = (self.config.stats_interval + 1) * slab \
            + self.config.migration_buffer
        need_room = count > self._bank_capacity() - margin
        if (count - live > self.config.compaction_slack) or need_room \
                or st.get("n_dropped", 0) > 0:
            self._do_compact()

    # ------------------------------------------------------------------
    # device-bank seams (the sharded drivers override them)
    # ------------------------------------------------------------------
    def _bank_count(self) -> int:
        return int(self.bank.count)

    def _bank_capacity(self) -> int:
        return self.bank.capacity

    def _do_compact(self) -> None:
        with self.timer.stage("compact"):
            self._compact_graph()
        self.compactions += 1

    def _extract_chunk(self, ids: np.ndarray):
        """One removed-pose extraction pass; returns (host fields, n).  The
        rows are the graph's static outputs: copied to the host here,
        before the next replay overwrites them."""
        rows, n = self._extract_graph(ids)
        n = int(n)
        if n == 0:
            return {}, 0
        return {k: v[:n].to("cpu", copy=True).numpy()
                for k, v in rows.items()}, n

    def _append_hostslab(self, padded: dict, n: int) -> None:
        """Tail-append the first n rows of a migration_buffer-row host
        slab."""
        self._append_graph(*(padded[k] for k in FIELDS), np.int32(n))

    def _apply_active_warp(self, warp: np.ndarray) -> None:
        self._warp_graph(np.asarray(warp, np.float32))

    def _bank_host(self) -> dict:
        """Host copy of the bank's allocated rows."""
        return bank_to_numpy(self.bank)

    # ------------------------------------------------------------------
    # active window migration (reference: move_add_surfels)
    # ------------------------------------------------------------------
    def _move_add_surfels(self, ref_index: int) -> None:
        to_add, to_remove = self.graph.add_remove_sets(
            ref_index, self.config.drift_free_poses, self.local_indices)
        buf_size = self.config.migration_buffer

        if to_remove:
            remaining = list(to_remove)
            while remaining:
                chunk = remaining[:migration.MAX_REMOVE_POSES]
                ids = np.full(migration.MAX_REMOVE_POSES, -1, np.int32)
                ids[:len(chunk)] = chunk
                while True:
                    host, n = self._extract_chunk(ids)
                    if n == 0:
                        break
                    for pose_id in chunk:
                        sel = host["last_update"] == pose_id
                        if sel.any():
                            self.pool.attach(
                                pose_id, {k: v[sel] for k, v in host.items()},
                                int(sel.sum()))
                    if n < buf_size:
                        break
                remaining = remaining[migration.MAX_REMOVE_POSES:]
            self.local_indices -= set(to_remove)

        if to_add:
            self.local_indices |= set(to_add)
            slab = self.pool.detach(to_add)
            m = len(slab["color"])
            if self._bank_count() > self._bank_capacity() - buf_size:
                self._do_compact()
            for off in range(0, m, buf_size):
                part = {k: v[off:off + buf_size] for k, v in slab.items()}
                n = len(part["color"])
                padded = {}
                for k in FIELDS:
                    arr = np.zeros((buf_size,) + part[k].shape[1:],
                                   part[k].dtype)
                    arr[:n] = part[k]
                    padded[k] = arr
                self._append_hostslab(padded, n)

    # ------------------------------------------------------------------
    # loop-closure warp (reference: warp_surfels)
    # ------------------------------------------------------------------
    def _warp_pool_np(self, pos, nrm, owner, warps):
        new_p, new_n = warp_ops.warp_pool(
            self._to_device(pos), self._to_device(nrm),
            self._to_device(owner), self._to_device(warps))
        return new_p.cpu().numpy(), new_n.cpu().numpy()

    def _warp_surfels(self) -> None:
        warps, moved = self.graph.pose_warps()
        # active surfels: single warp from the FIRST local pose
        # (surfel_map.cpp:808-813)
        if self.local_indices:
            first = min(self.local_indices)
            if first < len(moved) and moved[first]:
                self._apply_active_warp(warps[first])
        self.pool.warp(warps, moved, self._warp_pool_np)
        self.graph.commit_loop_poses()

    # ------------------------------------------------------------------
    # map readout (reference: publish_* / save_*)
    # ------------------------------------------------------------------
    def active_surfels(self, min_updates: Optional[int] = None) -> dict:
        """Host copy of live active surfels (update_times >= min_updates,
        default the config's stable threshold — publish_active_pointcloud /
        save_cloud gating)."""
        if min_updates is None:
            min_updates = self.config.stable_update_times
        rows = self._bank_host()
        sel = rows["update_times"] >= min_updates
        return {k: v[sel] for k, v in rows.items()}

    def inactive_surfels(self) -> dict:
        return self.pool.all_surfels()

    def map_surfels(self) -> dict:
        """Stable active + all inactive surfels (save_cloud semantics,
        `surfel_map.cpp:1153-1174`)."""
        act = self.active_surfels()
        ina = self.inactive_surfels()
        return {k: np.concatenate([act[k], ina[k]]) for k in FIELDS}

    def mesh_surfels(self) -> dict:
        """Surfels eligible for mesh export: every inactive (attached)
        surfel + stable active ones (save_mesh, `surfel_map.cpp:1219-1240`)."""
        return self.map_surfels()

    def save_cloud(self, path: str, binary: bool = True) -> int:
        """PCD export of the stable map (`save_cloud`, surfel_map.cpp:1153)."""
        from ..io import export
        return export.save_cloud_pcd(path, self.map_surfels(), binary=binary)

    def save_mesh(self, path: str, binary: bool = False) -> int:
        """Hexagon-tessellated PLY export (`save_mesh`,
        surfel_map.cpp:1219)."""
        from ..io import export
        return export.save_mesh_ply(path, self.mesh_surfels(), binary=binary)

    def save_trajectory(self, path: str, fmt: str = "kitti") -> int:
        """Loop-corrected keyframe trajectory ("kitti" 3x4 rows or "tum"
        stamped quaternions) for external eval tooling — the file form of
        the reference's continuously published /loop_path
        (`ros_stereo.cc:214-257`)."""
        from ..io import export
        poses = [k.loop_pose for k in self.graph.keyframes]
        stamps = [k.stamp for k in self.graph.keyframes]
        if fmt == "kitti":
            return export.save_trajectory_kitti(path, poses, stamps)
        if fmt == "tum":
            return export.save_trajectory_tum(path, poses, stamps)
        raise ValueError(f"unknown trajectory format {fmt!r}")

    def raw_pointcloud(self, depth: np.ndarray, pose: np.ndarray,
                       image: Optional[np.ndarray] = None) -> dict:
        """Back-projected world-frame cloud of one raw depth frame — the
        reference's `raw_pointcloud` debug topic (`surfel_map.cpp:56-63`,
        publish of the unfused input).  Host numpy; not on the hot path."""
        cam = self.config.camera
        depth = np.asarray(depth, np.float32)
        h, w = depth.shape
        vs, us = np.mgrid[0:h, 0:w]
        valid = depth > 0.01
        z = depth[valid]
        x = (us[valid] - cam.cx) / cam.fx * z
        y = (vs[valid] - cam.cy) / cam.fy * z
        pts = np.stack([x, y, z], axis=1)
        T = np.asarray(pose, np.float64)
        world = pts @ T[:3, :3].T + T[:3, 3]
        out = {"position": world.astype(np.float32)}
        if image is not None:
            out["color"] = np.asarray(image, np.float32)[valid]
        return out

    def fusion_path(self) -> List[np.ndarray]:
        """Loop-corrected poses of every keyframe (`fusion_loop_path`)."""
        return [kf.loop_pose.copy() for kf in self.graph.keyframes]

    def driftfree_path(self) -> List[np.ndarray]:
        """Poses of the current active (drift-free) window
        (`driftfree_loop_path`)."""
        return [self.graph.keyframes[i].loop_pose.copy()
                for i in sorted(self.local_indices)
                if i < len(self.graph.keyframes)]

    def loop_edges(self) -> List[Tuple[int, int]]:
        """Deduplicated loop/covisibility edges (`loop_marker` content)."""
        return [(i, j) for i, kf in enumerate(self.graph.keyframes)
                for j in kf.linked if j > i]

    def metrics(self) -> Dict[str, float]:
        """Observability snapshot: throughput and drop counters, buffer
        depths, stage means (ms), memory."""
        out: Dict[str, float] = {
            "frames_fused": self.frames_fused,
            "keyframes": len(self.graph),
            "active_count": self._bank_count(),
            "inactive_count": len(self.pool),
            "buffered_images": len(self.image_buffer),
            "buffered_depths": len(self.depth_buffer),
            "buffered_poses": len(self.pose_buffer),
            "memory_kb": self.memory_usage_kb(),
        }
        for k, v in self.dropped.items():
            out[f"dropped_{k}"] = v
        for k, v in self.timer.means_ms().items():
            out[f"stage_ms_{k}"] = v
        return out

    def memory_usage_kb(self) -> float:
        """`calculate_memory_usage` (surfel_map.cpp:895-904) equivalent."""
        bank_bytes = sum(t.numel() * t.element_size()
                         for _, t in self.bank.field_arrays())
        return (bank_bytes + self.pool.memory_bytes()) / 1024.0

    # ------------------------------------------------------------------
    # checkpoint/resume (the reference has none)
    # ------------------------------------------------------------------
    def _graph_arrays(self) -> dict:
        g = self.graph
        data = {}
        data["kf_cam"] = np.stack([k.cam_pose for k in g.keyframes]) \
            if len(g) else np.zeros((0, 4, 4))
        data["kf_loop"] = np.stack([k.loop_pose for k in g.keyframes]) \
            if len(g) else np.zeros((0, 4, 4))
        data["kf_stamp"] = np.array([k.stamp for k in g.keyframes])
        edges = [(i, j) for i, k in enumerate(g.keyframes) for j in k.linked]
        data["kf_edges"] = np.array(edges, np.int64).reshape(-1, 2)
        data["local_indices"] = np.array(sorted(self.local_indices), np.int64)
        data["frames_fused"] = np.int64(self.frames_fused)
        if self._alignment is not None:
            data["alignment"] = self._alignment
        return data

    def _load_graph(self, z) -> None:
        self.graph = PoseGraph()
        for cam, loop, stamp in zip(z["kf_cam"], z["kf_loop"], z["kf_stamp"]):
            idx = self.graph.add_keyframe(cam, float(stamp))
            self.graph.keyframes[idx].loop_pose = np.array(loop)
        for i, j in z["kf_edges"]:
            kf = self.graph.keyframes[int(i)]
            if int(j) not in kf.linked:
                kf.linked.append(int(j))
        self.local_indices = set(int(i) for i in z["local_indices"])
        self.frames_fused = int(z["frames_fused"])
        if "alignment" in z:
            self._alignment = np.array(z["alignment"])

    def _load_bank(self, z) -> None:
        n = int(z["bank_count"])
        self.bank = bank_from_numpy({k: z[f"bank_{k}"] for k in FIELDS}, n,
                                    self.device, self.config.surfel_capacity)

    def save_checkpoint(self, path: str) -> None:
        """Bank, pose graph and host pool as one .npz (the JAX package's
        format)."""
        data = {f"bank_{k}": v for k, v in self._bank_host().items()}
        data["bank_count"] = np.int64(len(data["bank_color"]))
        data.update(self._graph_arrays())
        data["pool_keys"] = np.array(sorted(self.pool.slabs), np.int64)
        for k in FIELDS:
            slabs = [self.pool.slabs[i][k] for i in sorted(self.pool.slabs)]
            data[f"pool_{k}"] = (np.concatenate(slabs) if slabs else
                                 np.zeros((0, 3) if k in ("position", "normal")
                                          else (0,), np.float32))
        data["pool_counts"] = np.array(
            [len(self.pool.slabs[i]["color"])
             for i in sorted(self.pool.slabs)], np.int64)
        np.savez_compressed(path, **data)

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path, allow_pickle=False)
        self._load_bank(z)
        self._build_graphs()    # the graphs wrote the replaced bank
        self._load_graph(z)
        self.pool = InactivePool()
        off = 0
        for key, cnt in zip(z["pool_keys"], z["pool_counts"]):
            slab = {k: z[f"pool_{k}"][off:off + int(cnt)].copy()
                    for k in FIELDS}
            self.pool.slabs[int(key)] = slab
            off += int(cnt)
