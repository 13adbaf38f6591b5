"""Host-side inactive surfel pool, keyed by owning keyframe.

Replaces the reference's single contiguous `inactive_pointcloud` +
per-pose (points_begin_index, points_pose_index) range bookkeeping with its
erase-and-shift maintenance (`surfel_map.cpp:1456-1595`).  A per-pose slab
dict gives the same operations — attach on deactivation, detach on loop
revisit, warp on loop closure — without any index shifting; the loop-closure
warp batches every moved pose's slab into one device call.

A numpy copy of the JAX package's `pipeline/inactive_pool.py`.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

FIELDS = ("position", "normal", "color", "size", "weight",
          "update_times", "last_update")


def _empty_slab():
    return dict(position=np.zeros((0, 3), np.float32),
                normal=np.zeros((0, 3), np.float32),
                color=np.zeros(0, np.float32),
                size=np.zeros(0, np.float32),
                weight=np.zeros(0, np.float32),
                update_times=np.zeros(0, np.int32),
                last_update=np.zeros(0, np.int32))


class InactivePool:
    def __init__(self):
        self.slabs: Dict[int, dict] = {}

    def __len__(self):
        return sum(len(s["color"]) for s in self.slabs.values())

    @property
    def num_poses(self) -> int:
        return len(self.slabs)

    def attach(self, pose_index: int, fields: dict, n: int) -> None:
        """Move n surfels (host numpy field dict, first n rows valid) into
        the pose's slab (`surfel_map.cpp:1476-1500`)."""
        if n == 0:
            return
        slab = {k: np.asarray(fields[k][:n]).copy() for k in FIELDS}
        if pose_index in self.slabs:
            old = self.slabs[pose_index]
            slab = {k: np.concatenate([old[k], slab[k]]) for k in FIELDS}
        self.slabs[pose_index] = slab

    def detach(self, pose_indices: Iterable[int]) -> dict:
        """Remove and return the combined slab of the given poses
        (loop-revisit reactivation, `surfel_map.cpp:1507-1590`)."""
        parts = [self.slabs.pop(i) for i in pose_indices if i in self.slabs]
        if not parts:
            return _empty_slab()
        return {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}

    def warp(self, warps: np.ndarray, moved: np.ndarray, warp_fn) -> int:
        """Warp every slab whose pose moved, in ONE batched device call.

        warps: (P, 4, 4) float64 per-pose warp matrices; moved: (P,) bool;
        warp_fn(positions, normals, pose_index, warps) -> (p', n') takes and
        returns numpy arrays (the driver wraps `ops.warp.warp_pool`).
        Returns number of surfels warped.
        (`warp_inactive_surfels_cpu_kernel`, surfel_map.cpp:681-748.)"""
        idxs = [i for i in self.slabs if i < len(moved) and moved[i]]
        if not idxs:
            return 0
        counts = [len(self.slabs[i]["color"]) for i in idxs]
        total = sum(counts)
        if total == 0:
            return 0
        pos = np.concatenate([self.slabs[i]["position"] for i in idxs])
        nrm = np.concatenate([self.slabs[i]["normal"] for i in idxs])
        owner = np.repeat(np.arange(len(idxs), dtype=np.int64), counts)
        sel = np.asarray(warps, np.float32)[np.asarray(idxs)]
        new_p, new_n = warp_fn(pos, nrm, owner, sel)
        off = 0
        for i, c in zip(idxs, counts):
            self.slabs[i]["position"] = new_p[off:off + c]
            self.slabs[i]["normal"] = new_n[off:off + c]
            off += c
        return total

    def all_surfels(self) -> dict:
        """Concatenate every slab (for export/publishing)."""
        if not self.slabs:
            return _empty_slab()
        keys = sorted(self.slabs)
        return {k: np.concatenate([self.slabs[i][k] for i in keys])
                for k in FIELDS}

    def memory_bytes(self) -> int:
        return sum(sum(a.nbytes for a in s.values())
                   for s in self.slabs.values())
