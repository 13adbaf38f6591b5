"""Host-side keyframe pose graph.

Mirrors the pose bookkeeping of `SurfelMap` (`surfel_map.h:36-46`,
`surfel_map.cpp:205-365`): a growing keyframe database with camera pose,
loop-corrected pose, covisibility/spanning edges, and the BFS that selects
the drift-free (active) window (`get_driftfree_poses`,
`surfel_map.cpp:1643-1674`).  The graph is tiny (thousands of nodes) so it
stays in numpy/python on the host; only the surfel warps it triggers run on
device.

A numpy copy of the JAX package's `pipeline/pose_graph.py`, with its
dispatch of large graphs to the native C++ BFS (`native/loader.py`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

from ..core import geometry


@dataclasses.dataclass
class Keyframe:
    """One pose-graph node (`PoseElement`, `surfel_map.h:36-46`)."""

    cam_pose: np.ndarray          # 4x4 Twc, float64
    loop_pose: np.ndarray         # 4x4 Twc after latest pose-graph update
    stamp: float
    linked: List[int] = dataclasses.field(default_factory=list)


class PoseGraph:
    def __init__(self):
        self.keyframes: List[Keyframe] = []

    def __len__(self):
        return len(self.keyframes)

    def knows(self, index: int, adding: bool) -> bool:
        """Whether `index` names a keyframe held, or the one a pose that
        `adding` a keyframe is about to add (a new keyframe may name
        itself)."""
        return 0 <= int(index) < len(self) + int(adding)

    def add_keyframe(self, pose: np.ndarray, stamp: float,
                     reference_index: Optional[int] = None) -> int:
        """Append a keyframe; bidirectionally link it to its reference
        (`surfel_map.cpp:327-353`)."""
        idx = len(self.keyframes)
        kf = Keyframe(cam_pose=np.array(pose, np.float64),
                      loop_pose=np.array(pose, np.float64), stamp=stamp)
        self.keyframes.append(kf)
        if reference_index is not None and idx > 0:
            kf.linked.append(int(reference_index))
            self.keyframes[int(reference_index)].linked.append(idx)
        return idx

    def add_loop_edges(self, edges) -> None:
        """Record loop/covisibility edges (both directions, deduplicated;
        `surfel_map.cpp:289-316`). Out-of-range indices are skipped."""
        n = len(self.keyframes)
        for a, b in edges:
            a, b = int(a), int(b)
            if a >= n or b >= n:
                continue
            if b not in self.keyframes[a].linked:
                self.keyframes[a].linked.append(b)
            if a not in self.keyframes[b].linked:
                self.keyframes[b].linked.append(a)

    def update_loop_path(self, path: List[np.ndarray]) -> bool:
        """Overwrite loop_poses from a full pose-graph-optimized path;
        extrapolate keyframes beyond the path length by the last correction
        (`surfel_map.cpp:236-272`).  Returns loop_changed."""
        changed = False
        m = min(len(path), len(self.keyframes))
        for i in range(m):
            self.keyframes[i].loop_pose = np.array(path[i], np.float64)
            # full 3x4 comparison: the reference tests translation only
            # (surfel_map.cpp:236-253), making rotation-only pose-graph
            # corrections invisible — documented divergence #14
            if not np.array_equal(self.keyframes[i].loop_pose[:3, :4],
                                  self.keyframes[i].cam_pose[:3, :4]):
                changed = True
        if len(self.keyframes) > len(path) > 0:
            last = len(path) - 1
            warp = self.keyframes[last].loop_pose @ geometry.invert_se3(
                self.keyframes[last].cam_pose)
            for i in range(len(path), len(self.keyframes)):
                self.keyframes[i].loop_pose = warp @ self.keyframes[i].cam_pose
        return changed

    def pose_warps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-keyframe warp matrices loop_pose * cam_pose^-1 and the mask of
        keyframes whose pose actually moved (`surfel_map.cpp:693-711`)."""
        n = len(self.keyframes)
        warps = np.tile(np.eye(4), (n, 1, 1))
        moved = np.zeros(n, bool)
        for i, kf in enumerate(self.keyframes):
            # full 3x4 comparison (divergence #14): rotation-only
            # corrections also warp; the reference would skip them
            if not np.array_equal(kf.cam_pose[:3, :4], kf.loop_pose[:3, :4]):
                warps[i] = kf.loop_pose @ geometry.invert_se3(kf.cam_pose)
                moved[i] = True
        return warps, moved

    def commit_loop_poses(self) -> None:
        """cam_pose := loop_pose for every keyframe (the state after the
        reference's warp kernels, `surfel_map.cpp:700,741`)."""
        for kf in self.keyframes:
            kf.cam_pose = kf.loop_pose.copy()

    def driftfree_window(self, root: int, radius: int) -> List[int]:
        """BFS over linked edges, depth < radius, root first
        (`get_driftfree_poses`, `surfel_map.cpp:1643-1674`).

        Dispatches to the native C++ BFS for large graphs; pure-Python
        walk otherwise (and for small graphs where ctypes marshalling
        costs more than the walk).  Both give the same order."""
        if root >= len(self.keyframes):
            return []
        if len(self.keyframes) >= 512:
            out = self._native_bfs(root, radius)
            if out is not None:
                return out
        seen = [root]
        seen_set = {root}
        level = [root]
        for _ in range(1, radius):
            nxt = []
            for node in level:
                for nb in self.keyframes[node].linked:
                    if nb not in seen_set:
                        seen_set.add(nb)
                        seen.append(nb)
                        nxt.append(nb)
            level = nxt
        return seen

    def _native_bfs(self, root: int, radius: int) -> Optional[List[int]]:
        """CSR adjacency -> native/surfel_native.cpp dsm_bfs."""
        from ..native import loader as native
        if not native.available():
            return None
        degrees = np.array([len(kf.linked) for kf in self.keyframes],
                           np.int64)
        indptr = np.zeros(len(self.keyframes) + 1, np.int64)
        np.cumsum(degrees, out=indptr[1:])
        indices = np.concatenate(
            [np.asarray(kf.linked, np.int64) for kf in self.keyframes]) \
            if indptr[-1] else np.zeros(0, np.int64)
        return [int(i) for i in native.bfs(indptr, indices, root, radius)]

    def add_remove_sets(self, root: int, radius: int,
                        local: Set[int]) -> Tuple[List[int], List[int]]:
        """(poses_to_add, poses_to_remove) vs the current local set
        (`get_add_remove_poses`, `surfel_map.cpp:1597-1641`)."""
        window = self.driftfree_window(root, radius)
        wset = set(window)
        to_add = [i for i in window if i not in local]
        to_remove = [i for i in sorted(local) if i not in wset]
        return to_add, to_remove
