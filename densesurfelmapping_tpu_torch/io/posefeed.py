"""File-based pose feed: the "fake SLAM" replacing ORB-SLAM2.

The rebuild consumes precomputed poses / keyframe decisions / loop edges in
the reference's message schema (SURVEY.md §2 item 9): per frame a Twc pose,
an is-keyframe flag, a reference-keyframe index, the loop-corrected keyframe
path so far, and loop-edge index pairs (the content of /orb_slam/pose,
/orb_slam/path, /orb_slam/loop produced by ros_stereo.cc:200-320).

Serialized as npz for exactness; also reads TUM-format text trajectories
(stamp tx ty tz qx qy qz qw) with a keyframe-every-N policy for convenience.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import geometry


@dataclasses.dataclass
class PoseMessage:
    stamp: float
    pose: np.ndarray                      # 4x4 Twc of this frame
    is_keyframe: bool
    reference_index: int                  # reference keyframe index
    loop_path: Optional[List[np.ndarray]]  # corrected poses of ALL keyframes
    loop_edges: List[Tuple[int, int]]


class PoseFeed:
    def __init__(self, messages: List[PoseMessage]):
        self.messages = messages

    def __iter__(self) -> Iterator[PoseMessage]:
        return iter(self.messages)

    def __len__(self):
        return len(self.messages)

    # ------------------------------------------------------------------
    @staticmethod
    def save(path: str, messages: Sequence[PoseMessage]) -> None:
        n = len(messages)
        stamps = np.array([m.stamp for m in messages])
        poses = np.stack([m.pose for m in messages])
        iskf = np.array([m.is_keyframe for m in messages], bool)
        refs = np.array([m.reference_index for m in messages], np.int64)
        path_lens = np.array([0 if m.loop_path is None else len(m.loop_path)
                              for m in messages], np.int64)
        has_path = np.array([m.loop_path is not None for m in messages], bool)
        paths = (np.concatenate([np.stack(m.loop_path) for m in messages
                                 if m.loop_path])
                 if any(has_path & (path_lens > 0)) else np.zeros((0, 4, 4)))
        edge_lens = np.array([len(m.loop_edges) for m in messages], np.int64)
        edges = (np.concatenate([np.array(m.loop_edges, np.int64).reshape(-1, 2)
                                 for m in messages])
                 if edge_lens.sum() else np.zeros((0, 2), np.int64))
        np.savez_compressed(path, n=n, stamps=stamps, poses=poses, iskf=iskf,
                            refs=refs, path_lens=path_lens, has_path=has_path,
                            paths=paths, edge_lens=edge_lens, edges=edges)

    @staticmethod
    def load(path: str) -> "PoseFeed":
        z = np.load(path)
        msgs = []
        p_off = e_off = 0
        for i in range(int(z["n"])):
            pl = int(z["path_lens"][i])
            loop_path = None
            if bool(z["has_path"][i]):
                loop_path = [z["paths"][p_off + j] for j in range(pl)]
                p_off += pl
            el = int(z["edge_lens"][i])
            edges = [tuple(e) for e in z["edges"][e_off:e_off + el]]
            e_off += el
            msgs.append(PoseMessage(
                stamp=float(z["stamps"][i]), pose=z["poses"][i],
                is_keyframe=bool(z["iskf"][i]),
                reference_index=int(z["refs"][i]),
                loop_path=loop_path, loop_edges=edges))
        return PoseFeed(msgs)

    # ------------------------------------------------------------------
    @staticmethod
    def from_tum(path: str, keyframe_every: int = 1) -> "PoseFeed":
        """TUM trajectory -> feed with keyframe-every-N policy, no loops."""
        msgs: List[PoseMessage] = []
        kf_count = 0
        last_ref = 0
        with open(path) as f:
            for line_no, line in enumerate(f):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(v) for v in line.split()]
                stamp, tx, ty, tz, qx, qy, qz, qw = vals[:8]
                pose = geometry.pose_matrix((qw, qx, qy, qz), (tx, ty, tz))
                iskf = (len(msgs) % keyframe_every == 0)
                if iskf:
                    last_ref = kf_count
                    kf_count += 1
                msgs.append(PoseMessage(
                    stamp=stamp, pose=pose, is_keyframe=iskf,
                    reference_index=last_ref, loop_path=None, loop_edges=[]))
        return PoseFeed(msgs)

    @staticmethod
    def from_poses(poses: Sequence[np.ndarray],
                   stamps: Optional[Sequence[float]] = None,
                   keyframe_every: int = 1) -> "PoseFeed":
        msgs = []
        kf_count = 0
        last_ref = 0
        for i, pose in enumerate(poses):
            iskf = (i % keyframe_every == 0)
            if iskf:
                last_ref = kf_count
                kf_count += 1
            msgs.append(PoseMessage(
                stamp=float(stamps[i]) if stamps is not None else float(i),
                pose=np.asarray(pose, np.float64), is_keyframe=iskf,
                reference_index=last_ref, loop_path=None, loop_edges=[]))
        return PoseFeed(msgs)
