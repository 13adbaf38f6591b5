"""KITTI odometry loader.

Reimplements the reference's data path (`kitti_publisher/scripts/publisher.py`
:30-64): gray PNG pairs from image_0/image_1 plus precomputed PSMNet
disparity .npy in depth_0/, converted to metric depth with depth = bf / disp
(bf = 386.1448 for seqs 00-02, 379.8145 for 04-12), streamed at a nominal
rate with monotonically increasing stamps.

Also reads KITTI ground-truth pose files (poses/NN.txt: 12 floats per line,
row-major 3x4 Twc) as a SLAM-free pose source for benchmarks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from . import png

# stereo baseline*focal per sequence group (publisher.py:40-41)
BF_SEQ_00_02 = 386.1448
BF_SEQ_04_12 = 379.8145


def bf_for_sequence(seq: int) -> float:
    return BF_SEQ_00_02 if seq <= 2 else BF_SEQ_04_12


def _imread_gray(path: str) -> np.ndarray:
    """u8 gray of a PNG: cv2, else PIL, else the numpy reader of io/png.py
    (RGB to luma as PIL's convert("L") does)."""
    try:
        import cv2
        img = cv2.imread(path, 0)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        return png.gray_u8(png.read_png(path))
    return np.asarray(Image.open(path).convert("L"))


@dataclasses.dataclass
class KittiFrame:
    index: int
    stamp: float
    image: np.ndarray      # (H, W) u8 intensity (left)
    depth: np.ndarray      # (H, W) f32 metric, 0 invalid
    pose: Optional[np.ndarray]  # 4x4 Twc ground truth if available
    right_image: Optional[np.ndarray] = None  # (H, W) f32 (stereo mode)


class KittiSequence:
    """Iterates (image, depth, pose) for one sequence directory laid out as
    <root>/image_0/%06d.png, <root>/depth_0/%06d.npy[, <root>/poses.txt]."""

    def __init__(self, root: str, seq: int = 0, rate_hz: float = 5.0,
                 poses_file: Optional[str] = None,
                 max_frames: Optional[int] = None,
                 stereo: bool = False):
        """stereo=True: skip the precomputed depth_0/ disparity files and
        yield the raw left/right pair instead (depth all-invalid) — the
        caller computes depth on-device via models.stereo."""
        self.root = root
        self.bf = bf_for_sequence(seq)
        self.rate = rate_hz
        self.max_frames = max_frames
        self.stereo = stereo
        self.poses = None
        poses_file = poses_file or os.path.join(root, "poses.txt")
        if os.path.exists(poses_file):
            self.poses = load_kitti_poses(poses_file)

    def frame_paths(self, i: int) -> Tuple[str, str, str]:
        return (os.path.join(self.root, "image_0", f"{i:06d}.png"),
                os.path.join(self.root, "image_1", f"{i:06d}.png"),
                os.path.join(self.root, "depth_0", f"{i:06d}.npy"))

    def __iter__(self) -> Iterator[KittiFrame]:
        i = 0
        while self.max_frames is None or i < self.max_frames:
            img_path, right_path, depth_path = self.frame_paths(i)
            need = [img_path, right_path if self.stereo else depth_path]
            if not all(os.path.exists(p) for p in need):
                return
            image = _imread_gray(img_path)   # u8, fed straight through
            right = None
            if self.stereo:
                right = _imread_gray(right_path).astype(np.float32)
                depth = np.zeros_like(image)
            else:
                disparity = np.load(depth_path)
                with np.errstate(divide="ignore", invalid="ignore"):
                    depth = self.bf / disparity
                depth = np.where(np.isfinite(depth) & (depth > 0), depth, 0.0)
            pose = None
            if self.poses is not None and i < len(self.poses):
                pose = self.poses[i]
            yield KittiFrame(index=i, stamp=i / self.rate,
                             image=image, depth=depth.astype(np.float32),
                             pose=pose, right_image=right)
            i += 1


def load_kitti_poses(path: str) -> np.ndarray:
    """poses/NN.txt -> (N, 4, 4) Twc (left camera frame)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = len(rows)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = rows
    return out
