"""TUM RGB-D dataset loader.

The natural dataset for the RGBD fusion profile (`config.RGBD_PROFILE`,
mirroring the reference's commented RGBD #define set,
`fusion_functions.h:18-21`; consumed upstream via ros_rgbd.cc feeds).

TUM layout: rgb/<stamp>.png + depth/<stamp>.png (16-bit, metric = value /
5000), listed by rgb.txt / depth.txt, ground truth in groundtruth.txt
(TUM trajectory format).  RGB and depth streams are asynchronous; frames
are associated by nearest stamp within a tolerance, poses interpolated
from the trajectory (nearest neighbor within tolerance).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core import geometry
from . import png

DEPTH_SCALE = 5000.0   # TUM 16-bit PNG depth units per meter


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            stamp, rel = line.split()[:2]
            out.append((float(stamp), rel))
    return out


def _imread(path: str) -> np.ndarray:
    """A PNG as stored (16-bit depth stays 16-bit): cv2, else PIL, else the
    numpy reader of io/png.py."""
    try:
        import cv2
        img = cv2.imread(path, -1)
        if img is None:
            raise IOError(path)
        return img
    except ImportError:
        pass
    try:
        from PIL import Image
    except ImportError:
        return png.read_png(path)
    return np.asarray(Image.open(path))


def associate(a: List[Tuple[float, str]], b: List[Tuple[float, str]],
              tolerance: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-stamp association of two sorted stamp lists
    (the standard TUM associate.py behavior)."""
    pairs = []
    j = 0
    used = set()
    for i, (ta, _) in enumerate(a):
        while j + 1 < len(b) and abs(b[j + 1][0] - ta) <= abs(b[j][0] - ta):
            j += 1
        if j < len(b) and abs(b[j][0] - ta) <= tolerance and j not in used:
            pairs.append((i, j))
            used.add(j)
    return pairs


@dataclasses.dataclass
class TumFrame:
    stamp: float
    image: np.ndarray             # (H, W) f32 intensity
    depth: np.ndarray             # (H, W) f32 metric, 0 invalid
    pose: Optional[np.ndarray]    # 4x4 Twc if ground truth available


class TumSequence:
    """Iterate associated (gray, depth, pose) frames of a TUM RGB-D dir."""

    def __init__(self, root: str, max_frames: Optional[int] = None,
                 tolerance: float = 0.02):
        self.root = root
        self.max_frames = max_frames
        self.rgb = _read_list(os.path.join(root, "rgb.txt"))
        self.depth = _read_list(os.path.join(root, "depth.txt"))
        self.pairs = associate(self.rgb, self.depth, tolerance)
        self.traj: List[Tuple[float, np.ndarray]] = []
        gt = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt):
            with open(gt) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    v = [float(x) for x in line.split()]
                    self.traj.append((v[0], geometry.pose_matrix(
                        (v[7], v[4], v[5], v[6]), (v[1], v[2], v[3]))))
        self.tolerance = tolerance

    def _pose_at(self, stamp: float) -> Optional[np.ndarray]:
        if not self.traj:
            return None
        stamps = np.array([t for t, _ in self.traj])
        k = int(np.argmin(np.abs(stamps - stamp)))
        if abs(stamps[k] - stamp) > 0.1:
            return None
        return self.traj[k][1]

    def __iter__(self) -> Iterator[TumFrame]:
        n = 0
        for i, j in self.pairs:
            if self.max_frames is not None and n >= self.max_frames:
                return
            stamp, rgb_rel = self.rgb[i]
            _, dep_rel = self.depth[j]
            img = _imread(os.path.join(self.root, rgb_rel))
            if img.ndim == 3:
                img = img.mean(axis=-1)
            dep_raw = _imread(os.path.join(self.root, dep_rel))
            depth = dep_raw.astype(np.float32) / DEPTH_SCALE
            depth = np.where(dep_raw > 0, depth, 0.0).astype(np.float32)
            yield TumFrame(stamp=stamp, image=img.astype(np.float32),
                           depth=depth, pose=self._pose_at(stamp))
            n += 1
