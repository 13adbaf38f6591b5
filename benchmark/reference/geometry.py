"""Batched camera/SE3 geometry primitives on tensors, plus the host-side
numpy pose helpers.

Mirrors the math of the reference's scalar helpers — `project`/`back_project`
(`fusion_functions.cpp:85-97`) — as batched tensor ops; counterpart of the
JAX package's `core/geometry.py`.  Matmuls are full f32: the package turns
TF32 off at import.
"""

from __future__ import annotations

import numpy as np
import torch


def project(points_c: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) (u, v).

    u = x*fx/z + cx ; v = y*fy/z + cy (`fusion_functions.cpp:85-89`).
    """
    x, y, z = points_c[..., 0], points_c[..., 1], points_c[..., 2]
    u = x * fx / z + cx
    v = y * fy / z + cy
    return torch.stack([u, v], dim=-1)


def back_project(u: torch.Tensor, v: torch.Tensor, depth: torch.Tensor,
                 fx, fy, cx, cy) -> torch.Tensor:
    """Pixel coords + metric depth -> camera-frame points (..., 3)
    (`fusion_functions.cpp:91-97`)."""
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def back_project_grid(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Back-project a full (H, W) depth image -> (H, W, 3) camera points
    (the reference's per-pixel `calculate_spaces_kernel`,
    `fusion_functions.cpp:644-662`)."""
    h, w = depth.shape
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    return back_project(u.expand(h, w), v.expand(h, w), depth,
                        fx, fy, cx, cy)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform to (..., 3) points
    (`warp_active_surfels_cpu_kernel`, `surfel_map.cpp:761-774`)."""
    return torch.matmul(points, T[:3, :3].T) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation block of a 4x4 transform to (..., 3) vectors."""
    return torch.matmul(vecs, T[:3, :3].T)


def transform_points_batched(Ts: torch.Tensor, points: torch.Tensor,
                             index: torch.Tensor) -> torch.Tensor:
    """Per-point transforms: Ts (P,4,4), points (N,3), index (N,) in [0,P)
    (the reference's per-pose inactive-surfel warp, `surfel_map.cpp:681-748`)."""
    R = Ts[index, :3, :3]            # (N, 3, 3)
    t = Ts[index, :3, 3]             # (N, 3)
    return torch.einsum("nij,nj->ni", R, points) + t


def rotate_vectors_batched(Ts: torch.Tensor, vecs: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
    R = Ts[index, :3, :3]
    return torch.einsum("nij,nj->ni", R, vecs)


def pose_matrix(quat_wxyz, position) -> np.ndarray:
    """(w,x,y,z) quaternion + translation -> 4x4 matrix (host-side, numpy).

    Equivalent of `SurfelMap::pose_ros2eigen` (`surfel_map.cpp:367-379`).
    """
    w, x, y, z = [float(v) for v in quat_wxyz]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(position, dtype=np.float64)
    return T


def matrix_to_quat_pos(T: np.ndarray):
    """4x4 -> ((w,x,y,z), (px,py,pz)) (host-side numpy).

    Equivalent of `SurfelMap::pose_eigen2ros` (`surfel_map.cpp:381-391`).
    """
    R = np.asarray(T, dtype=np.float64)[:3, :3]
    t = np.asarray(T, dtype=np.float64)[:3, 3]
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return (w, x, y, z), tuple(t)


def invert_se3(T: np.ndarray) -> np.ndarray:
    """Closed-form SE3 inverse (host-side numpy)."""
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


# KITTI axis-alignment: the reference rotates the whole trajectory so the
# first camera pose maps to an "idea pose" with z-up (`surfel_map.cpp:214-232`).
KITTI_IDEA_POSE = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float64)


def kitti_alignment(first_pose: np.ndarray) -> np.ndarray:
    """transform_kitti = idea_pose * T0^-1 (`surfel_map.cpp:220-227`)."""
    return KITTI_IDEA_POSE @ invert_se3(first_pose)
