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
