"""Map fidelity evaluation: splat the surfel map into a virtual camera and
score it against ground-truth depth.

The reference validated visually in rviz (SURVEY.md §4 — no tests, no
metrics).  This harness makes reconstruction accuracy a number: a z-buffer
point splat of the surfel map (radius-aware disk footprint) rendered at any
pose, compared against reference depth with coverage / MAE / RMSE / inlier
rates.  Used by tests (synthetic ground truth), the CLI (--eval), and the
matched-accuracy gate of BASELINE.md.

Counterpart of the JAX package's `eval/fidelity.py`: the render runs on the
driver's device as plain PyTorch (49 scatter-mins); the metrics are host
numpy copies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core import geometry

# splat footprint offsets: Euclidean disk of radius <= 4 px (evaluation-only
# op; 49 masked scatters, not a hot path).  Surfel radii are sized to cover
# their superpixel (~half the 8-px seed pitch and beyond), so a 4-px splat
# cap keeps rendered coverage faithful at typical ranges.
_MAX_SPLAT = 4
_OFFSETS = [(dy, dx) for dy in range(-_MAX_SPLAT, _MAX_SPLAT + 1)
            for dx in range(-_MAX_SPLAT, _MAX_SPLAT + 1)
            if dy * dy + dx * dx <= _MAX_SPLAT * _MAX_SPLAT]


def _render(config: SurfelMapConfig, position: torch.Tensor,
            size: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Z-buffered splat: (N,3)+(N,) -> (H, W) depth, 0 = empty."""
    cam = config.camera
    h, w = config.height, config.width
    inv = torch.linalg.inv_ex(pose).inverse         # no host sync
    p_c = geometry.transform_points(inv, position)
    z = p_c[:, 2]
    uv = geometry.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    # truncation toward zero, as astype(int32)
    u = (uv[:, 0] + 0.5).to(torch.int32)
    v = (uv[:, 1] + 0.5).to(torch.int32)
    ok = (z > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)

    # pixel footprint radius of the surfel disk
    pr = size * np.float32(cam.mean_focal) / z.clamp_min(1e-6)
    pr = pr.clamp(0.0, float(_MAX_SPLAT))

    # one spare slot takes the rejected entries (the JAX scatter drops them)
    buf = torch.full((h * w + 1,), float("inf"), dtype=torch.float32,
                     device=z.device)
    for dy, dx in _OFFSETS:
        ring = (dy * dy + dx * dx) ** 0.5
        # compared in f32, as JAX's weakly typed Python float
        m = ok & (pr + 0.5 >= ring) if ring else ok
        uu = (u + dx).clamp(0, w - 1)
        vv = (v + dy).clamp(0, h - 1)
        idx = torch.where(m, vv * w + uu, h * w)
        buf.scatter_reduce_(0, idx.long(), torch.where(m, z, float("inf")),
                            "amin")
    buf = buf[:h * w]
    return torch.where(torch.isfinite(buf), buf, 0.0).reshape(h, w)


def render_depth(config: SurfelMapConfig, surfels: Dict[str, np.ndarray],
                 pose: np.ndarray, device="cuda") -> np.ndarray:
    """Render the map (host surfel dict: position/normal/size[/...]) into
    the camera at 4x4 Twc `pose`, on `device`.  Returns (H, W) f32 depth,
    0 = no surfel."""
    pos = np.asarray(surfels["position"], np.float32).reshape(-1, 3)
    if len(pos) == 0:
        return np.zeros((config.height, config.width), np.float32)
    dev = torch.device(device)
    size = np.asarray(surfels["size"], np.float32).reshape(-1)
    out = _render(config, torch.from_numpy(pos).to(dev),
                  torch.from_numpy(np.ascontiguousarray(size)).to(dev),
                  torch.from_numpy(np.asarray(pose, np.float32)).to(dev))
    return out.cpu().numpy()


def depth_metrics(rendered: np.ndarray, gt: np.ndarray,
                  max_depth: float = 30.0) -> Dict[str, float]:
    """Coverage + error statistics over pixels where ground truth exists."""
    gt_valid = (gt > 0) & (gt <= max_depth)
    r_valid = rendered > 0
    both = gt_valid & r_valid
    n_gt = int(gt_valid.sum())
    n_both = int(both.sum())
    out = {
        "gt_pixels": float(n_gt),
        "coverage": n_both / max(n_gt, 1),
    }
    if n_both:
        err = np.abs(rendered[both] - gt[both])
        out.update(
            mae=float(err.mean()),
            rmse=float(np.sqrt((err ** 2).mean())),
            inlier_0p1m=float((err < 0.1).mean()),
            inlier_1pct=float((err < 0.01 * gt[both]).mean()),
            median=float(np.median(err)),
        )
    return out


def evaluate_map(mapping, frames, poses) -> Dict[str, float]:
    """Render the mapper's full map at each pose and average metrics
    against the given ground-truth depth frames."""
    surfels = mapping.map_surfels()
    agg: Dict[str, list] = {}
    for (img, dep), pose in zip(frames, poses):
        r = render_depth(mapping.config, surfels, pose,
                         device=mapping.device)
        m = depth_metrics(r, np.asarray(dep), mapping.config.fuse_far)
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def backproject_cloud(config: SurfelMapConfig, depth: np.ndarray,
                      pose: np.ndarray,
                      max_depth: float = 0.0) -> np.ndarray:
    """World-frame (N, 3) cloud of one ground-truth depth frame (the same
    back-projection as the raw_pointcloud debug topic)."""
    cam = config.camera
    depth = np.asarray(depth, np.float32)
    lim = max_depth or config.fuse_far
    vs, us = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
    valid = (depth > 0.01) & (depth <= lim)
    z = depth[valid]
    pts = np.stack([(us[valid] - cam.cx) / cam.fx * z,
                    (vs[valid] - cam.cy) / cam.fy * z, z], axis=1)
    T = np.asarray(pose, np.float64)
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


def cloud_metrics(map_points: np.ndarray, gt_points: np.ndarray,
                  threshold: float = 0.1,
                  sample: int = 200_000, seed: int = 0) -> Dict[str, float]:
    """Standard cloud-to-cloud reconstruction metrics (the mapping-paper
    complement to the depth-render fidelity): accuracy = map->GT nearest
    distances (is what we built correct), completeness = GT->map (did we
    build the whole scene), chamfer = mean of the two means, and
    precision/recall/F1 at `threshold` meters."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)

    def sub(a):
        a = np.asarray(a, np.float32).reshape(-1, 3)
        if len(a) > sample:
            a = a[rng.choice(len(a), sample, replace=False)]
        return a

    mp, gp = sub(map_points), sub(gt_points)
    if len(mp) == 0 or len(gp) == 0:
        return {"accuracy_mean": float("inf"),
                "completeness_mean": float("inf"), "chamfer": float("inf"),
                "precision": 0.0, "recall": 0.0, "f1": 0.0}
    d_acc = cKDTree(gp).query(mp, workers=-1)[0]
    d_comp = cKDTree(mp).query(gp, workers=-1)[0]
    precision = float((d_acc < threshold).mean())
    recall = float((d_comp < threshold).mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {
        "accuracy_mean": float(d_acc.mean()),
        "accuracy_median": float(np.median(d_acc)),
        "completeness_mean": float(d_comp.mean()),
        "completeness_median": float(np.median(d_comp)),
        "chamfer": float(0.5 * (d_acc.mean() + d_comp.mean())),
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def densify_surfels(surfels: Dict[str, np.ndarray],
                    rings=(0.45, 0.9), counts=(6, 12)) -> np.ndarray:
    """Sample the surfel DISKS as points: center + concentric rings in the
    tangent plane (x_dir = normal x z-hat, the hexagon-mesh basis of
    `save_mesh`/push_a_surfel, surfel_map.cpp:1176-1280).  The map's unit
    is a disk one superpixel wide — point metrics against a dense GT cloud
    must compare the disk footprint, not just centers ~SP_SIZE px apart."""
    pos = np.asarray(surfels["position"], np.float32).reshape(-1, 3)
    nrm = np.asarray(surfels["normal"], np.float32).reshape(-1, 3)
    rad = np.asarray(surfels["size"], np.float32).reshape(-1)
    if len(pos) == 0:
        return pos
    zhat = np.float32([0, 0, 1])
    x_dir = np.cross(nrm, zhat)
    deg = np.linalg.norm(x_dir, axis=1) < 1e-6      # normal ~ +-z
    x_dir[deg] = np.float32([1, 0, 0])
    x_dir /= np.maximum(np.linalg.norm(x_dir, axis=1, keepdims=True), 1e-9)
    y_dir = np.cross(nrm, x_dir)
    y_dir /= np.maximum(np.linalg.norm(y_dir, axis=1, keepdims=True), 1e-9)
    out = [pos]
    for frac, k in zip(rings, counts):
        ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
        for a in ang:
            r = (frac * rad)[:, None]
            out.append(pos + r * (np.cos(a) * x_dir + np.sin(a) * y_dir))
    return np.concatenate(out).astype(np.float32)


def evaluate_map_clouds(mapping, frames, poses,
                        threshold: float = 0.1) -> Dict[str, float]:
    """Cloud metrics of the mapper's full map (disk-densified — see
    densify_surfels) against the GT cloud aggregated from the given depth
    frames (each back-projected at its pose)."""
    surfels = mapping.map_surfels()
    gt = [backproject_cloud(mapping.config, dep, pose)
          for (_, dep), pose in zip(frames, poses)]
    gt = np.concatenate(gt) if gt else np.zeros((0, 3), np.float32)
    return cloud_metrics(densify_surfels(surfels), gt, threshold=threshold)
