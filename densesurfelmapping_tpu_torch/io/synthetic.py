"""Procedural test scenes: deterministic depth+intensity renderers.

The reference has no fixtures at all (SURVEY.md §4) — validation was rviz
eyeballing.  This module is the framework's test/bench data source: a simple
ray-cast world (ground plane + axis-aligned boxes + back wall) rendered from
arbitrary camera poses, giving exactly reproducible sequences with known
geometry for fidelity checks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import SurfelMapConfig


@dataclasses.dataclass
class Box:
    lo: np.ndarray  # (3,)
    hi: np.ndarray  # (3,)


@dataclasses.dataclass
class MovingBox:
    """A box translating linearly with time (world units per frame) — the
    moving-object stressor: surfels fused on it while it is somewhere
    become wrong once it leaves, and the staleness/occlusion kills
    (`ops/fusion.py`, mirroring `fusion_functions.cpp:207-211`) must
    reclaim them for the map to converge to the static world."""

    box: Box
    velocity: np.ndarray  # (3,) per unit time

    def at(self, time: float) -> Box:
        d = self.velocity * time
        return Box(lo=self.box.lo + d, hi=self.box.hi + d)


@dataclasses.dataclass
class Scene:
    """World: ground plane y = ground_y (+y down, camera convention),
    optional far wall z = wall_z, boxes, optional moving boxes."""

    ground_y: float = 1.5
    wall_z: Optional[float] = 60.0
    boxes: List[Box] = dataclasses.field(default_factory=list)
    max_depth: float = 29.0
    intensity_freq: Tuple[float, float] = (0.23, 0.31)
    texture: str = "default"   # "default" | "multisine" (aperiodic; for
    #                            stereo-matching tests where the periodic
    #                            default texture would be ambiguous)
    movers: List[MovingBox] = dataclasses.field(default_factory=list)

    def render(self, config: SurfelMapConfig, pose: np.ndarray,
               depth_noise: float = 0.0, seed: int = 0,
               time: float = 0.0, include_movers: bool = True):
        """Ray-cast depth + procedural world-texture intensity from a 4x4
        camera-to-world pose. Returns (image f32 HxW, depth f32 HxW).

        `time` positions the movers; `include_movers=False` renders the
        static world only (the ground truth a converged map should match
        after transient objects leave)."""
        cam = config.camera
        h, w = config.height, config.width
        yy, xx = np.mgrid[0:h, 0:w]
        dirs = np.stack([(xx - cam.cx) / cam.fx,
                         (yy - cam.cy) / cam.fy,
                         np.ones((h, w))], axis=-1)  # camera-frame rays, z=1
        R = pose[:3, :3]
        t = pose[:3, 3]
        rays = dirs @ R.T                        # world-frame directions
        org = t[None, None, :]

        zdepth = np.full((h, w), np.inf)

        def consider(t_hit):
            """t_hit is the CAMERA-frame z (ray param since dir_z_cam == 1)."""
            nonlocal zdepth
            good = (t_hit > 0.05) & (t_hit < zdepth)
            zdepth = np.where(good, t_hit, zdepth)

        # ground plane: org_y + t*dir_y = ground_y
        dy = rays[..., 1]
        t_g = np.where(np.abs(dy) > 1e-9, (self.ground_y - t[1]) / dy, np.inf)
        consider(np.where(t_g > 0, t_g, np.inf))

        if self.wall_z is not None:
            dz = rays[..., 2]
            t_w = np.where(np.abs(dz) > 1e-9, (self.wall_z - t[2]) / dz,
                           np.inf)
            consider(np.where(t_w > 0, t_w, np.inf))

        for box in self.boxes:
            t_hit = _ray_box(org, rays, box.lo, box.hi)
            consider(t_hit)

        if include_movers:
            for mover in self.movers:
                b = mover.at(time)
                consider(_ray_box(org, rays, b.lo, b.hi))

        depth = np.where(np.isfinite(zdepth) & (zdepth < self.max_depth),
                         zdepth, 0.0)

        # world-anchored texture so intensity is view-consistent
        safe_z = np.where(np.isfinite(zdepth), zdepth, 0.0)
        pts = org + rays * safe_z[..., None]
        X, Y, Z = pts[..., 0], pts[..., 1], pts[..., 2]
        if self.texture == "multisine":
            # incommensurate frequencies -> locally unique appearance
            tex = 128 + 36 * (np.sin(1.7 * X + 0.3) * np.sin(2.9 * Z + 1.1)
                              + np.sin(5.3 * X + 4.1) * np.sin(0.73 * Z)
                              + np.sin(3.1 * X + 1.9 * Z)
                              + 0.7 * np.sin(8.9 * X - 3.7 * Z + 2.0)) / 1.6 \
                + 18 * np.sin(4.3 * Y + 0.7)
        else:
            fx_, fy_ = self.intensity_freq
            tex = 128 + 55 * np.sin(X * 7 * fx_) * np.cos(Z * 9 * fy_) \
                + 30 * np.sin(Y * 5)
        image = np.floor(np.where(depth > 0, tex, 20.0)).clip(0, 255)

        if depth_noise:
            rng = np.random.default_rng(seed)
            depth = np.where(depth > 0,
                             depth + rng.normal(0, depth_noise, (h, w)), 0.0)
        return image.astype(np.float32), depth.astype(np.float32)


def _ray_box(org, rays, lo, hi):
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / rays
        t0 = (lo[None, None] - org) * inv
        t1 = (hi[None, None] - org) * inv
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmax >= np.maximum(tmin, 0))
    return np.where(hit, np.where(tmin > 0, tmin, np.inf), np.inf)


@dataclasses.dataclass(frozen=True)
class DirtModel:
    """Real-data statistics layered over the clean renderer (VERDICT r3
    item 5): the clean scenes are benign — no sensor noise, no exposure
    drift, no depth outliers — so nothing stresses the fusion outlier
    gates the way real KITTI depth does.  The reference's drive-profile
    constants exist precisely because real depth is dirty
    (`fusion_functions.h:13-16`: BASELINE 0.5, DISPARITY_ERROR 4.0,
    MIN_TOLERATE_DIFF 0.1 — a disparity-domain error model); this model
    injects matching defects deterministically:

    * photometric: per-pixel Gaussian sensor noise + a slow sinusoidal
      exposure (gain/bias) drift, with an extra gain mismatch on the
      right camera (stereo rigs never match exactly; census is supposed
      to shrug this off, SAD is not);
    * depth: Gaussian noise applied in DISPARITY space (error grows
      quadratically with depth, like real triangulation), plus periodic
      OUTLIER BURSTS — blobs of grossly wrong depth on every Nth frame,
      the flying-pixel/mismatch clusters stereo front-ends emit — plus
      random dropout (invalid pixels).

    Everything derives from (seed, frame_index), so dirty runs are as
    reproducible as clean ones."""

    photometric_sigma: float = 2.0     # intensity units (0..255 scale)
    exposure_amp: float = 0.12         # multiplicative gain amplitude
    exposure_period: float = 60.0      # frames per gain cycle
    exposure_bias: float = 6.0         # additive offset amplitude
    lr_gain_mismatch: float = 0.03     # extra gain error, right image only
    disparity_sigma: float = 0.5       # px 1-sigma (gate assumes max 4.0)
    outlier_burst_every: int = 7       # every Nth frame carries blobs
    outlier_blobs: int = 10            # blobs per burst frame
    outlier_blob_radius: int = 8       # px
    outlier_scale: Tuple[float, float] = (0.35, 2.5)  # depth multiplier
    dropout_rate: float = 0.02         # fraction of valid pixels zeroed
    seed: int = 0


def apply_dirt(image: np.ndarray, depth: Optional[np.ndarray],
               frame_index: int, dirt: DirtModel, bf: float,
               right: bool = False):
    """Return (dirty_image, dirty_depth) for one frame; `depth` may be
    None (stereo feeds, where only images enter the pipeline).  `bf` is
    the stereo baseline*focal product that converts depth to disparity
    for the noise model (`publisher.py:40` contract)."""
    h, w = image.shape
    rng = np.random.default_rng(
        np.uint32((dirt.seed * 1_000_003 + frame_index) * 2 + int(right)))
    phase = 2.0 * np.pi * frame_index / max(dirt.exposure_period, 1e-9)
    gain = 1.0 + dirt.exposure_amp * np.sin(phase)
    if right:
        gain *= 1.0 + dirt.lr_gain_mismatch * np.sin(0.7 * phase + 1.3)
    bias = dirt.exposure_bias * np.sin(0.5 * phase + 0.4)
    img = gain * image + bias
    if dirt.photometric_sigma > 0:
        img = img + rng.normal(0.0, dirt.photometric_sigma, (h, w))
    img = np.clip(img, 0.0, 255.0).astype(np.float32)

    if depth is None:
        return img, None
    dep = np.asarray(depth, np.float32)
    valid = dep > 0
    if dirt.disparity_sigma > 0:
        disp = np.where(valid, bf / np.maximum(dep, 1e-6), 0.0)
        disp = disp + rng.normal(0.0, dirt.disparity_sigma, (h, w))
        dep = np.where(valid & (disp > 0.1), bf / np.maximum(disp, 0.1), 0.0)
    if dirt.outlier_burst_every and \
            frame_index % dirt.outlier_burst_every == 0:
        r = dirt.outlier_blob_radius
        for _ in range(dirt.outlier_blobs):
            cy = int(rng.integers(0, h))
            cx = int(rng.integers(0, w))
            scale = float(rng.uniform(*dirt.outlier_scale))
            y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
            x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
            blob = dep[y0:y1, x0:x1]
            dep[y0:y1, x0:x1] = np.where(blob > 0, blob * scale, blob)
    if dirt.dropout_rate > 0:
        drop = rng.random((h, w)) < dirt.dropout_rate
        dep = np.where(drop, 0.0, dep)
    return img, dep.astype(np.float32)


def default_scene() -> Scene:
    return Scene(ground_y=1.5, wall_z=60.0, boxes=[
        Box(lo=np.array([-4.0, -0.5, 12.0]), hi=np.array([-2.0, 1.5, 14.0])),
        Box(lo=np.array([2.0, 0.0, 20.0]), hi=np.array([5.0, 1.5, 23.0])),
        Box(lo=np.array([-1.0, -1.0, 35.0]), hi=np.array([1.0, 1.5, 38.0])),
    ])


def forward_trajectory(n_frames: int, step: float = 0.5,
                       yaw_rate: float = 0.0) -> List[np.ndarray]:
    """Simple dead-ahead (optionally curving) camera trajectory."""
    poses = []
    pose = np.eye(4)
    yaw = 0.0
    for _ in range(n_frames):
        poses.append(pose.copy())
        yaw += yaw_rate
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                      [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        fwd = R @ np.array([0.0, 0.0, step])
        pose = pose.copy()
        pose[:3, :3] = R
        pose[:3, 3] = pose[:3, 3] + fwd
    return poses


def loop_trajectory(n_frames: int, radius: float = 8.0) -> List[np.ndarray]:
    """Closed circular trajectory (revisits the start: loop-closure tests)."""
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        R = np.array([[np.cos(a), 0, np.sin(a)],
                      [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([radius * (1 - np.cos(a)), 0.0, radius * np.sin(a)])
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = t
        poses.append(pose)
    return poses
