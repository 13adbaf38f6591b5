"""Visualization: camera frustum/pose-graph geometry + debug renders.

ROS-free equivalent of the reference's rviz surface:

* `CameraPoseVisualization` frustum MarkerArray
  (`surfel_fusion/src/CameraPoseVisualization.{h,cpp}`, h:10-43) ->
  `camera_frustum_lines` + `save_lineset_ply` (CloudCompare/MeshLab-readable
  PLY line sets instead of rviz markers).
* pose-graph topics `fusion_loop_path` / `driftfree_loop_path` /
  `loop_marker` (`surfel_map.cpp:56-63`) -> `pose_graph_lines`.
* the superpixel/normal debug window `debug_show`
  (`fusion_functions.cpp:977-1006`, call commented out in the reference) ->
  `render_segmentation` + a dependency-free `save_png`.

Everything here is host-side numpy on data already pulled from the device;
none of it sits on the hot path.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .config import CameraIntrinsics, SurfelMapConfig


# ----------------------------------------------------------------------
# line-set geometry (rviz marker replacement)
# ----------------------------------------------------------------------
def camera_frustum_lines(pose: np.ndarray, camera: CameraIntrinsics,
                         scale: float = 1.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Frustum wireframe of a camera at 4x4 Twc `pose`.

    Returns (verts (5,3) f32, edges (8,2) i32): apex + 4 image-plane
    corners at depth `scale`, like the marker pyramid of
    `CameraPoseVisualization::add_pose`."""
    cam = camera
    corners_px = np.array([[0.0, 0.0], [cam.width, 0.0],
                           [cam.width, cam.height], [0.0, cam.height]])
    rays = np.stack([(corners_px[:, 0] - cam.cx) / cam.fx,
                     (corners_px[:, 1] - cam.cy) / cam.fy,
                     np.ones(4)], axis=-1) * scale
    verts_c = np.concatenate([np.zeros((1, 3)), rays])          # apex + 4
    R, t = pose[:3, :3], pose[:3, 3]
    verts = (verts_c @ R.T + t).astype(np.float32)
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]], np.int32)
    return verts, edges


def pose_graph_lines(keyframe_poses: Sequence[np.ndarray],
                     loop_edges: Iterable[Tuple[int, int]] = ()
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pose-graph geometry: keyframe positions, consecutive-path edges,
    loop-closure edges (the `fusion_loop_path` + `loop_marker` content)."""
    pts = np.array([np.asarray(p)[:3, 3] for p in keyframe_poses],
                   np.float32).reshape(-1, 3)
    n = len(pts)
    path = np.array([[i, i + 1] for i in range(n - 1)], np.int32) \
        .reshape(-1, 2)
    loops = np.array([[a, b] for a, b in loop_edges
                      if 0 <= a < n and 0 <= b < n], np.int32).reshape(-1, 2)
    return pts, path, loops


def save_lineset_ply(path: str, verts: np.ndarray, edges: np.ndarray,
                     color: Tuple[int, int, int] = (255, 200, 0)) -> None:
    """ASCII PLY with vertex + edge elements (line set)."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    r, g, b = color
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {r} {g} {b}\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")


def save_camera_markers(path: str, poses: Sequence[np.ndarray],
                        camera: CameraIntrinsics, scale: float = 1.0,
                        loop_edges: Iterable[Tuple[int, int]] = ()) -> None:
    """One PLY line set with every camera frustum + the pose-graph path +
    loop edges (the full rviz camera/pose-graph display as a file)."""
    all_v: List[np.ndarray] = []
    all_e: List[np.ndarray] = []
    off = 0
    for pose in poses:
        v, e = camera_frustum_lines(np.asarray(pose), camera, scale)
        all_v.append(v)
        all_e.append(e + off)
        off += len(v)
    pts, pe, le = pose_graph_lines(poses, loop_edges)
    if len(pts):
        all_v.append(pts)
        if len(pe):
            all_e.append(pe + off)
        if len(le):
            all_e.append(le + off)
    save_lineset_ply(path, np.concatenate(all_v) if all_v else
                     np.zeros((0, 3)), np.concatenate(all_e) if all_e else
                     np.zeros((0, 2)))


# ----------------------------------------------------------------------
# debug raster renders (debug_show equivalent)
# ----------------------------------------------------------------------
def render_segmentation(config: SurfelMapConfig, image: np.ndarray,
                        assignment: np.ndarray,
                        norms: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W, 3) u8 visualization of the superpixel segmentation: intensity
    underlay, superpixel boundaries in red, optional normal-map tint
    (|n| -> RGB) — what the reference's `debug_show` drew to an OpenCV
    window (`fusion_functions.cpp:977-1006`)."""
    h, w = config.height, config.width
    img = np.asarray(image)[:h, :w]
    asg = np.asarray(assignment)[:h, :w]
    base = np.clip(img, 0, 255).astype(np.uint8)
    rgb = np.stack([base] * 3, axis=-1)

    if norms is not None:
        nm = np.asarray(norms)[:h, :w]
        tint = ((np.abs(nm) * 255).clip(0, 255)).astype(np.uint8)
        has = (np.abs(nm).sum(-1, keepdims=True) > 0)
        rgb = np.where(has, (0.5 * rgb + 0.5 * tint).astype(np.uint8), rgb)

    boundary = np.zeros((h, w), bool)
    boundary[:, 1:] |= asg[:, 1:] != asg[:, :-1]
    boundary[1:, :] |= asg[1:, :] != asg[:-1, :]
    rgb[boundary] = (255, 64, 64)
    return rgb


def depth_colormap(depth: np.ndarray, max_depth: float = 30.0) -> np.ndarray:
    """(H, W, 3) u8 turbo-ish colormap; invalid depth (<=0) black."""
    d = np.asarray(depth, np.float32)
    t = np.clip(d / max_depth, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    rgb = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    rgb[d <= 0] = 0
    return rgb


def save_png(path: str, rgb: np.ndarray) -> None:
    """Minimal dependency-free PNG writer (8-bit RGB)."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
