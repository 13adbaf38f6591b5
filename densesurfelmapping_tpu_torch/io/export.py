"""Map export: PCD point clouds and hexagon-tessellated PLY surfel meshes.

Mirrors `SurfelMap::save_cloud` (`surfel_map.cpp:1153-1174`) and
`save_mesh`/`push_a_surfel` (`surfel_map.cpp:1176-1280`): each surfel becomes
a 6-vertex hexagon in its tangent plane (x_dir = normalize((-ny, nx, 0)),
y_dir = n x x_dir, radii r/2 and r*0.86603) plus 4 triangles.

Vertex generation is vectorized numpy; serialization prefers the C++ native
writer (`native/loader.py`) and falls back to numpy text dumps.
Binary variants are ours (the reference only writes ASCII).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..native import loader as native


def hexagon_vertices(position: np.ndarray, normal: np.ndarray,
                     size: np.ndarray):
    """(N,3)x(N,3)x(N,) -> vertices (N,6,3) in reference corner order
    (`push_a_surfel`, surfel_map.cpp:1176-1216)."""
    n = np.asarray(normal, np.float64)
    p = np.asarray(position, np.float64)
    r = np.asarray(size, np.float64)
    x_dir = np.stack([-n[:, 1], n[:, 0], np.zeros(len(n))], axis=1)
    ln = np.linalg.norm(x_dir, axis=1, keepdims=True)
    # degenerate case (normal along z): reference normalizes a zero vector
    # producing NaN; we pick +x deterministically
    x_dir = np.where(ln > 1e-12, x_dir / np.maximum(ln, 1e-12),
                     np.array([1.0, 0.0, 0.0]))
    y_dir = np.cross(n, x_dir)
    h_r = (r * 0.5)[:, None]
    t_r = (r * 0.86603)[:, None]
    rr = r[:, None]
    verts = np.stack([
        p - x_dir * h_r - y_dir * t_r,
        p + x_dir * h_r - y_dir * t_r,
        p - x_dir * rr,
        p + x_dir * rr,
        p - x_dir * h_r + y_dir * t_r,
        p + x_dir * h_r + y_dir * t_r,
    ], axis=1)
    return verts


# per-surfel triangle fan (4 faces; surfel_map.cpp:1265-1278)
HEX_FACES = np.array([[0, 1, 2], [1, 3, 2], [2, 3, 4], [4, 3, 5]], np.int64)


def save_mesh_ply(path: str, surfels: Dict[str, np.ndarray],
                  binary: bool = False) -> int:
    """Write the hexagon mesh; returns surfel count."""
    pos = surfels["position"]
    n_surfels = len(pos)
    if n_surfels == 0:
        verts = np.zeros((0, 3), np.float32)
        colors = np.zeros((0,), np.uint8)
        faces = np.zeros((0, 3), np.int64)
    else:
        verts = hexagon_vertices(pos, surfels["normal"],
                                 surfels["size"]).reshape(-1, 3)
        colors = np.repeat(
            np.clip(surfels["color"], 0, 255).astype(np.uint8), 6)
        faces = (HEX_FACES[None, :, :]
                 + 6 * np.arange(n_surfels, dtype=np.int64)[:, None, None]
                 ).reshape(-1, 3)
    if native.available():
        native.write_ply_mesh(path, verts.astype(np.float32), colors, faces,
                              binary)
    else:
        _write_ply_python(path, verts, colors, faces, binary)
    return n_surfels


def _write_ply_python(path, verts, colors, faces, binary):
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary
           else "format ascii 1.0\n")
        + f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_index\nend_header\n")
    if binary:
        vert_dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
        vbuf = np.zeros(len(verts), vert_dt)
        vbuf["xyz"] = verts.astype(np.float32)
        vbuf["rgb"] = np.repeat(colors[:, None], 3, axis=1)
        face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        fbuf = np.zeros(len(faces), face_dt)
        fbuf["n"] = 3
        fbuf["idx"] = faces.astype(np.int32)
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(vbuf.tobytes())
            f.write(fbuf.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for v, c in zip(verts, colors):
                f.write(f"{v[0]:g} {v[1]:g} {v[2]:g} {c} {c} {c}\n")
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def save_cloud_pcd(path: str, surfels: Dict[str, np.ndarray],
                   binary: bool = True) -> int:
    """x/y/z/intensity PCD (save_cloud, surfel_map.cpp:1153-1174)."""
    pos = np.asarray(surfels["position"], np.float32)
    intensity = np.asarray(surfels["color"], np.float32)
    n = len(pos)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
        "TYPE F F F F\nCOUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n")
    data = np.concatenate([pos, intensity[:, None]], axis=1)
    if native.available():
        native.write_pcd(path, data, binary)
    elif binary:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(data.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            np.savetxt(f, data, fmt="%g")
    return n


def load_ply_vertices(path: str) -> np.ndarray:
    """Minimal PLY reader (test/verification helper)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = int(next(l for l in header
                           if l.startswith("element vertex")).split()[-1])
        binary = any("binary" in l for l in header)
        if binary:
            dt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            buf = np.frombuffer(f.read(n_verts * dt.itemsize), dt)
            return buf["xyz"].copy()
        rows = [f.readline().decode().split()[:3] for _ in range(n_verts)]
        return np.array(rows, np.float64)


def save_trajectory_kitti(path: str, poses, stamps=None) -> int:
    """KITTI odometry trajectory format: one 3x4 row-major Twc per line.

    `poses` is a sequence of 4x4 Twc (the driver's loop-corrected keyframe
    path — the data the reference publishes continuously on /loop_path,
    `ros_stereo.cc:214-257`); written so standard external eval tooling
    (evo, kitti-devkit) consumes the rebuilt map's trajectory directly."""
    import numpy as np

    with open(path, "w") as f:
        for p in poses:
            row = np.asarray(p, np.float64)[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
    return len(poses)


def save_trajectory_tum(path: str, poses, stamps) -> int:
    """TUM trajectory format: `stamp tx ty tz qx qy qz qw` per line
    (the rgbd-benchmark-tools / evo input convention)."""
    import numpy as np

    def quat_wxyz(R):
        # Shepperd's method: numerically stable for every rotation sign
        t = np.trace(R)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                             (R[0, 2] - R[2, 0]) / s,
                             (R[1, 0] - R[0, 1]) / s])
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        return q

    with open(path, "w") as f:
        for stamp, p in zip(stamps, poses):
            p = np.asarray(p, np.float64)
            w, x, y, z = quat_wxyz(p[:3, :3])
            tx, ty, tz = p[:3, 3]
            f.write(f"{stamp:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n")
    return len(poses)
