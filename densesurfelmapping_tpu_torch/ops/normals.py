"""Geometry engine: space map, pixel normals, robust per-seed plane fit.

Counterpart of the JAX package's `ops/normals.py` (the reference's
`calculate_norms`, `fusion_functions.cpp:916-958`):

* `calculate_spaces_kernel` (:644-662)       -> one back-projected grid
* `calculate_pixels_norms_kernel` (:664-712) -> shifted-slice cross products
* `calculate_sp_depth_norms_kernel` (:792-914) + `get_huber_norm` (:104-188)
  -> masked window reductions + a batched 5-iteration Huber Gauss-Newton
     with a closed-form 4x4 solve.

The reference accumulates the normal equations in float64; this runs float32
with the same +5*I damping.  `seed_plane_fields` is the plain twin of the
plane-fit CUDA kernel (`ops/cuda/planefit.py`, `csrc/planefit.cu`), which
`compute_seed_planes` launches on a CUDA tensor.
"""

from __future__ import annotations

import torch

from ..config import SurfelMapConfig
from ..core import geometry
from ..core.state import SuperpixelState
from . import windows as W
from .superpixel import device_geometry


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False):
    return torch.sqrt((v * v).sum(dim=dim, keepdim=keepdim))


def space_map(config: SurfelMapConfig, depth: torch.Tensor,
              geom=None) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame points (z==depth, no gating),
    mirroring `calculate_spaces_kernel` (`fusion_functions.cpp:644-662`).

    geom: a column slab's geometry (`parallel/frame_sharding.py`), whose
    GLOBAL pixel coordinate planes keep the back-projection that of the
    full frame."""
    cam = config.camera
    if geom is not None:
        return geometry.back_project(geom["px_x"], geom["px_y"], depth,
                                     cam.fx, cam.fy, cam.cx, cam.cy)
    return geometry.back_project_grid(depth, cam.fx, cam.fy, cam.cx, cam.cy)


def pixel_normals(config: SurfelMapConfig, space: torch.Tensor,
                  geom=None) -> torch.Tensor:
    """Right x down cross-product normals with a view-angle gate
    (`calculate_pixels_norms_kernel`, `fusion_functions.cpp:664-712`).

    Interior pixels only (rows/cols 1..orig-2); zero elsewhere and wherever
    any of {self, right, down} has z < 0.1 or |view angle| < MAX_ANGLE_COS.
    """
    h, w, _ = space.shape
    me = space
    right = torch.nn.functional.pad(space[:, 1:], (0, 0, 0, 1))
    down = torch.nn.functional.pad(space[1:], (0, 0, 0, 0, 0, 1))

    dz_ok = (me[..., 2] >= 0.1) & (right[..., 2] >= 0.1) \
        & (down[..., 2] >= 0.1)

    n = torch.linalg.cross(right - me, down - me, dim=-1)
    n = n / _norm(n, keepdim=True).clamp_min(1e-20)

    view = (n * me).sum(dim=-1) / _norm(me).clamp_min(1e-20)
    angle_ok = view.abs() >= config.max_angle_cos

    if geom is not None:
        row = geom["px_y"].to(torch.int32)
        col = geom["px_x"].to(torch.int32)
    else:
        row = torch.arange(h, device=space.device)[:, None]
        col = torch.arange(w, device=space.device)[None, :]
    interior = ((row >= 1) & (row < config.height - 1)
                & (col >= 1) & (col < config.width - 1))

    keep = (dz_ok & angle_ok & interior)[..., None]
    return torch.where(keep, n, 0.0)


def _solve4(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 solve by cofactor (adjugate) expansion, elementwise math
    (what Eigen's Matrix4d::inverse() uses in the reference,
    fusion_functions.cpp:176).  H: (..., 4, 4), b: (..., 4)."""
    m = [[H[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (m[r0][c0] * (m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1])
                - m[r0][c1] * (m[r1][c0] * m[r2][c2] - m[r1][c2] * m[r2][c0])
                + m[r0][c2] * (m[r1][c0] * m[r2][c1] - m[r1][c1] * m[r2][c0]))

    rows = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            minor = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            cof[i][j] = minor if (i + j) % 2 == 0 else -minor
    det = (m[0][0] * cof[0][0] + m[0][1] * cof[0][1]
           + m[0][2] * cof[0][2] + m[0][3] * cof[0][3])
    inv_det = 1.0 / det
    # x = H^-1 b ; (H^-1)_{ij} = cof[j][i] * inv_det (adjugate transpose)
    x = [(cof[0][i] * b[..., 0] + cof[1][i] * b[..., 1]
          + cof[2][i] * b[..., 2] + cof[3][i] * b[..., 3]) * inv_det
         for i in range(4)]
    return torch.stack(x, dim=-1)


def _huber_gauss_newton(points: torch.Tensor, mask: torch.Tensor,
                        n0: torch.Tensor, huber_range: float):
    """Batched `get_huber_norm` (`fusion_functions.cpp:104-188`).

    points: (S, K, 3) camera-frame inlier positions, mask: (S, K) validity,
    n0: (S, 3) initial unit normal (nb starts at 0).  Returns (S, 4) unit
    plane [nx, ny, nz, nb] with n.p + nb = 0 for on-plane points.
    """
    hr = huber_range
    cnt = mask.sum(dim=-1, keepdim=True).float().clamp_min(1.0)
    mean = torch.where(mask[..., None], points, 0.0).sum(dim=1) / cnt
    centered = points - mean[:, None, :]

    # the normal equations as elementwise products + K-axis sums (the form
    # of the JAX package; only the K-sum order is free)
    Ai = [torch.where(mask, centered[..., i], 0.0) for i in range(3)]
    Ai.append(mask.float())                                     # 4 x (S, K)
    n = torch.cat([n0, torch.zeros_like(n0[:, :1])], dim=-1)
    eye5 = 5.0 * torch.eye(4, dtype=torch.float32, device=points.device)
    for _ in range(5):
        r = Ai[0] * n[:, 0:1]
        for i in range(1, 4):
            r = r + Ai[i] * n[:, i:i + 1]                       # (S, K)
        inl = (r < hr) & (r > -hr) & mask
        jw = torch.where(inl, 2.0 * r,
                         torch.where(r >= hr, hr,
                                     torch.where(r <= -hr, -hr, 0.0)))
        jw = torch.where(mask, jw, 0.0)
        jac = torch.stack([(Ai[i] * jw).sum(dim=-1)
                           for i in range(4)], dim=-1)          # (S, 4)
        hw = torch.where(inl, 2.0, 0.0)
        hess_ij = [[None] * 4 for _ in range(4)]
        for i in range(4):
            hwi = hw * Ai[i]
            for j in range(i, 4):
                hess_ij[i][j] = hess_ij[j][i] = (hwi * Ai[j]).sum(dim=-1)
        hess = torch.stack([torch.stack(row, dim=-1)
                            for row in hess_ij], dim=-2) + eye5  # (S, 4, 4)
        n = n - _solve4(hess, jac)

    # uncenter: nb -= n . mean, then normalize the full 4-vector by |n_xyz|
    nb = n[:, 3] - (n[:, :3] * mean).sum(dim=-1)
    safe = _norm(n[:, :3]).clamp_min(1e-20)
    return torch.cat([n[:, :3] / safe[:, None], (nb / safe)[:, None]],
                     dim=-1)


def seed_plane_fields(config: SurfelMapConfig, depth: torch.Tensor,
                      assignment: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, mean_depth: torch.Tensor,
                      norm: torch.Tensor, pos: torch.Tensor,
                      view_cos: torch.Tensor, size: torch.Tensor, geom=None):
    """Per-seed robust plane fit (`calculate_sp_depth_norms_kernel`,
    `fusion_functions.cpp:792-914`), the plain twin of the plane-fit kernel
    (`ops/cuda/planefit.py`, which has its signature): gate
    on >=16 valid depths and >=80% Huber inliers, average inlier pixel
    normals, refine with batched Huber GN over inlier 3D positions, project
    the seed center onto the plane, orient toward the camera.

    Reads the padded (H, W) depth and assignment and the seed fields it
    writes; returns the seeds' (norm, pos, mean_depth, view_cos, size), the
    fields as given where a seed fails the gates."""
    sp = config.sp_size
    g = geom or device_geometry(config, assignment.device)
    rows, cols = x.shape
    S = rows * cols
    K = 4 * sp * sp
    hr = float(config.profile.huber_range)
    cam = config.camera

    space = space_map(config, depth, geom)
    norms = pixel_normals(config, space, geom)
    depth_win = W.extract_windows(depth, sp)
    assign_win = W.extract_windows(assignment, sp)
    # this pass admits the last row/column (flat-index bound in the C++,
    # fusion_functions.cpp:815-817), unlike update_seeds' clamped window
    member = (assign_win == g["flat_id"][..., None]) & g["in_image"]

    nx_w, ny_w, nz_w = (W.extract_windows(norms[..., i], sp)
                        for i in range(3))
    px_w, py_w, pz_w = (W.extract_windows(space[..., i], sp)
                        for i in range(3))

    # squared pixel distance to the (float) seed centroid, over ALL members
    ex = g["win_x"] - x[..., None]
    ey = g["win_y"] - y[..., None]
    dist = ex * ex + ey * ey
    max_dist = torch.where(member, dist, 0.0).amax(dim=-1)

    valid_d = member & (depth_win > 0.05)
    nd = valid_d.sum(dim=-1).float()

    # Huber inliers around the seed's (already Newton-refined) mean depth
    resid = mean_depth[..., None] - depth_win
    inlier = valid_d & (resid < hr) & (resid > -hr)
    ni = inlier.sum(dim=-1).float()

    sum_n = torch.stack([W.masked_sum(nx_w, inlier),
                         W.masked_sum(ny_w, inlier),
                         W.masked_sum(nz_w, inlier)], dim=-1)   # (R, C, 3)
    nlen = _norm(sum_n, keepdim=True)
    n_avg = sum_n / nlen.clamp_min(1e-20)

    ok = ((nd >= 16.0)
          & (ni / nd.clamp_min(1.0) >= 0.8)
          & (nlen[..., 0] > 1e-20))

    pts = torch.stack([px_w, py_w, pz_w], dim=-1).reshape(S, K, 3)
    plane = _huber_gauss_newton(pts, inlier.reshape(S, K),
                                n_avg.reshape(S, 3), hr)
    plane = plane.reshape(rows, cols, 4)

    # project the seed centroid (at mean depth) onto the fitted plane
    avg = geometry.back_project(x, y, mean_depth, cam.fx, cam.fy, cam.cx,
                                cam.cy)
    k = -(avg * plane[..., :3]).sum(dim=-1) - plane[..., 3]
    avg = avg + k[..., None] * plane[..., :3]

    view = -(plane[..., :3] * avg).sum(dim=-1) \
        / _norm(avg).clamp_min(1e-20)
    flip = view < 0
    norm_out = torch.where(flip[..., None], -plane[..., :3], plane[..., :3])

    okn = ok[..., None]
    return (torch.where(okn, norm_out, norm),
            torch.where(okn, avg, pos),
            torch.where(ok, avg[..., 2], mean_depth),
            torch.where(ok, view.abs(), view_cos),
            torch.where(ok, torch.sqrt(max_dist), size))


def compute_seed_planes(config: SurfelMapConfig, seeds: SuperpixelState,
                        assignment: torch.Tensor, depth: torch.Tensor,
                        geom=None) -> SuperpixelState:
    """`calculate_norms` composite (space map, pixel normals, plane fit):
    the seeds with their planes.  On a CUDA tensor the plane-fit kernel
    (`ops/cuda/planefit.py`) runs it in one launch, on a CPU tensor its
    plain twin `seed_plane_fields`.  geom: a column slab's geometry
    override (`parallel/frame_sharding.py`)."""
    from .cuda import planefit
    norm, pos, mean_depth, view_cos, size = planefit.seed_planes(
        config, depth, assignment, seeds.x, seeds.y, seeds.mean_depth,
        seeds.norm, seeds.pos, seeds.view_cos, seeds.size, geom)
    return seeds.replace(norm=norm, pos=pos, mean_depth=mean_depth,
                         view_cos=view_cos, size=size)
