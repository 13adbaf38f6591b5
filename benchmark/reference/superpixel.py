"""SLIC-style superpixel segmentation over intensity + inverse depth: the plain
PyTorch twin of the CUDA kernels in `csrc/slic.cu`.

Counterpart of the JAX package's `ops/superpixel.py` (the reference engine is
`fusion_functions.cpp:363-642`).  Each kernel has a plain function here with
the kernel's signature:

* `assign_sweep`      <-> `slic_assign`   (one pixel-assignment sweep)
* `seed_sums`         <-> `slic_centroid` (per-seed membership sums)
* `huber_mean_depth`  <-> `slic_huber`    (5-step Huber-Newton mean depth)

A frozen copy of the port's `ops/superpixel.py`: `run_slic` runs these
functions on any device and never a kernel.

`geom=` (every stage) overrides the static geometry of `device_geometry`:
the column-slab path of `parallel/frame_sharding.py` passes each slab's
masks and global coordinates.  The kernels take no such override, so a
`geom` call runs these functions on any device, as the JAX package's
`run_slic` runs its XLA path whenever `geom` is given.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import SurfelMapConfig
from .state import SuperpixelState
from . import windows as W

BIG_COST = 1e10

# candidate scan order of the reference: check_i (x offset) outer, check_j
# (y offset) inner (`fusion_functions.cpp:413-414`); first strict minimum wins.
_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


@functools.lru_cache(maxsize=8)
def _static_geometry(config: SurfelMapConfig):
    """Host-side constant masks/planes for the given config (numpy)."""
    sp = config.sp_size
    h, w = config.padded_height, config.padded_width
    rows, cols = config.sp_rows, config.sp_cols
    oh, ow = config.height, config.width

    ry = np.arange(h) % sp
    rx = np.arange(w) % sp

    # |off*sp + sp/2 - r| < sp  gate of `update_pixels_kernel`
    # (`fusion_functions.cpp:416-420`), reduced to a function of r = pix % sp.
    def axis_gate(r, off):
        return np.abs(off * sp + sp // 2 - r) < sp

    gate_y = {off: axis_gate(ry, off)[:, None] for off in (-1, 0, 1)}
    gate_x = {off: axis_gate(rx, off)[None, :] for off in (-1, 0, 1)}

    pixel_valid = np.zeros((h, w), bool)
    pixel_valid[:oh, :ow] = True

    seed_valid = np.zeros((rows, cols), bool)
    seed_valid[:oh // sp, :ow // sp] = True

    flat_id = (np.arange(rows)[:, None] * cols + np.arange(cols)[None, :]
               ).astype(np.int32)

    interior = W.window_interior_mask(rows, cols, sp, oh, ow)
    in_image = W.window_image_mask(rows, cols, sp, oh, ow)
    win_y, win_x = W.window_pixel_coords(rows, cols, sp)

    in_range = {}
    nb_flat = {}
    for di, dj in _OFFSETS:
        pad_v = np.pad(seed_valid, 1, constant_values=False)
        nb_valid = pad_v[1 + dj:1 + dj + rows, 1 + di:1 + di + cols]
        nb_valid_px = np.repeat(np.repeat(nb_valid, sp, 0), sp, 1)
        in_range[(di, dj)] = gate_y[dj] & gate_x[di] & nb_valid_px & pixel_valid
        pad_f = np.pad(flat_id, 1, constant_values=-1)
        nb = pad_f[1 + dj:1 + dj + rows, 1 + di:1 + di + cols]
        nb_flat[(di, dj)] = np.repeat(np.repeat(nb, sp, 0), sp, 1)

    px_y = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    px_x = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    center_y = np.broadcast_to(
        (np.arange(rows, dtype=np.float32) * sp + sp // 2)[:, None],
        (rows, cols))
    center_x = np.broadcast_to(
        (np.arange(cols, dtype=np.float32) * sp + sp // 2)[None, :],
        (rows, cols))

    return dict(
        pixel_valid=pixel_valid, seed_valid=seed_valid, flat_id=flat_id,
        interior=interior, in_image=in_image,
        win_y=win_y.astype(np.float32), win_x=win_x.astype(np.float32),
        in_range=in_range, nb_flat=nb_flat,
        px_y=px_y, px_x=px_x, center_y=center_y, center_x=center_x,
    )


@functools.lru_cache(maxsize=8)
def device_geometry(config: SurfelMapConfig, device: torch.device):
    """`_static_geometry` as tensors on `device`, uploaded once per
    (config, device) so the per-frame path copies nothing to the device."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    g = _static_geometry(config)
    out = {k: put(v) for k, v in g.items() if isinstance(v, np.ndarray)}
    out["in_range"] = {k: put(v) for k, v in g["in_range"].items()}
    out["nb_flat"] = {k: put(v) for k, v in g["nb_flat"].items()}
    return out


def _neighbor_plane(field: torch.Tensor, di: int, dj: int,
                    sp: int) -> torch.Tensor:
    """Seed plane (R, C) -> pixel plane (H, W) of each pixel's (di, dj)
    neighbor-seed value (zero outside the grid)."""
    rows, cols = field.shape
    p = torch.nn.functional.pad(field[None], (1, 1, 1, 1))[0]
    nb = p[1 + dj:1 + dj + rows, 1 + di:1 + di + cols]
    return W.upsample_to_pixels(nb, sp)


def initialize_seeds(config: SurfelMapConfig, image: torch.Tensor,
                     depth: torch.Tensor, geom=None) -> SuperpixelState:
    """Seed grid init (`fusion_functions.cpp:577-629`): centers on the SP
    grid; if the center has no depth, steal the first valid depth in the
    seed's window (row-major scan order)."""
    sp = config.sp_size
    g = geom or device_geometry(config, image.device)
    rows, cols = image.shape[0] // sp, image.shape[1] // sp

    half = sp // 2
    center_i = image.reshape(rows, sp, cols, sp)[:, half, :, half]
    center_d = depth.reshape(rows, sp, cols, sp)[:, half, :, half]

    depth_win = W.extract_windows(depth, sp)
    steal_ok = (depth_win > 0.01) & g["interior"]
    stolen, found = W.first_valid(depth_win, steal_ok)

    mean_depth = torch.where((center_d < 0.01) & found, stolen, center_d)
    seed_valid = g["seed_valid"]
    zeros = torch.zeros((rows, cols), dtype=torch.float32,
                        device=image.device)
    return SuperpixelState(
        x=g["center_x"], y=g["center_y"],
        mean_intensity=torch.where(seed_valid, center_i, 0.0),
        mean_depth=torch.where(seed_valid, mean_depth, 0.0),
        size=zeros, norm=torch.zeros((rows, cols, 3), dtype=torch.float32,
                                     device=image.device),
        pos=torch.zeros((rows, cols, 3), dtype=torch.float32,
                        device=image.device),
        view_cos=zeros,
        stable=~seed_valid,   # padded seeds are permanently "stable" (inert)
        fused=torch.zeros((rows, cols), dtype=torch.bool,
                          device=image.device),
    )


# ----------------------------------------------------------------------
# plain twins of the three kernels (same signatures as ops/cuda/slic.py)
# ----------------------------------------------------------------------
def assign_sweep(config: SurfelMapConfig, image: torch.Tensor,
                 inv_depth: torch.Tensor, assignment: torch.Tensor,
                 x: torch.Tensor, y: torch.Tensor,
                 mean_intensity: torch.Tensor, mean_depth: torch.Tensor,
                 stable: torch.Tensor, geom=None):
    """One pixel-assignment sweep (`update_pixels_kernel`,
    `fusion_functions.cpp:389-453`).

    Returns (new_assignment (H, W) i32, claimed (R, C) bool).  Pixels whose
    current seed is stable keep their assignment; a seed is claimed when an
    updated pixel chose it (the caller clears its stable flag)."""
    sp = config.sp_size
    g = geom or device_geometry(config, image.device)
    px_y, px_x = g["px_y"], g["px_x"]
    half_sq = float((sp // 2) * (sp // 2))

    # running strict-< minimum in the reference's candidate scan order:
    # first minimum wins
    big = torch.full(image.shape, BIG_COST, dtype=torch.float32,
                     device=image.device)
    none = torch.full(image.shape, -1, dtype=torch.int32, device=image.device)
    best_d, best_d_idx, best_nd, best_nd_idx = big, none, big, none
    all_has_depth = inv_depth > 0
    for di, dj in _OFFSETS:
        sx = _neighbor_plane(x, di, dj, sp)
        sy = _neighbor_plane(y, di, dj, sp)
        si = _neighbor_plane(mean_intensity, di, dj, sp)
        sd = _neighbor_plane(mean_depth, di, dj, sp)
        in_range = g["in_range"][(di, dj)]
        flat = g["nb_flat"][(di, dj)]

        ex = sx - px_x
        ey = sy - px_y
        dist = ex * ex + ey * ey
        idiff = si - image
        nodepth = dist / half_sq + idiff * idiff / 100.0
        ddiff = torch.where(sd > 0, 1.0 / sd.clamp_min(1e-20), 0.0) \
            - inv_depth
        with_depth = nodepth + ddiff * ddiff * 400.0
        has_d = (sd > 0) & (inv_depth > 0)

        cost_nd = torch.where(in_range, nodepth, BIG_COST)
        cost_d = torch.where(in_range & has_d, with_depth, cost_nd)

        take_d = cost_d < best_d
        best_d = torch.where(take_d, cost_d, best_d)
        best_d_idx = torch.where(take_d, flat, best_d_idx)
        take_nd = cost_nd < best_nd
        best_nd = torch.where(take_nd, cost_nd, best_nd)
        best_nd_idx = torch.where(take_nd, flat, best_nd_idx)
        # all_has_depth &= calculate_cost(...) over in-range candidates only
        all_has_depth = all_has_depth & (has_d | ~in_range)

    chosen = torch.where(all_has_depth, best_d_idx, best_nd_idx)
    best_cost = torch.where(all_has_depth, best_d, best_nd)
    chosen = torch.where(best_cost >= BIG_COST, -1, chosen)

    if geom is None:
        cur_stable = stable.reshape(-1)[assignment.clamp_min(0).long()] \
            & (assignment >= 0)
    else:
        # assignment holds GLOBAL flat ids: map them into this grid's
        # columns (a column slab holds only its own)
        rows, cols = stable.shape
        ids = assignment.clamp_min(0)
        id_r = ids // g["grid_cols"]
        id_c = ids % g["grid_cols"] - g["col0"]
        in_grid = (assignment >= 0) & (id_c >= 0) & (id_c < cols)
        lidx = (id_r * cols + id_c).clamp(0, rows * cols - 1).long()
        cur_stable = stable.reshape(-1)[lidx] & in_grid
    updated = g["pixel_valid"] & ~cur_stable
    new_assignment = torch.where(updated, chosen, assignment)

    # claimed := some updated pixel chose the seed, as a windowed OR.  The
    # window extraction zero-pads, and 0 is seed 0's id, so seed 0 counts
    # as claimed in every sweep (the JAX package's XLA path does the same;
    # the CUDA kernel reproduces it).
    claim_src = torch.where(updated, new_assignment, -1)
    claim_win = W.extract_windows(claim_src, sp)
    claimed = (claim_win == g["flat_id"][..., None]).any(dim=-1)
    return new_assignment, claimed


def _member_windows(config: SurfelMapConfig, assignment: torch.Tensor,
                    geom=None):
    """(R, C, K) membership of each seed's clamped window: the pixel is
    assigned to the seed and inside the reference's strict-< scan bound."""
    g = geom or device_geometry(config, assignment.device)
    assign_win = W.extract_windows(assignment, config.sp_size)
    return (assign_win == g["flat_id"][..., None]) & g["interior"]


def seed_sums(config: SurfelMapConfig, image: torch.Tensor,
              depth: torch.Tensor, assignment: torch.Tensor, geom=None):
    """Per-seed sums over the seed's own pixels inside its 2sp x 2sp window
    (`update_seeds_kernel`, `fusion_functions.cpp:468-533`).

    Returns six (R, C) f32 planes: n, sum x, sum y, sum intensity,
    n with depth > 0.1, sum of those depths."""
    g = geom or device_geometry(config, image.device)
    sp = config.sp_size
    member = _member_windows(config, assignment, geom)
    image_win = W.extract_windows(image, sp)
    depth_win = W.extract_windows(depth, sp)
    dmem = member & (depth_win > 0.1)
    return (member.sum(dim=-1).float(),
            W.masked_sum(g["win_x"], member),
            W.masked_sum(g["win_y"], member),
            W.masked_sum(image_win, member),
            dmem.sum(dim=-1).float(),
            W.masked_sum(depth_win, dmem))


def huber_mean_depth(config: SurfelMapConfig, depth: torch.Tensor,
                     assignment: torch.Tensor, mean: torch.Tensor,
                     converged: torch.Tensor, geom=None) -> torch.Tensor:
    """Five Huber-Newton steps of each seed's mean depth over its member
    pixels with depth > 0.1, with the |delta| < 0.01 convergence latch
    (`fusion_functions.cpp:534-554`).  Seeds already `converged` keep their
    mean.  Returns the (R, C) f32 mean."""
    hr = float(config.profile.huber_range)
    depth_win = W.extract_windows(depth, config.sp_size)
    dmem = _member_windows(config, assignment, geom) & (depth_win > 0.1)
    for _ in range(5):
        r = mean[..., None] - depth_win
        inl = (r < hr) & (r > -hr)
        psi = torch.where(inl, 2.0 * r,
                          torch.where(r > 0, hr, -hr))
        sum_a = W.masked_sum(psi, dmem)
        sum_b = 2.0 * (dmem & inl).sum(dim=-1).float()
        delta = -sum_a / (sum_b + 10.0)
        mean = torch.where(converged, mean, mean + delta)
        converged = converged | (delta.abs() < 0.01)
    return mean


# ----------------------------------------------------------------------
# the SLIC stages
# ----------------------------------------------------------------------
def _kernels(use_kernels: bool, geom=None):
    """The plain functions of the three SLIC stages (the reference never
    runs a kernel)."""
    if use_kernels:
        raise ValueError("the reference runs no kernel")
    return tuple(functools.partial(fn, geom=geom) for fn in
                 (assign_sweep, seed_sums, huber_mean_depth))


def assign_pixels(config: SurfelMapConfig, seeds: SuperpixelState,
                  image: torch.Tensor, inv_depth: torch.Tensor,
                  assignment: torch.Tensor, use_kernels: bool = False,
                  geom=None):
    """One assignment sweep; returns (new_assignment, seeds with every
    freshly claimed seed's stable flag cleared)."""
    assign, _, _ = _kernels(use_kernels, geom)
    new_assignment, claimed = assign(
        config, image, inv_depth, assignment, seeds.x, seeds.y,
        seeds.mean_intensity, seeds.mean_depth, seeds.stable)
    return new_assignment, seeds.replace(stable=seeds.stable & ~claimed)


def update_seeds(config: SurfelMapConfig, seeds: SuperpixelState,
                 assignment: torch.Tensor, image: torch.Tensor,
                 depth: torch.Tensor, use_kernels: bool = False,
                 geom=None) -> SuperpixelState:
    """One seed-update sweep (`update_seeds_kernel`,
    `fusion_functions.cpp:468-561`): recompute centroid / mean intensity of
    every unstable seed, latch stability on small updates, and Huber-Newton
    the per-seed mean depth."""
    _, sums, huber = _kernels(use_kernels, geom)
    n, sum_x, sum_y, sum_i, nd, sum_d = sums(config, image, depth,
                                             assignment)
    safe_n = n.clamp_min(1.0)
    new_x = sum_x / safe_n
    new_y = sum_y / safe_n
    new_i = sum_i / safe_n

    # per-seed semantics: a seed with zero members keeps its state (the
    # reference instead `return`s, killing the remaining seeds of the worker
    # thread's chunk — a bug not reproduced; fusion_functions.cpp:516-517)
    upd = ~seeds.stable & (n > 0)
    diff = ((seeds.mean_intensity - new_i).abs()
            + (seeds.x - new_x).abs() + (seeds.y - new_y).abs())
    new_stable = seeds.stable | (upd & (diff < 0.2))

    mean = huber(config, depth, assignment, sum_d / nd.clamp_min(1.0),
                 nd <= 0)
    new_depth = torch.where(nd > 0, mean, 0.0)
    return seeds.replace(
        x=torch.where(upd, new_x, seeds.x),
        y=torch.where(upd, new_y, seeds.y),
        mean_intensity=torch.where(upd, new_i, seeds.mean_intensity),
        mean_depth=torch.where(upd, new_depth, seeds.mean_depth),
        stable=new_stable,
    )


def run_slic(config: SurfelMapConfig, image: torch.Tensor,
             depth: torch.Tensor, use_kernels: bool | None = None,
             geom=None):
    """Full superpixel extraction (`generate_super_pixels`,
    `fusion_functions.cpp:960-975`): seed init + ITERATION_NUM x
    (assign, update).  Returns (seeds, assignment (H,W) i32 flat ids).

    use_kernels: ignored (the plain functions always run).
    geom: a geometry override (a column slab)."""
    use_kernels = False
    inv_depth = torch.where(depth > 0.01, 1.0 / depth.clamp_min(1e-20), 0.0)

    seeds = initialize_seeds(config, image, depth, geom)
    # raw pixels start at seed 0 like the reference's zero-fill
    # (fusion_functions.cpp:964); padded pixels are pinned to -1 (no seed)
    g = geom or device_geometry(config, image.device)
    assignment = torch.where(g["pixel_valid"], 0, -1).to(torch.int32)
    for _ in range(config.sp_iters):
        assignment, seeds = assign_pixels(config, seeds, image, inv_depth,
                                          assignment, use_kernels, geom)
        seeds = update_seeds(config, seeds, assignment, image, depth,
                             use_kernels, geom)
    return seeds, assignment
