"""Fusion/association engine: surfel <- superpixel weighted fusion, new-surfel
initialization, and compaction of the fixed-capacity surfel bank.

Counterpart of the JAX package's `ops/fusion.py` (the reference's
`fuse_surfels_kernel`, `fusion_functions.cpp:190-313`, `initialize_surfels`
(:315-361) and the slot reuse of `SurfelMap::fuse_map`,
`surfel_map.cpp:1077-1112`).  Every bank row is processed in parallel with
mask algebra in place of the reference's per-surfel `continue` chains.  The
bank is updated in place; no function reads a device value on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core import geometry
from ..core.state import FIELDS, SuperpixelState, SurfelBank


def get_weight(depth: torch.Tensor) -> torch.Tensor:
    """Fusion weight min(1/z^2, 1) (`fusion_functions.cpp:99-102`)."""
    d = depth.clamp_min(1e-20)
    return (1.0 / (d * d)).clamp_max(1.0)


def _f32(value: float) -> float:
    """A Python constant rounded to f32 (as a JAX weak-typed constant)."""
    return float(np.float32(value))


def fuse_surfels(config: SurfelMapConfig, bank: SurfelBank,
                 seeds: SuperpixelState, assignment: torch.Tensor,
                 depth: torch.Tensor, pose: torch.Tensor,
                 frame_index: torch.Tensor,
                 pose_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One projective-association + weighted-fusion pass over the whole bank,
    updating it in place.  Returns fused (R, C) bool: seeds claimed by at
    least one surfel (or already fused).

    Gate order mirrors `fuse_surfels_kernel` (`fusion_functions.cpp:190-313`):
    staleness kill -> dead skip -> depth range -> image bounds -> occlusion
    kill -> seed normal/view gates -> tolerate_diff band -> normal-agreement
    kill -> weighted update.  One pass over the full capacity, with rows past
    `count` masked out, so the bank's count is never read on the host.

    pose_mask (optional, (max_keyframes,) bool): active-window gating — rows
    whose last_update keyframe is outside the mask are frozen (no update,
    no kill), the in-memory equivalent of the reference's active/inactive
    migration (`move_add_surfels`, `surfel_map.cpp:1456-1595`).
    """
    rows, cols = config.sp_rows, config.sp_cols
    # inv_ex: no host synchronisation for an error check
    inv_pose = torch.linalg.inv_ex(pose).inverse
    in_prefix = torch.arange(bank.capacity, dtype=torch.int32,
                             device=bank.device) < bank.count
    out = _fuse_rows(config, bank, in_prefix, seeds, assignment.reshape(-1),
                     depth, pose, inv_pose, frame_index, pose_mask)
    (position, normal, color, size, weight, update_times, last_update,
     fused_flat) = out
    bank.position.copy_(position)
    bank.normal.copy_(normal)
    bank.color.copy_(color)
    bank.size.copy_(size)
    bank.weight.copy_(weight)
    bank.update_times.copy_(update_times)
    bank.last_update.copy_(last_update)
    return seeds.fused | (fused_flat.reshape(rows, cols) > 0)


def _pack_seeds(seeds: SuperpixelState) -> torch.Tensor:
    """All ten per-seed fusion fields as one (S, 10) gather payload."""
    return torch.cat([
        seeds.norm.reshape(-1, 3), seeds.pos.reshape(-1, 3),
        seeds.mean_depth.reshape(-1, 1), seeds.view_cos.reshape(-1, 1),
        seeds.mean_intensity.reshape(-1, 1), seeds.size.reshape(-1, 1),
    ], dim=-1)


def _fuse_rows(config: SurfelMapConfig, bank: SurfelBank,
               in_prefix: torch.Tensor, seeds: SuperpixelState,
               assignment: torch.Tensor, depth: torch.Tensor,
               pose: torch.Tensor, inv_pose: torch.Tensor,
               frame_index: torch.Tensor, pose_mask=None):
    """Gate chain + weighted fusion over every bank row."""
    cam = config.camera
    prof = config.profile
    h, w = depth.shape
    position, normal = bank.position, bank.normal
    update_times, last_update = bank.update_times, bank.last_update

    alive = in_prefix & (update_times > 0)
    if pose_mask is not None:
        # frozen rows (owner keyframe outside the active window) are
        # untouchable: no fusion, no staleness/occlusion/normal kills
        P = pose_mask.shape[0]
        owner_ok = pose_mask[last_update.clamp(0, P - 1).long()] \
            & (last_update >= 0)
        alive = alive & owner_ok

    # staleness kill: idle > stale_frames and weakly observed
    stale = ((frame_index - last_update > config.stale_frames)
             & (update_times < config.stable_update_times) & alive)
    alive = alive & ~stale

    p_c = geometry.transform_points(inv_pose, position)          # (N, 3)
    n_c = geometry.rotate_vectors(inv_pose, normal)
    z = p_c[:, 2]
    in_range = (z >= config.fuse_near) & (z <= config.fuse_far)

    uv = geometry.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    pu = (uv[..., 0] + 0.5).to(torch.int32)
    pv = (uv[..., 1] + 0.5).to(torch.int32)
    in_img = ((pu >= 1) & (pu <= config.width - 2)
              & (pv >= 1) & (pv <= config.height - 2))
    consider = alive & in_range & in_img
    flat_px = (pv.clamp(0, h - 1) * w + pu.clamp(0, w - 1)).long()

    # occlusion: surfel more than 1m in front of the measured surface => kill
    d_px = depth.reshape(-1)[flat_px]
    occluded = consider & (z < d_px - 1.0)
    alive = alive & ~occluded
    consider = consider & ~occluded

    # the superpixel this surfel projects into, and its ten fusion fields
    raw_sp = assignment[flat_px]
    sp_idx = raw_sp.clamp_min(0).long()
    has_sp = raw_sp >= 0
    sg = _pack_seeds(seeds)[sp_idx]                              # (N, 10)
    s_norm, s_pos = sg[:, 0:3], sg[:, 3:6]
    s_depth, s_vcos, s_int, s_size = sg[:, 6], sg[:, 7], sg[:, 8], sg[:, 9]

    norm_set = (s_norm != 0.0).any(dim=-1)
    consider = consider & has_sp & norm_set \
        & (s_vcos >= config.max_angle_cos)

    cam_f = _f32(cam.mean_focal)
    tol = z * z / _f32(_f32(prof.baseline) * cam_f) * prof.disparity_error
    tol = tol.clamp_min(prof.min_tolerate_diff)
    in_band = (z >= s_depth - tol) & (z <= s_depth + tol)
    consider = consider & in_band

    ncos = (n_c * s_norm).sum(dim=-1)
    bad_norm = consider & (ncos < config.max_angle_cos)
    alive = alive & ~bad_norm
    commit = consider & ~bad_norm

    # weighted fusion (`fusion_functions.cpp:273-311`)
    w_old = bank.weight
    w_new = get_weight(s_depth)
    w_sum = w_old + w_new
    sp_w = geometry.transform_points(pose, s_pos)
    fused_p = (position * w_old[:, None] + w_new[:, None] * sp_w) \
        / w_sum[:, None]
    fused_n_c = n_c * w_old[:, None] + w_new[:, None] * s_norm
    fused_n_c = fused_n_c / torch.sqrt(
        (fused_n_c * fused_n_c).sum(dim=-1, keepdim=True)).clamp_min(1e-20)
    fused_n_w = geometry.rotate_vectors(pose, fused_n_c)
    new_size = s_size * (s_depth / (cam_f * torch.where(
        s_vcos != 0, s_vcos, 1.0))).abs()

    cm = commit[:, None]
    killed = stale | occluded | bad_norm

    # seed.fused |= any committing surfel hit it (a scatter-max OR in place
    # of the reference's racy boolean write at fusion_functions.cpp:311)
    # (out of place: under torch.func.vmap the zeros are not batched)
    fused_part = torch.zeros(config.num_seeds, dtype=torch.int32,
                             device=depth.device).scatter_reduce(
        0, sp_idx, commit.to(torch.int32), "amax")

    return (torch.where(cm, fused_p, position),
            torch.where(cm, fused_n_w, normal),
            torch.where(commit, s_int, bank.color),
            torch.where(commit & (new_size < bank.size), new_size, bank.size),
            torch.where(commit, w_sum, w_old),
            torch.where(killed, 0, torch.where(commit, update_times + 1,
                                               update_times)),
            torch.where(commit, frame_index, last_update),
            fused_part)


def extract_new_surfels(config: SurfelMapConfig, seeds: SuperpixelState,
                        fused: torch.Tensor, pose: torch.Tensor,
                        frame_index: torch.Tensor):
    """Candidate new surfels from unfused seeds (`initialize_surfels`,
    `fusion_functions.cpp:315-361`).  Returns a dict of (S,) field tensors
    plus a (S,) validity mask."""
    from .superpixel import device_geometry
    g = device_geometry(config, fused.device)
    S = config.num_seeds

    norm_set = (seeds.norm != 0.0).any(dim=-1)
    ok = (g["seed_valid"]
          & (seeds.mean_depth != 0.0)
          & ~fused
          & (seeds.view_cos >= config.max_angle_cos)
          & norm_set)

    cam_f = _f32(config.camera.mean_focal)
    vcos = seeds.view_cos.reshape(S)
    depth = seeds.mean_depth.reshape(S)
    size = seeds.size.reshape(S) * (depth / (cam_f * torch.where(
        vcos != 0, vcos, 1.0))).abs()

    fields = dict(
        position=geometry.transform_points(pose, seeds.pos.reshape(S, 3)),
        normal=geometry.rotate_vectors(pose, seeds.norm.reshape(S, 3)),
        color=seeds.mean_intensity.reshape(S),
        size=size,
        weight=get_weight(depth),
        update_times=torch.ones(S, dtype=torch.int32, device=fused.device),
        last_update=frame_index.to(torch.int32).expand(S),
    )
    return fields, ok.reshape(S)


def append_new(bank: SurfelBank, new_fields: dict,
               new_mask: torch.Tensor) -> dict:
    """Append the valid new surfels at the bank tail, in place, WITHOUT
    repacking (holes are reclaimed by `compact_bank` under the driver's
    policy).  If the tail lacks room for a full slab the append is skipped
    and reported in n_dropped.  Returns the stats dict (device scalars)."""
    cap = bank.capacity
    S = new_mask.shape[0]
    dev = bank.device
    mask_i = new_mask.to(torch.int32)
    n_want = mask_i.sum(dtype=torch.int32)

    # compaction slot of each valid candidate; invalid ones go to the spare
    # row S of the slab, which is dropped
    dest = torch.where(new_mask, torch.cumsum(mask_i, 0) - 1, S).long()

    can = bank.count <= cap - S
    start = torch.where(can, bank.count, cap - S)
    n_new = torch.where(can, n_want, 0)
    rows = start.long() + torch.arange(S, device=dev)
    take = can & (torch.arange(S, device=dev) < n_want)

    for k in FIELDS:
        old, new = getattr(bank, k), new_fields[k]
        slab = torch.zeros((S + 1,) + new.shape[1:], dtype=new.dtype,
                           device=dev).index_copy(0, dest, new)
        keep = take.reshape((S,) + (1,) * (new.dim() - 1))
        old[rows] = torch.where(keep, slab[:S], old[rows])
    bank.count.add_(n_new)

    n_live = bank.live_mask.sum(dtype=torch.int32)
    return dict(n_live=n_live - n_new, n_new=n_new,
                n_dropped=n_want - n_new)


def compact_bank(bank: SurfelBank) -> None:
    """Repack live rows to the front, in place (hole elimination): a stable
    partition by liveness, then one gather per field."""
    live = bank.live_mask
    n_live = live.sum(dtype=torch.int32)
    perm = torch.argsort((~live).to(torch.uint8), stable=True)
    keep = torch.arange(bank.capacity, dtype=torch.int32,
                        device=bank.device) < n_live
    for k in FIELDS:
        t = getattr(bank, k)
        moved = t[perm]
        k_ = keep.reshape((-1,) + (1,) * (t.dim() - 1))
        t.copy_(torch.where(k_, moved, 0))
    bank.count.copy_(n_live)
