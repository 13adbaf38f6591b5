"""Loop-closure warp engine: batched rigid re-alignments of surfel tensors.

Counterpart of the JAX package's `ops/warp.py` (the reference's
`warp_surfels`, `surfel_map.cpp:791-824`): the inactive pool is warped by one
gather + batched matmul (each surfel indexes its pose's warp matrix), the
active bank by a single 4x4 transform.
"""

from __future__ import annotations

import torch

from . import geometry
from .state import SurfelBank


def warp_active(bank: SurfelBank, warp: torch.Tensor) -> None:
    """Apply one warp matrix to every bank row, in place
    (`warp_active_surfels_cpu_kernel`, `surfel_map.cpp:750-789` — the
    reference uses the warp of the first local pose for all local surfels)."""
    bank.position.copy_(geometry.transform_points(warp, bank.position))
    bank.normal.copy_(geometry.rotate_vectors(warp, bank.normal))


def warp_bank_by_pose(bank: SurfelBank, warps: torch.Tensor,
                      moved: torch.Tensor, pose_mask: torch.Tensor,
                      first_local: int) -> None:
    """Loop-closure warp, in place, of a device-resident bank holding BOTH
    active and frozen surfels (no host pool).

    Reference semantics in one pass (`warp_surfels`, surfel_map.cpp:791-824):
    rows owned by an in-window (active) keyframe all use the FIRST local
    pose's warp (:808-813); frozen rows use their own keyframe's warp
    (:681-748); rows whose selected keyframe did not move stay put.

    warps: (P, 4, 4) loop_pose @ cam_pose^-1 per keyframe; moved: (P,) bool;
    pose_mask: (P,) bool active window; first_local: keyframe index."""
    P = warps.shape[0]
    lu = bank.last_update.clamp(0, P - 1).long()
    active = pose_mask[lu] & (bank.last_update >= 0)
    idx = torch.where(active, first_local, lu)
    do = (moved[idx] & (bank.update_times > 0)
          & (bank.last_update >= 0))[:, None]
    new_p = geometry.transform_points_batched(warps, bank.position, idx)
    new_n = geometry.rotate_vectors_batched(warps, bank.normal, idx)
    bank.position.copy_(torch.where(do, new_p, bank.position))
    bank.normal.copy_(torch.where(do, new_n, bank.normal))


def warp_pool(positions: torch.Tensor, normals: torch.Tensor,
              pose_index: torch.Tensor, warps: torch.Tensor):
    """Warp an inactive-pool slab: positions/normals (M, 3), pose_index (M,)
    selecting each surfel's warp from warps (P, 4, 4)
    (`warp_inactive_surfels_cpu_kernel`, `surfel_map.cpp:681-748`)."""
    return (geometry.transform_points_batched(warps, positions, pose_index),
            geometry.rotate_vectors_batched(warps, normals, pose_index))
