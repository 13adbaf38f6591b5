"""Map-to-camera depth render: the temporal prior of the stereo matcher.

Counterpart of the JAX package's `ops/render.py`.  The stereo-resident fuse
step computes depth on the device while the surfel bank (every previous
frame fused) is already there; this renders the live bank into the current
camera at superpixel granularity, as the prior of the matcher's rescue gate
(`models/stereo._wta_and_gates`, StereoConfig.prior_rescue).  One pass over
the bank (transform + project) and one scatter-min onto a stride-decimated
grid, upsampled by repetition.
"""

from __future__ import annotations

import torch

from ..config import SurfelMapConfig
from ..core import geometry
from ..core.state import SurfelBank


def render_prior_depth(config: SurfelMapConfig, bank: SurfelBank,
                       pose: torch.Tensor, stride: int = 8,
                       min_updates: int = 5, reduce=None) -> torch.Tensor:
    """(H, W) f32 nearest-surface map depth at `pose` (Twc); 0 = no surfel.

    Only rows with update_times >= min_updates contribute (the reference's
    stability threshold, `surfel_map.cpp:1159`).  `reduce` (optional)
    merges the coarse (hs, ws) z-buffer (inf = empty cell) with others
    before the upsample.  The sharded stereo steps render each shard's
    z-buffer (`coarse_zbuffer`), merge them (the JAX package's `lax.pmin`)
    and upsample the merged one (`upsample_prior`)."""
    coarse = coarse_zbuffer(config, bank, pose, stride, min_updates)
    if reduce is not None:
        coarse = reduce(coarse)
    return upsample_prior(config, coarse, stride)


def upsample_prior(config: SurfelMapConfig, coarse: torch.Tensor,
                   stride: int = 8) -> torch.Tensor:
    """The (H, W) prior depth of a coarse (hs, ws) z-buffer: each cell's
    depth repeated over its stride x stride pixels, 0 where it is empty
    (inf)."""
    h, w = config.height, config.width
    hs, ws = -(-h // stride), -(-w // stride)
    coarse = torch.where(torch.isfinite(coarse), coarse, 0.0)
    return coarse[:, None, :, None].expand(hs, stride, ws, stride).reshape(
        hs * stride, ws * stride)[:h, :w]


def coarse_zbuffer(config: SurfelMapConfig, bank: SurfelBank,
                   pose: torch.Tensor, stride: int = 8,
                   min_updates: int = 5) -> torch.Tensor:
    """The (hs, ws) f32 z-buffer of `render_prior_depth` before the
    upsample: each stride x stride cell's nearest stable surfel depth, inf
    where none projects."""
    cam = config.camera
    h, w = config.height, config.width
    hs, ws = -(-h // stride), -(-w // stride)

    inv_pose = torch.linalg.inv_ex(pose).inverse    # no host sync
    p_c = geometry.transform_points(inv_pose, bank.position)
    z = p_c[:, 2]
    uv = geometry.project(p_c, cam.fx, cam.fy, cam.cx, cam.cy)
    # pixel = round(uv) (the fusion convention); cell = pixel // stride
    pu = (uv[:, 0] + 0.5).to(torch.int32)
    pv = (uv[:, 1] + 0.5).to(torch.int32)

    ok = (bank.live_mask & (bank.update_times >= min_updates)
          & (z >= config.fuse_near) & (z <= config.fuse_far)
          & (pu >= 0) & (pu < w) & (pv >= 0) & (pv < h))
    cell = torch.where(ok, (pv // stride) * ws + (pu // stride), hs * ws)
    # one spare slot takes the rejected rows (the JAX scatter drops them);
    # out of place, so that under torch.func.vmap (the stereo fleet's
    # round) the batched depths scatter into a batched buffer
    buf = torch.full((hs * ws + 1,), float("inf"), dtype=torch.float32,
                     device=z.device)
    buf = buf.scatter_reduce(0, cell.long(), torch.where(ok, z, float("inf")),
                             "amin")
    return buf[:hs * ws].view(hs, ws)
