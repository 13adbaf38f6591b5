"""The reference's frame step, compaction and loop warp over one bank.

Each function takes what a driver receives (the frame as the sensor sent
it, the pose, the reference keyframe, the active window) and updates the
bank it is given in place, as the port's captured step does: decode and
pad, SLIC, plane fit, fusion, append (`fuse_frame`), the matcher first
for a stereo pair, then compaction on the configured schedule.  Matmuls
run in full float32 (TF32 off).

`lowp=True` is the control: the same step with what it computes rounded
to bfloat16 where it is produced (the stereo depth, the seed planes and
every bank row the step writes), the precision below the configuration's
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import depthfilter, fusion, normals, superpixel, warp
from . import stereo as stereo_model
from .state import FrameInput, SurfelBank

_SEED_FLOATS = ("x", "y", "mean_intensity", "mean_depth", "size", "norm",
                "pos", "view_cos")
_BANK_FLOATS = ("position", "normal", "color", "size", "weight")


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _pad(config, plane: torch.Tensor) -> torch.Tensor:
    return F.pad(plane, (0, config.padded_width - config.width,
                         0, config.padded_height - config.height))


def _fuse(config, bank: SurfelBank, image: torch.Tensor, depth: torch.Tensor,
          pose: torch.Tensor, frame_index: torch.Tensor,
          pose_mask: torch.Tensor, lowp: bool) -> None:
    """`fuse_frame` over padded f32 planes, with the window gating."""
    frame = FrameInput(image=image, depth=depth, pose=pose,
                       frame_index=frame_index)
    before = {k: getattr(bank, k).clone() for k in _BANK_FLOATS} \
        if lowp else None
    seeds, assignment = superpixel.run_slic(config, frame.image, frame.depth)
    seeds, _ = normals.compute_seed_planes(config, seeds, assignment,
                                           frame.depth)
    if lowp:
        seeds = seeds.replace(**{k: _bf16(getattr(seeds, k))
                                 for k in _SEED_FLOATS})
    fused = fusion.fuse_surfels(config, bank, seeds, assignment, frame.depth,
                                frame.pose, frame.frame_index,
                                pose_mask=pose_mask)
    new_fields, new_mask = fusion.extract_new_surfels(
        config, seeds, fused, frame.pose, frame.frame_index)
    fusion.append_new(bank, new_fields, new_mask)
    if lowp:
        for k in _BANK_FLOATS:
            t = getattr(bank, k)
            t.copy_(torch.where(t == before[k], t, _bf16(t)))


def stereo_depth(config, stereo_config, left: torch.Tensor,
                 right: torch.Tensor, bf: torch.Tensor,
                 filter_depth: bool = True) -> torch.Tensor:
    """Disparity -> metric depth (`depth = bf / disparity`) -> the flyer
    and median post-filter: the port's `compute_depth_stereo` without the
    map prior (off in the configurations run here)."""
    disp = stereo_model.disparity(left, right, stereo_config)
    depth = torch.where(disp > 0, bf / disp.clamp_min(1e-6), 0.0)
    depth = torch.where(depth <= config.fuse_far, depth, 0.0)
    if filter_depth:
        depth = depthfilter.clean_depth(depth)
        for _ in range(stereo_config.fill_after_clean
                       if stereo_config.post_median else 0):
            d2 = torch.where(depth > 0, bf / depth.clamp_min(1e-6), 0.0)
            d2 = stereo_model._median_postfilter(
                d2, stereo_config.speckle_tol, stereo_config.fill_support)
            depth = torch.where(d2 > 0, bf / d2.clamp_min(1e-6), 0.0)
    return depth


def fuse_depth_frame(config, bank: SurfelBank, image_u8: torch.Tensor,
                     depth_f32: torch.Tensor, pose: torch.Tensor,
                     frame_index: int, pose_mask: torch.Tensor,
                     lowp: bool = False) -> None:
    """A depth-fed frame: u8 intensity and f32 metric depth as sent; the
    configuration's compact upload carries the depth as float16."""
    _exact()
    if not config.compact_upload:
        raise ValueError("the reference decodes the compact upload only")
    dev = bank.device
    image = _pad(config, image_u8.to(dev).float())
    depth = _pad(config, depth_f32.to(dev).to(torch.float16).float())
    _fuse(config, bank, image, depth, pose.to(dev, torch.float32),
          torch.tensor(frame_index, dtype=torch.int32, device=dev),
          pose_mask.to(dev), lowp)


def fuse_stereo_frame(config, stereo_config, bank: SurfelBank,
                      left_u8: torch.Tensor, right_u8: torch.Tensor,
                      pose: torch.Tensor, frame_index: int,
                      pose_mask: torch.Tensor, bf: float,
                      filter_depth: bool = True, lowp: bool = False) -> None:
    """A rectified u8 pair: the matcher's depth, then the frame step with
    the left image as intensity."""
    _exact()
    dev = bank.device
    left = left_u8.to(dev).float()
    right = right_u8.to(dev).float()
    bf_t = torch.tensor(bf, dtype=torch.float32, device=dev)
    depth = stereo_depth(config, stereo_config, left, right, bf_t,
                         filter_depth)
    if lowp:
        depth = _bf16(depth)
    _fuse(config, bank, _pad(config, left), _pad(config, depth),
          pose.to(dev, torch.float32),
          torch.tensor(frame_index, dtype=torch.int32, device=dev),
          pose_mask.to(dev), lowp)


def compact(bank: SurfelBank) -> None:
    """Live rows to the front, in order (`fusion.compact_bank`)."""
    fusion.compact_bank(bank)


def warp_by_pose(bank: SurfelBank, warps: torch.Tensor, moved: torch.Tensor,
                 pose_mask: torch.Tensor, first_local: int,
                 lowp: bool = False) -> None:
    """The loop warp of a bank that holds active and frozen rows: active
    rows take the first local keyframe's warp, frozen rows their own."""
    _exact()
    dev = bank.device
    before = (bank.position.clone(), bank.normal.clone()) if lowp else None
    warp.warp_bank_by_pose(bank, warps.to(dev, torch.float32),
                           moved.to(dev), pose_mask.to(dev), first_local)
    if lowp:
        for t, old in zip((bank.position, bank.normal), before):
            t.copy_(torch.where(t == old, t, _bf16(t)))
