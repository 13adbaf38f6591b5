"""The per-frame fuse step over device state (depth-fed entry points).

Counterpart of the JAX package's `pipeline/fuse_step.py`: the whole hot path
(`FusionFunctions::fuse_initialize_map`, `fusion_functions.cpp:30-83`),

    superpixels -> normals/plane fit -> fuse -> new surfels (tail append)

on tensors of one device.  The bank is updated in place (where the JAX
package donates it); the stats dict holds device scalars, read by the host
only when it asks.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import SurfelMapConfig
from ..core.state import AUX_HEAD_BYTES, FrameInput, SurfelBank
from ..ops import fusion, normals, superpixel


def fuse_frame(config: SurfelMapConfig, bank: SurfelBank, frame: FrameInput,
               pose_mask: torch.Tensor | None = None
               ) -> Tuple[SurfelBank, dict]:
    """(bank, frame) -> (bank updated in place, stats).

    pose_mask (optional (max_keyframes,) bool): active-window gating — see
    `fusion.fuse_surfels`.  Stages carry the reference's timing-print names
    (fusion_functions.cpp:55,75,82) as profiler scopes."""
    with torch.profiler.record_function("superpixel"):
        seeds, assignment = superpixel.run_slic(config, frame.image,
                                                frame.depth)
        seeds, _space = normals.compute_seed_planes(
            config, seeds, assignment, frame.depth)

    with torch.profiler.record_function("fuse"):
        fused = fusion.fuse_surfels(
            config, bank, seeds, assignment, frame.depth, frame.pose,
            frame.frame_index, pose_mask=pose_mask)

    with torch.profiler.record_function("initialize"):
        new_fields, new_mask = fusion.extract_new_surfels(
            config, seeds, fused, frame.pose, frame.frame_index)
        stats = fusion.append_new(bank, new_fields, new_mask)

    stats["n_fused_seeds"] = fused.sum(dtype=torch.int32)
    return bank, stats


def ingest_frame(config: SurfelMapConfig, image_u8: torch.Tensor,
                 depth_f16: torch.Tensor):
    """Device-side decode of a compact frame (`core.state.compact_frame`):
    u8 intensity + f16 depth at raw camera resolution -> padded f32 planes."""
    ph, pw = config.padded_height, config.padded_width
    pad = (0, pw - config.width, 0, ph - config.height)
    return (F.pad(image_u8.float(), pad), F.pad(depth_f16.float(), pad))


def fuse_frame_compact(config: SurfelMapConfig, bank: SurfelBank,
                       image_u8: torch.Tensor, depth_f16: torch.Tensor,
                       pose: torch.Tensor, frame_index: torch.Tensor
                       ) -> Tuple[SurfelBank, dict]:
    """fuse_frame over a compact-encoded frame."""
    img, dep = ingest_frame(config, image_u8, depth_f16)
    return fuse_frame(config, bank, FrameInput(
        image=img, depth=dep, pose=pose, frame_index=frame_index))


def _bitcast(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a 1-D u8 slice as `dtype`; a slice whose storage offset is
    not a multiple of the item size is copied first (`.view(dtype)` needs an
    aligned offset)."""
    if seg.storage_offset() % dtype.itemsize:
        seg = seg.clone()
    return seg.view(dtype)


def unpack_frame(config: SurfelMapConfig, buf: torch.Tensor):
    """Decode of `core.state.pack_frame`: (3*H*W,) u8 -> (u8 image,
    f16 depth) at raw camera resolution."""
    oh, ow = config.height, config.width
    hw = oh * ow
    img = buf[:hw].view(oh, ow)
    dep = _bitcast(buf[hw:3 * hw], torch.float16).view(oh, ow)
    return img, dep


def fuse_frame_windowed(config: SurfelMapConfig, bank: SurfelBank,
                        image_u8: torch.Tensor, depth_f16: torch.Tensor,
                        pose: torch.Tensor, frame_index: torch.Tensor,
                        pose_mask: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """Compact fuse step with device-resident active/inactive gating:
    pose_mask (max_keyframes,) bool marks the drift-free window; rows owned
    by out-of-window keyframes are frozen in place."""
    img, dep = ingest_frame(config, image_u8, depth_f16)
    return fuse_frame(config, bank, FrameInput(
        image=img, depth=dep, pose=pose, frame_index=frame_index),
        pose_mask=pose_mask)


def unpack_aux(aux: torch.Tensor):
    """Decode of `core.state.pack_aux`: (72 + P,) u8 -> (pose (4,4) f32,
    frame_index () i32, bf () f32, window mask (P,) bool)."""
    pose = _bitcast(aux[:64], torch.float32).view(4, 4)
    ref = _bitcast(aux[64:68], torch.int32)[0]
    bf = _bitcast(aux[68:72], torch.float32)[0]
    return pose, ref, bf, aux[AUX_HEAD_BYTES:].bool()


def fuse_frame_windowed_aux(config: SurfelMapConfig, bank: SurfelBank,
                            buf: torch.Tensor, aux: torch.Tensor
                            ) -> Tuple[SurfelBank, dict]:
    """Windowed packed fuse step whose small per-frame arguments arrive in
    one aux buffer."""
    pose, ref, _, mask = unpack_aux(aux)
    img, dep = unpack_frame(config, buf)
    return fuse_frame_windowed(config, bank, img, dep, pose, ref, mask)


def fuse_frame_onebuf(config: SurfelMapConfig, bank: SurfelBank,
                      buf: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """Windowed fuse step whose ENTIRE per-frame payload (packed frame +
    aux, `core.state.pack_frame_with_aux`) arrives as one buffer: a single
    host-to-device copy per frame."""
    hw3 = 3 * config.height * config.width
    return fuse_frame_windowed_aux(config, bank, buf[:hw3], buf[hw3:])
