"""Single-GPU multi-session mapping: the fuse step batched over B streams.

Counterpart of the JAX package's `parallel/multistream.py`.  Fleet/serving
mode on one device: B independent camera sessions fuse in one pass of ops
per round (batched banks, batched frames), where the JAX package runs
`jax.jit(jax.vmap(fuse_step))`.  Here the single-frame step of
`pipeline/fuse_step.py` runs under `torch.func.vmap`: every PyTorch op of the
step runs once for the B streams, and the three SLIC kernels reach their
stream axis through their vmap rule (`ops/cuda/slic.py`), one launch per
sweep for all streams.  Banks are updated in place (the JAX package donates
them).

The reference has no equivalent (one ROS process maps one session).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core.state import AUX_HEAD_BYTES, FIELDS, FrameInput, SurfelBank
from ..ops import fusion
from ..ops import warp as warp_ops
from ..pipeline import fuse_step

_BANK_KEYS = FIELDS + ("count",)


def make_banks(config: SurfelMapConfig, n_streams: int,
               device="cuda") -> SurfelBank:
    """Empty per-stream banks: every field gains a leading (B,) axis and
    `count` is (B,) i32; dead rows carry last_update = -1 as in
    `SurfelBank.empty`."""
    one = SurfelBank.empty(config.surfel_capacity, device)
    return SurfelBank(**{k: getattr(one, k).expand(
        (n_streams,) + getattr(one, k).shape).clone() for k in _BANK_KEYS})


def stream_bank(banks: SurfelBank, stream: int) -> SurfelBank:
    """Stream `stream`'s bank as views into the fleet's banks: the solo
    ops that update a bank in place write into the fleet."""
    return SurfelBank(**{k: getattr(banks, k)[stream] for k in _BANK_KEYS})


def place_rows(banks: SurfelBank, stream: int, fields: dict,
               count: int) -> None:
    """Stream `stream`'s slot := `count` numpy rows (e.g. the `bank_*`
    arrays of a checkpoint written by either package), the rest empty rows
    (last_update = -1).  The batched `bank_from_numpy`."""
    cap = banks.position.shape[1]
    if count > cap:
        raise ValueError(f"{count} surfels exceed the capacity {cap}")
    empty = SurfelBank.empty(cap, "cpu")
    for k in FIELDS:
        host = getattr(empty, k)
        host[:count] = torch.from_numpy(
            np.ascontiguousarray(fields[k][:count]))
        getattr(banks, k)[stream].copy_(host)
    banks.count[stream].fill_(count)


def concat_banks(a: SurfelBank, b: SurfelBank) -> SurfelBank:
    """Streams of `a` followed by those of `b`."""
    return SurfelBank(**{k: torch.cat([getattr(a, k), getattr(b, k)])
                         for k in _BANK_KEYS})


def select_streams(banks: SurfelBank, keep) -> SurfelBank:
    """The banks of the streams `keep`, in that order (a copy)."""
    idx = torch.as_tensor(list(keep), dtype=torch.long,
                          device=banks.position.device)
    return SurfelBank(**{k: getattr(banks, k).index_select(0, idx)
                         for k in _BANK_KEYS})


def stack_frames(frames, device="cuda") -> Tuple[torch.Tensor, ...]:
    """[(image_u8, depth_f16, pose, index), ...] -> batched device tensors
    (images (B, h, w) u8, depths (B, h, w) f16, poses (B, 4, 4) f32, frame
    indices (B,) i32)."""
    cis, cds, pss, fis = zip(*frames)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (put(np.stack(cis)), put(np.stack(cds)),
            put(np.stack(pss, axis=0).astype(np.float32)),
            put(np.asarray(fis, np.int32)))


def _vmap_banks(fn):
    """torch.func.vmap of fn(bank, *args) over the stream axis of a
    batched bank (passed in as its fields, so that the in-place updates of
    the single-frame ops land in the fleet's banks)."""
    def one(fields, *args):
        return fn(SurfelBank(**fields), *args)

    def run(banks: SurfelBank, *args):
        return torch.func.vmap(one)(
            {k: getattr(banks, k) for k in _BANK_KEYS}, *args)
    return run


def _fuse_compact(config, bank, image_u8, depth_f16, pose, frame_index):
    return fuse_step.fuse_frame_compact(config, bank, image_u8, depth_f16,
                                        pose, frame_index)[1]


def batched_fuse_step(config: SurfelMapConfig):
    """(banks, images_u8 (B,h,w), depths_f16 (B,h,w), poses (B,4,4),
    frame_indices (B,)) -> (banks updated in place, stats (B,) each): the
    compact fuse step of every stream in one pass."""
    run = _vmap_banks(functools.partial(_fuse_compact, config))

    def step(banks, images_u8, depths_f16, poses, frame_indices):
        return banks, run(banks, images_u8, depths_f16, poses, frame_indices)
    return step


def _bytes_as(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, n) u8 columns reinterpreted as `dtype` along the last axis (a
    contiguous copy first: a column slice is strided)."""
    return seg.contiguous().view(dtype)


def unpack_payload(payload: torch.Tensor, frame_bytes: int):
    """Decode of a round's (B, frame_bytes + 72 + P) u8 payload: (frames
    (B, frame_bytes) u8, poses (B, 4, 4) f32, reference indices (B,) i32,
    bf (B,) f32, window masks (B, P) bool); the batched
    `fuse_step.unpack_aux`."""
    b = payload.shape[0]
    aux = payload[:, frame_bytes:]
    poses = _bytes_as(aux[:, :64], torch.float32).view(b, 4, 4)
    refs = _bytes_as(aux[:, 64:68], torch.int32)[:, 0]
    bf = _bytes_as(aux[:, 68:72], torch.float32)[:, 0]
    return (payload[:, :frame_bytes], poses, refs, bf,
            aux[:, AUX_HEAD_BYTES:].bool())


def _fuse_windowed(config, bank, image_u8, depth_f16, pose, frame_index,
                   pose_mask):
    return fuse_step.fuse_frame_windowed(config, bank, image_u8, depth_f16,
                                         pose, frame_index, pose_mask)[1]


def batched_onebuf_step(config: SurfelMapConfig, banks: SurfelBank,
                        payload: torch.Tensor) -> dict:
    """The windowed fuse step of every stream from ONE (B, 3 h w + 72 + P)
    u8 payload (each row `core.state.pack_frame_with_aux`): banks updated
    in place; returns the stats, (B,) each.  The batched
    `fuse_step.fuse_frame_onebuf`."""
    b = payload.shape[0]
    h, w = config.height, config.width
    frames, poses, refs, _, masks = unpack_payload(payload, 3 * h * w)
    images = frames[:, :h * w].reshape(b, h, w)
    depths = _bytes_as(frames[:, h * w:], torch.float16).view(b, h, w)
    return _vmap_banks(functools.partial(_fuse_windowed, config))(
        banks, images, depths, poses, refs, masks)


def _fuse_depth(config, bank, image, depth, pose, frame_index, pose_mask):
    return fuse_step.fuse_frame(config, bank, FrameInput(
        image=image, depth=depth, pose=pose, frame_index=frame_index),
        pose_mask=pose_mask)[1]


def batched_stereo_onebuf_step(config: SurfelMapConfig, stereo_config,
                               filter_depth: bool, banks: SurfelBank,
                               payload: torch.Tensor) -> dict:
    """The stereo-resident windowed step of every stream from ONE
    (B, 2 h w + 72 + P) u8 payload (each row
    `core.state.pack_stereo_with_aux`).  Each stream's depth comes from the
    on-device matcher (`fuse_step.compute_depth_stereo`, its map prior from
    that stream's bank), one stream after another into one (B, H, W)
    depth; the fuse step then runs once for all streams.  The batched
    `fuse_step.fuse_frame_stereo_onebuf`."""
    b = payload.shape[0]
    h, w = config.height, config.width
    ph, pw = config.padded_height, config.padded_width
    pad = (0, pw - w, 0, ph - h)
    frames, poses, refs, bf, masks = unpack_payload(payload, 2 * h * w)
    lefts, depths, rescued = [], [], []
    for k in range(b):
        left, right = fuse_step.unpack_stereo(config, frames[k])
        depth, n_rescued = fuse_step.compute_depth_stereo(
            config, stereo_config, left, right, bf[k], filter_depth,
            prior_depth=fuse_step._stereo_prior(
                config, stereo_config, stream_bank(banks, k), poses[k]))
        lefts.append(torch.nn.functional.pad(left, pad))
        depths.append(torch.nn.functional.pad(depth, pad))
        rescued.append(n_rescued)
    stats = _vmap_banks(functools.partial(_fuse_depth, config))(
        banks, torch.stack(lefts), torch.stack(depths), poses, refs, masks)
    stats["n_rescued_px"] = torch.stack(rescued)
    return stats


def batched_warp(banks: SurfelBank, warps: torch.Tensor, moved: torch.Tensor,
                 pose_masks: torch.Tensor, first_locals: torch.Tensor
                 ) -> None:
    """`ops/warp.warp_bank_by_pose` of every stream in one pass, in place:
    warps (B, P, 4, 4), moved (B, P), pose_masks (B, P), first_locals
    (B,) i32."""
    def one(bank, w, m, pm, first):
        warp_ops.warp_bank_by_pose(bank, w, m, pm, first)
        return bank.count          # vmap needs an output; unused
    _vmap_banks(one)(banks, warps, moved, pose_masks, first_locals)


def batched_compact(banks: SurfelBank) -> None:
    """`ops/fusion.compact_bank` of every stream in one pass, in place: a
    stable partition of each stream's rows by liveness."""
    def one(bank):
        fusion.compact_bank(bank)
        return bank.count          # vmap needs an output; unused
    _vmap_banks(one)(banks)

