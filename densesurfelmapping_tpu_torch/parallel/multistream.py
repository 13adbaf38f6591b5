"""Single-GPU multi-session mapping: the fuse step batched over B streams.

Counterpart of the JAX package's `parallel/multistream.py`.  Fleet/serving
mode on one device: B independent camera sessions fuse in one pass of ops
per round (batched banks, batched frames), where the JAX package runs
`jax.jit(jax.vmap(fuse_step))`.  Here the single-frame step of
`pipeline/fuse_step.py` runs under `torch.func.vmap`: every PyTorch op of the
step runs once for the B streams, and the three SLIC kernels reach their
stream axis through their vmap rule (`ops/cuda/slic.py`), one launch per
sweep for all streams.  In stereo mode the whole per-stream stereo step
(pair unpack, map prior, matcher, depth, filter, fuse) runs under the vmap,
and the SGM kernels reach theirs the same way (`ops/cuda/sgm.py`): one
matcher pass per round, one launch of B5 and of B6 for all streams.  Banks
are updated in place (the JAX package donates them).

The reference has no equivalent (one ROS process maps one session).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core.state import AUX_HEAD_BYTES, FIELDS, SurfelBank
from ..ops import fusion
from ..ops import warp as warp_ops
from ..pipeline import fuse_step

_BANK_KEYS = FIELDS + ("count",)


def make_banks(config: SurfelMapConfig, n_streams: int,
               device="cuda") -> SurfelBank:
    """Empty per-stream banks: every field gains a leading (B,) axis and
    `count` is (B,) i32; dead rows carry last_update = -1 as in
    `SurfelBank.empty`."""
    return empty_banks(config.surfel_capacity, n_streams, device)


def empty_banks(capacity: int, n_streams: int, device) -> SurfelBank:
    """`make_banks` of `capacity` rows a stream (a mesh cell's slabs)."""
    one = SurfelBank.empty(capacity, device)
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
    the single-frame ops land in the fleet's banks) and of every argument
    (tensors or containers of them; None passes through unbatched)."""
    def one(fields, *args):
        return fn(SurfelBank(**fields), *args)

    def run(banks: SurfelBank, *args):
        return torch.func.vmap(one, in_dims=(0,) + tuple(
            None if a is None else 0 for a in args))(
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


def unpack_frames(config: SurfelMapConfig, bufs: torch.Tensor):
    """Decode of (B, 3 h w) u8 packed frames (`core.state.pack_frame`
    rows): (images (B, h, w) u8, depths (B, h, w) f16); the batched
    `fuse_step.unpack_frame`, outside any vmap (a dtype view has no
    batching rule in every torch release)."""
    b = bufs.shape[0]
    h, w = config.height, config.width
    return (bufs[:, :h * w].reshape(b, h, w),
            _bytes_as(bufs[:, h * w:3 * h * w], torch.float16).view(b, h, w))


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
    frames, poses, refs, _, masks = unpack_payload(
        payload, 3 * config.height * config.width)
    return _vmap_banks(functools.partial(_fuse_windowed, config))(
        banks, *unpack_frames(config, frames), poses, refs, masks)


def graphed_onebuf_step(config: SurfelMapConfig, banks: SurfelBank,
                        pool=None) -> fuse_step.StepGraph:
    """`batched_onebuf_step` on `banks` as a `fuse_step.StepGraph` over the
    round's (B, 3 h w + 72 + P) payload: the whole round, B1-B3's batched
    launches (grid z = stream) included, in one captured graph replayed
    once per round.  The counterpart of the JAX fleet's jitted
    `_batched_onebuf_step` (densesurfelmapping_tpu/pipeline/
    multi_session.py:81-88)."""
    return fuse_step.StepGraph(
        lambda bk, buf: batched_onebuf_step(config, bk, buf), banks,
        (banks.count.shape[0], fuse_step.onebuf_bytes(config)), pool,
        keep=fuse_step.step_geometry(config, banks))


def _fuse_stereo(config, stereo_config, filter_depth, bank, frame, pose,
                 frame_index, bf, pose_mask):
    return fuse_step.fuse_frame_stereo_windowed_packed(
        config, stereo_config, filter_depth, bank, frame, pose, frame_index,
        bf, pose_mask)[1]


def batched_stereo_onebuf_step(config: SurfelMapConfig, stereo_config,
                               filter_depth: bool, banks: SurfelBank,
                               payload: torch.Tensor) -> dict:
    """The stereo-resident windowed step of every stream from ONE
    (B, 2 h w + 72 + P) u8 payload (each row
    `core.state.pack_stereo_with_aux`): one stream's whole step
    (`fuse_step.fuse_frame_stereo_windowed_packed`: the pair's unpack, the
    map prior from that stream's bank, the matcher, depth, filter, pad and
    fuse) under torch.func.vmap over the streams, as the JAX fleet vmaps
    `fuse_frame_stereo_onebuf`.  The matcher runs once for all streams:
    B5 and B6 (or B4 on the materialized branch) launch once per round
    through their vmap rules.  Banks updated in place; returns the stats,
    (B,) each, `n_rescued_px` among them."""
    frames, poses, refs, bf, masks = unpack_payload(
        payload, 2 * config.height * config.width)
    return _vmap_banks(functools.partial(
        _fuse_stereo, config, stereo_config, filter_depth))(
            banks, frames, poses, refs, bf, masks)


def graphed_stereo_onebuf_step(config: SurfelMapConfig, stereo_config,
                               filter_depth: bool, banks: SurfelBank,
                               pool=None) -> fuse_step.StepGraph:
    """`batched_stereo_onebuf_step` on `banks` as a `fuse_step.StepGraph`
    over the round's (B, 2 h w + 72 + P) payload: the one vmapped stereo
    step (one B6 and one B5 launch, or B4's on the materialized branch, and
    B1-B3's batched launches) in one captured graph replayed once per
    round.  The counterpart of the JAX fleet's jitted
    `_batched_stereo_onebuf_step` (densesurfelmapping_tpu/pipeline/
    multi_session.py:90-96)."""
    return fuse_step.StepGraph(
        lambda bk, buf: batched_stereo_onebuf_step(
            config, stereo_config, filter_depth, bk, buf), banks,
        (banks.count.shape[0], fuse_step.stereo_onebuf_bytes(config)), pool,
        keep=fuse_step.step_geometry(config, banks))


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


def graphed_warp(config: SurfelMapConfig, banks: SurfelBank,
                 pool=None) -> fuse_step.BankGraph:
    """`batched_warp` on `banks` as a `fuse_step.BankGraph` (the JAX
    fleet's jitted `_batched_warp`, densesurfelmapping_tpu/pipeline/
    multi_session.py:99-103).  Inputs, with P = config.max_keyframes:
    warps (B, P, 4, 4) f32, moved (B, P) bool, window masks (B, P) bool and
    first locals (B,) i32."""
    b, p = banks.count.shape[0], config.max_keyframes
    return fuse_step.BankGraph(
        batched_warp, banks, (((b, p, 4, 4), torch.float32),
                              ((b, p), torch.bool), ((b, p), torch.bool),
                              ((b,), torch.int32)), pool)


def graphed_compact(banks: SurfelBank, pool=None) -> fuse_step.BankGraph:
    """`batched_compact` on `banks` as a `fuse_step.BankGraph` (the JAX
    fleet's jitted `_batched_compact`, densesurfelmapping_tpu/pipeline/
    multi_session.py:106-108)."""
    return fuse_step.BankGraph(batched_compact, banks, (), pool)
