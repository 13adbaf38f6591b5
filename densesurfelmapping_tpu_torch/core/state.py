"""Device state as dataclasses of tensors (structure-of-arrays, static
capacity), plus the host-side numpy frame codecs.

Counterpart of the JAX package's `core/state.py`: the same fields, shapes and
dtypes, as plain dataclasses of `torch.Tensor`s on one device.  The surfel
store (reference `SurfelElement`, `elements.h:22-31`) has a fixed capacity
with masked liveness; the fuse step updates it in place.  The codecs are the
numpy encoding path of the JAX package; f32 frames take the native C++
encoder (`native/loader.py`) where it is available, which is pinned bitwise
to the numpy path by the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SurfelMapConfig

# per-surfel fields of SurfelBank, in the JAX package's order
FIELDS = ("position", "normal", "color", "size", "weight",
          "update_times", "last_update")


@dataclasses.dataclass
class SurfelBank:
    """Fixed-capacity surfel store (reference SurfelElement, `elements.h:22-31`).

    Rows [0, count) are allocated; a row is *live* iff update_times > 0.
    `count` is a 0-d int32 tensor on the bank's device, so no step needs to
    read it on the host.
    """

    position: torch.Tensor       # (N, 3) f32, world frame
    normal: torch.Tensor         # (N, 3) f32, world frame, unit
    color: torch.Tensor          # (N,)   f32, mean intensity 0..255
    size: torch.Tensor           # (N,)   f32, surfel radius (m)
    weight: torch.Tensor         # (N,)   f32, accumulated fusion weight
    update_times: torch.Tensor   # (N,)   i32, #fusions; 0 == dead slot
    last_update: torch.Tensor    # (N,)   i32, keyframe index of last fuse
    count: torch.Tensor          # ()     i32, allocated prefix length

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def live_mask(self) -> torch.Tensor:
        in_prefix = torch.arange(self.capacity, dtype=torch.int32,
                                 device=self.device) < self.count
        return in_prefix & (self.update_times > 0)

    @staticmethod
    def empty(capacity: int, device) -> "SurfelBank":
        f = dict(dtype=torch.float32, device=device)
        i = dict(dtype=torch.int32, device=device)
        return SurfelBank(
            position=torch.zeros((capacity, 3), **f),
            normal=torch.zeros((capacity, 3), **f),
            color=torch.zeros((capacity,), **f),
            size=torch.zeros((capacity,), **f),
            weight=torch.zeros((capacity,), **f),
            update_times=torch.zeros((capacity,), **i),
            last_update=torch.full((capacity,), -1, **i),
            count=torch.zeros((), **i),
        )

    def field_arrays(self):
        """(name, tensor) pairs of the per-surfel fields (excludes count)."""
        return [(k, getattr(self, k)) for k in FIELDS]


def bank_from_numpy(fields: dict, count: int, device,
                    capacity: int) -> SurfelBank:
    """A bank of `capacity` rows whose first `count` rows are the given
    numpy fields (e.g. the `bank_*` arrays of a checkpoint written by either
    package); the rest are empty rows."""
    if count > capacity:
        raise ValueError(f"{count} surfels exceed the capacity {capacity}")
    bank = SurfelBank.empty(capacity, "cpu")
    for k, t in bank.field_arrays():
        t[:count] = torch.from_numpy(np.ascontiguousarray(fields[k][:count]))
    bank.count.fill_(count)
    return SurfelBank(**{f.name: getattr(bank, f.name).to(device)
                         for f in dataclasses.fields(SurfelBank)})


def bank_to_numpy(bank: SurfelBank) -> dict:
    """Host copy of the allocated rows [0, count): {field: numpy array}
    (one device-to-host transfer per field; off the hot path).  Always a
    copy, also of a CPU bank, which the fuse step updates in place."""
    n = int(bank.count)
    return {k: t[:n].to("cpu", copy=True).numpy()
            for k, t in bank.field_arrays()}


@dataclasses.dataclass
class SuperpixelState:
    """Per-frame superpixel seed grid (reference Superpixel_seed,
    `elements.h:5-20`), laid out as (sp_rows, sp_cols) field planes."""

    x: torch.Tensor               # (R, C) f32, centroid pixel col
    y: torch.Tensor               # (R, C) f32, centroid pixel row
    mean_intensity: torch.Tensor  # (R, C) f32
    mean_depth: torch.Tensor      # (R, C) f32, 0 == no depth
    size: torch.Tensor            # (R, C) f32, max pixel radius
    norm: torch.Tensor            # (R, C, 3) f32, camera-frame normal (0 == unset)
    pos: torch.Tensor             # (R, C, 3) f32, camera-frame center on plane
    view_cos: torch.Tensor        # (R, C) f32
    stable: torch.Tensor          # (R, C) bool, SLIC convergence latch
    fused: torch.Tensor           # (R, C) bool, claimed by a surfel this frame

    def replace(self, **kw) -> "SuperpixelState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class FrameInput:
    """One synchronized (intensity, depth, pose) observation; the pose is
    camera-to-world (Twc), `frame_index` the reference keyframe index."""

    image: torch.Tensor        # (H, W) f32, intensity 0..255 (padded)
    depth: torch.Tensor        # (H, W) f32, metric depth, 0 == invalid (padded)
    pose: torch.Tensor         # (4, 4) f32, Twc
    frame_index: torch.Tensor  # ()     i32


def pad_frame(config: SurfelMapConfig, image: np.ndarray, depth: np.ndarray):
    """Pad raw (H, W) image/depth to the config's aligned device shape
    (padding pixels: intensity 0, depth 0 == invalid)."""
    ph, pw = config.padded_height, config.padded_width
    h, w = image.shape
    if (h, w) != (config.height, config.width):
        raise ValueError(f"frame shape {(h, w)} != config camera "
                         f"{(config.height, config.width)}")
    out_img = np.zeros((ph, pw), np.float32)
    out_dep = np.zeros((ph, pw), np.float32)
    out_img[:h, :w] = image
    out_dep[:h, :w] = depth
    return out_img, out_dep


def compact_frame(config: SurfelMapConfig, image: np.ndarray,
                  depth: np.ndarray):
    """Compact frame encoding: u8 intensity (exact for camera images) and f16
    depth (<=0.05% relative quantization, far inside the association gate,
    tolerate_diff >= 0.1 m).  An input that is already u8/f16 is returned
    as is, so callers must not mutate a fed frame buffer afterwards."""
    h, w = image.shape
    if (h, w) != (config.height, config.width):
        raise ValueError(f"frame shape {(h, w)} != config camera "
                         f"{(config.height, config.width)}")
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    depth = np.asarray(depth)
    if depth.dtype != np.float16:
        # f16 overflow becomes +-inf, which every depth gate rejects
        depth = depth.astype(np.float16)
    return np.ascontiguousarray(image), np.ascontiguousarray(depth)


def pack_frame(config: SurfelMapConfig, image: np.ndarray,
               depth: np.ndarray) -> np.ndarray:
    """One-buffer frame encoding: u8 intensity bytes followed by the f16
    depth bytes, as a single (3*H*W,) u8 array.

    f32 inputs take the native C++ encoder (clip/convert in one
    memory-bound pass); other dtypes, or no native library, the numpy
    path."""
    image = np.asarray(image)
    depth = np.asarray(depth)
    if image.dtype == np.float32 and depth.dtype == np.float32:
        from ..native import loader as native
        if native.available():
            if image.shape != (config.height, config.width):
                raise ValueError(f"frame shape {image.shape} != config "
                                 f"camera {(config.height, config.width)}")
            return native.pack_frame(image, depth)
    ci, cd = compact_frame(config, image, depth)
    return np.concatenate([ci.reshape(-1), cd.reshape(-1).view(np.uint8)])


def pack_stereo_pair(config: SurfelMapConfig, left: np.ndarray,
                     right: np.ndarray) -> np.ndarray:
    """One-buffer stereo-pair encoding: left u8 bytes then right u8 bytes, a
    single (2*H*W,) u8 array (the depth is computed on the device by
    `pipeline.fuse_step.fuse_frame_stereo_packed`).  u8 camera images pass
    as they are; other dtypes are clipped and converted."""
    out = []
    for name, img in (("left", left), ("right", right)):
        img = np.asarray(img)
        if img.shape != (config.height, config.width):
            raise ValueError(f"{name} shape {img.shape} != camera "
                             f"{(config.height, config.width)}")
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(img.reshape(-1))
    return np.concatenate(out)


def pack_stereo_with_aux(config: SurfelMapConfig, pair_buf: np.ndarray,
                         aux: np.ndarray) -> np.ndarray:
    """`pack_stereo_pair` bytes followed by `pack_aux` bytes as ONE u8
    buffer.  Decoded by `pipeline.fuse_step.fuse_frame_stereo_onebuf`."""
    aux = np.asarray(aux, np.uint8)
    out = np.empty(pair_buf.shape[0] + aux.shape[0], np.uint8)
    out[:pair_buf.shape[0]] = pair_buf
    out[pair_buf.shape[0]:] = aux
    return out


AUX_HEAD_BYTES = 72   # pose f32 (64) + frame index i32 (4) + bf f32 (4)


def pack_aux(pose: np.ndarray, frame_index: int, window_mask: np.ndarray,
             bf: float = 0.0) -> np.ndarray:
    """Per-frame small-argument buffer: pose + frame index + stereo bf +
    active-window mask as ONE (72 + max_keyframes,) u8 array.  Decoded on
    the device by `pipeline.fuse_step.unpack_aux`."""
    mask = np.asarray(window_mask)
    out = np.empty(AUX_HEAD_BYTES + mask.shape[0], np.uint8)
    out[:64] = np.ascontiguousarray(
        pose, np.float32).reshape(16).view(np.uint8)
    out[64:68] = np.array([frame_index], np.int32).view(np.uint8)
    out[68:72] = np.array([bf], np.float32).view(np.uint8)
    out[72:] = mask.astype(np.uint8)
    return out


def pack_frame_with_aux(config: SurfelMapConfig, image: np.ndarray,
                        depth: np.ndarray, aux: np.ndarray) -> np.ndarray:
    """`pack_frame` bytes followed by `pack_aux` bytes as ONE u8 buffer: the
    whole per-frame payload in a single host-to-device copy.  Decoded by
    `pipeline.fuse_step.fuse_frame_onebuf`."""
    n = config.height * config.width
    aux = np.asarray(aux, np.uint8)
    out = np.empty(3 * n + aux.shape[0], np.uint8)
    image = np.asarray(image)
    depth = np.asarray(depth)
    wrote = False
    if image.dtype == np.float32 and depth.dtype == np.float32:
        if image.shape != (config.height, config.width):
            raise ValueError(f"frame shape {image.shape} != config camera "
                             f"{(config.height, config.width)}")
        from ..native import loader as native
        # f32 frames encode straight into the output (no concatenate copy)
        wrote = native.pack_frames_into([image], [depth], [out[:3 * n]])
    if not wrote:
        out[:3 * n] = pack_frame(config, image, depth)
    out[3 * n:] = aux
    return out

