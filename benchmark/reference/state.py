"""The reference's device state: the surfel bank, the superpixel seed grid
and a frame as dataclasses of tensors (a frozen copy of the port's
`core/state.py`, without its host codecs)."""

from __future__ import annotations

import dataclasses

import torch

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
