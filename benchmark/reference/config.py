"""Typed configuration of the PyTorch port (a jax-free copy of
`densesurfelmapping_tpu/config.py`: same dataclasses, same field names, same
JSON, so a config round-trips between the two packages).

The reference (HKUST-Aerial-Robotics/DenseSurfelMapping) spreads its
configuration over three uncoordinated layers: ROS launch params
(`surfel_fusion/launch/kitti_orb.launch:5-19`), compile-time #defines with a
comment-toggled driving-vs-RGBD profile (`surfel_fusion/src/fusion_functions.h:7-21`),
and an OpenCV YAML for the SLAM front-end.  Here everything lives in one
frozen dataclass so a config is a hashable static argument of jitted code,
with the drive/RGBD profiles exposed as named presets.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model (reference: cam_fx/fy/cx/cy ROS params,
    `surfel_map.cpp:14-29`)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def mean_focal(self) -> float:
        # camera_f = (|fx| + |fy|) / 2 (`fusion_functions.cpp:250`)
        return (abs(self.fx) + abs(self.fy)) / 2.0


# KITTI odometry gray sequences 00-02 (reference: kitti_orb.launch:5-10,
# kitti00-02.yaml).
KITTI_00_INTRINSICS = CameraIntrinsics(
    width=1241, height=376,
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
)


@dataclasses.dataclass(frozen=True)
class FusionProfile:
    """Sensor-noise profile.

    Mirrors the #define block toggled by comments in the reference
    (`fusion_functions.h:12-21`): `huber_range` bounds the robust-fit
    residual, `baseline`/`disparity_error` model the stereo depth noise used
    to derive the projective-association depth gate, `min_tolerate_diff`
    floors that gate.
    """

    huber_range: float
    baseline: float
    disparity_error: float
    min_tolerate_diff: float


# "for drive" profile (`fusion_functions.h:13-16`)
DRIVE_PROFILE = FusionProfile(
    huber_range=0.4, baseline=0.5, disparity_error=4.0, min_tolerate_diff=0.1)
# "for RGBD" profile (`fusion_functions.h:18-21`)
RGBD_PROFILE = FusionProfile(
    huber_range=0.05, baseline=0.08, disparity_error=1.0, min_tolerate_diff=0.05)


@dataclasses.dataclass(frozen=True)
class SurfelMapConfig:
    """Full configuration of the mapping core.

    Static shapes are the key TPU design decision: image dims are padded so
    the lane dimension tiles onto the VPU/MXU, and the surfel store has a
    fixed capacity with masked validity instead of std::vector push_back.
    """

    camera: CameraIntrinsics
    profile: FusionProfile = DRIVE_PROFILE

    # --- superpixel engine (reference fusion_functions.h:7-11) ---
    sp_size: int = 8              # SP_SIZE: superpixel grid pitch in px
    sp_iters: int = 3             # ITERATION_NUM
    max_angle_cos: float = 0.1    # MAX_ANGLE_COS view-angle gate

    # --- fusion gates (reference kitti_orb.launch:15-16) ---
    fuse_near: float = 0.5        # fuse_near_distence
    fuse_far: float = 30.0        # fuse_far_distence

    # --- surfel lifecycle ---
    drift_free_poses: int = 10    # BFS radius of the active window (launch:19)
    stale_frames: int = 5         # idle>5 & update_times<5 => kill
    stable_update_times: int = 5  # surfel is "stable" once fused >=5 times

    # --- TPU capacity planning (no reference equivalent: replaces
    #     std::vector dynamic growth with fixed-capacity device arrays) ---
    surfel_capacity: int = 1 << 19      # active surfel SoA rows
    new_surfel_buffer: int = 0          # 0 => derived from sp grid
    migration_buffer: int = 1 << 15     # max surfels moved per migration call
    compaction_slack: int = 1 << 16     # dead rows tolerated before repack

    # --- host/device interface ---
    # frames ride to the device as u8 intensity + f16 depth (<=0.05% depth
    # quantization, far inside the association gates) instead of 2x f32
    compact_upload: bool = True
    # fuse-step stats (and the compaction decision) sync device->host every
    # N frames; each sync is a blocking transfer, so N amortizes RPC latency
    stats_interval: int = 8
    # device-resident-pool mode: static keyframe bound (active-window mask
    # length) and the fixed no-readback compaction schedule
    max_keyframes: int = 8192
    compact_interval: int = 256

    # padding alignment for the image tensors
    lane_align: int = 128
    sublane_align: int = 8

    # ------------------------------------------------------------------
    # derived static geometry
    # ------------------------------------------------------------------
    @property
    def width(self) -> int:
        return self.camera.width

    @property
    def height(self) -> int:
        return self.camera.height

    @property
    def padded_width(self) -> int:
        # pad W so the (last) lane dim is 128-aligned AND a multiple of
        # sp_size so the seed grid tiles exactly.
        m = self.lane_align * self.sp_size // _gcd(self.lane_align, self.sp_size)
        return _round_up(self.camera.width, m)

    @property
    def padded_height(self) -> int:
        m = self.sublane_align * self.sp_size // _gcd(self.sublane_align, self.sp_size)
        return _round_up(self.camera.height, m)

    @property
    def sp_cols(self) -> int:
        """Padded seed-grid width (device tensor dim)."""
        return self.padded_width // self.sp_size

    @property
    def sp_rows(self) -> int:
        return self.padded_height // self.sp_size

    @property
    def valid_sp_cols(self) -> int:
        """Seed-grid width the reference would use: image_width / SP_SIZE
        with integer truncation (`fusion_functions.cpp:14`)."""
        return self.camera.width // self.sp_size

    @property
    def valid_sp_rows(self) -> int:
        return self.camera.height // self.sp_size

    @property
    def num_seeds(self) -> int:
        return self.sp_cols * self.sp_rows

    @property
    def window(self) -> int:
        """Side length of the per-seed pixel window (2*SP_SIZE)."""
        return 2 * self.sp_size

    @property
    def new_capacity(self) -> int:
        if self.new_surfel_buffer:
            return self.new_surfel_buffer
        return self.num_seeds

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "SurfelMapConfig":
        raw = json.loads(text)
        raw["camera"] = CameraIntrinsics(**raw["camera"])
        raw["profile"] = FusionProfile(**raw["profile"])
        return SurfelMapConfig(**raw)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def kitti_config(**overrides) -> SurfelMapConfig:
    """KITTI seq 00-02 stereo preset (drive profile)."""
    return SurfelMapConfig(camera=KITTI_00_INTRINSICS, profile=DRIVE_PROFILE,
                           **overrides)


def rgbd_config(camera: Optional[CameraIntrinsics] = None, **overrides) -> SurfelMapConfig:
    """RGB-D / VINS preset (tight-noise profile, short range)."""
    cam = camera or CameraIntrinsics(
        width=640, height=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5)
    overrides.setdefault("fuse_near", 0.1)
    overrides.setdefault("fuse_far", 5.0)
    return SurfelMapConfig(camera=cam, profile=RGBD_PROFILE, **overrides)


def mono_config(camera: Optional[CameraIntrinsics] = None, **overrides) -> SurfelMapConfig:
    """Monocular preset: noisy learned depth => widest gates of the drive
    profile plus aggressive staleness kills."""
    cam = camera or KITTI_00_INTRINSICS
    overrides.setdefault("stale_frames", 3)
    return SurfelMapConfig(camera=cam, profile=DRIVE_PROFILE, **overrides)
