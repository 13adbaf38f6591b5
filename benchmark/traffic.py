"""The general traffic generator: one drive through a town, as a SLAM
front-end would publish it to the mapper.

Every mix is a data file under `workloads/` that this module reads:

* the route (`route_m`: waypoints of axis-aligned streets in metres, x east
  and z north, the corners driven as arcs of `turn_radius_m`), sampled at
  `route_frames` frames over its length;
* the town along it (`world_seed`; buildings on both sides of every street
  at `setback_m` from its centre line, with the sizes and gaps given);
* ORB-SLAM2's cadence: a keyframe every `keyframe_every` frames,
  `covisibility` edges to the `covis_back` newest keyframes, revisit edges
  to older keyframes within `revisit_radius_m` that look the same way
  (within `revisit_heading_deg`), at most `max_edges`, and the full
  keyframe path every frame;
* the tracked pose's drift: odometry whose every frame errs by
  `drift_yaw_rad` of heading and `drift_trans_m` sideways in the camera's
  own frame, so the error grows with the distance driven; and a loop
  closure where the route comes back onto a street it has driven (the
  first revisit after `closure_gap_keyframes` keyframes without one),
  which snaps the path to ground truth and resets the drift;
* how many frames warm the program up (`warmup_frames`) and how many the
  check samples in the window (`samples`).

The world and the drive are one for every seed; the seed picks the drift's
directions, which order the same work differently.  The route's frames are
rendered once, on the device, by a torch copy of `io/synthetic.Scene.render`
(for a level camera), and kept on the host as a sensor's messages arrive.
Past the route's end the drive starts over along it, as a second pass.
"""

from __future__ import annotations

import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

BASELINE_M = 0.54    # KITTI's stereo baseline: right camera along camera x
GROUND_Y = 1.5       # +y down: the ground 1.5 m below the camera
MAX_DEPTH = 25.0     # `Scene.max_depth` of the stress scene
FAR = 1e6            # a padding box, farther than anything seen


@dataclasses.dataclass(frozen=True)
class Mix:
    """One traffic mix (`workloads/<name>.json`)."""

    route_m: Tuple[Tuple[float, float], ...]
    route_frames: int = 4541
    turn_radius_m: float = 8.0
    world_seed: int = 0
    setback_m: Tuple[float, float] = (6.0, 10.0)
    building_len_m: Tuple[float, float] = (8.0, 20.0)
    building_depth_m: Tuple[float, float] = (5.0, 12.0)
    building_height_m: Tuple[float, float] = (3.0, 12.0)
    gap_m: Tuple[float, float] = (2.0, 6.0)
    clear_m: float = 5.0
    keyframe_every: int = 2
    drift_yaw_rad: float = 1.2e-3
    drift_trans_m: float = 2.5e-3
    covis_back: int = 4
    revisit_radius_m: float = 2.0
    revisit_heading_deg: float = 45.0
    closure_gap_keyframes: int = 10
    max_edges: int = 35
    warmup_frames: int = 300
    samples: int = 3

    @staticmethod
    def load(path: Path) -> "Mix":
        raw = json.loads(Path(path).read_text())
        raw.pop("why", None)
        return Mix(**{k: (tuple(tuple(p) for p in v) if k == "route_m" else
                          tuple(v) if isinstance(v, list) else v)
                      for k, v in raw.items()})


# ----------------------------------------------------------------------
# the route: straight legs, corners as arcs, sampled by arc length
# ----------------------------------------------------------------------
def _heading(d) -> float:
    """Heading angle of a direction (x, z): forward is (sin, cos)."""
    return math.atan2(d[0], d[1])


def route_path(mix: Mix) -> Tuple[np.ndarray, np.ndarray]:
    """(positions (N, 2) as (x, z), headings (N,)) of the route's frames,
    equally spaced along it."""
    pts = np.asarray(mix.route_m, float)
    r = mix.turn_radius_m
    # pieces: ("line", start, heading, length) | ("arc", start, h0, sign, len)
    pieces = []
    start = pts[0]
    for k in range(1, len(pts)):
        d1 = pts[k] - pts[k - 1]
        h1 = _heading(d1)
        if k + 1 < len(pts):
            d2 = pts[k + 1] - pts[k]
            turn = math.remainder(_heading(d2) - h1, 2 * math.pi)
            cut = r * math.tan(abs(turn) / 2)
        else:
            turn, cut = 0.0, 0.0
        end = pts[k] - cut * d1 / np.linalg.norm(d1)
        pieces.append(("line", start, h1, float(np.linalg.norm(end - start))))
        if turn:
            pieces.append(("arc", end, h1, math.copysign(1.0, turn),
                           r * abs(turn)))
            d2u = d2 / np.linalg.norm(d2)
            start = pts[k] + cut * d2u
    lengths = np.array([p[-1] for p in pieces])
    total = lengths.sum()
    s = np.arange(mix.route_frames) * (total / mix.route_frames)
    edges = np.concatenate([[0.0], np.cumsum(lengths)])
    pos = np.zeros((mix.route_frames, 2))
    head = np.zeros(mix.route_frames)
    for j, p in enumerate(pieces):
        sel = (s >= edges[j]) & (s < edges[j + 1])
        u = s[sel] - edges[j]
        if p[0] == "line":
            _, a, h, _ = p
            pos[sel] = a + u[:, None] * np.array([math.sin(h), math.cos(h)])
            head[sel] = h
        else:
            _, a, h0, sign, _ = p
            h = h0 + sign * u / r
            pos[sel, 0] = a[0] + r * sign * (math.cos(h0) - np.cos(h))
            pos[sel, 1] = a[1] + r * sign * (np.sin(h) - math.sin(h0))
            head[sel] = h
    return pos, head


def level_pose(x: float, z: float, heading: float) -> np.ndarray:
    """Camera-to-world pose of a level camera at (x, 0, z), +z along the
    heading (as `circuit_trajectory` builds its poses)."""
    z_cam = np.array([math.sin(heading), 0.0, math.cos(heading)])
    y_cam = np.array([0.0, 1.0, 0.0])
    x_cam = np.cross(y_cam, z_cam)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2] = x_cam, y_cam, z_cam
    T[:3, 3] = (x, 0.0, z)
    return T


def route_poses(mix: Mix) -> np.ndarray:
    pos, head = route_path(mix)
    return np.stack([level_pose(p[0], p[1], h) for p, h in zip(pos, head)])


# ----------------------------------------------------------------------
# the town: buildings along the streets
# ----------------------------------------------------------------------
def _gap2d(a, b) -> float:
    """Distance between two (x0, z0, x1, z1) rectangles."""
    dx = max(0.0, a[0] - b[2], b[0] - a[2])
    dz = max(0.0, a[1] - b[3], b[1] - a[3])
    return math.hypot(dx, dz)


def town(mix: Mix) -> np.ndarray:
    """(n, 2, 3) boxes (lo, hi), standing on the ground on both sides of
    every leg of the route, none within `clear_m` of a street's centre line
    nor overlapping another."""
    rng = np.random.default_rng(mix.world_seed)
    pts = np.asarray(mix.route_m, float)
    streets = [(min(a[0], b[0]), min(a[1], b[1]), max(a[0], b[0]),
                max(a[1], b[1])) for a, b in zip(pts[:-1], pts[1:])]
    placed: List[tuple] = []
    boxes = []
    U = lambda lohi: rng.uniform(*lohi)    # noqa: E731
    for a, b in zip(pts[:-1], pts[1:]):
        d = (b - a) / np.linalg.norm(b - a)
        n = np.array([d[1], -d[0]])
        length = float(np.linalg.norm(b - a))
        for side in (-1.0, 1.0):
            s = -mix.setback_m[0]
            while s < length + mix.setback_m[0]:
                ln, dp, off = (U(mix.building_len_m), U(mix.building_depth_m),
                               U(mix.setback_m))
                c0 = a + d * s + n * side * off
                c1 = a + d * (s + ln) + n * side * (off + dp)
                rect = (min(c0[0], c1[0]), min(c0[1], c1[1]),
                        max(c0[0], c1[0]), max(c0[1], c1[1]))
                s += ln + U(mix.gap_m)
                if any(_gap2d(rect, st) < mix.clear_m for st in streets) \
                        or any(_gap2d(rect, q) <= 0.0 for q in placed):
                    continue
                placed.append(rect)
                h = U(mix.building_height_m)
                boxes.append(((rect[0], GROUND_Y - h, rect[1]),
                              (rect[2], GROUND_Y, rect[3])))
    return np.asarray(boxes, float).reshape(-1, 2, 3)


def visible_boxes(boxes: np.ndarray, poses: np.ndarray,
                  camera) -> np.ndarray:
    """(F, n) whether a ray of each level camera can hit each box before
    MAX_DEPTH: the box lies in front of it, inside its horizontal field of
    view, and nearer than MAX_DEPTH times its longest ray (a ray's
    parameter is the camera z, the depth).  Leaving the others out changes
    no pixel."""
    u0 = (0 - camera.cx) / camera.fx
    u1 = (camera.width - 1 - camera.cx) / camera.fx
    v = max(abs(camera.cy), abs(camera.height - 1 - camera.cy)) / camera.fy
    reach = MAX_DEPTH * math.sqrt(1 + max(u0 * u0, u1 * u1) + v * v) + 1.0
    tx, tz = poses[:, 0, 3, None], poses[:, 2, 3, None]          # (F, 1)
    lo, hi = boxes[None, :, 0], boxes[None, :, 1]                 # (1, n, 3)
    near_x = np.clip(tx, lo[..., 0], hi[..., 0])
    near_z = np.clip(tz, lo[..., 2], hi[..., 2])
    close = np.hypot(near_x - tx, near_z - tz) < reach
    # the footprint's corners in camera x and z: (F, n, 4)
    cx = np.stack([b[..., 0] for b in (lo, lo, hi, hi)], -1) - tx[..., None]
    cz = np.stack([b[..., 2] for b in (lo, hi, lo, hi)], -1) - tz[..., None]
    r = poses[:, None, None]
    xc = r[..., 0, 0] * cx + r[..., 2, 0] * cz
    zc = r[..., 0, 2] * cx + r[..., 2, 2] * cz
    eps = 1e-6
    behind = (zc <= 0.05 + eps).all(-1)
    left = (xc < u0 * zc - eps).all(-1)
    right = (xc > u1 * zc + eps).all(-1)
    return close & ~behind & ~left & ~right


# ----------------------------------------------------------------------
# the render
# ----------------------------------------------------------------------
def render(boxes: np.ndarray, camera, poses: np.ndarray, device,
           dtype=torch.float64):
    """`Scene.render` of the stress scene in torch, for level cameras: the
    ray-cast z-depth and the default texture of F frames at once.  boxes
    (F, K, 2, 3) are each frame's (padded with far boxes), poses
    (F, 4, 4) camera-to-world with a level camera (yaw only), so a ray's x
    and z depend on its column only and its y on its row only.  Returns
    (image f32 (F, H, W) floored to 0..255, depth f32 (F, H, W), 0 == no
    hit)."""
    f = dict(dtype=dtype, device=device)
    h, w = camera.height, camera.width
    u = (torch.arange(w, **f) - camera.cx) / camera.fx             # (W,)
    v = (torch.arange(h, **f) - camera.cy) / camera.fy             # (H,)
    P = torch.as_tensor(poses, **f)
    t = P[:, :3, 3]                                               # (F, 3)
    ax = u[None] * P[:, 0, 0, None] + P[:, 0, 2, None]           # (F, W)
    az = u[None] * P[:, 2, 0, None] + P[:, 2, 2, None]
    ay = v[None].expand(len(P), h)                                # (F, H)
    inf = torch.tensor(math.inf, **f)
    t_g = torch.where(ay.abs() > 1e-9, (GROUND_Y - t[:, 1, None]) / ay, inf)
    t_g = torch.where(t_g > 0, t_g, inf)
    z = torch.where(t_g > 0.05, t_g, inf)[:, :, None].expand(-1, h, w)
    z = z.contiguous()
    B = torch.as_tensor(boxes, **f)                               # (F,K,2,3)

    def slab(lo, hi, org, inv):
        t0, t1 = (lo - org) * inv, (hi - org) * inv
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    xa = slab(B[:, :, 0, 0, None], B[:, :, 1, 0, None],
              t[:, None, 0, None], (1.0 / ax)[:, None])           # (F,K,W)
    za = slab(B[:, :, 0, 2, None], B[:, :, 1, 2, None],
              t[:, None, 2, None], (1.0 / az)[:, None])
    ya = slab(B[:, :, 0, 1, None], B[:, :, 1, 1, None],
              t[:, None, 1, None], (1.0 / ay)[:, None])           # (F,K,H)
    # a box's entry is the largest of the three axes' entries, its exit the
    # smallest of their exits (max and min are exact in any order)
    lo_xz = torch.maximum(xa[0], za[0])
    hi_xz = torch.minimum(xa[1], za[1])
    for k in range(B.shape[1]):
        tn = torch.maximum(lo_xz[:, k, None, :], ya[0][:, k, :, None])
        tx = torch.minimum(hi_xz[:, k, None, :], ya[1][:, k, :, None])
        # `_ray_box` then `consider`: a hit in front, nearer than the last
        z = torch.where((tx >= tn) & (tn > 0.05) & (tn < z), tn, z)
    finite = torch.isfinite(z)
    depth = torch.where(finite & (z < MAX_DEPTH), z, 0.0)
    safe_z = torch.where(finite, z, 0.0)
    X = t[:, 0, None, None] + ax[:, None, :] * safe_z
    Y = t[:, 1, None, None] + ay[:, :, None] * safe_z
    Z = t[:, 2, None, None] + az[:, None, :] * safe_z
    tex = 128 + 55 * torch.sin(X * 7 * 0.23) * torch.cos(Z * 9 * 0.31) \
        + 30 * torch.sin(Y * 5)
    image = torch.floor(torch.where(depth > 0, tex, 20.0)).clamp(0, 255)
    return image.float(), depth.float()


@dataclasses.dataclass
class Frames:
    """The route's ground-truth poses and the sensor frames rendered there,
    on the host: u8 intensity and f32 depth (`publisher.py`'s messages),
    or for stereo the u8 left and right images."""

    poses: np.ndarray                 # (N, 4, 4)
    images: np.ndarray                # (N, H, W) u8
    depths: Optional[np.ndarray]      # (N, H, W) f32, depth-fed only
    rights: Optional[np.ndarray]      # (N, H, W) u8, stereo only


def padded_boxes(boxes: np.ndarray, camera, poses: np.ndarray) -> np.ndarray:
    """(F, K, 2, 3): each frame's visible boxes, padded with far boxes to
    the most any frame sees."""
    vis = [np.flatnonzero(m) for m in visible_boxes(boxes, poses, camera)]
    K = max(1, max(len(i) for i in vis))
    out = np.tile(np.array([[FAR, 0.0, FAR], [FAR + 1, 1.0, FAR + 1]]),
                  (len(poses), K, 1, 1))
    for f, idx in enumerate(vis):
        out[f, :len(idx)] = boxes[idx]
    return out


def render_route(mix: Mix, camera, device, stereo: bool,
                 chunk: int = 32) -> Frames:
    """Every frame of the route, rendered on `device` in chunks, then
    copied in one go to host arrays: page-locked on a CUDA device (their
    allocation overlaps the render), since faulting in ~10 GB of fresh
    pageable memory costs seconds more."""
    device = torch.device(device)
    poses = route_poses(mix)
    boxes = town(mix)
    n, h, w = len(poses), camera.height, camera.width
    kinds = {"images": torch.uint8}
    kinds.update({"rights": torch.uint8} if stereo
                 else {"depths": torch.float32})
    pin = device.type == "cuda"
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: {
            k: torch.empty((n, h, w), dtype=dt, pin_memory=pin)
            for k, dt in kinds.items()})
        on_dev = {k: torch.empty((n, h, w), dtype=dt, device=device)
                  for k, dt in kinds.items()}
        for a in range(0, n, chunk):
            sl = slice(a, min(n, a + chunk))
            img, dep = render(padded_boxes(boxes, camera, poses[sl]), camera,
                              poses[sl], device)
            on_dev["images"][sl] = img.to(torch.uint8)
            if stereo:
                rp = poses[sl].copy()
                rp[:, :3, 3] += rp[:, :3, 0] * BASELINE_M
                on_dev["rights"][sl] = render(
                    padded_boxes(boxes, camera, rp), camera, rp,
                    device)[0].to(torch.uint8)
            else:
                on_dev["depths"][sl] = dep
        host = host.result()
    for k, t in host.items():
        t.copy_(on_dev[k])
    arrays = {k: t.numpy() for k, t in host.items()}
    return Frames(poses, arrays["images"], arrays.get("depths"),
                  arrays.get("rights"))


# ----------------------------------------------------------------------
# the pose stream (`make_seq00_like`'s publication along the route)
# ----------------------------------------------------------------------
def drift_delta(yaw: float, trans: float) -> np.ndarray:
    d = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    d[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    d[0, 3] = trans
    return d


@dataclasses.dataclass
class Message:
    """One pose message as `feed_pose` takes it, with the route frame it
    belongs to; `path_delta` holds the entries of the published path that
    differ from the previous message's (the record the reference replays)."""

    stamp: float
    pose: np.ndarray
    is_keyframe: bool
    reference_index: int
    loop_path: List[np.ndarray]
    loop_edges: List[tuple]
    frame_index: int
    path_delta: Dict[int, np.ndarray]
    closure: bool


class PoseStream:
    """The drifting SLAM estimate of one camera along the route: frame i is
    route frame i % route_frames."""

    def __init__(self, mix: Mix, gt: np.ndarray, drift_sign: tuple):
        self.mix = mix
        self.gt = gt
        self.delta = drift_delta(drift_sign[0] * mix.drift_yaw_rad,
                                 drift_sign[1] * mix.drift_trans_m)
        self.last: Optional[tuple] = None    # (ground truth, estimate)
        self.kf_est: List[np.ndarray] = []
        self.kf_frame: List[int] = []
        self.kf_pos = np.zeros((1024, 3))
        self.kf_fwd = np.zeros((1024, 3))
        self.cos_heading = math.cos(math.radians(mix.revisit_heading_deg))
        self.quiet = mix.closure_gap_keyframes  # keyframes since a revisit
        self.last_ref = 0
        self.i = 0

    def _remember(self, k: int, gt: np.ndarray) -> None:
        if k >= len(self.kf_pos):
            for name in ("kf_pos", "kf_fwd"):
                old = getattr(self, name)
                grown = np.zeros((2 * len(old), 3))
                grown[:len(old)] = old
                setattr(self, name, grown)
        self.kf_pos[k] = gt[:3, 3]
        self.kf_fwd[k] = gt[:3, 2]

    def next(self) -> Message:
        mix, i = self.mix, self.i
        r = i % mix.route_frames
        gt = self.gt[r]
        if self.last is None:
            est = gt.copy()
        else:
            # odometry: the true motion since the last frame, composed with
            # this frame's error in the camera's own frame
            prev_gt, prev_est = self.last
            est = prev_est @ np.linalg.inv(prev_gt) @ gt @ self.delta
        iskf = i % mix.keyframe_every == 0
        edges: List[tuple] = []
        delta: Dict[int, np.ndarray] = {}
        closure = False
        if iskf:
            this_kf = len(self.kf_est)
            for j in range(max(0, this_kf - mix.covis_back), this_kf):
                edges.append((this_kf, j))
            old = this_kf - mix.covis_back
            revisit = np.zeros(0, int)
            if old > 0:
                d = np.linalg.norm(self.kf_pos[:old] - gt[:3, 3], axis=1)
                same_way = self.kf_fwd[:old] @ gt[:3, 2] > self.cos_heading
                revisit = np.flatnonzero((d < mix.revisit_radius_m)
                                         & same_way)
            edges += [(this_kf, int(j)) for j in revisit]
            edges = edges[:mix.max_edges]
            closure = len(revisit) > 0 \
                and self.quiet >= mix.closure_gap_keyframes
            self.quiet = 0 if len(revisit) else self.quiet + 1
            self._remember(this_kf, gt)
            self.kf_est.append(est.copy())
            self.kf_frame.append(r)
            delta[this_kf] = self.kf_est[-1]
            self.last_ref = this_kf
        if closure:
            # the pose graph's optimum: every keyframe snaps to ground
            # truth and the tracking drift resets
            self.kf_est = [self.gt[k].copy() for k in self.kf_frame]
            est = gt.copy()
            self.kf_est[-1] = est.copy()
            delta = dict(enumerate(self.kf_est))
        msg = Message(stamp=float(i), pose=est, is_keyframe=iskf,
                      reference_index=self.last_ref,
                      loop_path=list(self.kf_est), loop_edges=edges,
                      frame_index=r, path_delta=delta, closure=closure)
        self.last = (gt, est)
        self.i += 1
        return msg


def stream_for(mix: Mix, gt: np.ndarray, seed: int) -> PoseStream:
    """The camera's stream: the drift's directions drawn from the seed."""
    rng = np.random.default_rng(seed)
    return PoseStream(mix, gt, tuple(rng.choice([-1.0, 1.0], size=2)))
