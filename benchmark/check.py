"""What decides `correct`: snapshots of the program's banks around sampled
frames, the reference's own host bookkeeping, and the comparisons.

The map is a recurrence (each frame's step updates the bank the frames
before it built), so the check follows the program frame by frame from its
own state: before a sampled frame the bank is copied aside on the card,
after it again, and once the window has closed the reference (`reference/`)
applies its own step to the first copy and is compared with the second.
The start (frame 0 from an empty bank) is one such sample.  The inputs of
each step (the fuse pose, the reference keyframe, the active window, the
loop warps) the reference works out itself from the published messages
(`RefHost`), as the driver's host code does.

Two numbers are compared, each the worst over a run's samples:

* `step_rows_off`: of the bank rows that differ bitwise between the program
  and the reference after a frame's step (the rows the step wrote: fused,
  killed, appended; and compaction's moves), the share that has no
  counterpart on the other side within 1 mm in position with the same
  update count and keyframe, normal within 1e-2, weight and size within
  1e-3 and 1e-2 relative, colour within 1 intensity level.
* `warp_gap`: after a loop warp, the largest difference of a position
  coordinate (m) or a normal component between the program's bank and the
  reference's warp of the same bank, row by row (a warp moves no row);
  infinite if any other field differs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

FIELDS = ("position", "normal", "color", "size", "weight", "update_times",
          "last_update")
POS_TOL_M = 1e-3
NORMAL_TOL = 1e-2
WEIGHT_RTOL = 1e-3
SIZE_RTOL = 1e-2
COLOR_TOL = 1.0


# ----------------------------------------------------------------------
# snapshots: copies of a bank's fields on its device, stream-ordered
# ----------------------------------------------------------------------
class Snapshots:
    """Buffers beside the bank, allocated in set-up, that take copies of
    it (all rows of every field and the count), stream-ordered: a copy on
    the card costs ~0.1 ms, where one to the host would hold the next
    step back for milliseconds.  `nbytes` is what they hold, which the
    reported memory peak leaves out."""

    def __init__(self, bank, n: int):
        self.free = [{k: torch.empty_like(getattr(bank, k))
                      for k in FIELDS + ("count",)} for _ in range(n)]
        self.nbytes = sum(t.numel() * t.element_size()
                          for snap in self.free for t in snap.values())

    def take(self, bank) -> dict:
        if not self.free:
            raise RuntimeError("more snapshots than the plan allotted")
        out = self.free.pop()
        for k, t in out.items():
            t.copy_(getattr(bank, k))
        return out


def to_bank(snap: dict, device):
    """A reference `SurfelBank` on `device` from a snapshot."""
    from .reference.state import SurfelBank
    return SurfelBank(**{k: snap[k].to(device).clone()
                         for k in FIELDS + ("count",)})


# ----------------------------------------------------------------------
# the reference's host bookkeeping (the driver's pose graph, worked out
# again from the published messages)
# ----------------------------------------------------------------------
def invert_se3(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


@dataclasses.dataclass
class FrameInputs:
    """What one frame's step takes besides the sensor data."""

    pose: np.ndarray          # (4, 4) f32 fuse pose
    ref: int                  # reference keyframe
    mask: np.ndarray          # (P,) bool active window


@dataclasses.dataclass
class WarpInputs:
    warps: np.ndarray         # (P, 4, 4) f32
    moved: np.ndarray         # (P,) bool
    mask: np.ndarray
    first_local: int


class RefHost:
    """Keyframe poses as committed by loop warps, the published path, the
    covisibility links and the BFS window."""

    def __init__(self, radius: int, max_keyframes: int):
        self.radius = radius
        self.P = max_keyframes
        self.cam: List[np.ndarray] = []
        self.path: Dict[int, np.ndarray] = {}
        self.links: List[set] = []
        self.prev_ref: Optional[int] = None   # the last frame's keyframe

    def window(self, root: int) -> set:
        """BFS over the links to depth < radius (`driftfree_window`)."""
        seen, level = {root}, [root]
        for _ in range(1, self.radius):
            nxt = []
            for node in level:
                for nb in self.links[node]:
                    if nb not in seen:
                        seen.add(nb)
                        nxt.append(nb)
            level = nxt
        return seen

    def feed(self, msg, want_frame: bool) -> tuple:
        """Apply one message; returns (WarpInputs or None, FrameInputs or
        None when not wanted)."""
        warp = None
        K = len(self.cam)
        self.path.update(msg.path_delta)
        if K and any(i < K and not np.array_equal(p[:3, :4],
                                                  self.cam[i][:3, :4])
                     for i, p in msg.path_delta.items()):
            warps = np.tile(np.eye(4, dtype=np.float32), (self.P, 1, 1))
            moved = np.zeros(self.P, bool)
            for i in range(K):
                if not np.array_equal(self.path[i][:3, :4],
                                      self.cam[i][:3, :4]):
                    warps[i] = (self.path[i] @ invert_se3(self.cam[i])
                                ).astype(np.float32)
                    moved[i] = True
            # the window the driver set at the last frame's step
            mask, first = self.window_mask(self.prev_ref)
            warp = WarpInputs(warps, moved, mask, first)
            for i in range(K):
                self.cam[i] = np.array(self.path[i], np.float64)
        ref = int(msg.reference_index)
        if msg.is_keyframe or K == 0:
            new = len(self.cam)
            self.cam.append(np.array(msg.pose, np.float64))
            self.links.append(set())
            if new > 0:
                self.links[new].add(ref)
                self.links[ref].add(new)
        n = len(self.cam)
        for a, b in msg.loop_edges:
            if a < n and b < n:
                self.links[a].add(b)
                self.links[b].add(a)
        rel = invert_se3(self.cam[ref]) @ np.asarray(msg.pose, np.float64)
        fuse_pose = (self.cam[ref] @ rel).astype(np.float32)
        self.prev_ref = ref
        frame = None
        if want_frame:
            frame = FrameInputs(fuse_pose, ref, self.window_mask(ref)[0])
        return warp, frame

    def window_mask(self, root: Optional[int]) -> tuple:
        """(mask, first_local) of the window around `root` (all False and
        0 before the first frame)."""
        mask = np.zeros(self.P, bool)
        if root is None:
            return mask, 0
        win = self.window(root)
        mask[list(win)] = True
        return mask, min(win)


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------
def _live(bank) -> torch.Tensor:
    n = bank.update_times.shape[0]
    return (torch.arange(n, device=bank.update_times.device)
            < bank.count) & (bank.update_times > 0)


def _rows(bank) -> dict:
    live = _live(bank)
    return {k: getattr(bank, k)[live] for k in FIELDS}


def _keys(rows: dict) -> torch.Tensor:
    """A 64-bit hash of each row's bits."""
    parts = [rows["position"].view(torch.int32),
             rows["normal"].view(torch.int32)]
    parts += [rows[k].view(torch.int32)[:, None]
              for k in ("color", "size", "weight")]
    parts += [rows[k][:, None].to(torch.int32)
              for k in ("update_times", "last_update")]
    bits = torch.cat(parts, dim=1).to(torch.int64) & 0xFFFFFFFF
    mult = torch.tensor([(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 61) | 1
                         for i in range(bits.shape[1])],
                        dtype=torch.int64, device=bits.device)
    h = torch.zeros(bits.shape[0], dtype=torch.int64, device=bits.device)
    for i in range(bits.shape[1]):
        h = (h ^ (bits[:, i] * mult[i])) * 0x100000001B3
    return h


def _agree(a: dict, b: dict, chunk: int = 2048) -> torch.Tensor:
    """For each row of `a`, whether its nearest row of `b` by position is
    its counterpart within the tolerances."""
    n = a["position"].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=a["position"].device)
    if n == 0 or b["position"].shape[0] == 0:
        return out
    pb = b["position"].double()
    for s in range(0, n, chunk):
        pa = a["position"][s:s + chunk].double()
        d = torch.cdist(pa, pb, compute_mode="donot_use_mm_for_euclid_dist")
        dist, j = d.min(dim=1)
        ok = dist <= POS_TOL_M
        for k in ("update_times", "last_update"):
            ok &= a[k][s:s + chunk] == b[k][j]
        ok &= (a["normal"][s:s + chunk] - b["normal"][j]).abs().amax(1) \
            <= NORMAL_TOL
        for k, rtol in (("weight", WEIGHT_RTOL), ("size", SIZE_RTOL)):
            x, y = a[k][s:s + chunk], b[k][j]
            ok &= (x - y).abs() <= rtol * y.abs()
        ok &= (a["color"][s:s + chunk] - b["color"][j]).abs() <= COLOR_TOL
        out[s:s + chunk] = ok
    return out


def rows_off(prog, ref) -> dict:
    """`step_rows_off` of one frame: banks of the reference's kind (the
    program's snapshot made one with `to_bank`)."""
    a, b = _rows(prog), _rows(ref)
    ka, kb = _keys(a), _keys(b)
    ua = ~torch.isin(ka, kb)
    ub = ~torch.isin(kb, ka)
    da = {k: v[ua] for k, v in a.items()}
    db = {k: v[ub] for k, v in b.items()}
    n = int(ua.sum()) + int(ub.sum())
    off = int((~_agree(da, db)).sum()) + int((~_agree(db, da)).sum())
    return dict(share=off / n if n else 0.0, rows=n, off=off,
                live_prog=len(ka), live_ref=len(kb))


def warp_gap(prog, ref) -> float:
    """`warp_gap` of one warp: banks of the reference's kind."""
    for k in ("color", "size", "weight", "update_times", "last_update",
              "count"):
        if not torch.equal(getattr(prog, k), getattr(ref, k)):
            return float("inf")
    return max(float((prog.position - ref.position).abs().max()),
               float((prog.normal - ref.normal).abs().max()))
