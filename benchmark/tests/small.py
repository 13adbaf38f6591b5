"""A cell cut to a size a CPU test run holds: a 120 x 56 camera, 2^14
bank rows, compaction every 16 frames, a drift-free window of BFS depth
3 (so that the loop closure's warp moves the rows left outside it), a
150-frame drive around one small
block and on along its first street (a loop closure at frame 66, in the
72-frame warm-up); the stereo matcher over 32 disparities.  Only the tests
use it."""

import dataclasses

from benchmark import harness

SMALL_CAMERA = dict(width=120, height=56, fx=80.0, fy=80.0, cx=59.5,
                    cy=27.5)
SMALL_MIX = dict(route_m=((0, 0), (0, 12), (12, 12), (12, 0), (0, 0),
                          (0, 60)),
                 route_frames=150, turn_radius_m=2.0, setback_m=(3.0, 4.0),
                 building_len_m=(3.0, 6.0), building_depth_m=(2.0, 3.0),
                 gap_m=(1.0, 2.0), clear_m=2.0, warmup_frames=72,
                 samples=2)


def small_cell(name: str, stereo=None, **mix) -> harness.Cell:
    """The cell `name` cut to the small size; `stereo` overrides fields of
    its matcher's settings."""
    cell = harness.load_cell(name)
    m = dict(cell.config["mapper"], camera=dict(SMALL_CAMERA),
             surfel_capacity=1 << 14, compact_interval=16,
             drift_free_poses=3)
    cell.config = dict(cell.config, mapper=m)
    if cell.config.get("stereo"):
        cell.config["stereo"] = dict(cell.config["stereo"], max_disparity=32)
        cell.config["stereo"].update(stereo or {})
    kw = dict(SMALL_MIX)
    kw.update(mix)
    cell.mix = dataclasses.replace(cell.mix, **kw)
    return cell


def run_small(name: str, seconds: float = 1.5, seed: int = 2 ** 31 + 17,
              limits=None, **kw):
    cell = small_cell(name, kw.pop("stereo", None), **kw.pop("mix", {}))
    if limits is not None:
        cell.limits = limits
    return harness.run_cell(cell, seed, seconds, kw.pop("traced", False),
                            device="cpu", **kw)
