"""Wrapper of the plane-fit kernel (`csrc/planefit.cu`).

`seed_planes` has the signature of its plain twin,
`ops/normals.py::seed_plane_fields`, and keeps the contract of `kernel.py`: on a CPU tensor it runs that twin; on a CUDA
tensor it checks the inputs, launches `planefit_kernel` once on the current
stream and raises if the launch failed; it never falls back.  `LAUNCHES`
counts the launches.

The kernel replaces no TPU kernel: the JAX package runs the plane fit as
plain XLA (`densesurfelmapping_tpu/ops/normals.py`), which the twin
translated op by op.  Its sums run in the kernel's own order, so it is not
bitwise to the twin: tests/test_torch_planefit_kernel.py holds it to the
twin's `ok` gate, its normals within 1e-5 in cosine and its positions
within 1e-5 m.

Stream axis: (B, H, W) pixel planes with (B, R, C) and (B, R, C, 3) seed
fields run in one launch (grid z = stream), and so does a call under
`torch.func.vmap` (the fleet's step, `parallel/multistream.py`; a mesh
cell's streams, `parallel/sharding.py`; a column slab's streams,
`parallel/frame_sharding.py`).  A slab's geometry (`geom`) gives the kernel
the frame's seed column of the slab's first (`col0`) and the frame's grid
width (`grid_cols`); a whole frame is 0 and its own width.  The launch
geometry comes from `planefit_plan`, plain Python that the CPU tests check.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...config import SurfelMapConfig
from .. import normals as plain
from . import kernel
from .kernel import check, check_streams

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = kernel.Library("planefit", {
    "planefit": [_P] * 14 + [_I] * 10 + [_F] * 6 + [_P]}, ("planefit",))
LAUNCHES = _LIB.launches
reset_launch_counts = _LIB.reset_launch_counts
SEEDS = 8             # seeds (warps) of a block, csrc kSeeds


class PlanefitPlan(NamedTuple):
    """Block (bx, 0, z) fits stream z's seeds bx * SEEDS + w (flat index
    r * cols + c), one warp w each; each warp lists its seed's inlier
    points in shared memory, three planes of a window's 4 sp^2 floats (the
    C entry sizes that memory from sp)."""
    grid: tuple       # (blocks, 1, streams)
    threads: int
    smem: int         # bytes of dynamic shared memory per block


def planefit_plan(rows: int, cols: int, sp: int,
                  nb: int = 1) -> PlanefitPlan:
    """The kernel's geometry over nb streams of a rows x cols seed grid at
    seed pitch sp."""
    if not 2 <= sp <= 16:
        raise ValueError(f"sp_size {sp} outside the kernel's range 2..16")
    check_streams(nb)
    return PlanefitPlan(grid=(math.ceil(rows * cols / SEEDS), 1, nb),
                        threads=32 * SEEDS, smem=SEEDS * 3 * 4 * sp * sp * 4)


def _launch_planefit(config: SurfelMapConfig, depth, assignment, x, y,
                     mean_depth, norm, pos, view_cos, size,
                     geom=None) -> tuple:
    dev = depth.device
    lead, nb = kernel.lead("depth", depth, "H, W")
    sp, rows = config.sp_size, config.sp_rows
    if geom is None:
        col0, cols = 0, config.sp_cols
        grid_cols = cols
    else:
        col0, cols = geom["col0"], geom["center_x"].shape[-1]
        grid_cols = geom["grid_cols"]
    ph, pw = config.padded_height, cols * sp
    hw, rc = lead + (ph, pw), lead + (rows, cols)
    f32 = torch.float32
    ptrs = [check("depth", depth, f32, hw, dev),
            check("assignment", assignment, torch.int32, hw, dev),
            check("x", x, f32, rc, dev), check("y", y, f32, rc, dev),
            check("mean_depth", mean_depth, f32, rc, dev),
            check("norm", norm, f32, rc + (3,), dev),
            check("pos", pos, f32, rc + (3,), dev),
            check("view_cos", view_cos, f32, rc, dev),
            check("size", size, f32, rc, dev)]
    planefit_plan(rows, cols, sp, nb)
    outs = (torch.empty(rc + (3,), dtype=f32, device=dev),
            torch.empty(rc + (3,), dtype=f32, device=dev),
            *(torch.empty(rc, dtype=f32, device=dev) for _ in range(3)))
    cam = config.camera
    _LIB.launch("planefit", *ptrs, *(o.data_ptr() for o in outs), nb, ph,
                pw, rows, cols, config.height, config.width, sp, col0,
                grid_cols, float(cam.fx), float(cam.fy), float(cam.cx),
                float(cam.cy), float(config.profile.huber_range),
                float(config.max_angle_cos), kernel.stream(dev))
    return outs


def seed_planes(config: SurfelMapConfig, depth, assignment, x, y,
                mean_depth, norm, pos, view_cos, size, geom=None) -> tuple:
    """The per-seed plane fit over a padded (H, W) f32 depth and i32
    assignment and the seed fields it reads and writes ((R, C) f32 x, y,
    mean_depth, view_cos, size; (R, C, 3) f32 norm, pos) -> (norm, pos,
    mean_depth, view_cos, size), each with the stream axis first in a
    batched call.  geom: a column slab's geometry
    (`frame_sharding.slab_geometry`), the planes then the slab's columns.
    Plain twin: `normals.seed_plane_fields`."""
    return kernel.dispatch(plain.seed_plane_fields, _launch_planefit, 2,
                           config, depth, assignment, x, y, mean_depth, norm,
                           pos, view_cos, size, geom)
