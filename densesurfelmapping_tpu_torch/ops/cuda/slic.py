"""Wrappers of the SLIC CUDA kernels (`csrc/slic.cu`), the counterpart of the
JAX package's `ops/pallas/slic.py`.

Each wrapper has the signature of its plain twin in `ops/superpixel.py`.  On
a CPU tensor it runs that twin; on a CUDA tensor it checks the inputs,
launches the kernel on the current stream and raises if the launch failed;
it never falls back.  `LAUNCHES` counts the kernel launches per kernel.

The launch geometry of the kernels comes from `assign_plan`,
`centroid_plan` and `huber_plan`, plain Python that the CPU tests check
(tests/test_torch_slic_plan.py).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...config import SurfelMapConfig
from .. import superpixel as plain
from . import build

LAUNCHES = {"slic_assign": 0, "slic_centroid": 0, "slic_huber": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slic_assign": [_P] * 10 + [_I] * 10 + [_P],
    "slic_centroid": [_P] * 4 + [_I] * 10 + [_P],
    "slic_huber": [_P] * 5 + [_I] * 10 + [_F, _P],
}
MAX_SMEM = 232448         # shared memory one block may opt into (H100)
STRIP_SEEDS = 8           # B2/B3: seeds (warps) of a block, csrc kStripSeeds
ASSIGN_TILE = (32, 32)    # B1: pixel rows and columns of a block's tile
ASSIGN_THREADS = (32, 8)  # B1: threads of a block (x, y); 4 rows a thread


class AssignPlan(NamedTuple):
    """B1 geometry: block (bx, by) takes the pixels of the tile whose corner
    is (y0, x0) = (by, bx) * ASSIGN_TILE, thread (lx, ly) the pixels (y0 +
    ly + 8 k, x0 + lx), k < rows_per_thread.  It stages the seed cells
    [y0 // sp - 1, + staged[0]) x [x0 // sp - 1, + staged[1]): every cell the
    tile touches and a one-seed ring, the most any block needs.  Shared
    memory: a float4 and two ints per staged seed, an int per tile row."""
    grid: tuple                # (blocks along x, along y)
    threads: tuple             # (32, 8)
    tile: tuple                # (rows, columns) of pixels
    rows_per_thread: int
    staged: tuple              # (nsy, nsx) seed cells
    smem: int                  # bytes of dynamic shared memory per block


class StripPlan(NamedTuple):
    """B2/B3 geometry: block (bx, r) runs seeds (r, bx * seeds + w), one
    warp w each.  Their 2sp x 2sp windows' union spans 2sp rows from
    r * sp - sp/2 and (seeds + 1) sp columns from x0 = bx * seeds * sp -
    sp/2.  Shared memory stages `planes` 4-byte planes of it as `tile` =
    2sp rows of `chunks` 16-byte chunks from the 4-aligned column x0 - off,
    then `list_floats` floats per warp (B3's member list).  Lane l of warp w
    takes window pixels l + 32 j (row-major in the window, at tile column
    off + w * sp + window column) for j < per_lane."""
    seeds: int
    grid: tuple                # (blocks along the seed row, seed rows)
    threads: int
    off: int                   # x0 % 4, the same for every block
    chunks: int
    tile: tuple                # (2sp, 4 * chunks) floats
    planes: int
    list_floats: int
    smem: int                  # bytes of dynamic shared memory per block
    per_lane: int


def _check_sp(sp: int) -> None:
    if not 2 <= sp <= 16:
        raise ValueError(f"sp_size {sp} outside the kernels' range 2..16")


def _cells_spanned(n: int, tile: int, sp: int) -> int:
    """The most seed cells a tile of `tile` pixels from a multiple of `tile`
    touches along an axis of n pixels."""
    return max((t + tile - 1) // sp - t // sp + 1 for t in range(0, n, tile))


def assign_plan(h: int, w: int, sp: int) -> AssignPlan:
    """B1 over a padded (h, w) frame at seed pitch sp."""
    _check_sp(sp)
    ty, tx = ASSIGN_TILE
    staged = (_cells_spanned(h, ty, sp) + 2, _cells_spanned(w, tx, sp) + 2)
    return AssignPlan(
        grid=(math.ceil(w / tx), math.ceil(h / ty)), threads=ASSIGN_THREADS,
        tile=ASSIGN_TILE, rows_per_thread=ty // ASSIGN_THREADS[1],
        staged=staged, smem=24 * staged[0] * staged[1] + 4 * ty)


def _strip_plan(rows: int, cols: int, sp: int, planes: int,
                listed: bool) -> StripPlan:
    _check_sp(sp)
    per_lane = math.ceil(4 * sp * sp / 32)
    off = -(sp // 2) % 4          # bx * seeds * sp is a multiple of 4
    chunks = math.ceil((off + (STRIP_SEEDS + 1) * sp) / 4)
    tile = (2 * sp, 4 * chunks)
    list_floats = 32 * per_lane if listed else 0
    return StripPlan(
        seeds=STRIP_SEEDS, grid=(math.ceil(cols / STRIP_SEEDS), rows),
        threads=32 * STRIP_SEEDS, off=off, chunks=chunks, tile=tile,
        planes=planes, list_floats=list_floats,
        smem=4 * (planes * tile[0] * tile[1] + STRIP_SEEDS * list_floats),
        per_lane=per_lane)


def centroid_plan(rows: int, cols: int, sp: int) -> StripPlan:
    """B2: image, depth and assignment staged; no member list."""
    return _strip_plan(rows, cols, sp, planes=3, listed=False)


def huber_plan(rows: int, cols: int, sp: int) -> StripPlan:
    """B3: depth and assignment staged, and a member list per warp."""
    return _strip_plan(rows, cols, sp, planes=2, listed=True)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return build.load("slic", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t.data_ptr()


def _check_chunks(w: int, ptrs) -> None:
    """B2/B3 stage 16-byte chunks: the rows must start 16-byte aligned."""
    if w % 4 or any(p % 16 for p in ptrs):
        raise ValueError(f"the strip kernels need a width that is a "
                         f"multiple of 4 (got {w}) and 16-byte aligned "
                         f"planes")


def _prepare(config: SurfelMapConfig, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"the SLIC kernels run on CUDA tensors, got {device}")
    _check_sp(config.sp_size)
    return _lib(), torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def slic_assign(config: SurfelMapConfig, image, inv_depth, assignment,
                x, y, mean_intensity, mean_depth, stable):
    """B1: one pixel-assignment sweep -> (new_assignment (H, W) i32,
    claimed (R, C) bool).  Plain twin: `superpixel.assign_sweep`.  The
    kernel writes the bool claims itself (the C entry zeroes them first):
    two device operations per call, the memset and the kernel."""
    if image.device.type == "cpu":
        return plain.assign_sweep(config, image, inv_depth, assignment, x, y,
                                  mean_intensity, mean_depth, stable)
    dev = image.device
    lib, stream = _prepare(config, dev)
    hw = (config.padded_height, config.padded_width)
    rc = (config.sp_rows, config.sp_cols)
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check("image", image, f32, hw, dev),
            _check("inv_depth", inv_depth, f32, hw, dev),
            _check("assignment", assignment, i32, hw, dev),
            _check("x", x, f32, rc, dev), _check("y", y, f32, rc, dev),
            _check("mean_intensity", mean_intensity, f32, rc, dev),
            _check("mean_depth", mean_depth, f32, rc, dev),
            _check("stable", stable, torch.bool, rc, dev)]
    plan = assign_plan(*hw, config.sp_size)
    new_assignment = torch.empty(hw, dtype=i32, device=dev)
    claimed = torch.empty(rc, dtype=torch.bool, device=dev)
    err = lib.slic_assign(*ptrs, new_assignment.data_ptr(),
                          claimed.data_ptr(), *hw, *rc, config.height,
                          config.width, config.sp_size, *plan.staged,
                          plan.smem, stream)
    _launched("slic_assign", err)
    return new_assignment, claimed


def slic_centroid(config: SurfelMapConfig, image, depth, assignment):
    """B2: per-seed sums -> six (R, C) f32 planes (n, sum x, sum y,
    sum intensity, n with depth, sum depth).  Plain twin:
    `superpixel.seed_sums`."""
    if image.device.type == "cpu":
        return plain.seed_sums(config, image, depth, assignment)
    dev = image.device
    lib, stream = _prepare(config, dev)
    hw = (config.padded_height, config.padded_width)
    rows, cols = config.sp_rows, config.sp_cols
    ptrs = [_check("image", image, torch.float32, hw, dev),
            _check("depth", depth, torch.float32, hw, dev),
            _check("assignment", assignment, torch.int32, hw, dev)]
    _check_chunks(hw[1], ptrs)
    plan = centroid_plan(rows, cols, config.sp_size)
    out = torch.empty((6, rows, cols), dtype=torch.float32, device=dev)
    err = lib.slic_centroid(*ptrs, out.data_ptr(), *hw, rows, cols,
                            config.height, config.width, config.sp_size,
                            plan.chunks, plan.per_lane, plan.smem, stream)
    _launched("slic_centroid", err)
    return tuple(out.unbind(0))


def slic_huber(config: SurfelMapConfig, depth, assignment, mean, converged):
    """B3: five Huber-Newton steps of the per-seed mean depth with the
    convergence latch, in one launch -> (R, C) f32 mean.  Plain twin:
    `superpixel.huber_mean_depth`."""
    if depth.device.type == "cpu":
        return plain.huber_mean_depth(config, depth, assignment, mean,
                                      converged)
    dev = depth.device
    lib, stream = _prepare(config, dev)
    hw = (config.padded_height, config.padded_width)
    rc = (config.sp_rows, config.sp_cols)
    ptrs = [_check("depth", depth, torch.float32, hw, dev),
            _check("assignment", assignment, torch.int32, hw, dev),
            _check("mean", mean, torch.float32, rc, dev),
            _check("converged", converged, torch.bool, rc, dev)]
    _check_chunks(hw[1], ptrs[:2])
    plan = huber_plan(*rc, config.sp_size)
    out = torch.empty(rc, dtype=torch.float32, device=dev)
    err = lib.slic_huber(*ptrs, out.data_ptr(), *hw, *rc, config.height,
                         config.width, config.sp_size, plan.chunks,
                         plan.per_lane, plan.smem,
                         float(config.profile.huber_range), stream)
    _launched("slic_huber", err)
    return out
