"""Wrappers of the SGM CUDA kernels (`csrc/sgm.cu`), the counterpart of the
JAX package's `ops/pallas/sgm.py`.

Each wrapper has the signature of its plain twin in `ops/sgm.py`.  On a CPU
tensor it runs that twin; on a CUDA tensor it checks the inputs, launches
the kernels on the current stream and raises if a launch failed; it never
falls back.  `LAUNCHES` counts the calls of each kernel entry:

* sgm_axis_scan (B4): the scan of a materialized volume; for D <= 128 the
  warp step of B5/B6 (a line per warp pair for the roll set (0), B5's
  bands for (0, +1, -1)), for 128 < D <= 1024 the line kernel and its
  combine pass;
* sgm_census_x (B6): the horizontal family of the census aggregate (one
  warp per row and orientation, meeting at mid-row);
* sgm_census_y (B5): the vertical + diagonal family (one block per SM,
  bands of columns exchanging edge carries, a cooperative launch; the two
  orientations meet at mid-image).

The launch geometry comes from `axis_plan`, `census_x_plan` and
`census_y_plan`, plain Python that the CPU tests check.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import sgm as plain
from . import build
from .slic import _check

LAUNCHES = {"sgm_axis_scan": 0, "sgm_census_y": 0, "sgm_census_x": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sgm_axis_lines": [_P] * 3 + [_I] * 7 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_axis_warp": [_P] * 4 + [_I] * 7 + [_F, _F] + [_I] * 8 + [_P],
    "sgm_census_x": [_P] * 4 + [_I] * 3 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_census_y": [_P] * 5 + [_I] * 7 + [_F, _F] + [_I] * 7 + [_P],
    "sgm_census_y_occupancy": [_I] * 6 + [_P],
}
MAX_SMEM = 232448         # shared memory one block may opt into (H100)
H100_SMS = 132            # streaming multiprocessors of an H100 SXM
_CENSUS_ROWS = 8          # B5: census rows per cp.async chunk
_HALO_ROWS = 4            # B5: rows of a halo ring
_MAX_Y_WARPS = 20         # B4/B5 band blocks: __launch_bounds__(640)
_LINE_RING = 8            # B4 line kernel: staged rows a warp (kLRing)
_BAND_RING = 4            # B4 band kernel: staged volume rows (kVRing)
_ENTRY = {None: 0, "x": 1, "y": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return build.load("sgm", _SIGNATURES)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _rolls(rolls) -> list:
    rolls = [int(r) for r in rolls]
    if not 1 <= len(rolls) <= 3 or any(r not in (-1, 0, 1) for r in rolls):
        raise ValueError(f"rolls must be 1-3 shifts in (-1, 0, 1): {rolls}")
    return rolls + [0] * (3 - len(rolls))


# the roll sets B5 runs: the vertical path alone (4 paths) and the vertical
# path with both diagonals (8 paths), in the matcher's order
CENSUS_Y_ROLLS = ((0,), (0, 1, -1))


def census_y_rolls(v_rolls) -> list:
    """B5's three rolls (zero-padded) of `v_rolls`; raises for a roll set
    other than those of CENSUS_Y_ROLLS."""
    if tuple(int(r) for r in v_rolls) not in CENSUS_Y_ROLLS:
        raise ValueError(f"census_y runs the roll sets {CENSUS_Y_ROLLS}, "
                         f"got {tuple(v_rolls)}")
    return _rolls(v_rolls)


class AxisPlan(NamedTuple):
    """B4 geometry for an (L, R, D) volume scanned along axis 0 with the
    directions `rolls`.

    route "warp" (D <= 128, rolls (0,) or (0, 1, -1)): g = 1 runs one
    block of two warps (forward, backward) per row r, `blocks` = R; g = 3
    runs each orientation as `nbands` bands of `ncols` rows (B5's
    geometry, `census_y_plan`), a cooperative launch of 2 nbands blocks
    with `halo_bytes` of edge carries.  The orientations meet at step
    `mid`: the forward scan's totals of steps < mid and the backward
    scan's of steps >= mid go through the bf16 slab to the other scan.
    route "lines" (128 < D <= 1024, any 1-3 rolls): PR 2's line kernel,
    one block of `threads` per (line, direction), and a combine pass over
    an f32 scratch of `scratch_shape`."""
    route: str
    g: int
    blocks: int
    threads: int
    smem: int                  # bytes of shared memory per block
    nbands: int
    ncols: int                 # rows of a band (the last may be shorter)
    cpw: int                   # rows of a warp
    mid: int
    slab_shape: tuple          # bf16 (L, R, 128), or () on the lines route
    halo_bytes: int
    scratch_shape: tuple       # f32 (2g, L R D), or () on the warp route


def _band_row_bytes(ncols: int, n_d: int) -> int:
    """A staged band row of the volume: ncols n_d bf16 from the 16-byte
    chunk holding its start (csrc band_row_bytes)."""
    return 16 * ((2 * ncols * n_d + 29) // 16)


def axis_plan(L: int, R: int, D: int, rolls,
              sms: int = H100_SMS) -> AxisPlan:
    """B4's route and geometry; raises for shapes the kernels do not take
    and, for D <= 128, for a roll set other than CENSUS_Y_ROLLS."""
    if L < 1 or R < 1 or not 1 <= D <= 1024:
        raise ValueError(f"axis_scan: bad volume shape ({L}, {R}, {D}): "
                         f"1 <= D <= 1024")
    r = _rolls(rolls)
    g = len(rolls)
    if D > 128:
        threads = 32 * math.ceil(D / 32)
        return AxisPlan(route="lines", g=g, blocks=(R + L - 1) * 2 * g,
                        threads=threads, smem=4 * (2 * threads + 64),
                        nbands=0, ncols=0, cpw=0, mid=L // 2, slab_shape=(),
                        halo_bytes=0, scratch_shape=(2 * g, L * R * D))
    census_y_rolls(r[:g])
    common = dict(route="warp", g=g, mid=L // 2, slab_shape=(L, R, 128),
                  scratch_shape=())
    if g == 1:
        # per warp, a ring of staged rows (272 B) and other totals (256 B)
        return AxisPlan(blocks=R, threads=64, smem=2 * _LINE_RING * 528,
                        nbands=0, ncols=0, cpw=0, halo_bytes=0, **common)
    ncols, nbands, cpw, threads = _bands(R, sms)
    smem = (4 * 2 * 3 * (ncols + 2) * 128 + _BAND_RING
            * _band_row_bytes(ncols, D) + 4 * ncols * 256)
    if smem > MAX_SMEM:
        raise ValueError(f"axis_scan: a band of {ncols} rows x 3 directions "
                         f"needs {smem} B of shared memory > {MAX_SMEM} "
                         f"({R} rows on {sms} SMs)")
    return AxisPlan(blocks=2 * nbands, threads=threads, smem=smem,
                    nbands=nbands, ncols=ncols, cpw=cpw,
                    halo_bytes=_halo_bytes(nbands, 3), **common)


def axis_scan(v: torch.Tensor, rolls, p1: float, p2: float,
              carry_bf16: bool = False, entry=None,
              min_d: int = 0) -> torch.Tensor:
    """B4: sum of the 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) bf16 volume -> f32 (L, R, D).  Plain twin:
    `ops/sgm.axis_scan`.  On a CUDA tensor D <= 128 takes the roll sets
    (0,) and (0, 1, -1) only (`axis_plan`)."""
    if v.device.type == "cpu":
        return plain.axis_scan(v, rolls, p1, p2, carry_bf16=carry_bf16,
                               entry=entry, min_d=min_d)
    if v.device.type != "cuda":
        raise ValueError(f"the SGM kernels run on CUDA tensors, got "
                         f"{v.device}")
    if v.dim() != 3:
        raise ValueError(f"v must be (L, R, D), got {tuple(v.shape)}")
    if entry not in _ENTRY:
        raise ValueError(f"entry must be None, 'x' or 'y', got {entry!r}")
    L, R, D = v.shape
    dev = v.device
    ptr = _check("v", v, torch.bfloat16, (L, R, D), dev)
    plan = axis_plan(L, R, D, rolls, _sms(dev))
    r0, r1, r2 = _rolls(rolls)
    out = torch.empty((L, R, D), dtype=torch.float32, device=dev)
    args = (float(p1), float(p2), int(bool(carry_bf16)), _ENTRY[entry],
            int(min_d))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "lines":
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                              device=dev)
        err = _lib().sgm_axis_lines(ptr, scratch.data_ptr(), out.data_ptr(),
                                    L, R, D, plan.g, r0, r1, r2, *args,
                                    stream)
    else:
        if ptr % 16:
            raise ValueError("axis_scan stages 16-byte chunks of the "
                             "volume: its base must be 16-byte aligned")
        slab = torch.empty(plan.slab_shape, dtype=torch.bfloat16, device=dev)
        halo = torch.empty(plan.halo_bytes, dtype=torch.uint8, device=dev)
        err = _lib().sgm_axis_warp(
            ptr, out.data_ptr(), slab.data_ptr(),
            halo.data_ptr() if plan.halo_bytes else None, L, R, D, plan.g,
            r0, r1, r2, *args, plan.nbands, plan.ncols, plan.cpw,
            plan.threads, plan.smem, stream)
    _launched("sgm_axis_scan", err)
    return out


def _census_args(census_l, census_r, min_d, n_d):
    dev = census_l.device
    if dev.type != "cuda":
        raise ValueError(f"the SGM kernels run on CUDA tensors, got {dev}")
    if not 1 <= n_d <= 128 or min_d < 0:
        raise ValueError(f"census kernels take 1 <= n_d <= 128 and "
                         f"min_d >= 0, got n_d={n_d}, min_d={min_d}")
    if census_l.dim() != 2:
        raise ValueError(f"census_l must be (H, W), got "
                         f"{tuple(census_l.shape)}")
    H, W = census_l.shape
    return (H, W, _check("census_l", census_l, torch.int32, (H, W), dev),
            _check("census_r", census_r, torch.int32, (H, W), dev),
            torch.cuda.current_stream(dev).cuda_stream)


class CensusXPlan(NamedTuple):
    """B6 geometry: one block of two warps (forward, backward) per row; they
    meet at column `mid`: the forward warp's totals of x < mid and the
    backward warp's of x >= mid go through the slab to the other warp."""
    blocks: int
    threads: int
    smem: int                  # bytes of dynamic shared memory per block
    mid: int
    slab_shape: tuple          # bf16 (H, W, 128): first-half totals
    slab_bytes: int


class CensusYPlan(NamedTuple):
    """B5 geometry: per orientation `nbands` blocks, block c holding the
    columns bands(W)[c]; warp w of a block the `cpw` columns from w * cpw.
    A block's shared memory holds its band's row state twice (rows of odd
    and even parity), g x (ncols + 2) x 128 f32 each, two chunks of staged
    census rows, and, four times, a row of the other orientation's totals
    (ncols x 128 bf16) and of out (128 x (ncols | 1) f32).  The scans meet
    at row `mid`: the forward scan's totals of rows < mid and the backward
    scan's of rows >= mid go through the slab to the other scan."""
    nbands: int
    ncols: int                 # columns of a band (the last may be shorter)
    cpw: int                   # columns of a warp
    threads: int
    smem: int                  # bytes of dynamic shared memory per block
    mid: int
    slab_shape: tuple          # bf16 (H, W, 128): first-half totals
    slab_bytes: int
    halo_bytes: int            # tagged edge carries (u64) + rows done (u32)

    def bands(self, W: int):
        return [range(c * self.ncols, min(W, (c + 1) * self.ncols))
                for c in range(self.nbands)]


def census_x_plan(H: int, W: int, n_d: int) -> CensusXPlan:
    # a f32 out tile of 32 x 128 and a ring of 16 x 32 uint2 per warp, the
    # row's census
    smem = 2 * 4 * 32 * 128 + 2 * 8 * 16 * 32 + 4 * (4 * math.ceil(W / 4) + W)
    if smem > MAX_SMEM:
        raise ValueError(f"census_x: a row of width {W} needs {smem} B of "
                         f"shared memory > {MAX_SMEM}")
    return CensusXPlan(blocks=H, threads=64, smem=smem, mid=W // 2,
                       slab_shape=(H, W, 128), slab_bytes=2 * H * W * 128)


def _bands(W: int, sms: int) -> tuple:
    """(ncols, nbands, cpw, threads) of a band launch over W columns: one
    block per SM and orientation, `sms // 2` bands (at most one per
    column), columns split evenly, one warp per column up to 20 warps."""
    ncols = math.ceil(W / max(1, min(sms // 2, W)))
    cpw = math.ceil(ncols / _MAX_Y_WARPS)
    return ncols, math.ceil(W / ncols), cpw, 32 * math.ceil(ncols / cpw)


def _halo_bytes(nbands: int, g: int) -> int:
    """Per orientation, band and side, g rings of _HALO_ROWS rows of 128
    tagged carries (u64); then a u32 count of rows done per band."""
    return 8 * 2 * nbands * 2 * g * _HALO_ROWS * 128 + 4 * 2 * nbands


def census_y_plan(H: int, W: int, n_d: int, g: int,
                  sms: int = H100_SMS) -> CensusYPlan:
    """One block per SM: `sms // 2` bands per orientation (at most one per
    column), columns split evenly, one warp per column up to 20 warps.
    g is 1 or 3 (CENSUS_Y_ROLLS).  Raises if a band's row state does not
    fit one block's shared memory."""
    if g not in (1, 3) or not 1 <= n_d <= 128 or H < 1 or W < 1:
        raise ValueError(f"census_y: bad shape H={H} W={W} n_d={n_d} g={g}")
    ncols, nbands, cpw, threads = _bands(W, sms)
    q = math.ceil((ncols + n_d - 1) / 4)
    smem = (4 * (2 * g * (ncols + 2) * 128
                 + 2 * _CENSUS_ROWS * (4 * q + ncols))
            + 4 * ncols * 256 + 4 * 4 * 128 * (ncols | 1))
    if smem > MAX_SMEM:
        raise ValueError(
            f"census_y: a band of {ncols} columns x {g} directions needs "
            f"{smem} B of shared memory > {MAX_SMEM} (width {W} on {sms} "
            f"SMs)")
    return CensusYPlan(nbands=nbands, ncols=ncols, cpw=cpw, threads=threads,
                       smem=smem, mid=H // 2, slab_shape=(H, W, 128),
                       slab_bytes=2 * H * W * 128,
                       halo_bytes=_halo_bytes(nbands, g))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def census_y_occupancy(H: int, W: int, n_d: int, g: int,
                       carry_bf16: bool = False) -> tuple:
    """(blocks, blocks one SM holds at once, SMs) of B5's plan on the
    current card (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`); the
    cooperative launch needs blocks <= that x SMs."""
    sms = _sms(torch.device("cuda"))
    plan = census_y_plan(H, W, n_d, g, sms)
    n = ctypes.c_int(0)
    err = _lib().sgm_census_y_occupancy(n_d, g, int(bool(carry_bf16)),
                                        plan.cpw, plan.threads, plan.smem,
                                        ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           f"failed with CUDA error {err}")
    return 2 * plan.nbands, n.value, sms


def census_x(census_l: torch.Tensor, census_r: torch.Tensor, p1: float,
             p2: float, min_d: int, n_d: int,
             carry_bf16: bool = False) -> torch.Tensor:
    """B6: horizontal family of the census aggregate -> f32 (n_d, H, W).
    Plain twin: `ops/sgm.census_x_family`."""
    if census_l.device.type == "cpu":
        return plain.census_x_family(census_l, census_r, p1, p2, min_d, n_d,
                                     carry_bf16)
    H, W, cl, cr, stream = _census_args(census_l, census_r, min_d, n_d)
    plan = census_x_plan(H, W, n_d)
    dev = census_l.device
    out = torch.empty((n_d, H, W), dtype=torch.float32, device=dev)
    slab = torch.empty(plan.slab_shape, dtype=torch.bfloat16, device=dev)
    err = _lib().sgm_census_x(cl, cr, out.data_ptr(), slab.data_ptr(), H, W,
                              n_d, float(p1), float(p2), int(min_d),
                              int(bool(carry_bf16)), plan.smem, stream)
    _launched("sgm_census_x", err)
    return out


def census_y(census_l: torch.Tensor, census_r: torch.Tensor,
             out: torch.Tensor, v_rolls, p1: float, p2: float, min_d: int,
             carry_bf16: bool = False) -> torch.Tensor:
    """B5: adds the vertical (+ diagonal) family of the census aggregate to
    `out` (f32 (n_d, H, W), in place) and returns it.  Plain twin:
    `out + ops/sgm.census_y_family`."""
    n_d = out.shape[0]
    if census_l.device.type == "cpu":
        return out.add_(plain.census_y_family(census_l, census_r, v_rolls,
                                              p1, p2, min_d, n_d,
                                              carry_bf16))
    H, W, cl, cr, stream = _census_args(census_l, census_r, min_d, n_d)
    dev = census_l.device
    optr = _check("out", out, torch.float32, (n_d, H, W), dev)
    g = len(v_rolls)
    r0, r1, r2 = census_y_rolls(v_rolls)
    plan = census_y_plan(H, W, n_d, g, _sms(dev))
    slab = torch.empty(plan.slab_shape, dtype=torch.bfloat16, device=dev)
    halo = torch.empty(plan.halo_bytes, dtype=torch.uint8, device=dev)
    err = _lib().sgm_census_y(cl, cr, optr, slab.data_ptr(), halo.data_ptr(),
                              H, W, n_d, g, r0, r1, r2,
                              float(p1), float(p2), int(min_d),
                              int(bool(carry_bf16)), plan.nbands, plan.ncols,
                              plan.cpw, plan.threads, plan.smem, stream)
    _launched("sgm_census_y", err)
    return out


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                     carry_bf16: bool = False) -> torch.Tensor:
    """B6 + B5: 4/8-path SGM aggregation straight from (H, W) int32 census
    images -> f32 (n_d, H, W), x family + y family; the cost volume never
    materializes.  Plain twin: `ops/sgm.census_aggregate`."""
    if census_l.device.type == "cpu":
        return plain.census_aggregate(census_l, census_r, v_rolls, p1, p2,
                                      min_d, n_d, carry_bf16=carry_bf16)
    out = census_x(census_l, census_r, p1, p2, min_d, n_d, carry_bf16)
    return census_y(census_l, census_r, out, v_rolls, p1, p2, min_d,
                    carry_bf16)
