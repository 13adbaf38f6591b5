"""Wrappers of the SGM CUDA kernels (`csrc/sgm.cu`), the counterpart of the
JAX package's `ops/pallas/sgm.py`.

Each wrapper has the signature of its plain twin in `ops/sgm.py` and keeps
the contract of `kernel.py`: on a CPU tensor it runs that twin; on a CUDA
tensor it checks the inputs, launches the kernels on the current stream and
raises if a launch failed; it never falls back.  `LAUNCHES` counts the calls
of each kernel entry:

* sgm_axis_scan (B4): the scan of a materialized volume; for D <= 128 the
  warp step of B5/B6 (a line per warp pair for the roll set (0), B5's
  bands for (0, +1, -1)), for 128 < D <= 1024 the line kernel and its
  combine pass (one call, one count: two launches);
* sgm_census_x (B6): the horizontal family of the census aggregate (one
  warp per row and orientation, meeting at mid-row);
* sgm_census_y (B5): the vertical + diagonal family (one block per SM,
  bands of columns exchanging edge carries, a cooperative launch; the two
  orientations meet at mid-image);
* sgm_census_lines: one family of the census aggregate above 128 planes
  (128 < n_d <= 1024), B4's line kernel and combine pass with the Hamming
  cost computed from the census images in place of a volume read (one
  call, one count: two launches); `census_aggregate` makes two calls, the
  x family and the y family, and no (n_d, H, W) volume is built.

`plane_route` is the one place that bounds these routes by the number of
planes; the matcher (`models/stereo.py`) asks it which route a census
aggregate takes.

Stream axis: every wrapper also takes operands with a leading (B,) axis,
the B streams of the stereo fleet's round, and launches each kernel ONCE
for all of them (a launch adds one to its count however many streams it
runs), where the JAX package's `jax.vmap` of the fuse step gives each
`pallas_call` a stream axis on its grid: B6 and B4's line kernel take the
stream on grid y; B5 and B4's band kernel, cooperative launches of one
block per SM, keep their grid and walk the streams in each block; B4's
wide route (128 < D <= 1024), on a volume or on census images, takes the
stream on its line kernel's grid z and covers every stream in one combine
pass.  A call under a `torch.func.vmap` of the stereo step
(`parallel/multistream.py`; a mesh cell's streams in
`parallel/sharding.py`) reaches the batched launch too (`kernel.dispatch`).

The launch geometry comes from `axis_plan`, `census_x_plan` and
`census_y_plan`, plain Python that the CPU tests check.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import sgm as plain
from . import kernel
from .kernel import check, check_streams

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = kernel.Library("sgm", {
    "sgm_axis_lines": [_P] * 3 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_census_lines": [_P] * 4 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_axis_warp": [_P] * 4 + [_I] * 8 + [_F, _F] + [_I] * 8 + [_P],
    "sgm_census_x": [_P] * 4 + [_I] * 4 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_census_y": [_P] * 5 + [_I] * 8 + [_F, _F] + [_I] * 7 + [_P],
    "sgm_census_y_occupancy": [_I] * 6 + [_P],
}, ("sgm_axis_scan", "sgm_census_y", "sgm_census_x", "sgm_census_lines"))
LAUNCHES = _LIB.launches
reset_launch_counts = _LIB.reset_launch_counts
MAX_SMEM = 232448         # shared memory one block may opt into (H100)
H100_SMS = 132            # streaming multiprocessors of an H100 SXM
_CENSUS_ROWS = 8          # B5: census rows per cp.async chunk
_HALO_ROWS = 4            # B5: rows of a halo ring
_MAX_Y_WARPS = 20         # B4/B5 band blocks: __launch_bounds__(640)
_LINE_RING = 8            # B4 line kernel: staged rows a warp (kLRing)
_BAND_RING = 4            # B4 band kernel: staged volume rows (kVRing)
_ENTRY = {None: 0, "x": 1, "y": 2}
WARP_PLANES = 128         # B5, B6 and B4's warp step: 4 planes a lane
MAX_PLANES = 1024         # B4's line kernel: one plane a thread


def plane_route(n_d: int):
    """The kernels' route for n_d disparity planes: "warp" up to
    WARP_PLANES (B6 + B5 on census images, B4's warp step on a volume),
    "lines" up to MAX_PLANES (B4's line kernel and combine pass, on census
    images or a volume), None for a count no kernel takes."""
    if 1 <= n_d <= WARP_PLANES:
        return "warp"
    return "lines" if WARP_PLANES < n_d <= MAX_PLANES else None


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
    """B4 geometry for `streams` (L, R, D) volumes scanned along axis 0 with
    the directions `rolls`.

    route "warp" (D <= 128, rolls (0,) or (0, 1, -1)): g = 1 runs one
    block of two warps (forward, backward) per row r and stream, `blocks`
    = R blocks a stream on grid x, the stream on grid y; g = 3 runs each
    orientation as `nbands` bands of `ncols` rows (B5's geometry,
    `census_y_plan`), a cooperative launch of 2 nbands blocks with
    `halo_bytes` of edge carries, each block walking the streams in turn.
    The orientations meet at step `mid`: the forward scan's totals of
    steps < mid and the backward scan's of steps >= mid go through the bf16
    slab to the other scan (`slab_shape`: one stream's; a launch holds
    `streams` of them).
    route "lines" (128 < D <= 1024, any 1-3 rolls): PR 2's line kernel,
    one block of `threads` per (line, direction) of a stream (`blocks` a
    stream, the stream on grid z), and a combine pass over an f32 scratch
    of `scratch_shape`: each stream's 2g slabs of (L, R, D) in stream
    order, 24 L R D bytes a stream with g = 3 (11.5 GB at KITTI size and
    D = 1024); two launches for all the streams."""
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
    scratch_shape: tuple       # f32 (B 2g, L R D), or () on the warp route
    streams: int = 1           # volumes of one launch


def _band_row_bytes(ncols: int, n_d: int) -> int:
    """A staged band row of the volume: ncols n_d bf16 from the 16-byte
    chunk holding its start (csrc band_row_bytes)."""
    return 16 * ((2 * ncols * n_d + 29) // 16)


def _check_steps(streams: int, steps: int) -> None:
    """The streams' global rows (stream s, step t -> s steps + t) and their
    halo tags (one more) must fit the kernels' 32-bit counts."""
    check_streams(streams)
    if streams * steps >= 2 ** 31:
        raise ValueError(f"{streams} streams of {steps} steps overflow the "
                         f"32-bit halo tags")


def axis_plan(L: int, R: int, D: int, rolls,
              sms: int = H100_SMS, streams: int = 1) -> AxisPlan:
    """B4's route and geometry for `streams` volumes in one launch; raises
    for shapes the kernels do not take and, for D <= 128, for a roll set
    other than CENSUS_Y_ROLLS."""
    route = plane_route(D)
    if L < 1 or R < 1 or route is None:
        raise ValueError(f"axis_scan: bad volume shape ({L}, {R}, {D}): "
                         f"1 <= D <= {MAX_PLANES}")
    _check_steps(streams, L)
    r = _rolls(rolls)
    g = len(rolls)
    if route == "lines":
        threads = 32 * math.ceil(D / 32)
        return AxisPlan(route="lines", g=g, blocks=(R + L - 1) * 2 * g,
                        threads=threads, smem=4 * (2 * threads + 64),
                        nbands=0, ncols=0, cpw=0, mid=L // 2, slab_shape=(),
                        halo_bytes=0,
                        scratch_shape=(streams * 2 * g, L * R * D),
                        streams=streams)
    census_y_rolls(r[:g])
    common = dict(route="warp", g=g, mid=L // 2, slab_shape=(L, R, 128),
                  scratch_shape=(), streams=streams)
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


def _launch_axis_scan(v, rolls, p1, p2, carry_bf16, entry, min_d):
    if entry not in _ENTRY:
        raise ValueError(f"entry must be None, 'x' or 'y', got {entry!r}")
    lead, nb = kernel.lead("v", v, "L, R, D")
    L, R, D = v.shape[-3:]
    dev = v.device
    ptr = check("v", v, torch.bfloat16, lead + (L, R, D), dev)
    plan = axis_plan(L, R, D, rolls, _sms(dev), nb)
    r0, r1, r2 = _rolls(rolls)
    out = torch.empty(lead + (L, R, D), dtype=torch.float32, device=dev)
    args = (float(p1), float(p2), int(bool(carry_bf16)), _ENTRY[entry],
            int(min_d))
    if plan.route == "lines":
        # one launch of the line kernel (grid z = stream) and one of the
        # combine pass for all the streams, each stream on its own slabs
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32,
                              device=dev)
        _LIB.launch("sgm_axis_lines", ptr, scratch.data_ptr(),
                    out.data_ptr(), nb, L, R, D, plan.g, r0, r1, r2, *args,
                    kernel.stream(dev), count="sgm_axis_scan")
        return out
    if ptr % 16:
        raise ValueError("axis_scan stages 16-byte chunks of the "
                         "volume: its base must be 16-byte aligned")
    slab = torch.empty((nb,) + plan.slab_shape, dtype=torch.bfloat16,
                       device=dev)
    halo = torch.empty(plan.halo_bytes, dtype=torch.uint8, device=dev)
    _LIB.launch("sgm_axis_warp", ptr, out.data_ptr(), slab.data_ptr(),
                halo.data_ptr() if plan.halo_bytes else None, nb, L, R, D,
                plan.g, r0, r1, r2, *args, plan.nbands, plan.ncols, plan.cpw,
                plan.threads, plan.smem, kernel.stream(dev),
                count="sgm_axis_scan")
    return out


def axis_scan(v: torch.Tensor, rolls, p1: float, p2: float,
              carry_bf16: bool = False, entry=None,
              min_d: int = 0) -> torch.Tensor:
    """B4: sum of the 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) bf16 volume -> f32 (L, R, D); (B, L, R, D) volumes, or a
    call under torch.func.vmap, in one launch for the B streams.  Plain
    twin: `ops/sgm.axis_scan`.  On a CUDA tensor D <= 128 takes the roll
    sets (0,) and (0, 1, -1) only (`axis_plan`)."""
    return kernel.dispatch(plain.axis_scan, _launch_axis_scan, 3, v, rolls,
                           p1, p2, carry_bf16, entry, min_d)


def _census_args(census_l, census_r, min_d, n_d, max_d=WARP_PLANES):
    """(lead, streams, H, W, the census pointers): lead is () for one
    stream's (H, W) images, (B,) for B streams' (B, H, W)."""
    if not 1 <= n_d <= max_d or min_d < 0:
        raise ValueError(f"census kernels take 1 <= n_d <= {max_d} and "
                         f"min_d >= 0, got n_d={n_d}, min_d={min_d}")
    lead, nb = kernel.lead("census_l", census_l, "H, W")
    H, W = census_l.shape[-2:]
    dev = census_l.device
    return (lead, nb, H, W,
            check("census_l", census_l, torch.int32, lead + (H, W), dev),
            check("census_r", census_r, torch.int32, lead + (H, W), dev))


class CensusXPlan(NamedTuple):
    """B6 geometry: one block of two warps (forward, backward) per row and
    stream, grid (blocks, streams); they meet at column `mid`: the forward
    warp's totals of x < mid and the backward warp's of x >= mid go through
    the slab to the other warp (`slab_shape`: one stream's; a launch holds
    `streams` of them)."""
    blocks: int
    threads: int
    smem: int                  # bytes of dynamic shared memory per block
    mid: int
    slab_shape: tuple          # bf16 (H, W, 128): first-half totals
    slab_bytes: int            # of one stream's slab
    streams: int = 1


class CensusYPlan(NamedTuple):
    """B5 geometry: per orientation `nbands` blocks, block c holding the
    columns bands(W)[c]; warp w of a block the `cpw` columns from w * cpw.
    A block's shared memory holds its band's row state twice (rows of odd
    and even parity), g x (ncols + 2) x 128 f32 each, two chunks of staged
    census rows, and, four times, a row of the other orientation's totals
    (ncols x 128 bf16) and of out (128 x (ncols | 1) f32).  The scans meet
    at row `mid`: the forward scan's totals of rows < mid and the backward
    scan's of rows >= mid go through the slab to the other scan.

    `streams` images run in one launch of the same 2 nbands blocks, each
    block walking its band's streams in turn, each stream with a slab of
    `slab_shape`.  The halo ring and the rows-done counters run on across
    the streams: stream s, row t is global row s rows + t, whose halo
    values carry `tag(s, t)` and sit in ring row `ring_slot(s, t)`."""
    nbands: int
    ncols: int                 # columns of a band (the last may be shorter)
    cpw: int                   # columns of a warp
    threads: int
    smem: int                  # bytes of dynamic shared memory per block
    mid: int
    slab_shape: tuple          # bf16 (H, W, 128): first-half totals
    slab_bytes: int            # of one stream's slab
    halo_bytes: int            # tagged edge carries (u64) + rows done (u32)
    rows: int = 0              # H
    streams: int = 1

    def bands(self, W: int):
        return [range(c * self.ncols, min(W, (c + 1) * self.ncols))
                for c in range(self.nbands)]

    def tag(self, stream: int, t: int) -> int:
        """The tag of the halo values of stream `stream`, row t (csrc
        store_tagged): one more than the global row, so a zeroed ring holds
        none."""
        return stream * self.rows + t + 1

    def ring_slot(self, stream: int, t: int) -> int:
        """The ring row (of _HALO_ROWS) that holds stream `stream`, row t's
        halo values."""
        return (stream * self.rows + t) % _HALO_ROWS

    def rows_done(self, stream: int, t: int) -> int:
        """A band's count of rows done once it finished stream `stream`,
        row t; the meeting of stream s waits for the other orientation's
        count to reach s rows + its first half."""
        return stream * self.rows + t + 1


def census_x_plan(H: int, W: int, n_d: int,
                  streams: int = 1) -> CensusXPlan:
    check_streams(streams)
    # a f32 out tile of 32 x 128 and a ring of 16 x 32 uint2 per warp, the
    # row's census
    smem = 2 * 4 * 32 * 128 + 2 * 8 * 16 * 32 + 4 * (4 * math.ceil(W / 4) + W)
    if smem > MAX_SMEM:
        raise ValueError(f"census_x: a row of width {W} needs {smem} B of "
                         f"shared memory > {MAX_SMEM}")
    return CensusXPlan(blocks=H, threads=64, smem=smem, mid=W // 2,
                       slab_shape=(H, W, 128), slab_bytes=2 * H * W * 128,
                       streams=streams)


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
                  sms: int = H100_SMS, streams: int = 1) -> CensusYPlan:
    """One block per SM: `sms // 2` bands per orientation (at most one per
    column), columns split evenly, one warp per column up to 20 warps.
    g is 1 or 3 (CENSUS_Y_ROLLS).  Raises if a band's row state does not
    fit one block's shared memory.  The geometry does not depend on
    `streams`: the blocks walk the streams (giving each stream sms / B SMs
    instead would widen the bands past what a block holds, e.g. 254,592 B
    at KITTI width with sms = 66)."""
    if g not in (1, 3) or plane_route(n_d) != "warp" or H < 1 or W < 1:
        raise ValueError(f"census_y: bad shape H={H} W={W} n_d={n_d} g={g}")
    _check_steps(streams, H)
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
                       halo_bytes=_halo_bytes(nbands, g), rows=H,
                       streams=streams)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def census_y_occupancy(H: int, W: int, n_d: int, g: int,
                       carry_bf16: bool = False) -> tuple:
    """(blocks, blocks one SM holds at once, SMs) of B5's plan on the
    current card (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`); the
    cooperative launch needs blocks <= that x SMs.  The same for any number
    of streams (the blocks walk them)."""
    sms = _sms(torch.device("cuda"))
    plan = census_y_plan(H, W, n_d, g, sms)
    n = ctypes.c_int(0)
    err = _LIB.load().sgm_census_y_occupancy(n_d, g, int(bool(carry_bf16)),
                                        plan.cpw, plan.threads, plan.smem,
                                        ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           f"failed with CUDA error {err}")
    return 2 * plan.nbands, n.value, sms


def _launch_census_x(census_l, census_r, p1, p2, min_d, n_d, carry_bf16):
    lead, nb, H, W, cl, cr = _census_args(census_l, census_r, min_d, n_d)
    plan = census_x_plan(H, W, n_d, nb)
    dev = census_l.device
    out = torch.empty(lead + (n_d, H, W), dtype=torch.float32, device=dev)
    slab = torch.empty((nb,) + plan.slab_shape, dtype=torch.bfloat16,
                       device=dev)
    _LIB.launch("sgm_census_x", cl, cr, out.data_ptr(), slab.data_ptr(), nb,
                H, W, n_d, float(p1), float(p2), int(min_d),
                int(bool(carry_bf16)), plan.smem, kernel.stream(dev))
    return out


def _launch_census_y(census_l, census_r, out, v_rolls, p1, p2, min_d,
                     carry_bf16):
    n_d = out.shape[-3]
    lead, nb, H, W, cl, cr = _census_args(census_l, census_r, min_d, n_d)
    dev = census_l.device
    optr = check("out", out, torch.float32, lead + (n_d, H, W), dev)
    g = len(v_rolls)
    r0, r1, r2 = census_y_rolls(v_rolls)
    plan = census_y_plan(H, W, n_d, g, _sms(dev), nb)
    slab = torch.empty((nb,) + plan.slab_shape, dtype=torch.bfloat16,
                       device=dev)
    halo = torch.empty(plan.halo_bytes, dtype=torch.uint8, device=dev)
    _LIB.launch("sgm_census_y", cl, cr, optr, slab.data_ptr(),
                halo.data_ptr(), nb, H, W, n_d, g, r0, r1, r2, float(p1),
                float(p2), int(min_d), int(bool(carry_bf16)), plan.nbands,
                plan.ncols, plan.cpw, plan.threads, plan.smem,
                kernel.stream(dev))
    return out


def _census_lines_family(census_l, census_r, rolls, entry, p1, p2, min_d,
                         n_d, carry_bf16):
    """One family of the census aggregate above 128 planes, a
    `sgm_census_lines` call on B4's wide-route geometry (`axis_plan` over
    the family's (L, R)): entry "x" -> f32 lead + (W, H, n_d), rolls (0);
    entry "y" -> lead + (H, W, n_d), the matcher's rolls.  Its scratch is
    freed on return.  Plain twin: `ops/sgm.census_family`."""
    lead, nb, H, W, cl, cr = _census_args(census_l, census_r, min_d, n_d,
                                          max_d=MAX_PLANES)
    dev = census_l.device
    L, R = (W, H) if entry == "x" else (H, W)
    fp = axis_plan(L, R, n_d, rolls, _sms(dev), nb)
    r0, r1, r2 = _rolls(rolls)
    scratch = torch.empty(fp.scratch_shape, dtype=torch.float32, device=dev)
    out = torch.empty(lead + (L, R, n_d), dtype=torch.float32, device=dev)
    _LIB.launch("sgm_census_lines", cl, cr, scratch.data_ptr(),
                out.data_ptr(), fp.streams, H, W, n_d, fp.g, r0, r1, r2,
                float(p1), float(p2), int(bool(carry_bf16)), _ENTRY[entry],
                int(min_d), kernel.stream(dev))
    return out


def _launch_census_aggregate(census_l, census_r, v_rolls, p1, p2, min_d,
                             n_d, carry_bf16):
    if plane_route(n_d) == "warp":
        out = _launch_census_x(census_l, census_r, p1, p2, min_d, n_d,
                               carry_bf16)
        return _launch_census_y(census_l, census_r, out, v_rolls, p1, p2,
                                min_d, carry_bf16)
    # the line kernel, one call a family (raising past MAX_PLANES)
    opts = (p1, p2, min_d, n_d, carry_bf16)
    return plain.family_sum(
        _census_lines_family(census_l, census_r, (0,), "x", *opts),
        _census_lines_family(census_l, census_r, v_rolls, "y", *opts))


def _census_y_twin(census_l, census_r, out, v_rolls, p1, p2, min_d,
                   carry_bf16=False):
    """census_y's plain twin: `ops/sgm.census_y_family` added into out."""
    return out.add_(plain.census_y_family(census_l, census_r, v_rolls, p1,
                                          p2, min_d, out.shape[-3],
                                          carry_bf16))


def census_x(census_l: torch.Tensor, census_r: torch.Tensor, p1: float,
             p2: float, min_d: int, n_d: int,
             carry_bf16: bool = False) -> torch.Tensor:
    """B6: horizontal family of the census aggregate -> f32 (n_d, H, W);
    (B, H, W) census images, or a call under torch.func.vmap, in one launch
    -> (B, n_d, H, W).  Plain twin: `ops/sgm.census_x_family`."""
    return kernel.dispatch(plain.census_x_family, _launch_census_x, 2,
                           census_l, census_r, p1, p2, min_d, n_d,
                           carry_bf16)


def census_y(census_l: torch.Tensor, census_r: torch.Tensor,
             out: torch.Tensor, v_rolls, p1: float, p2: float, min_d: int,
             carry_bf16: bool = False) -> torch.Tensor:
    """B5: adds the vertical (+ diagonal) family of the census aggregate to
    `out` (f32 (n_d, H, W), in place) and returns it; (B, H, W) census
    images and out (B, n_d, H, W), or a call under torch.func.vmap (out
    batched too), in one launch.  Plain twin: `out +
    ops/sgm.census_y_family`."""
    return kernel.dispatch(_census_y_twin, _launch_census_y, 2, census_l,
                           census_r, out, v_rolls, p1, p2, min_d, carry_bf16,
                           inplace=2)


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                     carry_bf16: bool = False) -> torch.Tensor:
    """4/8-path SGM aggregation straight from (H, W) int32 census images
    -> f32 (n_d, H, W), x family + y family; the cost volume never
    materializes.  On a CUDA tensor the route is `plane_route(n_d)`: B6 +
    B5 ("warp"), or B4's line kernel and combine pass once per family with
    the cost computed from the census images ("lines", bitwise B4 on the
    census volume).  (B, H, W) images, or a call under torch.func.vmap (the
    stereo fleet's round), run one launch of each kernel for the B streams
    -> (B, n_d, H, W).  Plain twin: `ops/sgm.census_aggregate`."""
    return kernel.dispatch(plain.census_aggregate, _launch_census_aggregate,
                           2, census_l, census_r, v_rolls, p1, p2, min_d,
                           n_d, carry_bf16)
