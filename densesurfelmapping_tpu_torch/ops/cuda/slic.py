"""Wrappers of the SLIC CUDA kernels (`csrc/slic.cu`), the counterpart of the
JAX package's `ops/pallas/slic.py`.

Each wrapper has the signature of its plain twin in `ops/superpixel.py`.  On
a CPU tensor it runs that twin; on a CUDA tensor it checks the inputs,
launches the kernel on the current stream and raises if the launch failed;
it never falls back.  `LAUNCHES` counts the kernel launches per kernel.

Stream axis: every wrapper also takes operands with a leading (B,) axis,
(B, H, W) pixel planes and (B, R, C) seed planes, the B streams of a
multi-session fleet, and launches its kernel ONCE for all of them (the
kernel's grid z is the stream), where the JAX package vmaps the TPU
kernels.  On a CPU tensor the plain twin runs under `torch.func.vmap`.
Inside a `torch.func.vmap` of the fuse step (`parallel/multistream.py`) a
CUDA call reaches the batched launch through the `vmap` rule of an
autograd.Function, so the single-frame step batches over streams without a
loop.  A single (H, W) call launches as it always did.

The launch geometry of the kernels comes from `assign_plan`,
`centroid_plan` and `huber_plan`, plain Python that the CPU tests check
(tests/test_torch_slic_plan.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ...config import SurfelMapConfig
from .. import superpixel as plain
from . import build

LAUNCHES = {"slic_assign": 0, "slic_centroid": 0, "slic_huber": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slic_assign": [_P] * 10 + [_I] * 11 + [_P],
    "slic_centroid": [_P] * 4 + [_I] * 11 + [_P],
    "slic_huber": [_P] * 5 + [_I] * 11 + [_F, _P],
}
MAX_SMEM = 232448         # shared memory one block may opt into (H100)
STRIP_SEEDS = 8           # B2/B3: seeds (warps) of a block, csrc kStripSeeds
ASSIGN_TILE = (32, 32)    # B1: pixel rows and columns of a block's tile
ASSIGN_THREADS = (32, 8)  # B1: threads of a block (x, y); 4 rows a thread


class AssignPlan(NamedTuple):
    """B1 geometry: block (bx, by, z) takes the pixels of stream z's tile
    whose corner is (y0, x0) = (by, bx) * ASSIGN_TILE, thread (lx, ly) the
    pixels (y0 + ly + 8 k, x0 + lx), k < rows_per_thread.  It stages the
    seed cells [y0 // sp - 1, + staged[0]) x [x0 // sp - 1, + staged[1]):
    every cell the tile touches and a one-seed ring, the most any block
    needs.  Shared memory: a float4 and two ints per staged seed, an int per
    tile row.  The C entry zeroes `claims` bytes (every stream's claims)
    before the launch."""
    grid: tuple                # (blocks along x, along y, streams)
    threads: tuple             # (32, 8)
    tile: tuple                # (rows, columns) of pixels
    rows_per_thread: int
    staged: tuple              # (nsy, nsx) seed cells
    smem: int                  # bytes of dynamic shared memory per block
    claims: int                # bytes of the claims memset, B * R * C


class StripPlan(NamedTuple):
    """B2/B3 geometry: block (bx, r, z) runs stream z's seeds (r, bx *
    seeds + w), one warp w each.  Their 2sp x 2sp windows' union spans 2sp
    rows from r * sp - sp/2 and (seeds + 1) sp columns from x0 = bx *
    seeds * sp - sp/2.  Shared memory stages `planes` 4-byte planes of it
    as `tile` = 2sp rows of `chunks` 16-byte chunks from the 4-aligned
    column x0 - off, then `list_floats` floats per warp (B3's member list).
    Lane l of warp w takes window pixels l + 32 j (row-major in the window,
    at tile column off + w * sp + window column) for j < per_lane."""
    seeds: int
    grid: tuple                # (blocks along the seed row, seed rows,
                               #  streams)
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


def _check_streams(nb: int) -> None:
    if not 1 <= nb <= 65535:
        raise ValueError(f"{nb} streams outside the grid's z range 1..65535")


def assign_plan(h: int, w: int, sp: int, nb: int = 1) -> AssignPlan:
    """B1 over nb padded (h, w) frames at seed pitch sp."""
    _check_sp(sp)
    _check_streams(nb)
    ty, tx = ASSIGN_TILE
    staged = (_cells_spanned(h, ty, sp) + 2, _cells_spanned(w, tx, sp) + 2)
    return AssignPlan(
        grid=(math.ceil(w / tx), math.ceil(h / ty), nb),
        threads=ASSIGN_THREADS, tile=ASSIGN_TILE,
        rows_per_thread=ty // ASSIGN_THREADS[1], staged=staged,
        smem=24 * staged[0] * staged[1] + 4 * ty,
        claims=nb * (h // sp) * (w // sp))


def _strip_plan(rows: int, cols: int, sp: int, planes: int,
                listed: bool, nb: int) -> StripPlan:
    _check_sp(sp)
    _check_streams(nb)
    per_lane = math.ceil(4 * sp * sp / 32)
    off = -(sp // 2) % 4          # bx * seeds * sp is a multiple of 4
    chunks = math.ceil((off + (STRIP_SEEDS + 1) * sp) / 4)
    tile = (2 * sp, 4 * chunks)
    list_floats = 32 * per_lane if listed else 0
    return StripPlan(
        seeds=STRIP_SEEDS, grid=(math.ceil(cols / STRIP_SEEDS), rows, nb),
        threads=32 * STRIP_SEEDS, off=off, chunks=chunks, tile=tile,
        planes=planes, list_floats=list_floats,
        smem=4 * (planes * tile[0] * tile[1] + STRIP_SEEDS * list_floats),
        per_lane=per_lane)


def centroid_plan(rows: int, cols: int, sp: int, nb: int = 1) -> StripPlan:
    """B2: image, depth and assignment staged; no member list."""
    return _strip_plan(rows, cols, sp, planes=3, listed=False, nb=nb)


def huber_plan(rows: int, cols: int, sp: int, nb: int = 1) -> StripPlan:
    """B3: depth and assignment staged, and a member list per warp."""
    return _strip_plan(rows, cols, sp, planes=2, listed=True, nb=nb)


def stream_bases(ptr: int, nb: int, plane_bytes: int) -> list:
    """The address of each stream's plane in a contiguous (nb, ...) operand
    whose planes are plane_bytes long: where the kernels' blockIdx.z
    offsets put them."""
    return [ptr + z * plane_bytes for z in range(nb)]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return build.load("slic", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    """t's data pointer, once its device, dtype, shape (a batched call puts
    the stream count first) and layout are the kernel's."""
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


def _check_chunks(w: int, bases) -> None:
    """B2/B3 stage 16-byte chunks: the rows of every stream's plane must
    start 16-byte aligned (`bases`: each plane's address, `stream_bases`)."""
    bad = [p for p in bases if p % 16]
    if w % 4 or bad:
        raise ValueError(f"the strip kernels need a width that is a "
                         f"multiple of 4 (got {w}) and 16-byte aligned "
                         f"planes (misaligned: {bad[:4]})")


def _prepare(config: SurfelMapConfig, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"the SLIC kernels run on CUDA tensors, got {device}")
    _check_sp(config.sp_size)
    return _lib(), torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _lead(t: torch.Tensor) -> tuple:
    """() for a single frame, (B,) for the stream axis of a batched call."""
    lead = tuple(t.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"the SLIC kernels take (H, W) or (B, H, W) "
                         f"operands, got {tuple(t.shape)}")
    return lead


def _in_vmap(*ts) -> bool:
    """Some operand is a torch.func.vmap batched tensor."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in ts)


def _plain_batched(fn, config: SurfelMapConfig, *ts):
    """The plain twin over a leading stream axis (CPU tensors)."""
    return torch.func.vmap(functools.partial(fn, config))(*ts)


def _batch_operands(n: int, in_dims, ts) -> list:
    """For a vmap rule: every operand with the stream axis first and
    contiguous; one that vmap does not batch (a constant plane, such as the
    initial seed grid) is repeated for each of the n streams."""
    return [(t.expand(n, *t.shape) if d is None else t.movedim(d, 0))
            .contiguous() for t, d in zip(ts, in_dims)]


def _vmappable(launch, n_out: int):
    """An autograd.Function around `launch(config, *tensors)` whose vmap
    rule makes ONE batched launch for every stream: under torch.func.vmap
    the fuse step of one frame reaches the kernels' stream axis."""
    out_dims = 0 if n_out == 1 else (0,) * n_out

    class Launch(torch.autograd.Function):
        @staticmethod
        def forward(config, *ts):
            return launch(config, *ts)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def vmap(info, in_dims, config, *ts):
            return launch(config, *_batch_operands(
                info.batch_size, in_dims[1:], ts)), out_dims

    return Launch


def _launch_assign(config: SurfelMapConfig, image, inv_depth, assignment,
                   x, y, mean_intensity, mean_depth, stable):
    dev = image.device
    lib, stream = _prepare(config, dev)
    lead = _lead(image)
    nb = lead[0] if lead else 1
    hw = lead + (config.padded_height, config.padded_width)
    rc = lead + (config.sp_rows, config.sp_cols)
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check("image", image, f32, hw, dev),
            _check("inv_depth", inv_depth, f32, hw, dev),
            _check("assignment", assignment, i32, hw, dev),
            _check("x", x, f32, rc, dev), _check("y", y, f32, rc, dev),
            _check("mean_intensity", mean_intensity, f32, rc, dev),
            _check("mean_depth", mean_depth, f32, rc, dev),
            _check("stable", stable, torch.bool, rc, dev)]
    plan = assign_plan(*hw[-2:], config.sp_size, nb)
    new_assignment = torch.empty(hw, dtype=i32, device=dev)
    claimed = torch.empty(rc, dtype=torch.bool, device=dev)
    err = lib.slic_assign(*ptrs, new_assignment.data_ptr(),
                          claimed.data_ptr(), nb, *hw[-2:], *rc[-2:],
                          config.height, config.width, config.sp_size,
                          *plan.staged, plan.smem, stream)
    _launched("slic_assign", err)
    return new_assignment, claimed


def _launch_centroid(config: SurfelMapConfig, image, depth, assignment):
    dev = image.device
    lib, stream = _prepare(config, dev)
    lead = _lead(image)
    nb = lead[0] if lead else 1
    ph, pw = config.padded_height, config.padded_width
    rows, cols = config.sp_rows, config.sp_cols
    hw = lead + (ph, pw)
    ptrs = [_check("image", image, torch.float32, hw, dev),
            _check("depth", depth, torch.float32, hw, dev),
            _check("assignment", assignment, torch.int32, hw, dev)]
    _check_chunks(pw, [b for p in ptrs
                       for b in stream_bases(p, nb, 4 * ph * pw)])
    plan = centroid_plan(rows, cols, config.sp_size, nb)
    # (6, B, R, C): each of the six planes comes out contiguous
    out = torch.empty((6,) + lead + (rows, cols), dtype=torch.float32,
                      device=dev)
    err = lib.slic_centroid(*ptrs, out.data_ptr(), nb, ph, pw, rows, cols,
                            config.height, config.width, config.sp_size,
                            plan.chunks, plan.per_lane, plan.smem, stream)
    _launched("slic_centroid", err)
    return tuple(out.unbind(0))


def _launch_huber(config: SurfelMapConfig, depth, assignment, mean,
                  converged):
    dev = depth.device
    lib, stream = _prepare(config, dev)
    lead = _lead(depth)
    nb = lead[0] if lead else 1
    ph, pw = config.padded_height, config.padded_width
    hw = lead + (ph, pw)
    rc = lead + (config.sp_rows, config.sp_cols)
    ptrs = [_check("depth", depth, torch.float32, hw, dev),
            _check("assignment", assignment, torch.int32, hw, dev),
            _check("mean", mean, torch.float32, rc, dev),
            _check("converged", converged, torch.bool, rc, dev)]
    _check_chunks(pw, [b for p in ptrs[:2]
                       for b in stream_bases(p, nb, 4 * ph * pw)])
    plan = huber_plan(*rc[-2:], config.sp_size, nb)
    out = torch.empty(rc, dtype=torch.float32, device=dev)
    err = lib.slic_huber(*ptrs, out.data_ptr(), nb, ph, pw, *rc[-2:],
                         config.height, config.width, config.sp_size,
                         plan.chunks, plan.per_lane, plan.smem,
                         float(config.profile.huber_range), stream)
    _launched("slic_huber", err)
    return out


_Assign = _vmappable(_launch_assign, 2)
_Centroid = _vmappable(_launch_centroid, 6)
_Huber = _vmappable(_launch_huber, 1)


def slic_assign(config: SurfelMapConfig, image, inv_depth, assignment,
                x, y, mean_intensity, mean_depth, stable):
    """B1: one pixel-assignment sweep -> (new_assignment (H, W) i32,
    claimed (R, C) bool), each with the stream axis first in a batched
    call.  Plain twin: `superpixel.assign_sweep`.  The kernel writes the
    bool claims itself (the C entry zeroes them first): two device
    operations per call, the memset and the kernel, however many streams."""
    args = (image, inv_depth, assignment, x, y, mean_intensity, mean_depth,
            stable)
    if image.device.type == "cpu":
        if image.dim() == 3:
            return _plain_batched(plain.assign_sweep, config, *args)
        return plain.assign_sweep(config, *args)
    if _in_vmap(*args):
        return _Assign.apply(config, *args)
    return _launch_assign(config, *args)


def slic_centroid(config: SurfelMapConfig, image, depth, assignment):
    """B2: per-seed sums -> six (R, C) f32 planes (n, sum x, sum y,
    sum intensity, n with depth, sum depth), (B, R, C) in a batched call.
    Plain twin: `superpixel.seed_sums`."""
    args = (image, depth, assignment)
    if image.device.type == "cpu":
        if image.dim() == 3:
            return _plain_batched(plain.seed_sums, config, *args)
        return plain.seed_sums(config, *args)
    if _in_vmap(*args):
        return _Centroid.apply(config, *args)
    return _launch_centroid(config, *args)


def slic_huber(config: SurfelMapConfig, depth, assignment, mean, converged):
    """B3: five Huber-Newton steps of the per-seed mean depth with the
    convergence latch, in one launch -> (R, C) f32 mean ((B, R, C) in a
    batched call).  Plain twin: `superpixel.huber_mean_depth`."""
    args = (depth, assignment, mean, converged)
    if depth.device.type == "cpu":
        if depth.dim() == 3:
            return _plain_batched(plain.huber_mean_depth, config, *args)
        return plain.huber_mean_depth(config, *args)
    if _in_vmap(*args):
        return _Huber.apply(config, *args)
    return _launch_huber(config, *args)
