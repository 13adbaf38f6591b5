"""Wrappers of the SLIC CUDA kernels (`csrc/slic.cu`), the counterpart of the
JAX package's `ops/pallas/slic.py`.

Each wrapper has the signature of its plain twin in `ops/superpixel.py`.  On
a CPU tensor it runs that twin; on a CUDA tensor it checks the inputs,
launches the kernel on the current stream and raises if the launch failed;
it never falls back.  `LAUNCHES` counts the kernel launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SurfelMapConfig
from .. import superpixel as plain
from . import build

LAUNCHES = {"slic_assign": 0, "slic_centroid": 0, "slic_huber": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "slic_assign": [_P] * 10 + [_I] * 6 + [_P],
    "slic_centroid": [_P] * 4 + [_I] * 6 + [_P],
    "slic_huber": [_P] * 5 + [_I] * 6 + [_F, _P],
}


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


def _prepare(config: SurfelMapConfig, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"the SLIC kernels run on CUDA tensors, got {device}")
    if not 2 <= config.sp_size <= 16:
        raise ValueError(f"sp_size {config.sp_size} outside the kernels' "
                         "range 2..16 (one thread per window pixel)")
    return _lib(), torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def slic_assign(config: SurfelMapConfig, image, inv_depth, assignment,
                x, y, mean_intensity, mean_depth, stable):
    """B1: one pixel-assignment sweep -> (new_assignment (H, W) i32,
    claimed (R, C) bool).  Plain twin: `superpixel.assign_sweep`."""
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
    new_assignment = torch.empty(hw, dtype=i32, device=dev)
    claimed = torch.zeros(rc, dtype=i32, device=dev)
    err = lib.slic_assign(*ptrs, new_assignment.data_ptr(),
                          claimed.data_ptr(), hw[0], hw[1], rc[1],
                          config.height, config.width, config.sp_size,
                          stream)
    _launched("slic_assign", err)
    return new_assignment, claimed != 0


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
    out = torch.empty((6, rows, cols), dtype=torch.float32, device=dev)
    err = lib.slic_centroid(*ptrs, out.data_ptr(), hw[1], rows, cols,
                            config.height, config.width, config.sp_size,
                            stream)
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
    out = torch.empty(rc, dtype=torch.float32, device=dev)
    err = lib.slic_huber(*ptrs, out.data_ptr(), hw[1], rc[0], rc[1],
                         config.height, config.width, config.sp_size,
                         float(config.profile.huber_range), stream)
    _launched("slic_huber", err)
    return out
