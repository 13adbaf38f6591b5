"""Wrappers of the SGM CUDA kernels (`csrc/sgm.cu`), the counterpart of the
JAX package's `ops/pallas/sgm.py`.

Each wrapper has the signature of its plain twin in `ops/sgm.py`.  On a CPU
tensor it runs that twin; on a CUDA tensor it checks the inputs, launches
the kernels on the current stream and raises if a launch failed; it never
falls back.  `LAUNCHES` counts the calls of each kernel entry:

* sgm_axis_scan (B4): the line scan of a materialized volume and its
  combine pass;
* sgm_census_x (B6): the horizontal family of the census aggregate;
* sgm_census_y (B5): the vertical + diagonal family (line scan + combine).
"""

from __future__ import annotations

import ctypes

import torch

from .. import sgm as plain
from . import build
from .slic import _check

LAUNCHES = {"sgm_axis_scan": 0, "sgm_census_y": 0, "sgm_census_x": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sgm_axis_scan": [_P] * 3 + [_I] * 7 + [_F, _F] + [_I] * 3 + [_P],
    "sgm_census_x": [_P] * 3 + [_I] * 3 + [_F, _F] + [_I] * 2 + [_P],
    "sgm_census_y": [_P] * 4 + [_I] * 7 + [_F, _F] + [_I] * 2 + [_P],
}
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


def axis_scan(v: torch.Tensor, rolls, p1: float, p2: float,
              carry_bf16: bool = False, entry=None,
              min_d: int = 0) -> torch.Tensor:
    """B4: sum of the 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) bf16 volume -> f32 (L, R, D).  Plain twin:
    `ops/sgm.axis_scan`."""
    if v.device.type == "cpu":
        return plain.axis_scan(v, rolls, p1, p2, carry_bf16=carry_bf16,
                               entry=entry, min_d=min_d)
    if v.device.type != "cuda":
        raise ValueError(f"the SGM kernels run on CUDA tensors, got "
                         f"{v.device}")
    if v.dim() != 3 or not 1 <= v.shape[2] <= 1024:
        raise ValueError(f"v must be (L, R, D) with 1 <= D <= 1024, got "
                         f"{tuple(v.shape)}")
    if entry not in _ENTRY:
        raise ValueError(f"entry must be None, 'x' or 'y', got {entry!r}")
    L, R, D = v.shape
    ptr = _check("v", v, torch.bfloat16, (L, R, D), v.device)
    g = len(rolls)
    r0, r1, r2 = _rolls(rolls)
    scratch = torch.empty((2 * g, L * R * D), dtype=torch.float32,
                          device=v.device)
    out = torch.empty((L, R, D), dtype=torch.float32, device=v.device)
    err = _lib().sgm_axis_scan(
        ptr, scratch.data_ptr(), out.data_ptr(), L, R, D, g, r0, r1, r2,
        float(p1), float(p2), int(bool(carry_bf16)), _ENTRY[entry],
        int(min_d), torch.cuda.current_stream(v.device).cuda_stream)
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


def census_x(census_l: torch.Tensor, census_r: torch.Tensor, p1: float,
             p2: float, min_d: int, n_d: int,
             carry_bf16: bool = False) -> torch.Tensor:
    """B6: horizontal family of the census aggregate -> f32 (n_d, H, W).
    Plain twin: `ops/sgm.census_x_family`."""
    if census_l.device.type == "cpu":
        return plain.census_x_family(census_l, census_r, p1, p2, min_d, n_d,
                                     carry_bf16)
    H, W, cl, cr, stream = _census_args(census_l, census_r, min_d, n_d)
    out = torch.empty((n_d, H, W), dtype=torch.float32,
                      device=census_l.device)
    err = _lib().sgm_census_x(cl, cr, out.data_ptr(), H, W, n_d, float(p1),
                              float(p2), int(min_d), int(bool(carry_bf16)),
                              stream)
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
    optr = _check("out", out, torch.float32, (n_d, H, W), census_l.device)
    g = len(v_rolls)
    r0, r1, r2 = _rolls(v_rolls)
    scratch = torch.empty((2 * g, H * W * n_d), dtype=torch.float32,
                          device=census_l.device)
    err = _lib().sgm_census_y(cl, cr, scratch.data_ptr(), optr, H, W, n_d, g,
                              r0, r1, r2, float(p1), float(p2), int(min_d),
                              int(bool(carry_bf16)), stream)
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
