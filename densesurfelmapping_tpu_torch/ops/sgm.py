"""Plain PyTorch twins of the SGM kernels (`ops/cuda/sgm.py`, `csrc/sgm.cu`).

Counterpart of the JAX package's `ops/pallas/sgm.py` entry points, with
their signatures.  The CPU path of the port runs these; on the card they are
the yardstick the kernels are held to.  Both follow the kernels' f32 update
grouping `cost + (cand - Lmin)` (`models/stereo._sgm_dp`).
"""

from __future__ import annotations

import torch


def axis_scan(v: torch.Tensor, rolls, p1: float, p2: float,
              carry_bf16: bool = False, entry=None,
              min_d: int = 0) -> torch.Tensor:
    """Sum of the 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) cost volume: f32 sum of the two bf16 orientation outputs
    (twin of the B4 kernel, `axis_scan_pallas` in the JAX package)."""
    from ..models.stereo import _axis_scan
    return _axis_scan(v, rolls, p1, p2, carry_bf16=carry_bf16, entry=entry,
                      min_d=min_d, kernel_grouping=True)


def census_x_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    p1: float, p2: float, min_d: int, n_d: int,
                    carry_bf16: bool = False) -> torch.Tensor:
    """Horizontal family of the census aggregate, f32 (n_d, H, W): the f32
    sum of the forward and backward bf16 scans over x (twin of B6)."""
    from ..models.stereo import _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    return axis_scan(vol.permute(2, 1, 0).contiguous(), (0,), p1, p2,
                     carry_bf16, entry="x", min_d=min_d).permute(2, 1, 0)


def census_y_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                    carry_bf16: bool = False) -> torch.Tensor:
    """Vertical (+ diagonal, v_rolls (0, 1, -1)) family of the census
    aggregate, f32 (n_d, H, W) (twin of B5)."""
    from ..models.stereo import _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    return axis_scan(vol.permute(1, 2, 0).contiguous(), tuple(v_rolls), p1,
                     p2, carry_bf16, entry="y",
                     min_d=min_d).permute(2, 0, 1)


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                     carry_bf16: bool = False) -> torch.Tensor:
    """4/8-path SGM aggregation straight from (H, W) int32 census images:
    the f32 (n_d, H, W) volume x family + y family, each the f32 sum of its
    two bf16 orientations (twin of B6 + B5, and above 128 planes of B4's
    census route).  Here the census cost volume is built and scanned."""
    return (census_x_family(census_l, census_r, p1, p2, min_d, n_d,
                            carry_bf16)
            + census_y_family(census_l, census_r, v_rolls, p1, p2, min_d,
                              n_d, carry_bf16))
