"""Plain PyTorch twins of the fused census SGM kernels B5 and B6 (a frozen
copy of that route of the port's `ops/sgm.py`).

Counterpart of the JAX package's `ops/pallas/sgm.py` entry points, with
their signatures.  The CPU path of the port runs these; on the card they are
the yardstick the kernels are held to.  Both follow the kernels' f32 update
grouping `cost + (cand - Lmin)` (`models/stereo._sgm_dp`).
"""

from __future__ import annotations

import torch


def census_x_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    p1: float, p2: float, min_d: int,
                    n_d: int) -> torch.Tensor:
    """Horizontal family of the census aggregate, f32 (n_d, H, W): the f32
    sum of the forward and backward bf16 scans over x (twin of B6)."""
    from .stereo import _axis_scan, _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    return _axis_scan(vol.permute(2, 1, 0).contiguous(), (0,), p1, p2,
                      entry="x", min_d=min_d).permute(2, 1, 0)


def census_y_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    v_rolls, p1: float, p2: float, min_d: int,
                    n_d: int) -> torch.Tensor:
    """Vertical (+ diagonal, v_rolls (0, 1, -1)) family of the census
    aggregate, f32 (n_d, H, W) (twin of B5)."""
    from .stereo import _axis_scan, _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    return _axis_scan(vol.permute(1, 2, 0).contiguous(), tuple(v_rolls), p1,
                      p2, entry="y", min_d=min_d).permute(2, 0, 1)


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int,
                     n_d: int) -> torch.Tensor:
    """4/8-path SGM aggregation straight from (H, W) int32 census images:
    the f32 (n_d, H, W) volume x family + y family, each the f32 sum of its
    two bf16 orientations (twin of B6 + B5).  Here the census cost volume
    is built and scanned."""
    return (census_x_family(census_l, census_r, p1, p2, min_d, n_d)
            + census_y_family(census_l, census_r, v_rolls, p1, p2, min_d,
                              n_d))
