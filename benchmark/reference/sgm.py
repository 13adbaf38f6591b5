"""Plain PyTorch twin of the census SGM aggregate, on both of the port's
routes: the fused census kernels B6 + B5 (0 < D' < 128) and B4 over a
materialized cost volume (its narrow route for D' <= 128, its wide one up
to 1,024).  Both routes scan the same bf16 census volume with the same
per-orientation grouping, x family then y family, so one twin serves them
(a frozen copy of the port's `ops/sgm.py` and `models/stereo._sgm_aggregate`).

Counterpart of the JAX package's `ops/pallas/sgm.py` entry point, with its
signature.  The CPU path of the port runs such twins; on the card this is
the yardstick the kernels are held to.  It follows the kernels' f32 update
grouping `cost + (cand - Lmin)` (`models/stereo._sgm_dp`).
"""

from __future__ import annotations

import torch


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int,
                     n_d: int) -> torch.Tensor:
    """4/8-path SGM aggregation straight from (H, W) int32 census images:
    the (n_d, H, W) bf16 census volume (plane k holds disparity k + min_d)
    built once, then the f32 (n_d, H, W) x family + y family, in that
    order, each the f32 sum of its two bf16 orientations (twin of B6 + B5,
    and of B4's two calls)."""
    from .stereo import _axis_scan, _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    x = _axis_scan(vol.permute(2, 1, 0).contiguous(), (0,), p1, p2,
                   entry="x", min_d=min_d).permute(2, 1, 0)
    y = _axis_scan(vol.permute(1, 2, 0).contiguous(), tuple(v_rolls), p1,
                   p2, entry="y", min_d=min_d)
    return x + y.permute(2, 0, 1)
