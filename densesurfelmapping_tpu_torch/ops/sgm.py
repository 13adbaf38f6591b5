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


def family_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The f32 SGM aggregate lead + (D, H, W) of the x family (lead + (W,
    H, D), the scan over image x) and the y family (lead + (H, W, D), the
    scan over image y): x + y, in that order, of the two families permuted
    to (D, H, W).  The sum takes its layout from the two permuted views,
    so it is not contiguous in (D, H, W)."""
    n = x.dim() - 3
    lead = tuple(range(n))
    return (x.permute(*lead, n + 2, n + 1, n)
            + y.permute(*lead, n + 2, n, n + 1))


def census_family(census_l: torch.Tensor, census_r: torch.Tensor, rolls,
                  entry: str, p1: float, p2: float, min_d: int, n_d: int,
                  carry_bf16: bool = False) -> torch.Tensor:
    """One family of the census aggregate in its scan layout, the f32 sum
    of its two bf16 orientations: entry "x" -> (W, H, n_d), rolls (0,);
    entry "y" -> (H, W, n_d), the matcher's rolls.  Here the census cost
    volume is built and scanned (twin of one `sgm_census_lines` call)."""
    from ..models.stereo import _census_volume
    vol = _census_volume(census_l, census_r, min_d, n_d)
    order = (2, 1, 0) if entry == "x" else (1, 2, 0)
    return axis_scan(vol.permute(*order).contiguous(), tuple(rolls), p1, p2,
                     carry_bf16, entry=entry, min_d=min_d)


def census_x_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    p1: float, p2: float, min_d: int, n_d: int,
                    carry_bf16: bool = False) -> torch.Tensor:
    """Horizontal family of the census aggregate, f32 (n_d, H, W): the f32
    sum of the forward and backward bf16 scans over x (twin of B6)."""
    return census_family(census_l, census_r, (0,), "x", p1, p2, min_d, n_d,
                         carry_bf16).permute(2, 1, 0)


def census_y_family(census_l: torch.Tensor, census_r: torch.Tensor,
                    v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                    carry_bf16: bool = False) -> torch.Tensor:
    """Vertical (+ diagonal, v_rolls (0, 1, -1)) family of the census
    aggregate, f32 (n_d, H, W) (twin of B5)."""
    return census_family(census_l, census_r, v_rolls, "y", p1, p2, min_d,
                         n_d, carry_bf16).permute(2, 0, 1)


def census_aggregate(census_l: torch.Tensor, census_r: torch.Tensor,
                     v_rolls, p1: float, p2: float, min_d: int, n_d: int,
                     carry_bf16: bool = False) -> torch.Tensor:
    """4/8-path SGM aggregation straight from (H, W) int32 census images:
    the f32 (n_d, H, W) `family_sum` of the x and y families (twin of B6 +
    B5, and of the census route of B4's line kernel)."""
    opts = (p1, p2, min_d, n_d, carry_bf16)
    return family_sum(census_family(census_l, census_r, (0,), "x", *opts),
                      census_family(census_l, census_r, v_rolls, "y", *opts))
