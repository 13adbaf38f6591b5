"""Depth map post-filters for matcher output: flying-pixel suppression and an
invalid-aware 3x3 median.

Counterpart of the JAX package's `ops/depthfilter.py`.  Raw matcher depth
carries speckles and flying pixels at occlusion boundaries that would seed
spurious surfels; both filters are shifts and elementwise work on (H, W)
planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifts3x3(x: torch.Tensor):
    """The 9 aligned 3x3-neighborhood planes of x (edge-replicated)."""
    p = F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    h, w = x.shape
    return [p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def median3x3(depth: torch.Tensor, min_valid: int = 5,
              fill_invalid: bool = False) -> torch.Tensor:
    """Invalid-aware 3x3 median of a depth map (0 = invalid): invalid
    neighbors sort to +inf, the median rank follows the valid count, and
    pixels with fewer than `min_valid` valid neighbors become invalid.  An
    invalid center stays invalid unless `fill_invalid`."""
    planes = _shifts3x3(depth)
    stack = torch.stack([torch.where(p > 0, p, float("inf"))
                         for p in planes])                  # (9, H, W)
    n_valid = torch.stack([p > 0 for p in planes]).sum(dim=0)
    s = torch.sort(stack, dim=0).values
    idx = ((n_valid - 1) // 2).clamp(0, 8)
    med = torch.gather(s, 0, idx[None])[0]
    ok = n_valid >= min_valid
    if not fill_invalid:
        ok = ok & (depth > 0)
    return torch.where(ok & torch.isfinite(med), med, 0.0)


def suppress_flyers(depth: torch.Tensor, rel_threshold: float = 0.03,
                    min_agree: int = 3) -> torch.Tensor:
    """A valid pixel survives only if at least `min_agree` valid neighbors
    agree with it within `rel_threshold` relative depth."""
    planes = _shifts3x3(depth)
    agree = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    tol = rel_threshold * depth.clamp_min(1e-6)
    for i, p in enumerate(planes):
        if i == 4:
            continue
        agree = agree + ((p > 0) & ((p - depth).abs() <= tol)).to(
            torch.int32)
    return torch.where((depth > 0) & (agree >= min_agree), depth, 0.0)


def clean_depth(depth: torch.Tensor, rel_threshold: float = 0.03,
                min_agree: int = 3, min_valid: int = 5) -> torch.Tensor:
    """Flyer suppression, then the median denoise."""
    return median3x3(suppress_flyers(depth, rel_threshold, min_agree),
                     min_valid)
