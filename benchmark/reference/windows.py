"""Per-seed window extraction: every seed's 2*SP x 2*SP pixel window as a
dense (R, C, 4*SP*SP) tensor (counterpart of the JAX package's
`ops/windows.py`).

Every per-superpixel stage of the reference scans the seed's window testing
`superpixel_index[p] == seed` (`fusion_functions.cpp:497-515, 738-760,
811-839`); here all reductions are masked sums over the window axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def extract_windows(field: torch.Tensor, sp: int) -> torch.Tensor:
    """(H, W) -> (R, C, 4*sp*sp) where window (r, c) is the row-major
    flattening of field[r*sp - sp/2 : r*sp + 3sp/2, c*sp - sp/2 : c*sp + 3sp/2]
    zero-padded outside the array (reference window geometry,
    `fusion_functions.cpp:482-485`)."""
    h, w = field.shape
    if h % sp or w % sp:
        raise ValueError(f"field {(h, w)} does not tile by sp={sp}")
    r, c = h // sp, w // sp
    half = sp // 2
    padded = F.pad(field[None], (half, sp - half, half, sp - half))[0]
    # non-overlapping sp x sp tiles of the padded image
    tiles = padded.reshape(r + 1, sp, c + 1, sp).permute(0, 2, 1, 3)
    top = torch.cat([tiles[:-1, :-1], tiles[:-1, 1:]], dim=-1)
    bot = torch.cat([tiles[1:, :-1], tiles[1:, 1:]], dim=-1)
    win = torch.cat([top, bot], dim=-2)                  # (r, c, 2sp, 2sp)
    return win.reshape(r, c, 4 * sp * sp)


@functools.lru_cache(maxsize=8)
def window_pixel_coords(rows: int, cols: int, sp: int):
    """Static (R, C, 4*sp*sp) int32 arrays of each window element's absolute
    pixel (y, x) coordinate (host numpy constants)."""
    wy = np.arange(2 * sp)
    wx = np.arange(2 * sp)
    oy = (np.arange(rows) * sp - sp // 2)[:, None, None, None]
    ox = (np.arange(cols) * sp - sp // 2)[None, :, None, None]
    y = np.broadcast_to(oy + wy[None, None, :, None], (rows, cols, 2 * sp, 2 * sp))
    x = np.broadcast_to(ox + wx[None, None, None, :], (rows, cols, 2 * sp, 2 * sp))
    k = 4 * sp * sp
    return (y.reshape(rows, cols, k).astype(np.int32),
            x.reshape(rows, cols, k).astype(np.int32))


@functools.lru_cache(maxsize=8)
def window_interior_mask(rows: int, cols: int, sp: int,
                         orig_h: int, orig_w: int) -> np.ndarray:
    """Window elements the reference's *clamped* scans visit:
    0 <= y < orig_h - 1 and 0 <= x < orig_w - 1 (`update_seeds_kernel` and
    the seed-init depth steal, `fusion_functions.cpp:486-489, 606-609`)."""
    y, x = window_pixel_coords(rows, cols, sp)
    return (y >= 0) & (y < orig_h - 1) & (x >= 0) & (x < orig_w - 1)


@functools.lru_cache(maxsize=8)
def window_image_mask(rows: int, cols: int, sp: int,
                      orig_h: int, orig_w: int) -> np.ndarray:
    """Window elements inside the full raw image, last row/column included
    (`calculate_sp_depth_norms_kernel`'s flat-index bound,
    `fusion_functions.cpp:815-817`)."""
    y, x = window_pixel_coords(rows, cols, sp)
    return (y >= 0) & (y < orig_h) & (x >= 0) & (x < orig_w)


def first_valid(values: torch.Tensor, valid: torch.Tensor):
    """Along the last axis: (first valid value or 0, any valid) — the
    reference's early-break row-major depth steal
    (`fusion_functions.cpp:610-625`)."""
    # argmax of a 0/1 plane returns the first maximal index
    idx = torch.argmax(valid.to(torch.uint8), dim=-1)
    found = valid.any(dim=-1)
    picked = torch.gather(values, -1, idx[..., None])[..., 0]
    return torch.where(found, picked, 0.0), found


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values, 0.0).sum(dim=-1)


def upsample_to_pixels(seed_field: torch.Tensor, sp: int) -> torch.Tensor:
    """(R, C) seed plane -> (H, W) pixel plane by sp x sp block replication."""
    r, c = seed_field.shape
    return seed_field[:, None, :, None].expand(r, sp, c, sp).reshape(
        r * sp, c * sp)
