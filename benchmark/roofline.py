"""The table of peaks and the work each kernel's algorithm needs at given
shapes: each input byte read once, each output byte written once, and the
f32 operations, whatever implements it (a later kernel that fuses these
steps is measured against the same work).

The byte counts are those of the port's `chip_smoke.py` (its kernel
table's bounds, PERF.md), recomputed here from the shapes.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12, f32_per_s=67e12),
}


def peak(device_name: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)


def bound_s(nbytes: float, ops: float, pk: dict) -> float:
    """The least time the card could take."""
    return max(nbytes / pk["bytes_per_s"], ops / pk["f32_per_s"])


def slic_work(padded_h: int, padded_w: int, n_seeds: int) -> dict:
    """(bytes, operations) of one launch of each SLIC kernel over a padded
    frame of padded_h x padded_w with n_seeds seeds."""
    hw = padded_h * padded_w
    return {
        # B1: reads image, inverse depth, assignment, four seed planes and
        # the stable flags; writes the assignment and the bool claims; ~20
        # f32 operations per admitted candidate, at most 4 a pixel
        "slic_assign": (4 * hw * 4 + n_seeds * (4 * 4 + 1 + 1), hw * 4 * 20),
        # B2: reads image, depth, assignment; writes six seed planes; six
        # adds per pixel
        "slic_centroid": (3 * hw * 4 + 6 * n_seeds * 4, 6 * hw),
        # B3: reads depth, assignment, the mean and the latch; writes the
        # mean; five Huber steps of ~8 operations per pixel
        "slic_huber": (2 * hw * 4 + n_seeds * (4 + 1 + 4), 5 * 8 * hw),
    }


def sgm_work(h: int, w: int, n_d: int, v_paths: int = 3) -> dict:
    """(bytes, operations) of one launch of each SGM kernel over an h x w
    pair with n_d disparity planes (v_paths: directions of the y family per
    orientation, 3 for 8 paths)."""
    cells = h * w * n_d
    census = 2 * h * w * 4
    return {
        # B6: reads two census images, writes the x family (f32); ~10
        # operations per cell and orientation
        "census_x": (census + cells * 4, 2 * cells * 10),
        # B5: reads two census images and the x family, writes the sum
        "census_y": (census + 2 * cells * 4, 2 * v_paths * cells * 10),
        # B4 (one family): reads the bf16 volume, writes the f32 sum
        "axis_scan": (cells * 2 + cells * 4, 2 * v_paths * cells * 10),
    }


def share(runs_and_secs: dict, work: dict, pk: dict):
    """Roofline share (%) of a group of kernels: the least time of the runs
    counted over the time they took.  `runs_and_secs`: kernel -> (runs,
    seconds); None when no run of them was seen."""
    need = sum(n * bound_s(*work[k], pk) for k, (n, _) in
               runs_and_secs.items())
    took = sum(s for _, s in runs_and_secs.values())
    if took <= 0 or need <= 0:
        return None
    return 100.0 * need / took
