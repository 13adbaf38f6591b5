"""The launch plans of the SLIC kernels B1, B2 and B3
(`ops/cuda/slic.py::assign_plan`, `centroid_plan`, `huber_plan`): plain
Python, checked here on the CPU for every seed pitch the kernels take (sp
2..16), on KITTI's seed grid (47 x 160) and small or odd ones, by replaying
the kernels' indexing as `csrc/slic.cu` writes it (B1's tiles and candidate
slots, `Strip`, `WindowWalk`)."""

import math

import numpy as np
import pytest

from densesurfelmapping_tpu_torch.ops.cuda import slic as kslic

SPS = list(range(2, 17))
# seed grids (rows, cols): small and odd ones; KITTI's below
GRIDS = [(7, 20), (4, 8), (1, 1), (13, 9)]
PLANS = {"centroid": kslic.centroid_plan, "huber": kslic.huber_plan}


def _walk(sp: int, lane: int, per_lane: int):
    """WindowWalk: lane's window pixels (wy, wx) for j < per_lane, starting
    at lane / 2sp, lane % 2sp and stepping by 32 without a division."""
    side = 2 * sp
    wy, wx = lane // side, lane % side
    out = []
    for _ in range(per_lane):
        if wy < side:
            out.append((wy, wx))
        wx += 32 % side
        wy += 32 // side
        if wx >= side:
            wx -= side
            wy += 1
    return out


def _replay(plan, rows, cols, sp):
    """Times each seed is run by a warp (warp w of block (bx, r) runs seed
    (r, bx * seeds + w) when it exists); asserts that the lanes' walks take
    every pixel of a window once and that each read sits in the staged tile
    at the frame position of that window pixel."""
    side = 2 * sp
    tile_h, tile_w = plan.tile
    win = np.zeros((side, side), np.int64)
    for lane in range(32):
        for wy, wx in _walk(sp, lane, plan.per_lane):
            win[wy, wx] += 1
    assert (win == 1).all()
    gx, gy = plan.grid
    warps = plan.threads // 32
    for w in range(warps):
        # tile row wy, column off + w * sp + wx (the tile's column 0 is the
        # 4-aligned xa = x0 - off, x0 = bx * seeds * sp - sp/2) is window
        # pixel (wy, wx) of seed c = bx * seeds + w, whose window starts at
        # c * sp - sp/2
        assert side <= tile_h and plan.off + w * sp + side <= tile_w
        for bx in (0, 1, gx - 1):
            x0 = bx * plan.seeds * sp - sp // 2
            xa = x0 & ~3                  # the kernel's rounding down
            assert xa % 4 == 0 and x0 - xa == plan.off
            assert (xa + plan.off + w * sp
                    == (bx * plan.seeds + w) * sp - sp // 2)
    c = (np.arange(gx)[:, None] * plan.seeds + np.arange(warps)[None, :])
    c = c[c < cols]
    seeds = np.zeros((rows, cols), np.int64)
    for r in range(gy):
        np.add.at(seeds[r], c, 1)
    return seeds


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kernel", sorted(PLANS))
def test_strip_plan_covers_and_fits(kernel, grid, sp):
    rows, cols = grid
    plan = PLANS[kernel](rows, cols, sp)
    assert plan.threads == 32 * plan.seeds == 32 * kslic.STRIP_SEEDS
    assert (_replay(plan, rows, cols, sp) == 1).all()
    # pixels per lane as the kernels' source states: ceil((2sp)^2 / 32)
    assert plan.per_lane == math.ceil(4 * sp * sp / 32) <= 32
    # the union of the block's windows: 2sp rows, (seeds + 1) sp columns
    # after off, in 16-byte chunks; B3's member list holds a whole window
    assert plan.tile == (2 * sp, 4 * plan.chunks)
    assert 4 * (plan.chunks - 1) < plan.off + (plan.seeds + 1) * sp <= (
        plan.tile[1])
    assert plan.list_floats == (32 * plan.per_lane if kernel == "huber"
                                else 0) and plan.list_floats % 32 == 0
    assert plan.list_floats == 0 or plan.list_floats >= 4 * sp * sp
    assert plan.smem == 4 * (plan.planes * plan.tile[0] * plan.tile[1]
                             + plan.seeds * plan.list_floats)
    assert plan.smem <= kslic.MAX_SMEM


def test_kitti_plans_as_documented():
    """KITTI (47 x 160 seeds, sp 8): 20 x 47 blocks of 8 warps, 8 pixels
    per lane over a staged 16 x 72 tile: B2 stages three planes (13,824 B),
    B3 two and a 256-float member list per warp (17,408 B).  At sp 16 a lane
    takes 32 pixels and both need more than 48 KB (the opt-in)."""
    c = kslic.centroid_plan(47, 160, 8)
    h = kslic.huber_plan(47, 160, 8)
    for p in (c, h):
        assert (p.grid, p.per_lane, p.tile) == ((20, 47), 8, (16, 72))
        assert (_replay(p, 47, 160, 8) == 1).all()
    assert (c.smem, h.smem) == (13824, 17408)
    c16, h16 = kslic.centroid_plan(4, 8, 16), kslic.huber_plan(4, 8, 16)
    assert c16.per_lane == h16.per_lane == 32
    assert (c16.smem, h16.smem) == (55296, 69632)


@pytest.mark.parametrize("sp", [1, 17, 0])
def test_plans_refuse_sp_outside_the_kernels_range(sp):
    for plan in PLANS.values():
        with pytest.raises(ValueError, match="range 2..16"):
            plan(4, 4, sp)


@pytest.mark.parametrize("w, ptrs, ok", [
    (1280, [0, 16, 4096], True), (128, [256], True),
    (1282, [0, 16], False), (1280, [0, 8], False), (1280, [4], False)])
def test_strip_kernels_take_16_byte_rows_only(w, ptrs, ok):
    # B2/B3 copy 16-byte chunks: a row must start on a 16-byte boundary
    if ok:
        kslic._check_chunks(w, ptrs)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            kslic._check_chunks(w, ptrs)


# padded frames (h, w): KITTI, chip_smoke.py's 120 x 56 frame padded at sp
# 6 and 16, and odd ones
FRAMES = [(376, 1280), (60, 120), (64, 128), (33, 70), (5, 7)]


def _assign_axis(n: int, tile: int, sp: int, staged: int) -> None:
    """B1 along one axis of n pixels: the tiles [t0, t0 + tile) cover it
    once, and each pixel's candidate slots (from its tile's staged cells
    [t0 // sp - 1, + staged), slot b of b < 2 at the staged index
    cell - first cell - (r < sp/2), the slot b = 1 off where r == sp/2)
    are the seed offsets the reference's gate |off sp + sp/2 - r| < sp
    admits, in ascending order, all inside the staged cells."""
    half = sp // 2
    hits = np.zeros(n, np.int64)
    for t0 in range(0, n, tile):
        first = t0 // sp - 1
        for p in range(t0, min(t0 + tile, n)):
            hits[p] += 1
            cell, r = p // sp, p % sp
            base = cell - first - (r < half)
            slots = [base + b for b in range(1 if r == half else 2)]
            assert 0 <= slots[0] and slots[-1] < staged
            gate = [cell + off for off in (-1, 0, 1)
                    if abs(off * sp + half - r) < sp]
            assert [first + s for s in slots] == gate
    assert (hits == 1).all()


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("frame", FRAMES)
def test_assign_plan_covers_and_fits(frame, sp):
    h, w = frame
    plan = kslic.assign_plan(h, w, sp)
    th, tw = plan.tile
    assert plan.grid == (math.ceil(w / tw), math.ceil(h / th))
    assert plan.threads[0] == tw and plan.threads[1] * (
        plan.rows_per_thread) == th
    _assign_axis(h, th, sp, plan.staged[0])
    _assign_axis(w, tw, sp, plan.staged[1])
    # a float4 and two ints per staged seed, an int per tile row; the row
    # table packs (cell - first cell) << 8 | offset
    nsy, nsx = plan.staged
    assert plan.smem == 24 * nsy * nsx + 4 * th <= kslic.MAX_SMEM
    assert nsy < 256 and nsx <= 255 and sp < 256


def test_kitti_assign_plan_as_documented():
    """KITTI (376 x 1280 padded, sp 8): 40 x 12 blocks of 32 x 8 threads,
    4 pixels a thread; a tile is 4 x 4 seed cells, staged with their ring as
    6 x 6 seeds (992 B of shared memory).  sp 6 and 16, the other pitches
    chip_smoke.py checks on the card, stage 8 x 8 and 4 x 4."""
    p = kslic.assign_plan(376, 1280, 8)
    assert (p.grid, p.threads, p.rows_per_thread) == ((40, 12), (32, 8), 4)
    assert (p.staged, p.smem) == ((6, 6), 992)
    assert kslic.assign_plan(376, 1280, 6).staged == (8, 8)
    assert kslic.assign_plan(376, 1280, 16).staged == (4, 4)


@pytest.mark.parametrize("sp", [1, 17, 0])
def test_assign_plan_refuses_sp_outside_the_kernels_range(sp):
    with pytest.raises(ValueError, match="range 2..16"):
        kslic.assign_plan(56, 120, sp)
