"""Stereo depth on the device: block matching or semi-global matching (SGM)
with sub-pixel refinement, validity gates and post-filters.

Counterpart of the JAX package's `models/stereo.py`; the same functions under
the same names, on tensors of one device.  The reference pipeline reads
precomputed PSMNet disparity (`kitti_publisher/scripts/publisher.py:36-41`,
depth = bf / disparity); this module computes that disparity from the raw
rectified pair instead.

* box path: per candidate disparity, the SAD of intensity over a
  (2r+1)^2 window (separable cumsum-diff box filter), a streaming WTA with
  the parabola sub-pixel refine, left-right consistency, texture, cost and
  uniqueness gates;
* SGM path: a census (or SAD) cost volume aggregated along 4 or 8 scanline
  paths, then the same WTA and gates (`_wta_and_gates`), with an optional
  map-prior rescue of pixels the LR/uniqueness gates rejected;
* post-filters: a masked 3x3 median gate + hole fill (`_median_postfilter`)
  and an optional scanline occlusion fill (`_scanline_fill`).

The SGM aggregation runs in the CUDA kernels of `ops/cuda/sgm.py` on a CUDA
tensor when `StereoConfig.sgm_pallas` is set (the field keeps the JAX name),
and in the plain functions of this module and `ops/sgm.py` otherwise.  The
streaming WTA (`wta_streaming`) runs in the kernel of `ops/cuda/wta.py` on a
CUDA tensor and in its plain twin `_wta_scan` on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import timing

_INF = float("inf")


class StereoConfig(NamedTuple):
    """The JAX package's `StereoConfig`, field for field (its docstrings
    explain each measured default)."""

    max_disparity: int = 128      # candidate range [min_disparity, max)
    min_disparity: int = 1        # d=0 (infinity) excluded by default
    radius: int = 4               # SAD window radius (9x9)
    lr_threshold: float = 1.0     # max |dL - dR| in px
    cost_ceiling: float = 12.0    # mean abs diff ceiling per px (0..255)
    texture_threshold: float = 1.5  # min mean |horizontal gradient| in window
    subpixel: bool = True
    aggregation: str = "box"      # "box" (streaming WTA) | "sgm"
    sgm_p1: float = 1.0           # SGM smoothness penalties (P1 << P2)
    sgm_p2: float = 8.0
    sgm_paths: int = 8            # 4 (h/v) or 8 (+ diagonals)
    # aggregate in the hand-written kernels (CUDA tensors only; the name is
    # the JAX package's, where it selected the Pallas kernels)
    sgm_pallas: bool = True
    # bf16 DP carries clamped at the in-volume BIG (census only): every
    # carry stays bf16-exact, so all backends stay bitwise-equal
    sgm_carry_bf16: bool = False
    cost: str = "census"          # "sad" | "census" (5x5 Hamming)
    census_radius: int = 2        # 5x5 -> 24 neighbor bits
    census_ceiling: float = 16.0  # per-path census cost gate (0..24)
    # census + kernels: Hamming cost computed inside the scan kernels, the
    # (D', H, W) cost volume never materializes (0 < D' < 128 on B5/B6,
    # 128 < D' <= 1024 on B4's line kernel; D' == 128 builds it)
    sgm_fused_census: bool = True
    uniqueness_ratio: float = 0.95  # best < ratio * second; 0 disables
    post_median: bool = True      # masked 3x3 median gate + hole fill
    speckle_tol: float = 2.0      # px; gate |d - median| on valid pixels
    fill_support: int = 4         # min valid neighbors to fill a hole
    post_median_passes: int = 2
    fill_after_clean: int = 0     # disparity median fills after clean_depth
    wta_streaming: bool = True    # one pass over the planes (== reductions)
    wta_chunk: int = 16           # planes per scan step in the JAX package
    occlusion_fill: bool = False  # scanline background fill
    occlusion_max_gap: int = 32
    occlusion_lerp_tol: float = 3.0
    hierarchical: bool = False    # half-res SGM + band-limited refine
    hier_band: int = 3
    hier_refine_radius: int = 2
    hier_k_penalty: float = 1.0
    prior_rescue: bool = False    # tie-aware map-prior rescue
    prior_tol: float = 1.5        # max |d_refined - d_map| in px
    prior_stride: int = 8         # render cell pitch (px)
    prior_min_updates: int = 5    # bank stability floor for the render
    prior_tie_margin: float = 1.0  # per path (census bits) / absolute (box)
    sgm_texture_floor: float = 0.05  # near-zero mean |gradient| floor


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) mean filter over (2r+1)^2 windows via separable cumsum-diff
    (edge-padded so border windows average over the clipped support).  The
    mean is a multiply by the f32 reciprocal, as XLA compiles the JAX
    package's division by the constant."""
    k = 2 * r + 1

    def along(a, dim):
        n = a.shape[dim]
        lo = a.narrow(dim, 0, 1).expand(*[r + 1 if i == dim else s
                                          for i, s in enumerate(a.shape)])
        hi = a.narrow(dim, n - 1, 1).expand(*[r if i == dim else s
                                              for i, s in enumerate(a.shape)])
        c = torch.cumsum(torch.cat([lo, a, hi], dim), dim)
        return c.narrow(dim, k, n) - c.narrow(dim, 0, n)

    return along(along(x, 0), 1) * (1.0 / (k * k))


def _shift_right(img: torch.Tensor, d: int) -> torch.Tensor:
    """R_d(y, x) = img(y, x - d): content moves right, left edge replicated."""
    if d == 0:
        return img
    h, w = img.shape
    d = min(d, w)
    return torch.cat([img[:, :1].expand(h, d), img[:, :w - d]], 1)


def _shift_left(img: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    if d == 0:
        return img
    h, w = img.shape
    d = min(d, w)
    return torch.cat([img[:, d:], img.new_full((h, d), fill)], 1)


# optimal 25-comparator sorting network for 9 inputs (Knuth TAOCP 5.3.4)
_SORT9 = ((0, 3), (1, 7), (2, 5), (4, 8), (0, 7), (2, 4), (3, 8), (5, 6),
          (0, 2), (1, 3), (4, 5), (7, 8), (1, 4), (3, 6), (5, 7), (0, 1),
          (2, 4), (3, 5), (6, 8), (2, 3), (4, 5), (6, 7), (1, 2), (3, 4),
          (5, 6))


def _median_postfilter(disp: torch.Tensor, speckle_tol: float,
                       fill_support: int,
                       min_support: int = 2) -> torch.Tensor:
    """Masked 3x3 median gate + hole fill on a 0-invalid disparity map.

    The median of the <= 9 valid values of each 3x3 neighborhood (lower
    middle for even counts): invalid entries sort to +inf through the
    comparator network and the count-dependent rank is picked with selects.
    Valid pixels farther than `speckle_tol` from the median, or with fewer
    than `min_support` valid neighbors, are zeroed; invalid pixels with >=
    `fill_support` valid neighbors take the median."""
    h, w = disp.shape
    valid = disp > 0
    pd = F.pad(disp, (1, 1, 1, 1), value=0.0)
    pv = F.pad(valid, (1, 1, 1, 1), value=False)
    planes = []
    cnt = torch.zeros((h, w), dtype=torch.int32, device=disp.device)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            v = pv[dy:dy + h, dx:dx + w]
            planes.append(torch.where(v, pd[dy:dy + h, dx:dx + w], _INF))
            cnt = cnt + v.to(torch.int32)
    for a, b in _SORT9:
        lo = torch.minimum(planes[a], planes[b])
        planes[b] = torch.maximum(planes[a], planes[b])
        planes[a] = lo
    k = (cnt - 1).clamp_min(0) // 2          # median rank among valids
    med = planes[0]
    for i in range(1, 9):
        med = torch.where(k == i, planes[i], med)
    keep = valid & ((disp - med).abs() <= speckle_tol) \
        & (cnt - 1 >= min_support)
    fill = ~valid & (cnt >= fill_support)
    return torch.where(keep, disp, torch.where(fill, med, 0.0))


def _scanline_fill(disp: torch.Tensor, max_gap: int,
                   lerp_tol: float = 0.0) -> torch.Tensor:
    """Background-propagating occlusion fill on a 0-invalid disparity map:
    each invalid pixel bounded by valid pixels on both sides of its row (run
    length <= max_gap) takes the interpolation of its two anchors when they
    agree within `lerp_tol` px (a gap inside one surface), else their
    minimum (the farther surface of an occlusion band)."""
    h, w = disp.shape
    valid = disp > 0
    x = torch.arange(w, dtype=torch.int32,
                     device=disp.device).expand(h, w)
    li = torch.cummax(torch.where(valid, x, -1), dim=1).values
    ri = torch.cummin(torch.where(valid, x, w).flip(1), dim=1).values.flip(1)
    bounded = (li >= 0) & (ri < w) & (ri - li - 1 <= max_gap)
    ld = torch.gather(disp, 1, li.clamp(0, w - 1).long())
    rd = torch.gather(disp, 1, ri.clamp(0, w - 1).long())
    fill = torch.minimum(ld, rd)
    if lerp_tol > 0:
        t = (x - li).float() / (ri - li).clamp_min(1).float()
        # one fused multiply-add, as XLA compiles the JAX expression (the
        # f64 product of two f32 values is exact)
        lerp = (ld.double() + t.double() * (rd - ld).double()).float()
        fill = torch.where((ld - rd).abs() <= lerp_tol, lerp, fill)
    return torch.where(~valid & bounded, fill, disp)


_SGM_BIG = 1e4   # out-of-range wedge cost / "winner exists" ceiling
# the bf16 round-trip of _SGM_BIG (what the volume holds); also the carry
# clamp of sgm_carry_bf16 mode
_SGM_BIG_BF16 = 9984.0

# Out-of-range (x - d < 0) planes carry _SGM_BIG in the cost volume, and
# every scan direction that crosses the wedge into range (forward x and the
# two +x-moving diagonals) restarts a plane's path at the column floor
# where it enters range (x == d): L = C instead of C + P2, so periodic
# aliases tie exactly and the uniqueness gate rejects them (the JAX
# package's _SGM_BIG note gives the measurements behind this).


def _census(img: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) census transform as int32 (codes have <= 24 bits): bit k set
    iff neighbor k < center over the (2r+1)^2-1 neighborhood."""
    bits = (2 * r + 1) ** 2 - 1
    if bits > 32:
        raise ValueError(
            f"census_radius={r} needs {bits} bits; the 32-bit transform "
            f"supports radius <= 2 (24 bits)")
    h, w = img.shape
    p = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    bit = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nb = p[r + dy:r + dy + h, r + dx:r + dx + w]
            out = out | ((nb < img).to(torch.int32) << bit)
            bit += 1
    return out


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 tensors holding non-negative values (PyTorch
    has no popcount op); the same arithmetic as the CUDA kernels'
    `__popc`."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101) >> 24


def _census_volume(cl: torch.Tensor, cr: torch.Tensor, min_d: int,
                   n_d: int) -> torch.Tensor:
    """(n_d, H, W) bf16 Hamming cost volume of two census images: plane k
    holds disparity k + min_d, out-of-range pixels (x < d) hold
    bf16(_SGM_BIG)."""
    h, w = cl.shape
    x = torch.arange(w, device=cl.device).expand(h, w)
    costs = []
    for d in range(min_d, min_d + n_d):
        c = _popcount32(cl ^ _shift_right(cr, d)).to(torch.bfloat16)
        costs.append(torch.where(x >= d, c, _SGM_BIG))   # bf16: 9984
    return torch.stack(costs)


def _cost_volume(left: torch.Tensor, right: torch.Tensor,
                 cfg: StereoConfig) -> torch.Tensor:
    """(D', H, W) bf16 matching-cost volume, D' = max - min disparity:
    census Hamming distances (integers <= 24, exact in bf16) or the
    box-filtered absolute intensity difference ("sad")."""
    n_d = cfg.max_disparity - cfg.min_disparity
    if cfg.cost == "census":
        return _census_volume(_census(left, cfg.census_radius),
                              _census(right, cfg.census_radius),
                              cfg.min_disparity, n_d)
    h, w = left.shape
    x = torch.arange(w, device=left.device).expand(h, w)
    costs = []
    for d in range(cfg.min_disparity, cfg.max_disparity):
        c = _box_filter((left - _shift_right(right, d)).abs(), cfg.radius)
        costs.append(torch.where(x >= d, c, _SGM_BIG).to(torch.bfloat16))
    return torch.stack(costs)


def _cost_volume_scan(left: torch.Tensor, right: torch.Tensor,
                      cfg: StereoConfig) -> torch.Tensor:
    """The JAX package builds the kernels' volume with a scan over d; here
    it is the same tensor as `_cost_volume`."""
    return _cost_volume(left, right, cfg)


def _sgm_dp(L_prev: torch.Tensor, c: torch.Tensor, p1: float, p2: float,
            clamp: float | None = None,
            kernel_grouping: bool = False) -> torch.Tensor:
    """One scanline-DP update over the trailing disparity axis; L_prev and
    c are (..., D) f32, or bf16 with `clamp` set (sgm_carry_bf16).  The d
    boundaries are open (+inf neighbors).

    f32 grouping: `(c + cand) - Lmin` as the JAX package's scan path, or
    `c + (cand - Lmin)` (kernel_grouping) as its kernels and the CUDA
    kernels; the two agree bitwise on integer (census) costs.  bf16 mode
    always groups `c + (cand - Lmin)` and clamps."""
    Lmin = L_prev.amin(dim=-1, keepdim=True)
    inf = torch.full_like(L_prev[..., :1], _INF)
    dm = torch.cat([inf, L_prev[..., :-1]], -1)      # d-1
    dp = torch.cat([L_prev[..., 1:], inf], -1)       # d+1
    cand = torch.minimum(torch.minimum(L_prev, torch.minimum(dm, dp) + p1),
                         Lmin + p2)
    if clamp is None and not kernel_grouping:
        return c + cand - Lmin
    out = c + (cand - Lmin)
    return out if clamp is None else out.clamp_max(clamp)


def _roll_carry(c: torch.Tensor, roll: int) -> torch.Tensor:
    """Shift a DP carry one pixel along its row axis (axis -2) for a
    diagonal path; the wrapped row is zeroed so border pixels restart at
    L = C."""
    if not roll:
        return c
    c = torch.roll(c, roll, dims=-2)
    row = 0 if roll > 0 else c.shape[-2] - 1
    c[..., row, :] = 0
    return c


def _axis_scan(v: torch.Tensor, rolls, p1: float, p2: float,
               carry_bf16: bool = False, entry: Optional[str] = None,
               min_d: int = 0, kernel_grouping: bool = False
               ) -> torch.Tensor:
    """Sum of all 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) cost volume, f32.

    `rolls` lists the per-step row shift of each direction sharing the
    scan axis (0 straight, +-1 diagonal); the directions of one orientation
    advance as one batched update.  Each orientation's output is the
    sequential sum over `rolls` (in carry dtype) rounded ONCE to bf16; the
    result is f32(forward) + f32(backward).

    entry / min_d: the free-entry restart (see the _SGM_BIG note).
    entry="x": scan axis = image x; forward orientation only, at step x on
    plane k with k + min_d == x.  entry="y": scan axis = image y, rows =
    image x; the roll == +1 channels in both orientations, at r == k + min_d.
    kernel_grouping: the f32 update grouping of the kernels (`_sgm_dp`)."""
    g = len(rolls)
    L, R, D = v.shape
    cdt = torch.bfloat16 if carry_bf16 else torch.float32
    clamp = _SGM_BIG_BF16 if carry_bf16 else None
    dev = v.device
    # the penalties in carry dtype, as the JAX package's dt.type(p)
    p1, p2 = (float(torch.tensor(p, dtype=cdt)) for p in (p1, p2))

    ent_y = None
    if entry == "y" and any(r == 1 for r in rolls):
        r_io = torch.arange(R, device=dev)[:, None]
        k_io = torch.arange(D, device=dev)[None, :]
        ent_rd = r_io == k_io + min_d
        ent_y = torch.stack([ent_rd if rolls[k] == 1
                             else torch.zeros_like(ent_rd)
                             for k in range(g)])          # (G, R, D)
    k_io = torch.arange(D, device=dev)

    def one_dir(reverse: bool) -> torch.Tensor:
        carry = torch.zeros((g, R, D), dtype=cdt, device=dev)
        # rows collected and stacked (not written into an empty volume), so
        # that the scan runs under torch.func.vmap
        out = [None] * L
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            rolled = torch.stack([_roll_carry(carry[k], rolls[k])
                                  for k in range(g)])
            cost_c = v[t][None].to(cdt)
            nxt = _sgm_dp(rolled, cost_c, p1, p2, clamp=clamp,
                          kernel_grouping=kernel_grouping)
            if entry == "x" and not reverse:
                nxt = torch.where((k_io + min_d == t)[None, None], cost_c,
                                  nxt)
            elif ent_y is not None:
                nxt = torch.where(ent_y, cost_c, nxt)
            # sequential adds in carry dtype, then one bf16 rounding
            tot = nxt[0]
            for k in range(1, g):
                tot = tot + nxt[k]
            out[t] = tot.to(torch.bfloat16)
            carry = nxt
        return torch.stack(out).float()

    return one_dir(False) + one_dir(True)


def _sgm_aggregate(vol: torch.Tensor, p1: float, p2: float, n_paths: int,
                   use_kernels: bool = True, carry_bf16: bool = False,
                   min_d: int = 0) -> torch.Tensor:
    """4- or 8-path semi-global aggregation of a (D, H, W) cost volume;
    returns the f32 summed volume (horizontal family + vertical/diagonal
    family, in that order).

    use_kernels: the scans go through `ops/cuda/sgm.axis_scan` (the B4
    kernel on a CUDA tensor, its plain twin with the kernel grouping on a
    CPU tensor); else through `_axis_scan` with the scan path's grouping.
    min_d: plane k of `vol` holds disparity k + min_d."""
    if n_paths not in (4, 8):
        raise ValueError(f"sgm_paths must be 4 or 8, got {n_paths}")
    if use_kernels:
        from ..ops.cuda.sgm import axis_scan as scan
    else:
        scan = _axis_scan

    vh = vol.permute(2, 1, 0).contiguous()       # (W, H, D): scan over x
    agg = scan(vh, (0,), p1, p2, carry_bf16=carry_bf16, entry="x",
               min_d=min_d).permute(2, 1, 0)
    vv = vol.permute(1, 2, 0).contiguous()       # (H, W, D): scan over y
    # (1,1)/(-1,1): previous pixel one column left -> roll +1;
    # (1,-1)/(-1,-1): one column right -> roll -1
    v_rolls = (0,) if n_paths == 4 else (0, 1, -1)
    v_sum = scan(vv, v_rolls, p1, p2, carry_bf16=carry_bf16, entry="y",
                 min_d=min_d)
    return agg + v_sum.permute(2, 0, 1)


def _disparity_sgm(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoConfig, diagnostics: bool = False,
                   prior_disp: Optional[torch.Tensor] = None,
                   with_rescued: bool = False):
    """Semi-global-matching disparity: 4/8-path aggregation, then the WTA
    and gates of `_wta_and_gates`.

    With sgm_pallas, census cost and sgm_fused_census the aggregation is
    `census_aggregate`, and the cost volume never materializes: for 0 < D'
    < 128 B6 + B5 on a CUDA tensor, in one phase; for 128 < D' <= 1024
    B4's line kernel reading its cost from the census images, in the
    materialized route's two phases (`stereo_volume` holds the census
    images alone).  Otherwise (D' == 128 too) the volume is built and
    `_sgm_aggregate` scans it (B4 on a CUDA tensor with sgm_pallas)."""
    n_d = cfg.max_disparity - cfg.min_disparity
    fused = cfg.sgm_pallas and cfg.cost == "census" and cfg.sgm_fused_census

    def census_agg(cl, cr):
        from ..ops.cuda.sgm import census_aggregate
        v_rolls = (0,) if cfg.sgm_paths == 4 else (0, 1, -1)
        return census_aggregate(cl, cr, v_rolls, cfg.sgm_p1, cfg.sgm_p2,
                                cfg.min_disparity, n_d,
                                carry_bf16=cfg.sgm_carry_bf16)

    if fused and 0 < n_d < 128:
        with timing.phase("stereo_aggregate", left.device):
            agg = census_agg(_census(left, cfg.census_radius),
                             _census(right, cfg.census_radius))
    elif fused and 128 < n_d <= 1024:
        with timing.phase("stereo_volume", left.device):
            cl = _census(left, cfg.census_radius)
            cr = _census(right, cfg.census_radius)
        with timing.phase("stereo_scan", left.device):
            agg = census_agg(cl, cr)
    else:
        # two phases: the volume's build, then its two permuted copies and
        # both families' scans (B4) with their sum
        with timing.phase("stereo_volume", left.device):
            vol = (_cost_volume_scan if cfg.sgm_pallas
                   else _cost_volume)(left, right, cfg)
        with timing.phase("stereo_scan", left.device):
            agg = _sgm_aggregate(vol, cfg.sgm_p1, cfg.sgm_p2, cfg.sgm_paths,
                                 cfg.sgm_pallas,
                                 carry_bf16=(cfg.sgm_carry_bf16
                                             and cfg.cost == "census"),
                                 min_d=cfg.min_disparity)
    # on the card this phase lasts to the next stamp: the post-filters of
    # `disparity` count in it
    with timing.phase("stereo_wta", left.device):
        return _wta_and_gates(left, agg, cfg, diagnostics,
                              prior_disp=prior_disp,
                              with_rescued=with_rescued)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool (edge-pad to even first)."""
    h, w = img.shape
    if h % 2:
        img = torch.cat([img, img[-1:]], 0)
    if w % 2:
        img = torch.cat([img, img[:, -1:]], 1)
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def _disparity_hier(left: torch.Tensor, right: torch.Tensor,
                    cfg: StereoConfig) -> torch.Tensor:
    """Coarse-to-fine SGM (cfg.hierarchical): half-res SGM solve, nearest
    upsample, and a band-limited full-res census refine (a streaming pass
    over the disparity range where each pixel scores only candidates with
    |d - d0| <= hier_band, biased by hier_k_penalty per px of deviation)."""
    h, w = left.shape
    half = _disparity_sgm(_downsample2(left), _downsample2(right),
                          cfg._replace(
                              max_disparity=max(cfg.max_disparity // 2, 3),
                              min_disparity=max(cfg.min_disparity // 2, 1),
                              hierarchical=False))
    up = half.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    d0 = torch.round(2.0 * up).to(torch.int32)
    coarse_valid = up > 0

    cl = _census(left, cfg.census_radius)
    cr = _census(right, cfg.census_radius)
    x = torch.arange(w, dtype=torch.int32, device=left.device).expand(h, w)
    big = _SGM_BIG
    r = cfg.hier_refine_radius
    norm = float(torch.tensor(1.0 / (2 * r + 1) ** 2, dtype=torch.float32))

    def census_window_sum(d):
        """(2r+1)^2 sum of the Hamming cost at static disparity d."""
        c = _popcount32(cl ^ _shift_right(cr, d)).float()
        for ax in (0, 1):
            n = c.shape[ax]
            lo = c.narrow(ax, 0, 1).expand(*[r if i == ax else s
                                             for i, s in enumerate(c.shape)])
            hi = c.narrow(ax, n - 1, 1).expand(*[r if i == ax else s
                                                 for i, s in
                                                 enumerate(c.shape)])
            cpad = torch.cat([lo, c, hi], ax)
            acc = c
            for s in range(1, r + 1):
                acc = acc + cpad.narrow(ax, r - s, n)
                acc = acc + cpad.narrow(ax, r + s, n)
            c = acc
        return c

    full = dict(size=(h, w), device=left.device)
    best = torch.full(**full, fill_value=big)
    best_d = torch.zeros(**full, dtype=torch.int32)
    prev_c = torch.full(**full, fill_value=big)
    cm = torch.full(**full, fill_value=big)
    cp = torch.full(**full, fill_value=big)
    for d in range(cfg.min_disparity, cfg.max_disparity):
        k = d - d0
        active = (k.abs() <= cfg.hier_band) & (x >= d) & coarse_valid
        # mean cost + pull penalty as one fused multiply-add, as XLA
        # compiles the JAX package's expression (the f64 product is exact)
        c = torch.where(active,
                        (census_window_sum(d).double() * norm
                         + cfg.hier_k_penalty * k.abs().double()).float(),
                        big)
        take = c < best
        cp = torch.where(take, big, torch.where(best_d == d - 1, c, cp))
        cm = torch.where(take, prev_c, cm)
        best = torch.where(take, c, best)
        best_d = torch.where(take, d, best_d)
        prev_c = c

    disp = best_d.float()
    if cfg.subpixel:
        # remove the known pull penalty before the parabola fit
        kb = (best_d - d0).float()
        pen = cfg.hier_k_penalty
        b_c = best - pen * kb.abs()
        cm_c = cm - pen * (kb - 1.0).abs()
        cp_c = cp - pen * (kb + 1.0).abs()
        denom = cm_c + cp_c - 2.0 * b_c
        interior = (cm < big) & (cp < big) & (denom > 1e-9)
        delta = torch.where(interior,
                            0.5 * (cm_c - cp_c) / denom.clamp_min(1e-9), 0.0)
        disp = disp + delta.clamp(-0.5, 0.5)

    valid = coarse_valid & (best <= cfg.census_ceiling
                            + cfg.hier_k_penalty * cfg.hier_band) \
        & (best_d >= cfg.min_disparity) & (best_d < cfg.max_disparity)
    return torch.where(valid, disp, 0.0)


def _sheared_right(agg: torch.Tensor, min_d: int) -> torch.Tensor:
    """(H, D, W) bf16 right-image volume costR(y, x, k) = agg(k, y, x + k +
    min_d), +inf where x + k + min_d >= W; built with pads and one reshape
    (row stride W' + 1 eats the per-plane shift), no gather."""
    D, h, w = agg.shape
    w2 = w + D + min_d + 1
    sheared = F.pad(agg.to(torch.bfloat16), (0, w2 - w), value=_INF)
    sheared = sheared.permute(1, 0, 2).reshape(h, D * w2)
    sheared = F.pad(sheared, (0, D), value=_INF)
    return sheared.reshape(h, D, w2 + 1)[:, :, min_d:min_d + w]


def _wta_reductions(agg: torch.Tensor, cfg: StereoConfig,
                    prior_plane: Optional[torch.Tensor] = None):
    """Full-reduction WTA over the aggregated (D', H, W) volume: returns
    (idx, best, cm, cp, second, bestR_d, prior3); cm/cp None without
    subpixel, second None without the uniqueness gate, prior3 None without
    a prior (else the costs at the prior's planes p-1, p, p+1).  Planes
    with x < d + min_disparity are masked to +inf for the left WTA."""
    D, h, w = agg.shape
    d_ids = torch.arange(D, device=agg.device)[:, None, None]
    xc = torch.arange(w, device=agg.device)[None, None, :]
    aggm = torch.where(xc >= d_ids + cfg.min_disparity, agg, _INF)
    best = aggm.amin(dim=0)
    idx = aggm.argmin(dim=0).to(torch.int32)          # first minimum

    cm = cp = None
    if cfg.subpixel:
        oh = d_ids == idx[None]
        cm = torch.where(oh[1:], aggm[:-1], _INF).amin(dim=0)
        cp = torch.where(oh[:-1], aggm[1:], _INF).amin(dim=0)

    second = None
    if cfg.uniqueness_ratio > 0:
        far = (d_ids - idx[None]).abs() > 1
        second = torch.where(far, aggm, _INF).amin(dim=0)

    prior3 = None
    if prior_plane is not None:
        op = d_ids == prior_plane[None]
        prior3 = (torch.where(op[1:], aggm[:-1], _INF).amin(dim=0),
                  torch.where(op, aggm, _INF).amin(dim=0),
                  torch.where(op[:-1], aggm[1:], _INF).amin(dim=0))

    volR = _sheared_right(agg, cfg.min_disparity)
    bestR_d = volR.argmin(dim=1).to(torch.int32) + cfg.min_disparity
    return idx, best, cm, cp, second, bestR_d, prior3


def _wta_scan(agg: torch.Tensor, cfg: StereoConfig,
              prior_plane: Optional[torch.Tensor] = None):
    """Streaming WTA: the outputs of `_wta_reductions`, bitwise, from one
    pass over the disparity planes with per-pixel running state.  The plain
    twin of the WTA kernel (`ops/cuda/wta.py`, which runs it on a CPU
    tensor):

    * best/idx: strict `<` keeps the first minimum (argmin semantics);
    * cm/cp: the previous plane at take time / the plane after the winner;
    * second: min over |d - idx| > 1, split into `sl` (min over d <= idx-2,
      latched at take time) and `post` (d > idx+1, reset on every take);
    * bestR_d: the sheared right-image argmin, one shifted plane at a time,
      cast to bf16 exactly like the reductions' sheared volume."""
    D, h, w = agg.shape
    md = cfg.min_disparity
    xc = torch.arange(w, device=agg.device).expand(h, w)
    full = dict(size=(h, w), device=agg.device)
    inf = torch.full(**full, fill_value=_INF)
    best, cm, cp, prev, min2, sl, post = (inf,) * 7
    idx = torch.zeros(**full, dtype=torch.int32)
    bestR = torch.full(**full, fill_value=_INF, dtype=torch.bfloat16)
    bestRd = torch.full(**full, fill_value=md, dtype=torch.int32)
    prm = pr0 = prp = inf
    for d in range(D):
        plane = agg[d]
        cl = torch.where(xc >= d + md, plane, _INF)
        take = cl < best
        sl = torch.where(take, min2, sl)
        cm = torch.where(take, prev, cm)
        # old idx on purpose: the plane after the (current) winner
        cp = torch.where(take, _INF, torch.where(idx + 1 == d, cl, cp))
        post = torch.where(take, _INF,
                           torch.where(idx + 1 < d, torch.minimum(post, cl),
                                       post))
        min2 = torch.minimum(min2, prev)              # now <= d-1
        prev = cl
        idx = torch.where(take, d, idx)
        best = torch.where(take, cl, best)
        if prior_plane is not None:
            prm = torch.where(prior_plane - 1 == d, cl, prm)
            pr0 = torch.where(prior_plane == d, cl, pr0)
            prp = torch.where(prior_plane + 1 == d, cl, prp)
        cr = _shift_left(plane, d + md, _INF).to(torch.bfloat16)
        takeR = cr < bestR
        bestR = torch.where(takeR, cr, bestR)
        bestRd = torch.where(takeR, d + md, bestRd)
    return (idx, best, cm if cfg.subpixel else None,
            cp if cfg.subpixel else None,
            torch.minimum(sl, post) if cfg.uniqueness_ratio > 0 else None,
            bestRd, (prm, pr0, prp) if prior_plane is not None else None)


def _wta_and_gates(left: torch.Tensor, agg: torch.Tensor, cfg: StereoConfig,
                   diagnostics: bool = False,
                   prior_disp: Optional[torch.Tensor] = None,
                   with_rescued: bool = False):
    """WTA + sub-pixel + validity gates (LR consistency, texture floor,
    cost ceiling, uniqueness) on an aggregated (D', H, W) SGM volume, plus
    the tie-aware map-prior rescue when a prior is given."""
    h, w = left.shape
    n_paths = float(cfg.sgm_paths)
    D = agg.shape[0]

    prior_plane = None
    if cfg.prior_rescue and prior_disp is not None:
        prior_plane = (torch.round(prior_disp).to(torch.int32)
                       - cfg.min_disparity).clamp(0, D - 1)

    if cfg.wta_streaming:
        # the WTA kernel on a CUDA tensor, `_wta_scan` on a CPU tensor; the
        # kernel takes a contiguous volume, which the sum of two permuted
        # families (`_sgm_aggregate`, B4's census route) need not be
        from ..ops.cuda.wta import wta_scan
        idx, best, cm, cp, second, bestR_d, prior3 = wta_scan(
            agg.contiguous(), cfg.min_disparity, cfg.subpixel,
            cfg.uniqueness_ratio, prior_plane)
    else:
        idx, best, cm, cp, second, bestR_d, prior3 = _wta_reductions(
            agg, cfg, prior_plane=prior_plane)
    disp = (idx + cfg.min_disparity).float()

    if cfg.subpixel:
        denom = cm + cp - 2.0 * best
        interior = (idx > 0) & (idx < D - 1) & torch.isfinite(cm) \
            & torch.isfinite(cp) & (denom > 1e-9)
        delta = torch.where(interior,
                            0.5 * (cm - cp) / denom.clamp_min(1e-9), 0.0)
        disp = disp + delta.clamp(-0.5, 0.5)

    # LR lookup: dR at (x - dL) should equal dL
    dL = idx + cfg.min_disparity
    xl = torch.arange(w, dtype=torch.int32, device=left.device) - dL
    dR_at = torch.gather(bestR_d, 1, xl.clamp(0, w - 1).long())
    consistent = (xl >= 0) & ((dR_at - dL).abs() <= cfg.lr_threshold)

    if cfg.sgm_texture_floor > 0:
        grad = (left - _shift_right(left, 1)).abs()
        textured = _box_filter(grad, cfg.radius) >= cfg.sgm_texture_floor
    else:
        textured = torch.ones_like(left, dtype=torch.bool)

    per_path = (cfg.census_ceiling if cfg.cost == "census"
                else cfg.cost_ceiling)
    ceiling = n_paths * (per_path + cfg.sgm_p2)
    cost_ok = (best <= ceiling) & (best < _SGM_BIG)

    if cfg.uniqueness_ratio > 0:
        unique = best < cfg.uniqueness_ratio * second
    else:
        unique = torch.ones_like(cost_ok)

    valid = consistent & textured & cost_ok & unique
    rescued = torch.zeros_like(valid)
    if prior_plane is not None:
        prm, pr0, prp = prior3
        d_pr = (prior_plane + cfg.min_disparity).float()
        if cfg.subpixel:
            denom_p = prm + prp - 2.0 * pr0
            interior_p = torch.isfinite(prm) & torch.isfinite(prp) \
                & (denom_p > 1e-9)
            delta_p = torch.where(
                interior_p, 0.5 * (prm - prp) / denom_p.clamp_min(1e-9),
                0.0)
            d_pr = d_pr + delta_p.clamp(-0.5, 0.5)
        tie = pr0 <= best + cfg.prior_tie_margin * n_paths
        cost_ok_p = (pr0 <= ceiling) & (pr0 < _SGM_BIG)
        agree = (prior_disp > 0) & ((d_pr - prior_disp).abs()
                                    <= cfg.prior_tol)
        rescued = agree & tie & cost_ok_p & textured & ~valid
        valid = valid | rescued
        disp = torch.where(rescued, d_pr, disp)
    out = torch.where(valid, disp, 0.0)
    if diagnostics:
        return out, dict(disp=disp, consistent=consistent,
                         textured=textured, cost_ok=cost_ok, unique=unique,
                         rescued=rescued)
    if with_rescued:
        return out, rescued.sum(dtype=torch.int32)
    return out


def _post_filters(out: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    if cfg.occlusion_fill and cfg.occlusion_max_gap > 0:
        out = _scanline_fill(out, cfg.occlusion_max_gap,
                             cfg.occlusion_lerp_tol)
    if cfg.post_median:
        for _ in range(cfg.post_median_passes):
            out = _median_postfilter(out, cfg.speckle_tol, cfg.fill_support)
    return out


def _disparity_box(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoConfig,
                   prior_disp: Optional[torch.Tensor] = None):
    """Box-window SAD matcher with a streaming WTA; returns (disparity,
    rescued-pixel count)."""
    h, w = left.shape
    big = 1e10
    full = dict(size=(h, w), device=left.device)
    n_rescued = torch.zeros((), dtype=torch.int32, device=left.device)

    prior_plane_d = None
    if cfg.prior_rescue and prior_disp is not None:
        prior_plane_d = torch.round(prior_disp).to(torch.int32).clamp(
            cfg.min_disparity, cfg.max_disparity - 1)
        prm = pr0 = prp = torch.full(**full, fill_value=big)

    best = torch.full(**full, fill_value=big)
    best_d = torch.zeros(**full, dtype=torch.int32)
    prev_of_best = next_of_best = prev_c = min2 = sl = post = bestR = best
    bestR_d = best_d
    xcoord = torch.arange(w, device=left.device).expand(h, w)

    for d in range(cfg.min_disparity, cfg.max_disparity):
        c = _box_filter((left - _shift_right(right, d)).abs(), cfg.radius)
        c = torch.where(xcoord >= d, c, big)
        take = c < best
        sl = torch.where(take, min2, sl)
        post = torch.where(take, big,
                           torch.where(best_d + 1 < d,
                                       torch.minimum(post, c), post))
        min2 = torch.minimum(min2, prev_c)
        next_of_best = torch.where(take, big,
                                   torch.where(best_d == d - 1, c,
                                               next_of_best))
        prev_of_best = torch.where(take, prev_c, prev_of_best)
        best = torch.where(take, c, best)
        best_d = torch.where(take, d, best_d)
        prev_c = c
        if prior_plane_d is not None:
            prm = torch.where(prior_plane_d - 1 == d, c, prm)
            pr0 = torch.where(prior_plane_d == d, c, pr0)
            prp = torch.where(prior_plane_d + 1 == d, c, prp)
        # right-image volume: costR(y, x, d) = costL(y, x + d, d)
        cR = _shift_left(c, d, big)
        takeR = cR < bestR
        bestR = torch.where(takeR, cR, bestR)
        bestR_d = torch.where(takeR, d, bestR_d)

    disp = best_d.float()
    if cfg.subpixel:
        c0, cm, cp = best, prev_of_best, next_of_best
        denom = cm + cp - 2.0 * c0
        interior = (cm < big) & (cp < big) & (denom > 1e-9)
        delta = torch.where(interior,
                            0.5 * (cm - cp) / denom.clamp_min(1e-9), 0.0)
        disp = disp + delta.clamp(-0.5, 0.5)

    # left-right consistency by a select over the candidate d
    dR_at = torch.zeros(**full)
    bestR_f = bestR_d.float()
    for d in range(cfg.min_disparity, cfg.max_disparity):
        dR_at = torch.where(best_d == d, _shift_right(bestR_f, d), dR_at)
    consistent = (dR_at - best_d.float()).abs() <= cfg.lr_threshold

    grad = (left - _shift_right(left, 1)).abs()
    textured = _box_filter(grad, cfg.radius) >= cfg.texture_threshold

    valid = consistent & textured & (best <= cfg.cost_ceiling) & (best < big)
    if cfg.uniqueness_ratio > 0:
        valid = valid & (best < cfg.uniqueness_ratio
                         * torch.minimum(sl, post))
    if prior_plane_d is not None:
        d_pr = prior_plane_d.float()
        if cfg.subpixel:
            denom_p = prm + prp - 2.0 * pr0
            interior_p = (prm < big) & (prp < big) & (denom_p > 1e-9)
            delta_p = torch.where(
                interior_p, 0.5 * (prm - prp) / denom_p.clamp_min(1e-9),
                0.0)
            d_pr = d_pr + delta_p.clamp(-0.5, 0.5)
        tie = pr0 <= best + cfg.prior_tie_margin
        agree = (prior_disp > 0) & ((d_pr - prior_disp).abs()
                                    <= cfg.prior_tol)
        rescued = (agree & tie & textured & ~valid
                   & (pr0 <= cfg.cost_ceiling) & (pr0 < big))
        valid = valid | rescued
        disp = torch.where(rescued, d_pr, disp)
        n_rescued = rescued.sum(dtype=torch.int32)
    return torch.where(valid, disp, 0.0), n_rescued


def disparity(left: torch.Tensor, right: torch.Tensor,
              config: StereoConfig = StereoConfig(),
              prior_disp: Optional[torch.Tensor] = None,
              with_rescued: bool = False):
    """(H, W) f32 left disparity map; 0 = invalid.

    prior_disp (optional (H, W) f32, 0 = none): map-rendered disparity
    prior for the rescue gate (cfg.prior_rescue; `ops/render.py`); the
    hierarchical mode ignores it.  with_rescued: also return the i32 count
    of prior-rescued pixels (before the post-filters)."""
    cfg = config
    n_rescued = torch.zeros((), dtype=torch.int32, device=left.device)
    if cfg.aggregation == "sgm":
        if cfg.hierarchical:
            out = _disparity_hier(left, right, cfg)
        elif with_rescued:
            out, n_rescued = _disparity_sgm(left, right, cfg,
                                            prior_disp=prior_disp,
                                            with_rescued=True)
        else:
            out = _disparity_sgm(left, right, cfg, prior_disp=prior_disp)
    else:
        with timing.phase("stereo_aggregate", left.device):
            out, n_rescued = _disparity_box(left, right, cfg, prior_disp)
    out = _post_filters(out, cfg)
    return (out, n_rescued) if with_rescued else out


def depth_from_stereo(left: torch.Tensor, right: torch.Tensor, bf: float,
                      config: StereoConfig = StereoConfig(),
                      max_depth: Optional[float] = None) -> torch.Tensor:
    """Metric depth = bf / disparity (publisher.py:40 contract); 0 invalid."""
    disp = disparity(left, right, config)
    # a true division (python_scalar / tensor is a reciprocal-multiply)
    bf = torch.tensor(bf, dtype=torch.float32)
    depth = torch.where(disp > 0, bf / disp.clamp_min(1e-6), 0.0)
    if max_depth is not None:
        depth = torch.where(depth <= max_depth, depth, 0.0)
    return depth
