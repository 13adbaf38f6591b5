"""Stereo depth on the device by semi-global matching (SGM): the census
route that the configurations run (the CLI's `--stereo --sgm`).

Counterpart of the JAX package's `models/stereo.py`; the same functions under
the same names, on tensors of one device.  The reference pipeline reads
precomputed PSMNet disparity (`kitti_publisher/scripts/publisher.py:36-41`,
depth = bf / disparity); this module computes that disparity from the raw
rectified pair instead: a 5x5 census cost aggregated along 4 or 8 scanline
paths, a streaming WTA with the parabola sub-pixel refine, left-right
consistency, texture, cost and uniqueness gates, and a masked 3x3 median
gate + hole fill (`_median_postfilter`).

A frozen copy of the census SGM route of the port's `models/stereo.py`,
with f32 carries, at 1 <= D' <= 1024.  The port aggregates it on the fused
census kernels B6 + B5 (`sgm_fused_census`, 0 < D' < 128) or on a
materialized volume scanned by B4 (otherwise: its narrow route for
D' <= 128, its wide one above); both scan the same census volume with the
same grouping, and one twin, `sgm.census_aggregate`, serves both.

The matcher's other routes (SAD cost, the box matcher, bf16 carries, the
reduction WTA, the hierarchical solve, the occlusion fill and the map-prior
rescue) no configuration here runs: `check_route` refuses them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

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
    # (D', H, W) cost volume never materializes (0 < D' < 128 only)
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


_SGM_BIG = 1e4   # out-of-range wedge cost / "winner exists" ceiling

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


def _sgm_dp(L_prev: torch.Tensor, c: torch.Tensor, p1: float,
            p2: float) -> torch.Tensor:
    """One scanline-DP update over the trailing disparity axis; L_prev and
    c are (..., D) f32.  The d boundaries are open (+inf neighbors).  The
    kernels' f32 grouping `c + (cand - Lmin)`."""
    Lmin = L_prev.amin(dim=-1, keepdim=True)
    inf = torch.full_like(L_prev[..., :1], _INF)
    dm = torch.cat([inf, L_prev[..., :-1]], -1)      # d-1
    dp = torch.cat([L_prev[..., 1:], inf], -1)       # d+1
    cand = torch.minimum(torch.minimum(L_prev, torch.minimum(dm, dp) + p1),
                         Lmin + p2)
    return c + (cand - Lmin)


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
               entry: Optional[str] = None, min_d: int = 0) -> torch.Tensor:
    """Sum of all 2*len(rolls) SGM path responses along axis 0 of an
    (L, R, D) cost volume, f32.

    `rolls` lists the per-step row shift of each direction sharing the
    scan axis (0 straight, +-1 diagonal); the directions of one orientation
    advance as one batched update.  Each orientation's output is the
    sequential f32 sum over `rolls` rounded ONCE to bf16; the result is
    f32(forward) + f32(backward).

    entry / min_d: the free-entry restart (see the _SGM_BIG note).
    entry="x": scan axis = image x; forward orientation only, at step x on
    plane k with k + min_d == x.  entry="y": scan axis = image y, rows =
    image x; the roll == +1 channels in both orientations, at r == k +
    min_d."""
    g = len(rolls)
    L, R, D = v.shape
    dev = v.device
    # the penalties in f32, as the JAX package's dt.type(p)
    p1, p2 = (float(torch.tensor(p, dtype=torch.float32)) for p in (p1, p2))

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
        carry = torch.zeros((g, R, D), dtype=torch.float32, device=dev)
        out = [None] * L
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            rolled = torch.stack([_roll_carry(carry[k], rolls[k])
                                  for k in range(g)])
            cost_c = v[t][None].float()
            nxt = _sgm_dp(rolled, cost_c, p1, p2)
            if entry == "x" and not reverse:
                nxt = torch.where((k_io + min_d == t)[None, None], cost_c,
                                  nxt)
            elif ent_y is not None:
                nxt = torch.where(ent_y, cost_c, nxt)
            # sequential f32 adds, then one bf16 rounding
            tot = nxt[0]
            for k in range(1, g):
                tot = tot + nxt[k]
            out[t] = tot.to(torch.bfloat16)
            carry = nxt
        return torch.stack(out).float()

    return one_dir(False) + one_dir(True)


def check_route(cfg: StereoConfig) -> None:
    """Refuse a setting off the route this copy holds: census SGM with the
    streaming WTA and f32 carries at 1 <= D' <= 1024, on the fused census
    kernels (B5, B6) or on a materialized volume scanned by B4."""
    n_d = cfg.max_disparity - cfg.min_disparity
    off = {name: bad for name, bad in (
        ("aggregation", cfg.aggregation != "sgm"),
        ("cost", cfg.cost != "census"),
        ("sgm_pallas", not cfg.sgm_pallas),
        ("max_disparity", not 1 <= n_d <= 1024),
        ("sgm_paths", cfg.sgm_paths not in (4, 8)),
        ("sgm_carry_bf16", cfg.sgm_carry_bf16),
        ("wta_streaming", not cfg.wta_streaming),
        ("hierarchical", cfg.hierarchical),
        ("occlusion_fill", cfg.occlusion_fill and cfg.occlusion_max_gap > 0),
        ("prior_rescue", cfg.prior_rescue)) if bad}
    if off:
        raise ValueError(f"the reference holds the census SGM route with "
                         f"f32 carries only; off it: {sorted(off)}")


def _disparity_sgm(left: torch.Tensor, right: torch.Tensor,
                   cfg: StereoConfig) -> torch.Tensor:
    """Semi-global-matching disparity: the census aggregate
    (`sgm.census_aggregate`, the twin of B6 + B5 and of B4), then the WTA
    and gates of `_wta_and_gates`."""
    from .sgm import census_aggregate
    n_d = cfg.max_disparity - cfg.min_disparity
    cl = _census(left, cfg.census_radius)
    cr = _census(right, cfg.census_radius)
    v_rolls = (0,) if cfg.sgm_paths == 4 else (0, 1, -1)
    agg = census_aggregate(cl, cr, v_rolls, cfg.sgm_p1, cfg.sgm_p2,
                           cfg.min_disparity, n_d)
    return _wta_and_gates(left, agg, cfg)


def _wta_scan(agg: torch.Tensor, cfg: StereoConfig):
    """Streaming WTA over the aggregated (D', H, W) volume, one pass over
    the disparity planes with per-pixel running state; returns (idx, best,
    cm, cp, second, bestR_d), cm/cp None without subpixel, second None
    without the uniqueness gate.  Planes with x < d + min_disparity are
    masked to +inf for the left WTA.

    * best/idx: strict `<` keeps the first minimum (argmin semantics);
    * cm/cp: the previous plane at take time / the plane after the winner;
    * second: min over |d - idx| > 1, split into `sl` (min over d <= idx-2,
      latched at take time) and `post` (d > idx+1, reset on every take);
    * bestR_d: the sheared right-image argmin (costR(y, x, k) = agg(k, y,
      x + k + min_d)), one shifted plane at a time, in bf16."""
    D, h, w = agg.shape
    md = cfg.min_disparity
    xc = torch.arange(w, device=agg.device).expand(h, w)
    full = dict(size=(h, w), device=agg.device)
    inf = torch.full(**full, fill_value=_INF)
    best, cm, cp, prev, min2, sl, post = (inf,) * 7
    idx = torch.zeros(**full, dtype=torch.int32)
    bestR = torch.full(**full, fill_value=_INF, dtype=torch.bfloat16)
    bestRd = torch.full(**full, fill_value=md, dtype=torch.int32)
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
        cr = _shift_left(plane, d + md, _INF).to(torch.bfloat16)
        takeR = cr < bestR
        bestR = torch.where(takeR, cr, bestR)
        bestRd = torch.where(takeR, d + md, bestRd)
    return (idx, best, cm if cfg.subpixel else None,
            cp if cfg.subpixel else None,
            torch.minimum(sl, post) if cfg.uniqueness_ratio > 0 else None,
            bestRd)


def _wta_and_gates(left: torch.Tensor, agg: torch.Tensor,
                   cfg: StereoConfig) -> torch.Tensor:
    """WTA + sub-pixel + validity gates (LR consistency, texture floor,
    cost ceiling, uniqueness) on an aggregated (D', H, W) SGM volume."""
    h, w = left.shape
    n_paths = float(cfg.sgm_paths)
    D = agg.shape[0]

    idx, best, cm, cp, second, bestR_d = _wta_scan(agg, cfg)
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

    ceiling = n_paths * (cfg.census_ceiling + cfg.sgm_p2)
    cost_ok = (best <= ceiling) & (best < _SGM_BIG)

    if cfg.uniqueness_ratio > 0:
        unique = best < cfg.uniqueness_ratio * second
    else:
        unique = torch.ones_like(cost_ok)

    valid = consistent & textured & cost_ok & unique
    return torch.where(valid, disp, 0.0)


def disparity(left: torch.Tensor, right: torch.Tensor,
              config: StereoConfig) -> torch.Tensor:
    """(H, W) f32 left disparity map; 0 = invalid."""
    check_route(config)
    out = _disparity_sgm(left, right, config)
    if config.post_median:
        for _ in range(config.post_median_passes):
            out = _median_postfilter(out, config.speckle_tol,
                                     config.fill_support)
    return out
