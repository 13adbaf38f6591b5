"""Per-direction axis sharding of the SGM aggregation.

Counterpart of the JAX package's `parallel/sgm_sharding.py`.  SGM's
scanline DPs carry an unbounded dependency along their scan axis, so the
redundant halo of `parallel/frame_sharding.py` cannot cover them.  Each path
family is instead split along the axis PERPENDICULAR to its scan, over the
mesh's "surfel" axis:

* x+- scans (horizontal family): every image ROW is an independent DP
  chain, so the family runs on row slabs, each shard its H/n rows.
* y+- scans with carry roll 0 (4 paths): every COLUMN is independent, so
  the family runs on column slabs.
* the diagonals move one column per row: with the vertical roll they run
  on column slabs as one batched scan, and at every scan row each diagonal
  channel hands its one boundary carry column, a (1, D) sliver, to the
  neighbour its roll crosses into, around the ring of shards (the JAX
  package's `ppermute`), masking the true-width global border to 0 as the
  replicated scan's `_roll_carry` restarts there.

The per-step DP and the sequential channel sum are column-elementwise, so
the result is BITWISE the replicated `models/stereo.disparity` on the plain
scan path (census cost only: integer costs keep every value exact through
the bf16 volume, which also makes the divisibility padding exact; the JAX
module doc gives the argument).  Like the JAX package's, it runs plain
scans, not the SGM kernels.  The census transform, the WTA + gates and the
post-filters run once on the first shard's device, on the gathered sum.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..models.stereo import (StereoConfig, _SGM_BIG, _SGM_BIG_BF16,
                             _axis_scan, _census, _census_volume,
                             _popcount32, _post_filters, _sgm_dp,
                             _wta_and_gates)
from .sharding import Mesh, _to, cells, graphed_mesh, mesh_program


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _slab_cost_cols(cl_s: torch.Tensor, cr_full: torch.Tensor, col0: int,
                    w_real: int, min_d: int, n_d: int) -> torch.Tensor:
    """(n_d, H, wn) bf16 census cost volume of a COLUMN slab starting at
    global column col0: cost at global x reads cr[y, x - d] across the
    slab's left edge (cr rides whole).  The wedge (x < d) and the
    divisibility padding (x >= w_real) hold bf16(_SGM_BIG)."""
    h, wn = cl_s.shape
    xg = torch.arange(wn, device=cl_s.device).expand(h, wn) + col0
    max_d = min_d + n_d
    crp = F.pad(cr_full[None], (max_d, wn), mode="replicate")[0]
    costs = []
    for d in range(min_d, max_d):
        crd = crp[:, max_d - d + col0:max_d - d + col0 + wn]
        c = _popcount32(cl_s ^ crd).to(torch.bfloat16)
        costs.append(torch.where((xg >= d) & (xg < w_real), c, _SGM_BIG))
    return torch.stack(costs)


def _carry_penalties(p1: float, p2: float, carry_bf16: bool):
    """P1, P2 rounded to the carry dtype, as `_axis_scan` takes them: a
    host-only rounding through a CPU tensor, made once when a program is
    built, outside any captured call."""
    cdt = torch.bfloat16 if carry_bf16 else torch.float32
    return tuple(float(torch.tensor(p, dtype=cdt)) for p in (p1, p2))


def _ring_axis_scan(slabs: List[torch.Tensor], rolls, p1: float, p2: float,
                    w_real: int, min_d: int,
                    carry_bf16: bool = False) -> List[torch.Tensor]:
    """The batched y-family scan of `models/stereo._axis_scan(vv, rolls,
    ..., entry="y")` over column slabs (`slabs[s]`: (H, wn, D), global
    columns [s * wn, (s + 1) * wn)), the shards in lockstep: at every step
    each roll != 0 channel takes its boundary carry column from the ring
    neighbour its roll crosses from.  Returns each slab's f32 path sums.
    p1, p2: the penalties already in carry dtype (`_carry_penalties`).

    Inside a mesh program each shard's steps run on its card's lane, and
    a carry from another card is a peer copy whose event barrier orders
    the two lanes: the ring's lockstep across cards, with no fork and
    join per row.  Shards of one card share its lane, in shard order (a
    pass over the shards, `sharding.cells`, at every one of the 2 H rows
    made the capture at KITTI size 3.5x slower on one H100)."""
    n = len(slabs)
    g = len(rolls)
    H, wn, D = slabs[0].shape
    cdt = torch.bfloat16 if carry_bf16 else torch.float32
    clamp = _SGM_BIG_BF16 if carry_bf16 else None
    xg = [torch.arange(wn, device=v.device)[:, None] + s * wn
          for s, v in enumerate(slabs)]
    kd = [torch.arange(D, device=v.device)[None, :] for v in slabs]
    ent = None
    if any(r == 1 for r in rolls):
        ent = []
        for s in range(n):
            ent_rd = xg[s] == kd[s] + min_d
            ent.append(torch.stack([ent_rd if rolls[k] == 1
                                    else torch.zeros_like(ent_rd)
                                    for k in range(g)]))

    def roll_ring(carries, s, k):
        c, roll = carries[s][k], rolls[k]
        if roll == 0:
            return c
        zero = torch.zeros((), dtype=cdt, device=c.device)
        if roll > 0:
            recv = _to(carries[(s - 1) % n][k][-1:], c.device)
            c2 = torch.cat([recv, c[:-1]], 0)
            return torch.where(xg[s] == 0, zero, c2)
        recv = _to(carries[(s + 1) % n][k][:1], c.device)
        c2 = torch.cat([c[1:], recv], 0)
        return torch.where(xg[s] == w_real - 1, zero, c2)

    def one_dir(reverse: bool) -> List[torch.Tensor]:
        carries = [torch.zeros((g, wn, D), dtype=cdt, device=v.device)
                   for v in slabs]
        outs = [torch.empty((H, wn, D), dtype=torch.bfloat16,
                            device=v.device) for v in slabs]
        for t in (range(H - 1, -1, -1) if reverse else range(H)):
            nxts = []
            for s, v in enumerate(slabs):
                rolled = torch.stack([roll_ring(carries, s, k)
                                      for k in range(g)])
                cost_c = v[t][None].to(cdt)
                nxt = _sgm_dp(rolled, cost_c, p1, p2, clamp=clamp)
                if ent is not None:
                    nxt = torch.where(ent[s], cost_c, nxt)
                tot = nxt[0]
                for k in range(1, g):
                    tot = tot + nxt[k]
                outs[s][t] = tot.to(torch.bfloat16)
                nxts.append(nxt)
            carries = nxts
        return [o.float() for o in outs]

    fwd, bwd = one_dir(False), one_dir(True)
    return [a + b for a, b in zip(fwd, bwd)]


def sharded_sgm_disparity(mesh: Mesh, cfg: StereoConfig, height: int,
                          width: int):
    """(left, right[, prior_disp]) -> (H, W) disparity with the SGM
    aggregation axis-sharded over the mesh's "surfel" axis (row 0 of the
    grid); bitwise equal to `models/stereo.disparity` on the plain scan
    path (sgm_pallas=False).  Census cost only.  A mesh program over the
    row's cards (`sharding.mesh_program`): each slab pass on the shards'
    streams, the census, the gathers and the WTA on the home card."""
    if cfg.cost != "census":
        raise ValueError("axis-sharded SGM supports census cost only "
                         "(integer costs make the padding exact)")
    devs = mesh.grid[0]
    n = len(devs)
    h, w = height, width
    hp, wp = _round_up(h, n), _round_up(w, n)
    hn, wn = hp // n, wp // n
    p1, p2 = cfg.sgm_p1, cfg.sgm_p2
    bf16 = cfg.sgm_carry_bf16
    min_d = cfg.min_disparity
    n_d = cfg.max_disparity - cfg.min_disparity
    cp1, cp2 = _carry_penalties(p1, p2, bf16)

    def run(left, right, prior_disp=None):
        with mesh_program([left.device] + devs):
            return _run(left, right, prior_disp)

    def _run(left, right, prior_disp):
        home = left.device
        cl = _census(left, cfg.census_radius)
        cr = _census(right, cfg.census_radius)

        # horizontal family: row slabs (pad rows are independent chains)
        clr, crr = F.pad(cl, (0, 0, 0, hp - h)), F.pad(cr, (0, 0, 0, hp - h))
        x_parts = []
        for s in cells(devs):
            dev = devs[s]
            rows = slice(s * hn, (s + 1) * hn)
            vol = _census_volume(_to(clr[rows], dev), _to(crr[rows], dev),
                                 min_d, n_d)
            vh = vol.permute(2, 1, 0).contiguous()       # (W, hn, D)
            scan = _axis_scan(vh, (0,), p1, p2, carry_bf16=bf16, entry="x",
                              min_d=min_d)
            x_parts.append(_to(scan.permute(2, 1, 0), home))
        x_agg = torch.cat(x_parts, 1)[:, :h]

        # vertical (+ diagonal) family: column slabs
        clc = F.pad(cl, (0, wp - w))
        vv = []
        for s in cells(devs):
            dev = devs[s]
            vol = _slab_cost_cols(_to(clc[:, s * wn:(s + 1) * wn], dev),
                                  _to(cr, dev), s * wn, w, min_d, n_d)
            vv.append(vol.permute(1, 2, 0).contiguous())  # (H, wn, D)
        if cfg.sgm_paths == 4:
            sums = [_axis_scan(vv[s], (0,), p1, p2, carry_bf16=bf16)
                    for s in cells(devs)]
        else:
            sums = _ring_axis_scan(vv, (0, 1, -1), cp1, cp2, w, min_d,
                                   carry_bf16=bf16)
        y_agg = torch.cat([_to(y.permute(2, 0, 1), home) for y in sums],
                          2)[:, :, :w]

        out = _wta_and_gates(left, x_agg + y_agg, cfg, prior_disp=prior_disp)
        return _post_filters(out, cfg)

    return run


def graphed_sharded_sgm_disparity(mesh: Mesh, cfg: StereoConfig,
                                  height: int, width: int,
                                  with_prior: bool = False):
    """`sharded_sgm_disparity` as a captured graph (the JAX package's
    `jax.jit(run)`, densesurfelmapping_tpu/parallel/sgm_sharding.py:296),
    its height and width fixed when it is built: a `fuse_step.BankGraph`
    without a bank whose static inputs are left and right ((H, W) f32) and,
    if `with_prior`, prior_disp, on the home cell.  Call: (left, right[,
    prior_disp]) -> the (H, W) disparity, a static output that the next
    call overwrites.  One capture over the row's cards, the ring's carry
    copies between cards inside it, each card's memory from a pool of the
    object's own (`fuse_step.graph_pool`); eager on a CPU mesh
    (`sharding.graphed_mesh`)."""
    from ..pipeline.fuse_step import BankGraph, graph_pool
    run = sharded_sgm_disparity(mesh, cfg, height, width)
    spec = ((height, width), torch.float32)
    row = Mesh([mesh.grid[0]])
    graphed = graphed_mesh(row)
    return BankGraph(lambda _, *images: run(*images), None,
                     (spec,) * (3 if with_prior else 2),
                     pool=graph_pool(row.devices()) if graphed else None,
                     graphed=graphed, devices=row.devices())
