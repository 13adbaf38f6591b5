"""Execution over a device mesh: surfel-sharded fusion + stream parallelism.

Counterpart of the JAX package's `parallel/sharding.py`.  The mesh is a
(data, surfel) grid of devices driven by ONE host process (the JAX drivers
are single-controller too):

  * axis "data"   - independent camera streams: each row of the grid owns
    a contiguous block of the streams' frames and bank rows.
  * axis "surfel" - each stream's surfel bank split into equal row slabs;
    a cell holds its row's streams' slabs as one batched `SurfelBank`
    (`ShardedBanks`).  `fuse_surfels` is embarrassingly parallel over
    surfels against a replicated frame, so the only collective of the fuse
    step is an OR (a max over int32) of the per-seed fused flags before
    new-surfel extraction.  New surfels go to shards round-robin by seed
    index, so shards stay balanced.

Every pass of a mesh program is one torch.func.vmap per cell over its
row's streams, as the JAX package runs `jax.vmap(per_stream)` inside its
`shard_map`: a kernel reached inside (B1-B3, B5, B6, B4) launches once per
cell for the row's streams, through its `vmap` rule.

The collectives of the JAX package are explicit tensor operations across
the shards' tensors here (`_all_reduce`): the max of the fused flags, the
sum of the stats, the min of the prior's coarse z-buffers; with several
cards they are peer copies.  With one card the grid repeats it (virtual
shards, as the JAX tests run 8 virtual CPU devices).  On CUDA every mesh
program runs inside `mesh_program`: each card works on a stream of the
program (its lane), and each pass over the shards (`cells`) gives every
shard a stream of its own, forked from its card's lane and joined back
after the pass, so the shards' work overlaps across cards and on one card
(virtual shards); the collectives run between the passes.  Captured, the
same forks and joins are the edges of one CUDA graph over every card.

The superpixel/plane-fit stage, and the stereo front-end, run replicated on
every shard's device, the JAX package's policy: on CUDA that is B1-B3 (and
B5/B6) once per cell and step.  `parallel/frame_sharding.py` splits the
segmentation by image columns instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
from typing import List, Sequence

import numpy as np
import torch

from ..config import SurfelMapConfig
from ..core.state import FIELDS, FrameInput, SuperpixelState, SurfelBank
from ..ops import fusion, normals, superpixel
from ..ops import warp as warp_ops
from ..utils import timing
from . import multistream


class Mesh:
    """A (data, surfel) grid of torch devices: `shape["data"]` rows of
    `shape["surfel"]` shards; `device(row, shard)` is a cell's device."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = [list(row) for row in grid]
        self.shape = {"data": len(self.grid), "surfel": len(self.grid[0])}

    def device(self, row: int, shard: int) -> torch.device:
        return self.grid[row][shard]

    def devices(self) -> List[torch.device]:
        """The distinct devices of the grid, in row-major order (the home
        cell's first)."""
        return list(dict.fromkeys(d for row in self.grid for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.grid})"


def _normal_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"a mesh on {d}: no CUDA device is available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, data: int = 1,
              devices=None) -> Mesh:
    """Mesh ("data", "surfel") over `devices`: None = every CUDA card
    (raises without one), a device (or its name) = that one device, or a
    sequence of devices.  n_devices (default: as many as given) cells are
    laid out row-major, data rows of n_devices / data shards; when it
    exceeds the devices given they repeat in turn, so one card holds
    several virtual shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available "
                               "(pass devices='cpu' for a CPU mesh)")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devs = [_normal_device(devices)]
    else:
        devs = [_normal_device(d) for d in devices]
    n = n_devices or len(devs)
    if n % data:
        raise ValueError(f"{n} devices do not split into {data} data rows")
    flat = [devs[i % len(devs)] for i in range(n)]
    per = n // data
    return Mesh([flat[r * per:(r + 1) * per] for r in range(data)])


@dataclasses.dataclass
class ShardedBanks:
    """Per-stream banks laid out for a mesh, one batched bank per cell:
    `rows[r][s]` is data row r's bank on cell (r, s), a `SurfelBank` whose
    fields are (B_r, rows_per_shard, ...) and whose count is (B_r,), for
    the row's B_r streams in stream order (the fleet's layout,
    `multistream.make_banks`; a cell's (B_local, N / n_surfel) slab of the
    JAX package's bank).  `shards[b][s]` is stream b's slab on shard s,
    views into its row's bank (`multistream.stream_bank`), so code of one
    stream reads and writes the same rows.  A row given as one stream's
    unbatched banks (count ()) becomes a row of that stream, as views.
    The host view of a stream's bank is its shards' rows in shard order
    (`live_rows`)."""

    rows: List[List[SurfelBank]]

    def __post_init__(self):
        self.rows = [[b if b.count.dim() else _one_stream(b) for b in row]
                     for row in self.rows]

    def spans(self) -> List[tuple]:
        """(first stream, end) of each data row's streams."""
        out, lo = [], 0
        for row in self.rows:
            out.append((lo, lo + row[0].count.shape[0]))
            lo = out[-1][1]
        return out

    @property
    def shards(self) -> List[List[SurfelBank]]:
        """`[b][s]`: stream b's slab on shard s, views into its row."""
        return [[multistream.stream_bank(bank, j) for bank in row]
                for row in self.rows for j in range(row[0].count.shape[0])]

    @property
    def n_streams(self) -> int:
        return self.spans()[-1][1]

    @property
    def n_shards(self) -> int:
        return len(self.rows[0])

    @property
    def rows_per_shard(self) -> int:
        return self.rows[0][0].position.shape[1]

    def counts(self) -> np.ndarray:
        """(B, n_shards) counts on the host (reads the device)."""
        return np.concatenate([np.stack([b.count.cpu().numpy() for b in row],
                                        axis=1) for row in self.rows]
                              ).astype(np.int64)

    def host(self, field: str) -> np.ndarray:
        """(B, n_shards * rows, ...) host copy of one field: every shard's
        rows in shard order (the JAX package's (B, N) layout)."""
        return np.concatenate([np.concatenate(
            [getattr(b, field).cpu().numpy() for b in row], axis=1)
            for row in self.rows])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for row in self.rows for b in row
                   for _, t in b.field_arrays())

    def devices(self) -> List[torch.device]:
        """The distinct devices of the banks, in (row, shard) order (row
        0's first shard, the home cell, first)."""
        return list(dict.fromkeys(b.device for row in self.rows
                                  for b in row))


def _one_stream(bank: SurfelBank) -> SurfelBank:
    """One stream's bank as a batched bank of that stream (views)."""
    return SurfelBank(**{k: t[None] for k, t in _fields(bank).items()})


def _fields(obj) -> dict:
    """A dataclass's tensors by field name (to pass through a vmap)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def replicate_banks(mesh: Mesh, config: SurfelMapConfig,
                    n_streams: int) -> ShardedBanks:
    """Empty per-stream banks laid out for the mesh: one batched bank per
    cell.  Capacity is padded so each surfel shard has equal rows; stream
    b lives on data row b * data // n_streams (the JAX `P("data")`
    split: each row holds a contiguous block of the streams)."""
    n = mesh.shape["surfel"]
    rows = -(-config.surfel_capacity // n)
    return ShardedBanks([
        [multistream.empty_banks(rows, hi - lo, mesh.device(r, s))
         for s in range(n)]
        for r, (lo, hi) in enumerate(_row_spans(mesh, n_streams))])


def _row(mesh: Mesh, stream: int, n_streams: int) -> int:
    if n_streams % mesh.shape["data"]:
        raise ValueError(f"{n_streams} streams do not split over "
                         f"{mesh.shape['data']} data rows")
    return stream * mesh.shape["data"] // n_streams


def _row_spans(mesh: Mesh, n_streams: int) -> List[tuple]:
    """(first stream, end) of each data row's streams (`_row`)."""
    rows = [_row(mesh, b, n_streams) for b in range(n_streams)]
    return [(rows.index(r), n_streams - rows[::-1].index(r))
            for r in range(mesh.shape["data"])]


def live_rows(field, counts) -> np.ndarray:
    """Concatenated live rows of ONE stream's sharded bank field (host
    numpy): shard s owns rows [s * slab, s * slab + counts[s]) of the
    (n_shards * slab, ...) field.  The one place that encodes the layout."""
    field = np.asarray(field)
    counts = np.asarray(counts)
    n_shards = counts.shape[0]
    slab = field.shape[0] // n_shards
    return np.concatenate([field[s * slab:s * slab + int(counts[s])]
                           for s in range(n_shards)])


def shard_frames(mesh: Mesh, frames: FrameInput) -> List[List[FrameInput]]:
    """A batched FrameInput (leading stream axis) placed on the mesh:
    `[r][s]` is data row r's streams' frames, batched, on the device of
    its cell s (replicated over "surfel")."""
    spans = _row_spans(mesh, frames.image.shape[0])
    return [[FrameInput(**{k: _to(t[lo:hi], d)
                           for k, t in _fields(frames).items()})
             for d in row] for row, (lo, hi) in zip(mesh.grid, spans)]


# ----------------------------------------------------------------------
# streams: each card's lane, each cell's stream
# ----------------------------------------------------------------------
class _Program(threading.local):
    lanes = None    # card -> its lane, inside a CUDA mesh program


_PROGRAM = _Program()


@functools.lru_cache(maxsize=None)
def _stream(device: torch.device, k: int) -> torch.cuda.Stream:
    """The mesh programs' k-th stream on a card: k = 0 its lane (not
    the home card's, whose lane is the caller's stream), k >= 1 its k-th
    cell's.  Fixed streams: the caching allocator keeps its free blocks
    per stream, so new streams per call would keep growing them."""
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def mesh_program(devices):
    """Run a mesh program over `devices` (its cells' cards, the home
    card first): the home card's lane is the caller's current stream
    (`main`), every other card's lane its own stream, forked from main on
    entry and joined into main on exit, and current on that card while
    the program runs, so PyTorch issues each card's work and the peer
    copies between cards (two-way event barriers between the two cards'
    current streams) on the lanes; its phases write no device stamps
    (`timing.unstamped`).  Outside a capture the lanes also
    fork from and join into each card's stream current before the call,
    so work around the call stays ordered; under a capture (main
    capturing) they fork and join main alone, and a replay orders the
    other cards' streams (`fuse_step.BankGraph.replay`).  Nested calls,
    CPU meshes: no-op."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    if _PROGRAM.lanes is not None or devs[0].type != "cuda":
        yield
        return
    home = devs[0]
    main = torch.cuda.current_stream(home)
    with torch.cuda.device(home):
        capturing = torch.cuda.is_current_stream_capturing()
    outer = {d: torch.cuda.current_stream(d) for d in devs[1:]}
    lanes = {home: main, **{d: _stream(d, 0) for d in devs[1:]}}
    for d in devs[1:]:
        lanes[d].wait_stream(main)
        if not capturing:
            lanes[d].wait_stream(outer[d])
    _PROGRAM.lanes = lanes
    try:
        with contextlib.ExitStack() as stack:
            for d in devs[1:]:
                stack.enter_context(torch.cuda.stream(lanes[d]))
            stack.enter_context(torch.cuda.device(home))
            stack.enter_context(timing.unstamped())
            yield
    finally:
        _PROGRAM.lanes = None
    for d in devs[1:]:
        main.wait_stream(lanes[d])
        if not capturing:
            outer[d].wait_stream(lanes[d])


def cell_streams(devices) -> List[tuple]:
    """(card, k) of each cell's stream in a pass over `devices`: the k-th
    cell on a card (k >= 1) runs on that card's k-th cell stream,
    `_stream(card, k)` (k = 0 is the card's lane)."""
    nth = collections.Counter()
    out = []
    for d in devices:
        nth[d] += 1
        out.append((d, nth[d]))
    return out


def capture_plan(mesh: "Mesh") -> dict:
    """What a graph of a program over `mesh`'s banks does on each card,
    from the devices alone (nothing allocated): whether the mesh is
    graphed (`graphed_mesh`); its home card (the capture stream, the
    static inputs, the replay's stream); and per card: its lane (the home
    card's is the capture stream, k = 0 another card's `_stream`), where
    its allocations go under the capture (the home card's through the
    graph's pool argument, the others' through `use_mem_pool`:
    `fuse_step.capture`), its cells as (row, shard) (the banks the
    warm-up clones on that card) and their streams' k (`cell_streams`, per
    data row: each row's pass is its own)."""
    home = mesh.device(0, 0)
    cards = {d: dict(lane="capture" if d == home else 0,
                     pool="graph" if d == home else "use_mem_pool",
                     cells=[], streams=[]) for d in mesh.devices()}
    for r, row in enumerate(mesh.grid):
        for s, (d, k) in enumerate(cell_streams(row)):
            cards[d]["cells"].append((r, s))
            cards[d]["streams"].append(k)
    return dict(graphed=graphed_mesh(mesh), home=home, cards=cards)


def cells(devices):
    """Iterate s over the cells of one pass (`devices[s]`: cell s's
    card), each iteration's work on cell s's own stream: every cell's
    stream forks from its card's lane before the first iteration and the
    lanes join every cell's stream after the last, so a cell may read
    what the lanes or earlier passes made, and the lanes may read what
    the pass made, but cells of one pass must not read each other's
    results.  Outside a CUDA mesh program: a plain range."""
    devices = list(devices)
    lanes = _PROGRAM.lanes
    if lanes is None:
        yield from range(len(devices))
        return
    streams = [_stream(d, k) for d, k in cell_streams(devices)]
    for st, d in zip(streams, devices):
        st.wait_stream(lanes[d])
    for s, st in enumerate(streams):
        with torch.cuda.stream(st):
            yield s
    for st, d in zip(streams, devices):
        lanes[d].wait_stream(st)


# ----------------------------------------------------------------------
# the collectives, as tensor operations across the shards
# ----------------------------------------------------------------------
def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


def _all_reduce(tensors: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """op-reduce one tensor per shard in shard order; every shard gets the
    result on its own device (a no-op copy for a virtual shard)."""
    acc = tensors[0]
    for t in tensors[1:]:
        acc = op(acc, _to(t, acc.device))
    return [_to(acc, t.device) for t in tensors]


def _replicate(t: torch.Tensor, row: Sequence[SurfelBank]):
    """One copy of t on every cell's device."""
    return [_to(t, b.device) for b in row]


def _stack_rows(banks: ShardedBanks, per_row: List[dict]) -> dict:
    """The data rows' stats dicts ((B_r,) each) -> one dict of (B,)
    tensors in stream order on the home cell."""
    home = banks.rows[0][0].device
    return {k: torch.cat([_to(st[k], home) for st in per_row])
            for k in per_row[0]}


# ----------------------------------------------------------------------
# the fuse step of one data row: one vmapped pass per cell over its streams
# ----------------------------------------------------------------------
def _fuse_row(config: SurfelMapConfig, row: List[SurfelBank], front,
              inputs: Sequence[tuple], masks=None, segmented=None) -> dict:
    """The sharded fuse step of one data row's streams: updates `row` (its
    cells' batched banks) in place and returns the row's stats, (B_r,)
    each, on its first cell.  The JAX package's `jax.vmap(per_stream)`
    inside its `shard_map`: every pass is one torch.func.vmap over the
    row's streams on each cell (`cells`), so each kernel it reaches
    launches once per cell with the streams on its stream axis.

    Pass 1: `front(*inputs[s])` -> (a FrameInput, extra stats) decodes one
    stream's frame on cell s (`inputs[s]`: the row's tensors on that
    cell); then the frame stage (SLIC and the plane fit, or `segmented[s]`,
    the (seed fields, assignment) of the column-sharded stage) and
    `fuse_surfels` against the cell's slab.  The collective, outside the
    vmap: the OR (a max over int32) of the (B_r, S) fused flags across the
    shards.  Pass 2: new-surfel extraction, the round-robin ownership of
    new surfels by seed index and the in-place compact-and-append.  masks
    (optional, per cell (B_r, P) bool): the window gating.  The extra
    stats (the matcher's n_rescued_px) are shard 0's."""
    n = len(row)
    devs = [b.device for b in row]

    def first(bank, ins, mask, seg):
        frame, extra = front(*ins)
        dev = frame.depth.device
        with timing.phase("superpixel", dev):
            if seg is None:
                seeds, assignment = superpixel.run_slic(config, frame.image,
                                                        frame.depth)
                seeds, _ = normals.compute_seed_planes(
                    config, seeds, assignment, frame.depth)
            else:
                seeds, assignment = SuperpixelState(**seg[0]), seg[1]
        with timing.phase("fuse", dev):
            fused = fusion.fuse_surfels(
                config, bank, seeds, assignment, frame.depth, frame.pose,
                frame.frame_index, pose_mask=mask)
        return (_fields(seeds), fused.to(torch.int32), frame.pose,
                frame.frame_index, extra)

    passes = [multistream._vmap_banks(first)(
        row[s], inputs[s], None if masks is None else masks[s],
        None if segmented is None else segmented[s]) for s in cells(devs)]

    # seeds claimed by ANY shard's surfels: OR across the surfel axis
    fused_all = _all_reduce([p[1] for p in passes], torch.maximum)
    per_shard = []
    with timing.phase("append", devs[0]):
        for s in cells(devs):
            def second(bank, seeds, fused, pose, ref, s=s):
                new_fields, new_mask = fusion.extract_new_surfels(
                    config, SuperpixelState(**seeds), fused > 0, pose, ref)
                # round-robin ownership of new surfels by seed index
                seed_idx = torch.arange(new_mask.shape[0],
                                        device=new_mask.device)
                return fusion.compact_and_append_(
                    bank, new_fields, new_mask & (seed_idx % n == s))
            seeds, _, pose, ref, _ = passes[s]
            per_shard.append(multistream._vmap_banks(second)(
                row[s], seeds, fused_all[s], pose, ref))
    stats = {k: functools.reduce(torch.add, [_to(st[k], devs[0])
                                             for st in per_shard])
             for k in ("n_live", "n_new", "n_dropped")}
    stats["n_fused_seeds"] = (fused_all[0] > 0).flatten(1).sum(
        dim=1, dtype=torch.int32)
    stats.update(passes[0][4])
    return stats


def _frame_front(image, depth, pose, frame_index):
    """Pass 1's front of a step fed padded frames: the frame itself."""
    return FrameInput(image=image, depth=depth, pose=pose,
                      frame_index=frame_index), {}


def _frame_inputs(frames: Sequence[FrameInput]) -> List[tuple]:
    """`_frame_front`'s inputs on each cell, from a row of `shard_frames`."""
    return [(f.image, f.depth, f.pose, f.frame_index) for f in frames]


def _packed_front(config: SurfelMapConfig):
    """Pass 1's front of a step fed compact single-buffer frames (u8
    intensity + f16 depth, `_packed_inputs`): the device-side ingest of
    the single-device drivers, so sharded and dense runs see the same
    frames."""
    from ..pipeline.fuse_step import ingest_frame

    def front(image_u8, depth_f16, pose, frame_index):
        img, dep = ingest_frame(config, image_u8, depth_f16)
        return FrameInput(image=img, depth=dep, pose=pose,
                          frame_index=frame_index), {}
    return front


def sharded_fuse_frame(config: SurfelMapConfig, mesh: Mesh):
    """Multi-device fuse step over mesh ("data", "surfel").

    Call: (banks, frames) -> (banks, stats): banks from `replicate_banks`
    (updated in place), frames from `shard_frames`; stats (B,) each."""
    del mesh    # the banks and frames carry their devices

    def step(banks: ShardedBanks, frames):
        with mesh_program(banks.devices()):
            return banks, _stack_rows(banks, [
                _fuse_row(config, row, _frame_front, _frame_inputs(frames[r]))
                for r, row in enumerate(banks.rows)])
    return step


def sharded_fuse_frame_windowed(config: SurfelMapConfig, mesh: Mesh):
    """sharded_fuse_frame with device-resident active-window gating: masks
    (B, max_keyframes) bool; rows owned by out-of-window keyframes stay
    frozen.  Call: (banks, frames, masks) -> (banks, stats)."""
    del mesh

    def step(banks: ShardedBanks, frames, masks: torch.Tensor):
        with mesh_program(banks.devices()):
            return banks, _stack_rows(banks, [
                _fuse_row(config, row, _frame_front, _frame_inputs(frames[r]),
                          masks=_replicate(masks[lo:hi], row))
                for r, (row, (lo, hi)) in enumerate(zip(banks.rows,
                                                        banks.spans()))])
    return step


def _packed_inputs(config: SurfelMapConfig, row: Sequence[SurfelBank],
                   bufs, poses, refs) -> list:
    """`_packed_front`'s inputs on each cell of a row: the row's (B_r,
    3HW) u8 buffers decoded (`multistream.unpack_frames`), poses and
    frame indices."""
    return [tuple(_to(t, b.device) for t in (
        *multistream.unpack_frames(config, bufs), poses, refs))
        for b in row]


def sharded_fuse_frame_windowed_packed(config: SurfelMapConfig, mesh: Mesh):
    """sharded_fuse_frame_windowed over compact single-buffer frames (u8
    intensity + f16 depth bytes, decoded on the device): the ingest
    encoding of the single-device drivers, so sharded and dense runs see
    the same frames.

    Call: (banks, bufs (B, 3HW) u8, poses (B,4,4) f32, refs (B,) i32,
    masks (B, max_keyframes) bool) -> (banks, stats)."""
    del mesh
    front = _packed_front(config)

    def step(banks: ShardedBanks, bufs, poses, refs, masks):
        with mesh_program(banks.devices()):
            return banks, _stack_rows(banks, [
                _fuse_row(config, row, front, _packed_inputs(
                    config, row, bufs[lo:hi], poses[lo:hi], refs[lo:hi]),
                    masks=_replicate(masks[lo:hi], row))
                for row, (lo, hi) in zip(banks.rows, banks.spans())])
    return step


def merged_zbuffers(config: SurfelMapConfig, stereo_config, row, poses):
    """Pass 0 of the stereo steps: every cell renders the coarse z-buffers
    of its slab for the row's streams (one vmapped `coarse_zbuffer` per
    cell; poses: the row's (B_r, 4, 4) poses on each cell), min-merged
    across the shards (the JAX package's `lax.pmin`; exact, so every
    shard gets the dense bank's z-buffer): (B_r, hs, ws) f32 per cell, or
    None when the prior is off."""
    from ..ops.render import coarse_zbuffer
    if not stereo_config.prior_rescue or stereo_config.hierarchical:
        return None
    render = multistream._vmap_banks(lambda bank, pose: coarse_zbuffer(
        config, bank, pose, stereo_config.prior_stride,
        stereo_config.prior_min_updates))
    return _all_reduce([render(row[s], poses[s])
                        for s in cells([b.device for b in row])],
                       torch.minimum)


def sharded_prior(config: SurfelMapConfig, stereo_config, row, poses):
    """The matcher's map prior of ONE stream on every shard (`row`: its
    per-shard banks, `poses`: its pose on each shard's device), None each
    when the prior is off: the stereo steps' merged z-buffer
    (`merged_zbuffers`) upsampled on each shard, as their pass 1 does."""
    from ..ops.render import upsample_prior
    merged = merged_zbuffers(config, stereo_config,
                             [_one_stream(b) for b in row],
                             [p[None] for p in poses])
    if merged is None:
        return [None] * len(row)
    return [upsample_prior(config, m[0], stereo_config.prior_stride)
            for m in merged]


def _stereo_front(config: SurfelMapConfig, stereo_config,
                  filter_depth: bool):
    """Pass 1's front of the stereo steps, for one stream: the pair's
    unpack, the prior's upsample from the merged z-buffer (when given),
    the matcher, depth and its filter, and the pad."""
    from ..ops.render import upsample_prior
    from ..pipeline.fuse_step import compute_depth_stereo, unpack_stereo
    ph, pw = config.padded_height, config.padded_width
    pad = (0, pw - config.width, 0, ph - config.height)

    def front(buf, pose, ref, bf, coarse=None):
        left, right = unpack_stereo(config, buf)
        prior = None if coarse is None else upsample_prior(
            config, coarse, stereo_config.prior_stride)
        depth, n_rescued = compute_depth_stereo(
            config, stereo_config, left, right, bf, filter_depth,
            prior_depth=prior)
        return FrameInput(image=torch.nn.functional.pad(left, pad),
                          depth=torch.nn.functional.pad(depth, pad),
                          pose=pose, frame_index=ref), \
            {"n_rescued_px": n_rescued}
    return front


def _stereo_row(config, stereo_config, filter_depth, row, bufs, poses,
                refs, bfs, masks) -> dict:
    """The stereo-resident step of one data row's streams: pass 0 (the
    merged prior z-buffers), then `_fuse_row` with the matcher in its
    pass 1, under the same vmap as the fuse: on CUDA B5 and B6 launch once
    per cell for the row's streams (B4 twice on the materialized
    branch)."""
    zbuf = merged_zbuffers(config, stereo_config, row,
                           _replicate(poses, row))
    inputs = [tuple(_to(t, b.device) for t in (bufs, poses, refs, bfs))
              + (() if zbuf is None else (zbuf[s],))
              for s, b in enumerate(row)]
    return _fuse_row(config, row, _stereo_front(config, stereo_config,
                                                filter_depth), inputs,
                     masks=None if masks is None else _replicate(masks, row))


def sharded_fuse_frame_stereo_windowed_packed(config: SurfelMapConfig,
                                              stereo_config,
                                              filter_depth: bool,
                                              mesh: Mesh):
    """Stereo-resident windowed fuse over the mesh: the on-device stereo
    front-end (`fuse_step.compute_depth_stereo`) runs replicated per surfel
    shard, then the sharded windowed fuse.

    Call: (banks, bufs (B, 2HW) u8, poses (B,4,4), refs (B,), bfs (B,)
    f32, masks (B, max_keyframes)) -> (banks, stats)."""
    del mesh

    def step(banks: ShardedBanks, bufs, poses, refs, bfs, masks):
        with mesh_program(banks.devices()):
            return banks, _stack_rows(banks, [
                _stereo_row(config, stereo_config, filter_depth, row,
                            *(t[lo:hi] for t in (bufs, poses, refs, bfs,
                                                 masks)))
                for row, (lo, hi) in zip(banks.rows, banks.spans())])
    return step


def sharded_fuse_frame_stereo(config: SurfelMapConfig, stereo_config,
                              filter_depth: bool, mesh: Mesh):
    """Stereo-resident fuse without the window mask (the host-pool sharded
    driver); the same replicated front-end.

    Call: (banks, bufs (B, 2HW) u8, poses, refs, bfs) -> (banks, stats)."""
    del mesh

    def step(banks: ShardedBanks, bufs, poses, refs, bfs):
        with mesh_program(banks.devices()):
            return banks, _stack_rows(banks, [
                _stereo_row(config, stereo_config, filter_depth, row,
                            *(t[lo:hi] for t in (bufs, poses, refs, bfs)),
                            None)
                for row, (lo, hi) in zip(banks.rows, banks.spans())])
    return step


# ----------------------------------------------------------------------
# bank lifecycle: one vmapped call per cell over its row's streams, each
# (stream, shard) on its own rows
# ----------------------------------------------------------------------
def _row_cells(banks: ShardedBanks):
    """(row's first stream, end, shard, the cell's batched bank) of every
    cell, each row's cells in one pass (`cells`)."""
    for row, (lo, hi) in zip(banks.rows, banks.spans()):
        for s in cells([b.device for b in row]):
            yield lo, hi, s, row[s]


def sharded_warp_by_pose(config: SurfelMapConfig, mesh: Mesh):
    """Whole-bank per-pose loop warp over the mesh (`warp_bank_by_pose` on
    every cell, vmapped over its streams, in place).  Call: (banks, warps
    (B,P,4,4), moved (B,P), masks (B,P), firsts (B,)) -> banks."""
    del config, mesh

    def warp(banks: ShardedBanks, warps, moved, masks, firsts):
        with mesh_program(banks.devices()):
            for lo, hi, _, bank in _row_cells(banks):
                multistream.batched_warp(bank, *(
                    _to(t[lo:hi], bank.device)
                    for t in (warps, moved, masks, firsts)))
        return banks
    return warp


def sharded_compact(config: SurfelMapConfig, mesh: Mesh):
    """Per-shard hole elimination, in place: compaction never crosses a
    shard boundary, so no collective is needed."""
    del config, mesh

    def compact(banks: ShardedBanks):
        with mesh_program(banks.devices()):
            for _, _, _, bank in _row_cells(banks):
                multistream.batched_compact(bank)
        return banks
    return compact


def sharded_extract_by_pose(config: SurfelMapConfig, mesh: Mesh,
                            buffer_size: int):
    """Sharded active -> inactive extract: each (stream, shard) matches the
    removed pose ids against its own rows into its slice of a
    (B, n_shards * buffer_size) buffer.

    Call: (banks, pose_ids (MAX_REMOVE_POSES,)) -> (banks, buffers dict,
    counts (B, n_shards)), the buffers and counts on the home cell.  The
    union of the shards' buffers is the single-device extraction."""
    from ..ops.migration import extract_by_pose
    del config, mesh

    def extract(banks: ShardedBanks, pose_ids: torch.Tensor):
        home = banks.rows[0][0].device
        with mesh_program(banks.devices()):
            parts = [multistream._vmap_banks(
                lambda b, ids=_to(pose_ids, bank.device): extract_by_pose(
                    b, ids, buffer_size))(bank)
                for _, _, _, bank in _row_cells(banks)]
            n = banks.n_shards
            # cell (r, s) is parts[r * n + s]: (buffers (B_r, size, ...),
            # counts (B_r,)); stack the shards, then the rows
            rows = [parts[i:i + n] for i in range(0, len(parts), n)]
            return banks, {k: torch.cat([torch.stack(
                [_to(p[0][k], home) for p in row], 1).flatten(1, 2)
                for row in rows]) for k in FIELDS}, torch.cat([torch.stack(
                    [_to(p[1], home) for p in row], 1) for row in rows])
    return extract


def sharded_append(config: SurfelMapConfig, mesh: Mesh, per_buf: int):
    """Sharded host-slab append (pool re-activation): each (stream, shard)
    tail-appends its slice of a round-robin-distributed slab.

    Call: (banks, fields dict (B, n_shards * per_buf, ...), ns (B,
    n_shards)) -> banks."""
    del config, mesh

    def one(bank, part, n):
        mask = torch.arange(per_buf, device=n.device) < n
        fusion.append_new(bank, part, mask)
        return bank.count          # vmap needs an output; unused

    def append(banks: ShardedBanks, fields: dict, ns: torch.Tensor):
        with mesh_program(banks.devices()):
            for lo, hi, s, bank in _row_cells(banks):
                part = {k: _to(v[lo:hi, s * per_buf:(s + 1) * per_buf],
                               bank.device) for k, v in fields.items()}
                multistream._vmap_banks(one)(bank, part,
                                             _to(ns[lo:hi, s], bank.device))
        return banks
    return append


def sharded_warp_active(config: SurfelMapConfig, mesh: Mesh):
    """Loop-closure warp of every bank row (one matrix per stream), in
    place: elementwise per shard, no collectives.  Call: (banks, warps
    (B,4,4)) -> banks."""
    del config, mesh

    def one(bank, w):
        warp_ops.warp_active(bank, w)
        return bank.count          # vmap needs an output; unused

    def warp(banks: ShardedBanks, warps: torch.Tensor):
        with mesh_program(banks.devices()):
            for lo, hi, _, bank in _row_cells(banks):
                multistream._vmap_banks(one)(bank, _to(warps[lo:hi],
                                                       bank.device))
        return banks
    return warp


# ----------------------------------------------------------------------
# the mesh programs as captured CUDA graphs (the JAX package's
# `jax.jit(jax.shard_map(...))`): one `fuse_step.BankGraph` over the
# mesh's banks each, its static inputs on the home cell
# ----------------------------------------------------------------------
def graphed_mesh(mesh: Mesh) -> bool:
    """Whether a mesh's programs replay captured graphs: every cell is a
    CUDA card, one card repeated or several (8 cells on 4 cards too).
    One capture spans the cards: the program's lanes and cell streams
    (`mesh_program`, `cells`) fork from the capture stream and join it,
    the peer copies between cards become copy nodes with their event
    edges, and each card allocates from its own memory pool
    (`fuse_step.capture`).  A CPU mesh runs the programs eagerly."""
    return all(d.type == "cuda" for d in mesh.devices())


def mesh_step_graph(mesh: Mesh, banks: ShardedBanks, step, nbytes: int,
                    pool, keep):
    """A mesh fuse step as a StepGraph: one (B, nbytes) u8 payload, the
    stats (B,) each as outputs."""
    from ..pipeline.fuse_step import StepGraph
    return StepGraph(step, banks, (banks.n_streams, nbytes), pool, keep,
                     graphed=graphed_mesh(mesh))


def mesh_bank_graph(mesh: Mesh, banks: ShardedBanks, fn, specs, pool):
    from ..pipeline.fuse_step import BankGraph
    return BankGraph(fn, banks, specs, pool, graphed=graphed_mesh(mesh))


def step_geometry(config: SurfelMapConfig, mesh: Mesh):
    """The cached geometry planes the replicated frame stage reads on every
    card of the mesh (kept alive by its graph: the cache may evict
    them, and a graph reads each card's planes at their addresses)."""
    return [superpixel.device_geometry(config, d) for d in mesh.devices()]


def padded_payload_bytes(config: SurfelMapConfig, mask: bool) -> int:
    """Length of a padded-frame payload: the padded f32 image and depth
    planes, then `core.state.pack_aux`'s 72-byte head and, if `mask`, the
    (max_keyframes,) window mask."""
    from ..core.state import AUX_HEAD_BYTES
    from ..pipeline.fuse_step import padded_frame_bytes
    return padded_frame_bytes(config) + AUX_HEAD_BYTES \
        + (config.max_keyframes if mask else 0)


def unpack_padded(config: SurfelMapConfig, payload: torch.Tensor):
    """Decode of a (B, padded_payload_bytes) u8 payload: (a batched
    FrameInput, window masks (B, P) bool, empty without the mask)."""
    from ..pipeline.fuse_step import padded_frame_bytes
    from .multistream import _bytes_as, unpack_payload
    b = payload.shape[0]
    ph, pw = config.padded_height, config.padded_width
    planes, poses, refs, _, masks = unpack_payload(
        payload, padded_frame_bytes(config))
    planes = _bytes_as(planes, torch.float32).view(b, 2, ph, pw)
    return FrameInput(image=planes[:, 0], depth=planes[:, 1], pose=poses,
                      frame_index=refs), masks


def graphed_fuse_frame(config: SurfelMapConfig, mesh: Mesh,
                       banks: ShardedBanks, pool=None):
    """`sharded_fuse_frame` as a graph (the JAX package's
    `sharded_fuse_frame`, densesurfelmapping_tpu/parallel/sharding.py:
    86-115): input the (B, padded_payload_bytes(mask=False)) payload of
    each stream's padded planes, pose and frame index; returns the stats.
    `ShardedSurfelMapping`'s depth-fed step."""
    fuse = sharded_fuse_frame(config, mesh)

    def step(b: ShardedBanks, payload: torch.Tensor) -> dict:
        with mesh_program(b.devices()):
            frames, _ = unpack_padded(config, payload)
            return fuse(b, shard_frames(mesh, frames))[1]

    return mesh_step_graph(mesh, banks, step,
                           padded_payload_bytes(config, mask=False), pool,
                           step_geometry(config, mesh))


def graphed_fuse_frame_windowed(config: SurfelMapConfig, mesh: Mesh,
                                banks: ShardedBanks, pool=None):
    """`sharded_fuse_frame_windowed` as a graph (:119-144): input the
    (B, padded_payload_bytes(mask=True)) payload, the window mask after
    the aux head."""
    fuse = sharded_fuse_frame_windowed(config, mesh)

    def step(b: ShardedBanks, payload: torch.Tensor) -> dict:
        with mesh_program(b.devices()):
            frames, masks = unpack_padded(config, payload)
            return fuse(b, shard_frames(mesh, frames), masks)[1]

    return mesh_step_graph(mesh, banks, step,
                           padded_payload_bytes(config, mask=True), pool,
                           step_geometry(config, mesh))


def graphed_fuse_frame_windowed_packed(config: SurfelMapConfig, mesh: Mesh,
                                       banks: ShardedBanks, pool=None):
    """`sharded_fuse_frame_windowed_packed` as a graph (:148-179): input
    each stream's one-buffer payload (`core.state.pack_frame_with_aux`,
    (B, 3 H W + 72 + P) u8), the dense driver's; returns the stats.
    `ShardedDeviceResidentMapping`'s depth-fed step."""
    from ..pipeline.fuse_step import onebuf_bytes
    from .multistream import unpack_payload
    fuse = sharded_fuse_frame_windowed_packed(config, mesh)
    hw3 = 3 * config.height * config.width

    def step(b: ShardedBanks, payload: torch.Tensor) -> dict:
        bufs, poses, refs, _, masks = unpack_payload(payload, hw3)
        return fuse(b, bufs, poses, refs, masks)[1]

    return mesh_step_graph(mesh, banks, step, onebuf_bytes(config), pool,
                           step_geometry(config, mesh))


def graphed_fuse_frame_stereo_windowed_packed(config: SurfelMapConfig,
                                              stereo_config,
                                              filter_depth: bool,
                                              mesh: Mesh,
                                              banks: ShardedBanks,
                                              pool=None):
    """`sharded_fuse_frame_stereo_windowed_packed` as a graph (:183-236):
    input each stream's stereo one-buffer payload (`core.state.
    pack_stereo_with_aux`, (B, 2 H W + 72 + P) u8).
    `ShardedDeviceResidentMapping`'s stereo step."""
    from ..pipeline.fuse_step import stereo_onebuf_bytes
    from .multistream import unpack_payload
    fuse = sharded_fuse_frame_stereo_windowed_packed(
        config, stereo_config, filter_depth, mesh)
    hw2 = 2 * config.height * config.width

    def step(b: ShardedBanks, payload: torch.Tensor) -> dict:
        return fuse(b, *unpack_payload(payload, hw2))[1]

    return mesh_step_graph(mesh, banks, step, stereo_onebuf_bytes(config),
                           pool, step_geometry(config, mesh))


def graphed_fuse_frame_stereo(config: SurfelMapConfig, stereo_config,
                              filter_depth: bool, mesh: Mesh,
                              banks: ShardedBanks, pool=None):
    """`sharded_fuse_frame_stereo` as a graph (:240-278): input each
    stream's packed pair and 72-byte aux head (pose, frame index, bf),
    (B, 2 H W + 72) u8.  `ShardedSurfelMapping`'s stereo step."""
    from ..core.state import AUX_HEAD_BYTES
    from .multistream import unpack_payload
    fuse = sharded_fuse_frame_stereo(config, stereo_config, filter_depth,
                                     mesh)
    hw2 = 2 * config.height * config.width

    def step(b: ShardedBanks, payload: torch.Tensor) -> dict:
        bufs, poses, refs, bfs, _ = unpack_payload(payload, hw2)
        return fuse(b, bufs, poses, refs, bfs)[1]

    return mesh_step_graph(mesh, banks, step, hw2 + AUX_HEAD_BYTES, pool,
                           step_geometry(config, mesh))


def graphed_warp_by_pose(config: SurfelMapConfig, mesh: Mesh,
                         banks: ShardedBanks, pool=None):
    """`sharded_warp_by_pose` as a graph (:282-298).  Inputs, with P =
    config.max_keyframes: warps (B, P, 4, 4) f32, moved (B, P) bool, the
    window masks (B, P) bool, firsts (B,) i64."""
    B, P = banks.n_streams, config.max_keyframes
    return mesh_bank_graph(
        mesh, banks, sharded_warp_by_pose(config, mesh),
        (((B, P, 4, 4), torch.float32), ((B, P), torch.bool),
         ((B, P), torch.bool), ((B,), torch.int64)), pool)


def graphed_compact(config: SurfelMapConfig, mesh: Mesh,
                    banks: ShardedBanks, pool=None):
    """`sharded_compact` as a graph (:313-327); no input."""
    return mesh_bank_graph(mesh, banks, sharded_compact(config, mesh), (),
                           pool)


def graphed_extract_by_pose(config: SurfelMapConfig, mesh: Mesh,
                            banks: ShardedBanks, buffer_size: int,
                            pool=None):
    """`sharded_extract_by_pose` as a graph (:330-355): input the
    (MAX_REMOVE_POSES,) i32 pose ids, padded with -1; returns (buffers
    dict, counts (B, n_shards)), static outputs on the home cell."""
    from ..ops.migration import MAX_REMOVE_POSES
    extract = sharded_extract_by_pose(config, mesh, buffer_size)
    return mesh_bank_graph(mesh, banks, lambda b, ids: extract(b, ids)[1:],
                           (((MAX_REMOVE_POSES,), torch.int32),), pool)


def graphed_append(config: SurfelMapConfig, mesh: Mesh, banks: ShardedBanks,
                   per_buf: int, pool=None):
    """`sharded_append` as a graph (:358-386).  Inputs: the slab's fields
    in `FIELDS` order, (B, n_shards * per_buf, ...) each, then ns (B,
    n_shards) i32."""
    B, n = banks.n_streams, banks.n_shards
    one = banks.shards[0][0]
    specs = [((B, n * per_buf) + getattr(one, k).shape[1:],
              getattr(one, k).dtype) for k in FIELDS] \
        + [((B, n), torch.int32)]
    append = sharded_append(config, mesh, per_buf)

    def run(b: ShardedBanks, *args) -> None:
        *fields, ns = args
        append(b, dict(zip(FIELDS, fields)), ns)

    return mesh_bank_graph(mesh, banks, run, specs, pool)


def graphed_warp_active(config: SurfelMapConfig, mesh: Mesh,
                        banks: ShardedBanks, pool=None):
    """`sharded_warp_active` as a graph (:389-403): input the (B, 4, 4)
    f32 warps."""
    return mesh_bank_graph(mesh, banks, sharded_warp_active(config, mesh),
                           (((banks.n_streams, 4, 4), torch.float32),), pool)
