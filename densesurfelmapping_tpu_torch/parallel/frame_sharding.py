"""Image-axis (column-slab) sharding of the frame stage.

Counterpart of the JAX package's `parallel/frame_sharding.py`.
`parallel/sharding.py` replicates the superpixel/plane-fit stage on every
surfel shard; this module splits it over the same "surfel" axis by image
COLUMNS (a KITTI frame is 160 seed columns against 47 rows, so the halo
costs least along the width).

Redundant-halo SPMD, no communication inside the stage:

  * Each shard owns `own` seed columns and computes them PLUS a HALO_SP
    column fringe on each side.  SLIC information moves at most ~2 seed
    columns per assign/update iteration, so with seed init (1) + 3
    iterations (2 each) + the plane fit (1) an 8-column halo covers the
    dependency cone of the owned region: owned outputs are identical to the
    replicated computation (pinned by tests/test_torch_frame_sharding.py).
  * The static geometry (masks, window coordinates, neighbour ids) is built
    on an EXTENDED global grid with HALO_SP invalid columns on each side and
    sliced per shard, then handed to `ops/superpixel.py` / `ops/normals.py`
    through `geom=`.  Seed coordinates stay global throughout.
  * Each shard's owned seed columns and pixel assignment are then gathered
    (the JAX package's tiled `all_gather`) into the full-frame result every
    shard's fusion consumes.

A slab runs the plain SLIC functions, on CUDA too: the kernels take no
geometry override, and the JAX package runs its XLA path, not the Pallas
kernels, whenever `geom` is given (its `ops/superpixel.py:313`).  That is
the reference's design, not a fallback.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SurfelMapConfig
from ..core.state import SuperpixelState
from ..ops import normals, superpixel
from . import sharding

HALO_SP = 8  # seed columns of redundant fringe per side (see module doc)


@functools.lru_cache(maxsize=8)
def _extended_geometry(config: SurfelMapConfig, n_slabs: int,
                       halo: int = HALO_SP):
    """Global static geometry (numpy) on the halo-extended column grid:
    `superpixel._static_geometry` with `halo` invalid seed columns on each
    side (plus right padding that makes the owned region divide by
    n_slabs) and GLOBAL x coordinates (negative in the left extension)."""
    sp = config.sp_size
    R, C = config.sp_rows, config.sp_cols
    h = config.padded_height
    oh, ow = config.height, config.width
    own = -(-C // n_slabs)
    c_round = own * n_slabs
    c_ext = c_round + 2 * halo
    w_ext = c_ext * sp

    cglob = np.arange(c_ext) - halo                 # global seed col
    xglob = np.arange(w_ext) - halo * sp            # global pixel x
    ry = np.arange(h) % sp
    rx = np.arange(w_ext) % sp

    def axis_gate(r, off):
        return np.abs(off * sp + sp // 2 - r) < sp

    gate_y = {off: axis_gate(ry, off)[:, None] for off in (-1, 0, 1)}
    gate_x = {off: axis_gate(rx, off)[None, :] for off in (-1, 0, 1)}

    pixel_valid = np.zeros((h, w_ext), bool)
    pixel_valid[:oh, :] = (xglob >= 0) & (xglob < ow)

    seed_valid = np.zeros((R, c_ext), bool)
    seed_valid[:oh // sp, :] = (cglob >= 0) & (cglob < ow // sp)

    in_c = (cglob >= 0) & (cglob < C)
    flat_id = np.where(in_c[None, :],
                       np.arange(R)[:, None] * C + cglob[None, :],
                       -1).astype(np.int32)

    # window coordinates: y rows are global already; x from global cols
    k = 4 * sp * sp
    wy = np.arange(2 * sp)
    wx = np.arange(2 * sp)
    oy = (np.arange(R) * sp - sp // 2)[:, None, None, None]
    ox = (cglob * sp - sp // 2)[None, :, None, None]
    win_y = np.broadcast_to(oy + wy[None, None, :, None],
                            (R, c_ext, 2 * sp, 2 * sp)
                            ).reshape(R, c_ext, k).astype(np.int32)
    win_x = np.broadcast_to(ox + wx[None, None, None, :],
                            (R, c_ext, 2 * sp, 2 * sp)
                            ).reshape(R, c_ext, k).astype(np.int32)
    interior = ((win_y >= 0) & (win_y < oh - 1)
                & (win_x >= 0) & (win_x < ow - 1))
    in_image = ((win_y >= 0) & (win_y < oh)
                & (win_x >= 0) & (win_x < ow))

    in_range, nb_flat = {}, {}
    for di, dj in superpixel._OFFSETS:
        pad_v = np.pad(seed_valid, 1, constant_values=False)
        nb_valid = pad_v[1 + dj:1 + dj + R, 1 + di:1 + di + c_ext]
        nb_valid_px = np.repeat(np.repeat(nb_valid, sp, 0), sp, 1)
        in_range[(di, dj)] = (gate_y[dj] & gate_x[di]
                              & nb_valid_px & pixel_valid)
        pad_f = np.pad(flat_id, 1, constant_values=-1)
        nb = pad_f[1 + dj:1 + dj + R, 1 + di:1 + di + c_ext]
        nb_flat[(di, dj)] = np.repeat(np.repeat(nb, sp, 0), sp, 1)

    px_y = np.broadcast_to(
        np.arange(h, dtype=np.float32)[:, None], (h, w_ext))
    px_x = np.broadcast_to(xglob.astype(np.float32)[None, :], (h, w_ext))
    center_y = np.broadcast_to(
        (np.arange(R, dtype=np.float32) * sp + sp // 2)[:, None],
        (R, c_ext))
    center_x = np.broadcast_to(
        (cglob * sp + sp // 2).astype(np.float32)[None, :], (R, c_ext))

    return dict(
        pixel_valid=pixel_valid, seed_valid=seed_valid, flat_id=flat_id,
        interior=interior, in_image=in_image, win_y=win_y, win_x=win_x,
        in_range=in_range, nb_flat=nb_flat,
        px_y=px_y, px_x=px_x, center_y=center_y, center_x=center_x,
        own=own, c_round=c_round, grid_cols=C, halo=halo,
    )


_PIXEL_PLANES = ("pixel_valid", "px_y", "px_x")
_SEED_PLANES = ("seed_valid", "flat_id", "interior", "in_image", "win_y",
                "win_x", "center_y", "center_x")


@functools.lru_cache(maxsize=64)
def slab_geometry(config: SurfelMapConfig, n_slabs: int, shard: int,
                  device: torch.device) -> dict:
    """Shard `shard`'s slice of the extended geometry, as tensors on
    `device` (uploaded once per shard and device, so the per-frame path
    copies nothing to the device)."""
    ext = _extended_geometry(config, n_slabs)
    sp, own, halo = config.sp_size, ext["own"], ext["halo"]
    slab_c = own + 2 * halo

    def sl(a, unit, dtype=None):
        a = a[:, shard * own * unit:(shard * own + slab_c) * unit]
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t if dtype is None else t.to(dtype)).to(device)

    g = {k: sl(ext[k], sp) for k in _PIXEL_PLANES}
    g.update({k: sl(ext[k], 1) for k in _SEED_PLANES})
    # the plain functions take f32 window coordinates
    g["win_y"] = g["win_y"].float()
    g["win_x"] = g["win_x"].float()
    g["in_range"] = {k: sl(v, sp) for k, v in ext["in_range"].items()}
    g["nb_flat"] = {k: sl(v, sp) for k, v in ext["nb_flat"].items()}
    g["grid_cols"] = ext["grid_cols"]
    g["col0"] = shard * own - halo
    return g


def _columns(state: SuperpixelState, lo: int, hi: int) -> SuperpixelState:
    return SuperpixelState(**{f.name: getattr(state, f.name)[:, lo:hi]
                              for f in dataclasses.fields(state)})


def slab_segmentation(config: SurfelMapConfig, n_slabs: int,
                      image: torch.Tensor, depth: torch.Tensor,
                      devices=None):
    """Column-slab segmentation of one padded frame over n_slabs shards
    (`devices[s]` runs slab s; default: the image's device for all).
    Every shard segments its slab; the owned columns are then gathered
    into the full-frame (seeds, assignment) each shard needs.  Returns one
    (seeds, assignment) per shard, on its device.  Both passes run on the
    shards' streams (`sharding.cells`) inside a mesh program over the
    devices: the mesh steps' `_slab_segmentation` for one stream."""
    devices = devices or [image.device] * n_slabs
    with sharding.mesh_program([image.device] + list(devices)):
        out = _slab_segmentation(config, n_slabs, image[None], depth[None],
                                 devices)
    return [(SuperpixelState(**{k: v[0] for k, v in seeds.items()}),
             assignment[0]) for seeds, assignment in out]


def _slab_segmentation(config, n_slabs, image, depth, devices):
    """The column-slab segmentation of a data row's streams: image and
    depth (B_r, H, W) on the row's first cell; on each cell, one
    torch.func.vmap over the streams segments its slab (the JAX
    per_stream's vmap of `slab_segmentation`), then one gathers the owned
    columns.  Returns per cell (seed fields, assignment), batched."""
    ext = _extended_geometry(config, n_slabs)
    sp, own, halo = config.sp_size, ext["own"], ext["halo"]
    C = config.sp_cols

    pad = (halo * sp, (ext["c_round"] - C) * sp + halo * sp)
    img_e, dep_e = F.pad(image, pad), F.pad(depth, pad)
    slab_w = (own + 2 * halo) * sp
    owned = []
    for s in sharding.cells(devices):
        dev = devices[s]
        x0 = s * own * sp
        img_s = sharding._to(img_e[..., x0:x0 + slab_w], dev).contiguous()
        dep_s = sharding._to(dep_e[..., x0:x0 + slab_w], dev).contiguous()
        g = slab_geometry(config, n_slabs, s, dev)

        def segment(img, dep, g=g):
            seeds, assignment = superpixel.run_slic(config, img, dep,
                                                    use_kernels=False, geom=g)
            seeds = normals.compute_seed_planes(config, seeds, assignment,
                                                dep, geom=g)
            return (sharding._fields(_columns(seeds, halo, halo + own)),
                    assignment[:, halo * sp:(halo + own) * sp])
        owned.append(torch.func.vmap(segment)(img_s, dep_s))

    # the gather: every shard concatenates all shards' owned columns, then
    # crops the divisibility padding back to the config's grid
    def gather(parts):
        seeds = {k: torch.cat([p[0][k] for p in parts], dim=1)[:, :C]
                 for k in parts[0][0]}
        assignment = torch.cat([p[1] for p in parts],
                               dim=1)[:, :config.padded_width]
        return seeds, assignment

    return [torch.func.vmap(gather)([
        ({k: sharding._to(v, devices[s]) for k, v in seeds.items()},
         sharding._to(assignment, devices[s])) for seeds, assignment in owned])
        for s in sharding.cells(devices)]


def sharded_fuse_frame_framestage(config: SurfelMapConfig,
                                  mesh: sharding.Mesh):
    """`sharding.sharded_fuse_frame` with the frame stage column-sharded
    instead of replicated: the same call and the same outputs, with each
    shard segmenting (own + 2 HALO_SP) / sp_cols of the frame.

    Call: (banks, frames) -> (banks, stats), frames from
    `sharding.shard_frames`."""
    n = mesh.shape["surfel"]

    def step(banks: sharding.ShardedBanks, frames):
        with sharding.mesh_program(banks.devices()):
            return banks, sharding._stack_rows(banks, [
                sharding._fuse_row(
                    config, row, sharding._frame_front,
                    sharding._frame_inputs(frames[r]),
                    segmented=_slab_segmentation(
                        config, n, frames[r][0].image, frames[r][0].depth,
                        [b.device for b in row]))
                for r, row in enumerate(banks.rows)])
    return step


def sharded_fuse_frame_framestage_windowed_packed(config: SurfelMapConfig,
                                                 mesh: sharding.Mesh):
    """`sharding.sharded_fuse_frame_windowed_packed` with the frame stage
    column-sharded: the same call and the same outputs.
    `ShardedDeviceResidentMapping(frame_sharded=True)` selects it.

    Call: (banks, bufs (B, 3HW) u8, poses (B,4,4) f32, refs (B,) i32,
    masks (B, max_keyframes) bool) -> (banks, stats)."""
    from ..pipeline.fuse_step import ingest_frame
    n = mesh.shape["surfel"]
    front = sharding._packed_front(config)

    def step(banks: sharding.ShardedBanks, bufs, poses, refs, masks):
        with sharding.mesh_program(banks.devices()):
            per_row = []
            for row, (lo, hi) in zip(banks.rows, banks.spans()):
                inputs = sharding._packed_inputs(config, row, bufs[lo:hi],
                                                 poses[lo:hi], refs[lo:hi])
                # the row's frames on its first cell, for the slabs
                planes = ingest_frame(config, *inputs[0][:2])
                per_row.append(sharding._fuse_row(
                    config, row, front, inputs,
                    masks=sharding._replicate(masks[lo:hi], row),
                    segmented=_slab_segmentation(
                        config, n, *planes, [b.device for b in row])))
            return banks, sharding._stack_rows(banks, per_row)
    return step


def _slab_geometries(config: SurfelMapConfig, mesh: sharding.Mesh):
    """Every shard's slab geometry (`slab_geometry`, an lru_cache of device
    tensors that may evict them) and the full-frame planes the fuse tail
    reads (`sharding.step_geometry`): what a graph of the column-sharded
    step reads and keeps alive."""
    n = mesh.shape["surfel"]
    return [slab_geometry(config, n, s, dev) for row in mesh.grid
            for s, dev in enumerate(row)] + sharding.step_geometry(config,
                                                                   mesh)


def graphed_fuse_frame_framestage(config: SurfelMapConfig,
                                  mesh: sharding.Mesh,
                                  banks: sharding.ShardedBanks, pool=None):
    """`sharded_fuse_frame_framestage` as a graph (the JAX package's
    densesurfelmapping_tpu/parallel/frame_sharding.py:232-262): the input
    and outputs of `sharding.graphed_fuse_frame`."""
    fuse = sharded_fuse_frame_framestage(config, mesh)

    def step(b: sharding.ShardedBanks, payload: torch.Tensor) -> dict:
        with sharding.mesh_program(b.devices()):
            frames, _ = sharding.unpack_padded(config, payload)
            return fuse(b, sharding.shard_frames(mesh, frames))[1]

    return sharding.mesh_step_graph(
        mesh, banks, step, sharding.padded_payload_bytes(config, mask=False),
        pool, _slab_geometries(config, mesh))


def graphed_fuse_frame_framestage_windowed_packed(
        config: SurfelMapConfig, mesh: sharding.Mesh,
        banks: sharding.ShardedBanks, pool=None):
    """`sharded_fuse_frame_framestage_windowed_packed` as a graph (:265-304):
    the one-buffer payload of `sharding.graphed_fuse_frame_windowed_packed`.
    `ShardedDeviceResidentMapping(frame_sharded=True)`'s depth-fed step."""
    from ..pipeline.fuse_step import onebuf_bytes
    from .multistream import unpack_payload
    fuse = sharded_fuse_frame_framestage_windowed_packed(config, mesh)
    hw3 = 3 * config.height * config.width

    def step(b: sharding.ShardedBanks, payload: torch.Tensor) -> dict:
        bufs, poses, refs, _, masks = unpack_payload(payload, hw3)
        return fuse(b, bufs, poses, refs, masks)[1]

    return sharding.mesh_step_graph(mesh, banks, step, onebuf_bytes(config),
                                pool, _slab_geometries(config, mesh))
