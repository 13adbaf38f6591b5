"""ShardedSurfelMapping: the host-pool mapping driver over a device mesh.

Counterpart of the JAX package's `pipeline/sharded_driver.py`.  The same
host orchestration as `SurfelMapping` (pose graph, sync buffers, inactive
pool, export, checkpoint), with the active bank split in row slabs over the
mesh's "surfel" axis: the fuse step, compaction, migration extract,
re-activation appends and loop-closure warps run on every shard
(`parallel/sharding.py`).  One host process drives the whole mesh.

What it is for: maps whose active window outgrows one card's memory
(capacity scales with the mesh); on one card the shards are virtual and
the mesh only repeats the work.
"""

from __future__ import annotations

import numpy as np

from ..config import SurfelMapConfig
from ..core.state import FIELDS, FrameInput, bank_from_numpy, pad_frame
from ..parallel import sharding
from .driver import SurfelMapping, _StereoPair


def scatter_rows_to_sharded(config: SurfelMapConfig, mesh,
                            rows: dict) -> sharding.ShardedBanks:
    """Host rows -> one stream's sharded banks: row i goes to shard
    i % n_shards, in order (the load side of a checkpoint)."""
    n_shards = mesh.shape["surfel"]
    per = -(-config.surfel_capacity // n_shards)
    n = len(rows["color"])
    owner = np.arange(n) % n_shards
    row = []
    for s in range(n_shards):
        part = {k: np.asarray(rows[k])[owner == s] for k in FIELDS}
        c = len(part["color"])
        if c > per:
            raise ValueError("checkpoint exceeds per-shard capacity")
        row.append(bank_from_numpy(part, c, mesh.device(0, s), per))
    return sharding.ShardedBanks([row])


def gather_sharded_bank(banks: sharding.ShardedBanks, n_shards: int,
                        stream: int = 0) -> dict:
    """Host dict of a sharded bank's live per-shard prefixes, concatenated
    in shard order (`sharding.live_rows`)."""
    assert banks.n_shards == n_shards, (banks.n_shards, n_shards)
    counts = banks.counts()[stream]
    return {k: sharding.live_rows(banks.host(k)[stream], counts)
            for k in FIELDS}


class ShardedSurfelMapping(SurfelMapping):
    """Single-session mapping with the bank sharded over the mesh's
    "surfel" axis (the mesh must have one data row)."""

    def __init__(self, config: SurfelMapConfig, mesh,
                 kitti_alignment: bool = False):
        if mesh.shape["data"] != 1:
            raise ValueError("one session per data row")
        self.mesh = mesh
        self.n_shards = mesh.shape["surfel"]
        super().__init__(config, kitti_alignment, device=mesh.device(0, 0))
        self.bank = sharding.replicate_banks(mesh, config, n_streams=1)
        self._sfuse = sharding.sharded_fuse_frame(config, mesh)
        self._scompact = sharding.sharded_compact(config, mesh)
        # ceil: a full migration_buffer slab distributed round-robin puts
        # up to ceil(buf / n_shards) rows on shard 0
        self._per_chunk = max(-(-config.migration_buffer // self.n_shards),
                              1)
        self._sextract = sharding.sharded_extract_by_pose(
            config, mesh, self._per_chunk)
        self._sappend = sharding.sharded_append(config, mesh,
                                                self._per_chunk)
        self._swarp = sharding.sharded_warp_active(config, mesh)

    # the mesh programs stay eager: no captured graph
    def _build_graphs(self) -> None:
        pass

    def _build_stereo_graph(self) -> None:
        pass

    def _fuse_frame(self, image, depth, pose, ref_index: int) -> None:
        pose_dev = self._to_device(np.asarray(pose, np.float32)[None])
        refs = self._to_device(np.full(1, ref_index, np.int32))
        if isinstance(depth, _StereoPair):
            step = sharding.sharded_fuse_frame_stereo(
                self.config, self._stereo_cfg, self._stereo_filter,
                self.mesh)
            _, stats = step(self.bank, self._to_device(depth.buf[None]),
                            pose_dev, refs, self._to_device(
                                np.full(1, self._stereo_bf, np.float32)))
        else:
            pi, pd = pad_frame(self.config, np.asarray(image, np.float32),
                               np.asarray(depth, np.float32))
            frames = FrameInput(image=self._to_device(pi[None]),
                                depth=self._to_device(pd[None]),
                                pose=pose_dev, frame_index=refs)
            _, stats = self._sfuse(self.bank,
                                   sharding.shard_frames(self.mesh, frames))
        self._fuse_epilogue(stats)

    # ------------------------------------------------------------------
    # device-bank seams
    # ------------------------------------------------------------------
    def _bank_count(self) -> int:
        return int(self.bank.counts().sum())

    def _bank_capacity(self) -> int:
        # conservative: shards fill evenly (round-robin new-surfel
        # ownership); the callers' headroom margins already overshoot
        return self.n_shards * self.bank.rows_per_shard

    def _do_compact(self) -> None:
        self._scompact(self.bank)
        self.compactions += 1

    def _extract_chunk(self, ids: np.ndarray):
        _, bufs, ns = self._sextract(self.bank, self._to_device(ids))
        ns = ns[0].cpu().numpy()                     # (n_shards,)
        n = int(ns.sum())
        if n == 0:
            return {}, 0
        host = {}
        for k, v in bufs.items():
            arr = v[0].cpu().numpy().reshape(
                (self.n_shards, self._per_chunk) + tuple(v.shape[2:]))
            host[k] = np.concatenate(
                [arr[s, :ns[s]] for s in range(self.n_shards)])
        # the caller's loop contract: n == migration_buffer means "maybe
        # more"
        if (ns == self._per_chunk).any():
            return host, self.config.migration_buffer
        return host, min(n, self.config.migration_buffer - 1)

    def _append_hostslab(self, padded: dict, n: int) -> None:
        fields = {}
        ns = np.zeros((1, self.n_shards), np.int32)
        owner = np.arange(n) % self.n_shards
        for k in FIELDS:
            rows = padded[k][:n]
            out = np.zeros((1, self.n_shards, self._per_chunk)
                           + rows.shape[1:], rows.dtype)
            for s in range(self.n_shards):
                part = rows[owner == s]
                out[0, s, :len(part)] = part
                ns[0, s] = len(part)
            fields[k] = self._to_device(out.reshape(
                (1, self.n_shards * self._per_chunk) + rows.shape[1:]))
        self._sappend(self.bank, fields, self._to_device(ns))

    def _apply_active_warp(self, warp: np.ndarray) -> None:
        self._swarp(self.bank,
                    self._to_device(np.asarray(warp, np.float32)[None]))

    def _bank_host(self) -> dict:
        return gather_sharded_bank(self.bank, self.n_shards)

    def _load_bank(self, z) -> None:
        n = int(z["bank_count"])
        self.bank = scatter_rows_to_sharded(
            self.config, self.mesh, {k: z[f"bank_{k}"][:n] for k in FIELDS})

    def memory_usage_kb(self) -> float:
        return (self.bank.nbytes() + self.pool.memory_bytes()) / 1024.0
