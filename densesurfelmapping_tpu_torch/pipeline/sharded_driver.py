"""ShardedSurfelMapping: the host-pool mapping driver over a device mesh.

Counterpart of the JAX package's `pipeline/sharded_driver.py`.  The same
host orchestration as `SurfelMapping` (pose graph, sync buffers, inactive
pool, export, checkpoint), with the active bank split in row slabs over the
mesh's "surfel" axis: the fuse step, compaction, migration extract,
re-activation appends and loop-closure warps run on every shard
(`parallel/sharding.py`), each replayed from a captured graph over the
mesh's cards.  One host process drives the whole mesh.

What it is for: maps whose active window outgrows one card's memory
(capacity scales with the mesh); on one card the shards are virtual and
the mesh only repeats the work.
"""

from __future__ import annotations

import numpy as np

from ..config import SurfelMapConfig
from ..core.state import FIELDS, bank_from_numpy
from ..parallel import sharding
from .driver import SurfelMapping


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
    "surfel" axis (the mesh must have one data row).

    Its programs are the mesh programs of `parallel/sharding.py` as
    graphs (`sharding.graphed_*`, where the JAX driver dispatches its
    `jax.jit(jax.shard_map(...))` programs): the fuse step of the padded
    upload (the planes and the 72-byte aux head in one pinned copy per
    frame; there is no compact mesh step) and the stereo step in one
    memory pool, compaction, the migration extract and append and the
    active warp in another (one MemPool per card each), each captured at
    its first use and rebuilt where the dense driver rebuilds its graphs.
    The host reads each card's counts only in `_bank_count` and
    `_extract_chunk` (and the readouts)."""

    def __init__(self, config: SurfelMapConfig, mesh,
                 kitti_alignment: bool = False):
        if mesh.shape["data"] != 1:
            raise ValueError("one session per data row")
        self.mesh = mesh
        self.n_shards = mesh.shape["surfel"]
        # ceil: a full migration_buffer slab distributed round-robin puts
        # up to ceil(buf / n_shards) rows on shard 0
        self._per_chunk = max(-(-config.migration_buffer // self.n_shards),
                              1)
        super().__init__(config, kitti_alignment, device=mesh.device(0, 0))

    def _empty_bank(self) -> sharding.ShardedBanks:
        return sharding.replicate_banks(self.mesh, self.config, n_streams=1)

    def _compact_upload(self) -> bool:
        return False

    def _build_graphs(self) -> None:
        """The mesh programs against the current banks (the JAX driver's
        jits of `sharded_fuse_frame`, `sharded_compact`,
        `sharded_extract_by_pose`, `sharded_append` and
        `sharded_warp_active`)."""
        cfg, mesh, banks, pool = (self.config, self.mesh, self.bank,
                                  self._bank_pool)
        self._fuse_graph = sharding.graphed_fuse_frame(cfg, mesh, banks,
                                                       self._graph_pool)
        self._compact_graph = sharding.graphed_compact(cfg, mesh, banks, pool)
        self._extract_graph = sharding.graphed_extract_by_pose(
            cfg, mesh, banks, self._per_chunk, pool)
        self._append_graph = sharding.graphed_append(cfg, mesh, banks,
                                                     self._per_chunk, pool)
        self._warp_graph = sharding.graphed_warp_active(cfg, mesh, banks,
                                                        pool)
        self._stereo_graph = None
        if self._stereo_cfg is not None:
            self._build_stereo_graph()

    def _build_stereo_graph(self) -> None:
        """`sharded_fuse_frame_stereo` as a graph, built once per
        `enable_stereo` (and with the others)."""
        self._stereo_graph = sharding.graphed_fuse_frame_stereo(
            self.config, self._stereo_cfg, self._stereo_filter, self.mesh,
            self.bank, self._graph_pool)

    # ------------------------------------------------------------------
    # device-bank seams
    # ------------------------------------------------------------------
    def _bank_count(self) -> int:
        return int(self.bank.counts().sum())

    def _bank_capacity(self) -> int:
        # conservative: shards fill evenly (round-robin new-surfel
        # ownership); the callers' headroom margins already overshoot
        return self.n_shards * self.bank.rows_per_shard

    def _extract_chunk(self, ids: np.ndarray):
        """One removed-pose extraction pass over every shard; the graph's
        static outputs are copied to the host before the next replay."""
        bufs, ns = self._extract_graph(ids)
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
        """Distribute the first n rows of the slab round-robin over the
        shards and append each shard's part at its tail."""
        fields = []
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
            fields.append(out.reshape(
                (1, self.n_shards * self._per_chunk) + rows.shape[1:]))
        self._append_graph(*fields, ns)

    def _bank_host(self) -> dict:
        return gather_sharded_bank(self.bank, self.n_shards)

    def _load_bank(self, z) -> None:
        n = int(z["bank_count"])
        self.bank = scatter_rows_to_sharded(
            self.config, self.mesh, {k: z[f"bank_{k}"][:n] for k in FIELDS})

    def memory_usage_kb(self) -> float:
        return (self.bank.nbytes() + self.pool.memory_bytes()) / 1024.0
