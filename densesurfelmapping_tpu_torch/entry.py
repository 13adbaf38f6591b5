"""Multi-device dry run of the port: the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`.

    python -c "from densesurfelmapping_tpu_torch.entry import \\
        dryrun_multichip; dryrun_multichip(8)"

builds an n-cell mesh over every card (virtual shards where there are
fewer cards than cells: 8 cells on 4 cards are 2 per card), runs the
sharded fuse step on tiny frames, checks it against the single-device
step, then runs the sharded bank lifecycle (migration extract,
compaction, loop warp) and one windowed step.
"""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded step over an n_devices mesh of `device`: "cuda" (the
    default, which raises without a card) is every card of the machine,
    another device (e.g. "cpu", "cuda:1") that device alone; returns the
    totals it checked."""
    from .config import CameraIntrinsics, SurfelMapConfig
    from .core.state import FrameInput, SurfelBank, pad_frame
    from .io import synthetic
    from .ops import migration
    from .parallel import sharding
    from .pipeline.fuse_step import fuse_frame

    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = sharding.make_mesh(n_devices, data=data,
                              devices=None if device == "cuda" else device)
    dev = mesh.device(0, 0)

    cam = CameraIntrinsics(width=64, height=48, fx=60.0, fy=60.0,
                           cx=31.5, cy=23.5)
    cfg = SurfelMapConfig(camera=cam, surfel_capacity=1024, lane_align=8)
    step = sharding.sharded_fuse_frame(cfg, mesh)

    scene = synthetic.default_scene()
    banks = sharding.replicate_banks(mesh, cfg, n_streams=data)
    imgs, deps, poses = [], [], []
    for s in range(data):
        pose = np.eye(4)
        pose[0, 3] = 0.1 * s
        pi, pd = pad_frame(cfg, *scene.render(cfg, pose))
        imgs.append(pi)
        deps.append(pd)
        poses.append(pose.astype(np.float32))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    frames = sharding.shard_frames(mesh, FrameInput(
        image=put(np.stack(imgs)), depth=put(np.stack(deps)),
        pose=put(np.stack(poses)),
        frame_index=put(np.zeros(data, np.int32))))
    banks, stats = step(banks, frames)
    total = int(stats["n_new"].sum())
    if total <= 0:
        raise AssertionError("dry run fused no surfels")

    # sharded == dense: each stream's live rows, as sorted sets
    counts = banks.counts()
    for s in range(data):
        dense = SurfelBank.empty(cfg.surfel_capacity, dev)
        fuse_frame(cfg, dense, FrameInput(
            image=put(imgs[s]), depth=put(deps[s]), pose=put(poses[s]),
            frame_index=torch.zeros((), dtype=torch.int32, device=dev)))
        n = int(dense.count)
        if counts[s].sum() != n:
            raise AssertionError(f"stream {s}: sharded {counts[s]} vs "
                                 f"dense {n}")
        got = np.sort(sharding.live_rows(banks.host("position")[s],
                                         counts[s]), axis=0)
        want = np.sort(dense.position[:n].cpu().numpy(), axis=0)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=(
            f"stream {s}: sharded bank != single-device bank"))

    # the sharded bank lifecycle: extract, compact, loop warp
    ids = np.full(migration.MAX_REMOVE_POSES, -1, np.int32)
    ids[0] = 0
    banks, _, ns = sharding.sharded_extract_by_pose(cfg, mesh, 128)(
        banks, put(ids))
    sharding.sharded_compact(cfg, mesh)(banks)
    sharding.sharded_warp_active(cfg, mesh)(
        banks, put(np.stack([np.eye(4, dtype=np.float32)] * data)))
    total_live = int(banks.counts().sum())
    if total_live + int(ns.sum()) != total:
        raise AssertionError("extract + compact lost rows")

    # the windowed (device-resident lifecycle) step: every keyframe active
    masks = torch.ones((data, cfg.max_keyframes), dtype=torch.bool,
                       device=dev)
    sharding.sharded_fuse_frame_windowed(cfg, mesh)(banks, frames, masks)
    if np.isnan(banks.host("position")).any():
        raise AssertionError("NaN in the sharded bank")
    return dict(mesh=mesh.shape, n_new=total, extracted=int(ns.sum()),
                live=total_live)
