"""Device-link health probes: `python -m densesurfelmapping_tpu_torch
diagnose`.

Counterpart of the JAX package's `utils/diagnostics.py`, with its keys and
its verdict.  Three probes separate the axes along which a run can be slow:

* dispatch_ms  - chained `x + 1` on a 0-d tensor, fenced by one readback:
                 the cost of one small operation, host enqueue included
* h2d_mbps     - a fresh 16 MB pageable upload fenced by a 4-byte readback
                 (a 2 MB probe first decides whether the 16 MB one is
                 affordable, as the JAX package's does)
* fuse_ms      - the packed fuse step chained over the KITTI scene, fenced
                 once: on the card one replay per frame of the step
                 captured as a CUDA graph (`fuse_step.StepGraph`, as the
                 JAX package dispatches its jitted step), the capture done
                 in the two frames before the clock starts
* block_lies   - whether `torch.cuda.synchronize()` returned well before the
                 work was done, read against the readback's time
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

# The JAX package's healthy envelope (its utils/diagnostics.py:111-114):
# a shared definition of "healthy", not a measurement of the port.
HEALTHY_DISPATCH_MS = 10.0
HEALTHY_H2D_MBPS = 200.0
HEALTHY_FUSE_MS = 20.0


def default_config():
    """The fuse probe's configuration: KITTI size, capacity 2^19."""
    from ..config import kitti_config
    return kitti_config(surfel_capacity=1 << 19)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_dispatch_ms(device, iters: int = 20) -> float:
    """Per-operation cost of a chained tiny op, fenced by a readback."""
    x = torch.zeros((), device=device) + 1.0
    x.item()
    t0 = time.perf_counter()
    for _ in range(iters):
        x = x + 1.0
    x.item()
    return (time.perf_counter() - t0) / iters * 1e3


def probe_h2d_mbps(device, n_bytes: int = 1 << 24,
                   overhead_ms: float = 0.0) -> float:
    """Host-to-device rate of one fresh pageable upload of n_bytes, fenced
    by a 4-byte readback; `overhead_ms` (the dispatch cost) is subtracted
    from the fenced time."""
    buf = np.random.default_rng(0).integers(0, 255, size=n_bytes,
                                             dtype=np.uint8)
    d = torch.from_numpy(buf).to(device)
    d[:4].cpu()
    fresh = torch.from_numpy(buf[::-1].copy())
    t0 = time.perf_counter()
    d = fresh.to(device)
    d[:4].cpu()
    elapsed = time.perf_counter() - t0 - overhead_ms / 1e3
    return n_bytes / max(elapsed, 1e-6) / 1e6


def run_diagnostics(n_fuse: int = 15, device="cuda",
                    config=None) -> Dict[str, float]:
    """The probes on `device` (cuda by default, which raises without a
    card); `config` defaults to `default_config()`.  Returns the JAX
    package's keys: backend, dispatch_ms, h2d_mbps, fuse_ms, block_lies,
    healthy."""
    from ..core.state import SurfelBank, pack_aux, pack_frame_with_aux
    from ..io import synthetic
    from ..pipeline.fuse_step import graphed_fuse_frame_packed
    from .cache import enable_compilation_cache

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("diagnose on cuda: no CUDA device is available")
    enable_compilation_cache()
    out: Dict[str, float] = {"backend": device.type}
    out["dispatch_ms"] = round(probe_dispatch_ms(device), 2)
    quick = probe_h2d_mbps(device, n_bytes=1 << 21,
                           overhead_ms=out["dispatch_ms"])
    out["h2d_mbps"] = round(
        probe_h2d_mbps(device, overhead_ms=out["dispatch_ms"])
        if quick >= HEALTHY_H2D_MBPS else quick, 1)

    # the real fuse step, chained (a fresh upload per frame, as the online
    # driver does), one fence at the end; each frame's buffer carries its
    # pose and frame index behind the packed frame
    cfg = config or default_config()
    scene = synthetic.default_scene()
    poses = synthetic.forward_trajectory(n_fuse + 2, step=0.4)
    bufs = [torch.from_numpy(pack_frame_with_aux(
        cfg, *scene.render(cfg, p), pack_aux(p, i, np.zeros(0, bool))))
        for i, p in enumerate(poses)]
    bank = SurfelBank.empty(cfg.surfel_capacity, device)
    graph = graphed_fuse_frame_packed(cfg, bank)

    def step(i):
        graph(bufs[i].to(device))

    for i in range(2):
        step(i)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(2, n_fuse + 2):
        step(i)
    _sync(device)
    soft = time.perf_counter() - t0
    int(bank.count)
    fenced = time.perf_counter() - t0
    out["fuse_ms"] = round(fenced / n_fuse * 1e3, 2)
    out["block_lies"] = bool(soft < 0.5 * fenced)
    out["healthy"] = bool(out["dispatch_ms"] < HEALTHY_DISPATCH_MS
                          and out["h2d_mbps"] > HEALTHY_H2D_MBPS
                          and out["fuse_ms"] < HEALTHY_FUSE_MS)
    return out
