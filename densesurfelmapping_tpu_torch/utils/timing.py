"""Stage timing with the reference's checkpoint names.

Mirrors the `Timer` printf stopwatch (`surfel_fusion/src/timer.h:9-41`) and
the chrono spans sprinkled through `fuse_initialize_map` / `synchronize_msgs`
so per-stage numbers stay comparable with the C++ baseline.  Accumulates
stats instead of printing; device-side spans are `torch.profiler`
record_function scopes in `pipeline/fuse_step.py`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def means_ms(self) -> Dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f} ms"
                          for k, v in sorted(self.means_ms().items()))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler scope over the host and the CUDA device; the Chrome
    trace (`chrome://tracing`, Perfetto) is written into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
