"""The profiler's view of a short sub-window: device busy time, kernel time
by name, the device operations that took most time and the longest idle
gaps by what the host was doing.

It reads the raw kineto records (`prof.profiler.kineto_results.events()`)
and never exports a whole-window Chrome trace: parsing every record into
a FunctionEvent (`prof.events()`) costs seconds a 100k records, and a
frame of the graphed drive runs ~2,300 device operations.  The counted
body starts and ends `EDGE_PAD_S` of host time inside the profiled
window, whose edges the profiler may drop records next to (the arithmetic
of the port's `chip_smoke.device_records` and `kernel_time`).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

EDGE_PAD_S = 0.75
BODY = "bench.body"
HOST_PREFIX = "bench."


@dataclasses.dataclass
class DeviceView:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]    # name -> (runs, seconds)
    device_ops: List[Tuple[str, float]]      # top 10 by seconds
    idle_gaps: List[Tuple[str, float]]       # longest 10, by host span
    n_records: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel(self, part: str) -> Tuple[int, float]:
        """(runs, seconds) summed over the kernels whose name holds
        `part`."""
        runs = sum(n for k, (n, _) in self.kernels.items() if part in k)
        secs = sum(s for k, (_, s) in self.kernels.items() if part in k)
        return runs, secs


class Window:
    """Holds the `DeviceView` of a `profiled()` block once it has ended."""
    view: DeviceView = None


def span(name: str):
    """A host span that the trace reads (a profiler user annotation; a
    no-op outside a profiled window)."""
    import torch
    return torch.profiler.record_function(HOST_PREFIX + name)


@contextlib.contextmanager
def profiled():
    """Profile host and device over the block, which runs its work through
    `run_padded`; yields a Window whose `view` is set when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    w = Window()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield w
    w.view = read(prof)


def run_padded(step, seconds: float) -> int:
    """Call `step()` for `seconds` of host time, the middle `seconds - 2
    EDGE_PAD_S` under the BODY span; returns the steps in the body."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < EDGE_PAD_S:
        step()
    n = 0
    with torch.profiler.record_function(BODY):
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < seconds - 2 * EDGE_PAD_S:
            step()
            n += 1
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    while time.perf_counter() - t2 < EDGE_PAD_S:
        step()
    return n


def read(prof) -> DeviceView:
    from torch.autograd import DeviceType
    dev, host, body = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            name = e.name()
            if name == BODY:
                body.append((e.start_ns(), e.end_ns()))
            elif name.startswith(HOST_PREFIX) or "Launch" in name \
                    or "Memcpy" in name or "Synchronize" in name:
                host.append((e.start_ns(), e.end_ns(), name))
    if not body:
        raise RuntimeError("the trace holds no body span")
    lo, hi = min(b[0] for b in body), max(b[1] for b in body)
    return summarize(dev, host, lo, hi)


def summarize(dev, host, lo: int, hi: int) -> DeviceView:
    """Device records (start_ns, end_ns, name) clipped to [lo, hi]; host
    spans (start_ns, end_ns, name) label the idle gaps."""
    kernels: Dict[str, List[float]] = {}
    for s, e, n in dev:
        if lo <= s and e <= hi:     # whole records only
            k = kernels.setdefault(n, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) * 1e-9
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev
                 if e > lo and s < hi)
    busy, end = 0, lo
    gaps = []
    for s, e, n in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0, e - max(s, end))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for g0, g1 in gaps[:10]:
        labelled.append((_host_at(host, starts, (g0 + g1) // 2),
                         (g1 - g0) * 1e-9))
    ops = sorted(((n, v[1]) for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return DeviceView(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                      kernels={n: (v[0], v[1]) for n, v in kernels.items()},
                      device_ops=ops, idle_gaps=labelled,
                      n_records=len(dev))


def _host_at(host, starts, t: int) -> str:
    """The benchmark spans and the innermost runtime call open at t."""
    i = bisect.bisect_right(starts, t)
    open_ = [h for h in host[max(0, i - 4096):i] if h[1] >= t]
    spans = [n[len(HOST_PREFIX):] for _, _, n in open_
             if n.startswith(HOST_PREFIX)]
    calls = [n for _, _, n in open_ if not n.startswith(HOST_PREFIX)]
    label = "/".join(spans) or "host"
    return label + (f" ({calls[-1]})" if calls else "")
