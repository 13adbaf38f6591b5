"""Stage timing with the reference's checkpoint names, on the profiler's
clock when a profiler records.

Mirrors the `Timer` printf stopwatch (`surfel_fusion/src/timer.h:9-41`) and
the chrono spans sprinkled through `fuse_initialize_map` / `synchronize_msgs`
so per-stage numbers stay comparable with the C++ baseline.  Accumulates
stats instead of printing.

Three kinds of record, all cheap while no profiler records:

* host stages (`StageTimer.stage`): `perf_counter` totals always;
  while a `torch.profiler` records on the stage's thread, also a
  `dsm.<stage>` annotation in the profiler's trace; from any thread, the
  stage's seconds in the open *window*;
* device stamps (`phase`, `replay_stamps`): one tiny kernel
  (`csrc/stamp.cu::dsm_stamp_kernel`) writes (tag, %globaltimer) into a
  ring on the card at the start of each phase of a step and at the start
  and end of every replay of a captured program.  Captured into the CUDA
  graphs, so each replay writes its stamps; on the CPU nothing;
* window counters: frames fused, captures by kind, and the device backlog
  (frames enqueued and not finished, by one event a step replay).

The window opens at the first program call that finds a profiler
recording and closes at the first call of the same thread that finds none
(or over a `window()` block, profiler or not); `last_window()` reads the
ring once, when asked, and gives per-frame host ms by stage, device ms by
phase and between replays, the mean backlog and the frame count.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "dsm."               # the profiler annotations' names
RING_ENTRIES = 1 << 16        # (tag, ns) slots of the ring on the card

_enabled = torch.autograd._profiler_enabled


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        traced = _recording()
        w = _open
        t0 = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function(PREFIX + name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt
            if w is not None:
                w.add(name, dt)

    def means_ms(self) -> Dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f} ms"
                          for k, v in sorted(self.means_ms().items()))


# ----------------------------------------------------------------------
# device stamps
# ----------------------------------------------------------------------
# a stamp's tag names its kind and name: "end" (a replay's end, tag 0),
# "start" (a replay's start, named by its program) or "phase"
_keys: List[Tuple[str, str]] = [("end", "end")]
_tags: Dict[Tuple[str, str], int] = {("end", "end"): 0}


def _tag(kind: str, name: str) -> int:
    key = (kind, name)
    if key not in _tags:
        _tags[key] = len(_keys)
        _keys.append(key)
    return _tags[key]


class _Ring:
    """RING_ENTRIES (tag, ns) i64 pairs and a u64 cursor on one card."""

    def __init__(self, device: torch.device):
        from ..ops.cuda import build
        self.lib = build.load("stamp", {"dsm_stamp": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]})
        self.device = device
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        self.entries = torch.zeros(RING_ENTRIES, 2, dtype=torch.int64,
                                   device=device)


_ring: Optional[_Ring] = None
_held = threading.local()            # `unstamped` blocks of this thread


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _stamp(kind: str, name: str, device) -> None:
    """One stamp on the current stream of `device`, a card; none on
    another card than the ring's (one ring, on the first card stamped),
    nor before the ring exists while a graph is being captured."""
    global _ring
    if getattr(_held, "on", False):
        return
    device = _card(device)
    if _ring is None:
        if torch.cuda.is_current_stream_capturing():
            return
        _ring = _Ring(device)
    if _ring.device != device:
        return
    err = _ring.lib.dsm_stamp(
        _ring.cursor.data_ptr(), _ring.entries.data_ptr(), RING_ENTRIES,
        _tag(kind, name), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dsm_stamp launch failed with CUDA error {err}")


@contextlib.contextmanager
def unstamped():
    """No stamps from this thread inside the block: the mesh programs,
    whose cells run on several streams and cards, keep their phases'
    annotations alone."""
    prev = getattr(_held, "on", False)
    _held.on = True
    try:
        yield
    finally:
        _held.on = prev


@contextlib.contextmanager
def phase(name: str, device):
    """A phase of a step on `device`: a stamp at its start on a card (the
    phase lasts to the next stamp), and in an eager run under a profiler a
    `dsm.<name>` annotation over the block.  On the CPU: nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    _stamp("phase", name, device)
    if _enabled():
        with torch.profiler.record_function(PREFIX + name):
            yield
    else:
        yield


@contextlib.contextmanager
def replay_stamps(name: str, device):
    """The start and end stamps of a captured program named `name` around
    its body (captured with it, so written by every replay)."""
    if torch.device(device).type != "cuda":
        yield
        return
    _stamp("start", name, device)
    yield
    _stamp("end", "end", device)


def ring_entries(ring: np.ndarray, c0: int, c1: int) -> np.ndarray:
    """The (tag, ns) entries written while the cursor went from c0 to c1,
    in order, from a (N, 2) ring: slot i % N holds stamp i.  Only the
    newest N survive a window of more than N stamps."""
    n = len(ring)
    c0 = max(c0, c1 - n)
    return ring[np.arange(c0, c1) % n]


def phase_times(entries, keys) -> dict:
    """Device ns by phase, by bank program and between replays from
    consecutive (tag, ns) stamps (`keys[tag]` = (kind, name)).  Each stamp
    opens a segment that ends at the next: after an end stamp it is
    between replays; after a phase stamp it is that phase's; after a start
    stamp it is the next stamp's phase (the start opens a step's first
    phase) or, when a start is followed by no phase, its program's.  The
    segments sum to the span from the first stamp to the last."""
    phases = collections.defaultdict(int)
    programs = collections.defaultdict(int)
    between = 0
    rows = [(int(t), int(ns)) for t, ns in entries]
    for (ta, sa), (tb, sb) in zip(rows, rows[1:]):
        (ka, na), (kb, nb) = keys[ta], keys[tb]
        dt = sb - sa
        if ka == "end":
            between += dt
        elif ka == "phase":
            phases[na] += dt
        elif kb == "phase":
            phases[nb] += dt
        else:
            programs[na] += dt
    span_ns = rows[-1][1] - rows[0][1] if rows else 0
    return dict(phases=dict(phases), programs=dict(programs),
                between=between, span=span_ns)


# ----------------------------------------------------------------------
# the window
# ----------------------------------------------------------------------
class _Window:
    """Host seconds by stage, frames, captures by kind, the device backlog
    and the ring's cursor at open and close.  Any thread adds to it, under
    the lock; only its owner closes it."""

    def __init__(self, owner: Optional[int]):
        self.owner = owner           # the opening thread; None: `window()`
        self.host: Dict[str, float] = collections.defaultdict(float)
        self.frames = 0
        self.device_frames = 0
        self.backlog = 0
        self.pending = collections.deque()   # events of unfinished steps
        self.captures: Dict[str, int] = collections.defaultdict(int)
        self.ring = _ring            # a ring made inside the window: unread
        self.cursor = None           # pinned copies: the cursor at open, close
        if self.ring is not None:
            self.cursor = torch.zeros(2, dtype=torch.int64).pin_memory()
            self._read_cursor(0)
        self.summary = None

    def add(self, name: str, dt: float) -> None:
        with _lock:
            if self is _open:
                self.host[name] += dt

    def _read_cursor(self, i: int) -> None:
        """Copy the ring's cursor into slot i without blocking, ordered
        after the work enqueued on the card's current stream so far."""
        with torch.cuda.device(self.ring.device):
            self.cursor[i:i + 1].copy_(self.ring.cursor, non_blocking=True)

    def close(self) -> None:
        if self.ring is not None:
            self._read_cursor(1)
        self.pending.clear()

    def read(self) -> dict:
        n = self.frames
        out = dict(frames=n, captures=dict(self.captures),
                   host_ms={k: 1e3 * v / n for k, v in self.host.items()},
                   backlog_frames=(self.backlog / self.device_frames
                                   if self.device_frames else None),
                   device_ms={}, programs_ms={}, between_replays_ms=None,
                   span_ms=None, stamps=0)
        if self.ring is None:
            return out
        torch.cuda.synchronize(self.ring.device)
        c0, c1 = self.cursor.tolist()
        entries = ring_entries(self.ring.entries.cpu().numpy(), c0, c1)
        t = phase_times(entries, _keys)
        out.update(device_ms={k: 1e-6 * v / n
                              for k, v in t["phases"].items()},
                   programs_ms={k: 1e-6 * v / n
                                for k, v in t["programs"].items()},
                   between_replays_ms=1e-6 * t["between"] / n,
                   span_ms=1e-6 * t["span"] / n, stamps=len(entries),
                   stamps_lost=max(0, c1 - c0 - len(entries)))
        return out


_lock = threading.Lock()
_open: Optional[_Window] = None
_last: Optional[_Window] = None


def _begin(owner: Optional[int]) -> _Window:
    """A new window owned by thread `owner`.  An open one is kept where a
    profiler opens (another thread's profiler raced this one's), and
    closed first where `window()` does (`owner` None)."""
    global _open
    with _lock:
        if _open is not None:
            if owner is not None:
                return _open
            _end_locked(_open)
        _open = _Window(owner)
        return _open


def _end(w: _Window) -> None:
    with _lock:
        _end_locked(w)


def _end_locked(w: _Window) -> None:
    global _open, _last
    if w is _open:
        w.close()
        _last, _open = w, None


def _recording() -> bool:
    """Whether a profiler records on this thread (the profiler's state is
    the thread's own).  The first call that finds one recording, with no
    window open, opens one owned by its thread; the owner's first call
    that finds none closes it.  Other threads only add to it."""
    on = _enabled()
    w = _open
    if on and w is None:
        _begin(threading.get_ident())
    elif not on and w is not None and w.owner == threading.get_ident():
        _end(w)
    return on


@contextlib.contextmanager
def window():
    """A window over the block whether or not a profiler records (one that
    is open is closed first): the host stages of every thread, with no
    annotation where none records, the frames, the backlog and the stamps;
    `last_window()` reads it after the block.  An untraced stretch read so
    is free of the profiler's own cost (a graph launch under CUPTI costs
    several times its untraced host time)."""
    w = _begin(None)
    try:
        yield
    finally:
        _end(w)


def count_capture(kind: str) -> None:
    """A graph captured (`kind`: its `fuse_step.CAPTURES` entry): one more
    in the open window's count."""
    with _lock:
        if _open is not None:
            _open.captures[kind] += 1


def count_frame(device) -> None:
    """After a step's replay: while the window is open, one frame more, and
    on a card the frames enqueued before it and not yet finished (one
    event, timing off, recorded after each replay; the finished ones
    leave the front of the queue at the next)."""
    if _open is None:
        return
    with _lock:
        w = _open
        if w is None:
            return
        w.frames += 1
        if torch.device(device).type != "cuda":
            return
        q = w.pending
        while q and q[0].query():
            q.popleft()
        w.backlog += len(q)
        w.device_frames += 1
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        q.append(ev)


def last_window() -> Optional[dict]:
    """The last window's readings (None if no window held a frame): per
    fused frame, `host_ms` by stage, `device_ms` by phase, `programs_ms`
    by bank program, `between_replays_ms`, `span_ms` (first stamp to last);
    `backlog_frames` (mean frames enqueued, not finished, at a step's
    launch), `frames`, `captures` by kind and the count of `stamps`.  A
    window this thread's profiler opened is closed first, if it no longer
    records.  Reads the ring once, after a synchronize."""
    if _open is not None:
        _recording()
    w = _last
    if w is None or w.frames == 0:
        return None
    if w.summary is None:
        w.summary = w.read()
    return w.summary


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
