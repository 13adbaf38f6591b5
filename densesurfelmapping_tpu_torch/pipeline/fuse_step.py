"""The per-frame fuse step over device state (depth-fed entry points).

Counterpart of the JAX package's `pipeline/fuse_step.py`: the whole hot path
(`FusionFunctions::fuse_initialize_map`, `fusion_functions.cpp:30-83`),

    superpixels -> normals/plane fit -> fuse -> new surfels (tail append)

on tensors of one device.  The bank is updated in place (where the JAX
package donates it); the stats dict holds device scalars, read by the host
only when it asks.  Where the JAX drivers dispatch a jitted step, the
port's drivers replay the step captured in a CUDA graph (`StepGraph`); where
they dispatch a jitted bank program (compaction, the migration append and
extract, the loop warps), they replay it captured the same way
(`BankGraph`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import SurfelMapConfig
from ..core.state import AUX_HEAD_BYTES, FIELDS, FrameInput, SurfelBank
from ..ops import fusion, migration, normals, superpixel
from ..ops import warp as warp_ops
from ..utils import timing


def fuse_frame(config: SurfelMapConfig, bank: SurfelBank, frame: FrameInput,
               pose_mask: torch.Tensor | None = None
               ) -> Tuple[SurfelBank, dict]:
    """(bank, frame) -> (bank updated in place, stats).

    pose_mask (optional (max_keyframes,) bool): active-window gating — see
    `fusion.fuse_surfels`.  Its phases (`timing.phase`) follow the
    reference's timing prints (fusion_functions.cpp:55,75,82), the plane
    fit apart: superpixel, planefit, fuse, append."""
    dev = frame.depth.device
    with timing.phase("superpixel", dev):
        seeds, assignment = superpixel.run_slic(config, frame.image,
                                                frame.depth)
    with timing.phase("planefit", dev):
        seeds = normals.compute_seed_planes(config, seeds, assignment,
                                            frame.depth)

    with timing.phase("fuse", dev):
        fused = fusion.fuse_surfels(
            config, bank, seeds, assignment, frame.depth, frame.pose,
            frame.frame_index, pose_mask=pose_mask)

    with timing.phase("append", dev):
        new_fields, new_mask = fusion.extract_new_surfels(
            config, seeds, fused, frame.pose, frame.frame_index)
        stats = fusion.append_new(bank, new_fields, new_mask)
        stats["n_fused_seeds"] = fused.sum(dtype=torch.int32)
    return bank, stats


def ingest_frame(config: SurfelMapConfig, image_u8: torch.Tensor,
                 depth_f16: torch.Tensor):
    """Device-side decode of a compact frame (`core.state.compact_frame`):
    u8 intensity + f16 depth at raw camera resolution -> padded f32 planes."""
    ph, pw = config.padded_height, config.padded_width
    pad = (0, pw - config.width, 0, ph - config.height)
    return (F.pad(image_u8.float(), pad), F.pad(depth_f16.float(), pad))


def fuse_frame_compact(config: SurfelMapConfig, bank: SurfelBank,
                       image_u8: torch.Tensor, depth_f16: torch.Tensor,
                       pose: torch.Tensor, frame_index: torch.Tensor
                       ) -> Tuple[SurfelBank, dict]:
    """fuse_frame over a compact-encoded frame."""
    img, dep = ingest_frame(config, image_u8, depth_f16)
    return fuse_frame(config, bank, FrameInput(
        image=img, depth=dep, pose=pose, frame_index=frame_index))


def _bitcast(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a 1-D u8 slice as `dtype`; a slice whose storage offset is
    not a multiple of the item size is copied first (`.view(dtype)` needs an
    aligned offset)."""
    if seg.storage_offset() % dtype.itemsize:
        seg = seg.clone()
    return seg.view(dtype)


def unpack_frame(config: SurfelMapConfig, buf: torch.Tensor):
    """Decode of `core.state.pack_frame`: (3*H*W,) u8 -> (u8 image,
    f16 depth) at raw camera resolution."""
    oh, ow = config.height, config.width
    hw = oh * ow
    img = buf[:hw].view(oh, ow)
    dep = _bitcast(buf[hw:3 * hw], torch.float16).view(oh, ow)
    return img, dep


def fuse_frame_packed(config: SurfelMapConfig, bank: SurfelBank,
                      buf: torch.Tensor, pose: torch.Tensor,
                      frame_index: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """fuse_frame over a single-buffer packed frame (`core.state.pack_frame`,
    one host-to-device copy)."""
    img, dep = unpack_frame(config, buf)
    return fuse_frame_compact(config, bank, img, dep, pose, frame_index)


def fuse_frame_windowed_packed(config: SurfelMapConfig, bank: SurfelBank,
                               buf: torch.Tensor, pose: torch.Tensor,
                               frame_index: torch.Tensor,
                               pose_mask: torch.Tensor
                               ) -> Tuple[SurfelBank, dict]:
    """Windowed fuse step over a single-buffer packed frame."""
    img, dep = unpack_frame(config, buf)
    return fuse_frame_windowed(config, bank, img, dep, pose, frame_index,
                               pose_mask)


def fuse_frame_windowed(config: SurfelMapConfig, bank: SurfelBank,
                        image_u8: torch.Tensor, depth_f16: torch.Tensor,
                        pose: torch.Tensor, frame_index: torch.Tensor,
                        pose_mask: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """Compact fuse step with device-resident active/inactive gating:
    pose_mask (max_keyframes,) bool marks the drift-free window; rows owned
    by out-of-window keyframes are frozen in place."""
    img, dep = ingest_frame(config, image_u8, depth_f16)
    return fuse_frame(config, bank, FrameInput(
        image=img, depth=dep, pose=pose, frame_index=frame_index),
        pose_mask=pose_mask)


def unpack_aux(aux: torch.Tensor):
    """Decode of `core.state.pack_aux`: (72 + P,) u8 -> (pose (4,4) f32,
    frame_index () i32, bf () f32, window mask (P,) bool)."""
    pose = _bitcast(aux[:64], torch.float32).view(4, 4)
    ref = _bitcast(aux[64:68], torch.int32)[0]
    bf = _bitcast(aux[68:72], torch.float32)[0]
    return pose, ref, bf, aux[AUX_HEAD_BYTES:].bool()


def fuse_frame_windowed_aux(config: SurfelMapConfig, bank: SurfelBank,
                            buf: torch.Tensor, aux: torch.Tensor
                            ) -> Tuple[SurfelBank, dict]:
    """Windowed packed fuse step whose small per-frame arguments arrive in
    one aux buffer."""
    pose, ref, _, mask = unpack_aux(aux)
    img, dep = unpack_frame(config, buf)
    return fuse_frame_windowed(config, bank, img, dep, pose, ref, mask)


def fuse_frame_onebuf(config: SurfelMapConfig, bank: SurfelBank,
                      buf: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """Windowed fuse step whose ENTIRE per-frame payload (packed frame +
    aux, `core.state.pack_frame_with_aux`) arrives as one buffer: a single
    host-to-device copy per frame."""
    hw3 = 3 * config.height * config.width
    return fuse_frame_windowed_aux(config, bank, buf[:hw3], buf[hw3:])


# ----------------------------------------------------------------------
# stereo-resident entry points: depth computed on the device from a packed
# u8 left/right pair (the reference's offline PSMNet depth source,
# `kitti_publisher/scripts/publisher.py:36-41`, replaced by the matcher)
# ----------------------------------------------------------------------
def unpack_stereo(config: SurfelMapConfig, buf: torch.Tensor):
    """Decode of `core.state.pack_stereo_pair`: (2*H*W,) u8 -> (left f32,
    right f32) at raw camera resolution."""
    oh, ow = config.height, config.width
    hw = oh * ow
    return (buf[:hw].view(oh, ow).float(),
            buf[hw:2 * hw].view(oh, ow).float())


def compute_depth_stereo(config: SurfelMapConfig, stereo_config,
                         left_f32: torch.Tensor, right_f32: torch.Tensor,
                         bf: torch.Tensor, filter_depth: bool = True,
                         prior_depth: torch.Tensor | None = None):
    """Disparity -> metric depth (`depth = bf / disparity`, publisher.py:40)
    -> optional flyer/median post-filter; returns (depth, rescued-pixel
    count).  bf = fx * baseline is a 0-d tensor.  prior_depth (optional
    (H, W) map render, `ops/render.py`) feeds the matcher's rescue gate,
    converted to disparity with the same bf."""
    from ..models import stereo as stereo_model
    from ..ops import depthfilter

    prior_disp = None
    if prior_depth is not None:
        prior_disp = torch.where(prior_depth > 0,
                                 bf / prior_depth.clamp_min(1e-6), 0.0)
    # the matcher's phases: stereo_aggregate (on the materialized route
    # stereo_volume, stereo_scan), stereo_wta
    disp, n_rescued = stereo_model.disparity(
        left_f32, right_f32, stereo_config, prior_disp=prior_disp,
        with_rescued=True)
    with timing.phase("depth_filter", left_f32.device):
        depth = torch.where(disp > 0, bf / disp.clamp_min(1e-6), 0.0)
        depth = torch.where(depth <= config.fuse_far, depth, 0.0)
        if filter_depth:
            depth = depthfilter.clean_depth(depth)
            # optional disparity-domain median fills on the cleaned map
            for _ in range(stereo_config.fill_after_clean
                           if stereo_config.post_median else 0):
                d2 = torch.where(depth > 0, bf / depth.clamp_min(1e-6), 0.0)
                d2 = stereo_model._median_postfilter(
                    d2, stereo_config.speckle_tol,
                    stereo_config.fill_support)
                depth = torch.where(d2 > 0, bf / d2.clamp_min(1e-6), 0.0)
    return depth, n_rescued


def _stereo_prior(config: SurfelMapConfig, stereo_config, bank: SurfelBank,
                  pose: torch.Tensor):
    """Map-rendered depth prior for the matcher's rescue gate, or None (off
    unless stereo_config.prior_rescue, and in hierarchical mode, whose
    matcher ignores it).  Rendered from the bank before this frame's
    update (the sharded steps: `parallel.sharding.merged_zbuffers`)."""
    if not stereo_config.prior_rescue or stereo_config.hierarchical:
        return None
    from ..ops.render import render_prior_depth
    return render_prior_depth(config, bank, pose,
                              stride=stereo_config.prior_stride,
                              min_updates=stereo_config.prior_min_updates)


def fuse_frame_stereo_windowed_packed(config: SurfelMapConfig,
                                      stereo_config, filter_depth: bool,
                                      bank: SurfelBank, buf: torch.Tensor,
                                      pose: torch.Tensor,
                                      frame_index: torch.Tensor,
                                      bf: torch.Tensor,
                                      pose_mask: torch.Tensor | None
                                      ) -> Tuple[SurfelBank, dict]:
    """Stereo-resident fuse step: packed u8 pair -> depth on the device ->
    the fuse step, with the optional window gating of
    `fuse_frame_windowed`."""
    ph, pw = config.padded_height, config.padded_width
    pad = (0, pw - config.width, 0, ph - config.height)
    left, right = unpack_stereo(config, buf)
    depth, n_rescued = compute_depth_stereo(
        config, stereo_config, left, right, bf, filter_depth,
        prior_depth=_stereo_prior(config, stereo_config, bank, pose))
    bank, stats = fuse_frame(config, bank, FrameInput(
        image=F.pad(left, pad), depth=F.pad(depth, pad), pose=pose,
        frame_index=frame_index), pose_mask=pose_mask)
    stats["n_rescued_px"] = n_rescued
    return bank, stats


def fuse_frame_stereo_packed(config: SurfelMapConfig, stereo_config,
                             filter_depth: bool, bank: SurfelBank,
                             buf: torch.Tensor, pose: torch.Tensor,
                             frame_index: torch.Tensor, bf: torch.Tensor
                             ) -> Tuple[SurfelBank, dict]:
    """Stereo-resident fuse step without window gating."""
    return fuse_frame_stereo_windowed_packed(
        config, stereo_config, filter_depth, bank, buf, pose, frame_index,
        bf, None)


def fuse_frame_stereo_windowed_aux(config: SurfelMapConfig, stereo_config,
                                   filter_depth: bool, bank: SurfelBank,
                                   buf: torch.Tensor, aux: torch.Tensor
                                   ) -> Tuple[SurfelBank, dict]:
    """Stereo-resident windowed fuse with pose, index, bf and window mask
    in one aux buffer."""
    pose, ref, bf, mask = unpack_aux(aux)
    return fuse_frame_stereo_windowed_packed(
        config, stereo_config, filter_depth, bank, buf, pose, ref, bf, mask)


def fuse_frame_stereo_onebuf(config: SurfelMapConfig, stereo_config,
                             filter_depth: bool, bank: SurfelBank,
                             buf: torch.Tensor) -> Tuple[SurfelBank, dict]:
    """Stereo-resident windowed fuse with the whole payload (packed pair +
    aux, `core.state.pack_stereo_with_aux`) in one upload."""
    hw2 = 2 * config.height * config.width
    return fuse_frame_stereo_windowed_aux(config, stereo_config,
                                          filter_depth, bank, buf[:hw2],
                                          buf[hw2:])


# ----------------------------------------------------------------------
# batch replay: many frames per call (the JAX package's lax.scan paths)
# ----------------------------------------------------------------------
def fuse_frames_scan(config: SurfelMapConfig, bank: SurfelBank,
                     images_u8: torch.Tensor, depths_f16: torch.Tensor,
                     poses: torch.Tensor, frame_indices: torch.Tensor
                     ) -> Tuple[SurfelBank, dict]:
    """Fuse a chunk of compact frames (leading axis N, resident on the
    bank's device) in order: N successive `fuse_frame_compact` calls.
    Returns (bank updated in place, stats stacked (N,) per frame)."""
    per_frame = [fuse_frame_compact(config, bank, images_u8[i],
                                    depths_f16[i], poses[i],
                                    frame_indices[i])[1]
                 for i in range(images_u8.shape[0])]
    return bank, {k: torch.stack([st[k] for st in per_frame])
                  for k in per_frame[0]}


def fuse_frames_looped(config: SurfelMapConfig, n_loops: int,
                       bank: SurfelBank, images_u8: torch.Tensor,
                       depths_f16: torch.Tensor, poses: torch.Tensor
                       ) -> Tuple[SurfelBank, torch.Tensor]:
    """Fuse K stacked compact frames `n_loops` times: step t fuses frame
    t mod K with frame index t.  Returns (bank updated in place, the
    (n_loops * K,) i32 trace of the bank's count after each step).

    A looped replay of the trajectory for device-throughput measurement:
    later laps fuse against a larger map.  On a CUDA bank one lap is
    captured into a CUDA graph (`LapGraph`) and replayed n_loops times,
    then the call waits for the last replay: one enqueue per lap and one
    fence, where the JAX package runs one `lax.scan` program.  A CUDA bank
    replays the graph or raises; on a CPU bank the same steps run eagerly."""
    k = images_u8.shape[0]
    if bank.device.type == "cuda":
        lap = LapGraph(config, bank, images_u8, depths_f16, poses, n_loops)
        for _ in range(n_loops):
            lap.replay()
        # the one fence: the graph (and its memory pool) must outlive its
        # replays
        torch.cuda.current_stream(bank.device).synchronize()
        return bank, lap.trace
    trace = []
    for t in range(n_loops * k):
        i = t % k
        fuse_frame_compact(config, bank, images_u8[i], depths_f16[i],
                           poses[i], torch.tensor(t, dtype=torch.int32))
        trace.append(bank.count.clone())
    return bank, torch.stack(trace)


# graphs captured in this process (`capture`), read beside the kernels'
# LAUNCHES: a replayed graph launches its kernels without calling their
# wrappers.  "steps": the fuse steps and laps (StepGraph, LapGraph, the
# mesh steps), whose warm-up runs the kernels once; "programs": the other
# programs (BankGraph: the bank programs, the sharded SGM), which run none
# of them
CAPTURES = {"steps": 0, "programs": 0}


def devices_of(target) -> list:
    """The devices of a graph's target, the home first: one bank's, or
    the distinct devices of a `parallel.sharding.ShardedBanks` in (row,
    shard) order, whose home is the home cell (row 0's first shard),
    where the graph keeps its static inputs and is replayed."""
    if isinstance(target, SurfelBank):
        return [target.device]
    return target.devices()


def _clone(bank: SurfelBank) -> SurfelBank:
    return SurfelBank(**{f: getattr(bank, f).clone()
                         for f in bank.__dataclass_fields__})


def _scratch(target):
    """A clone of the target (a bank or a mesh's banks) to warm up on."""
    if isinstance(target, SurfelBank):
        return _clone(target)
    return dataclasses.replace(target, rows=[[_clone(b) for b in row]
                                             for row in target.rows])


def capture(bank, body: Callable[[object], object], pool=None,
            reset: Callable[[], None] | None = None, kind: str = "steps",
            devices=None):
    """Capture body(bank) into a `torch.cuda.CUDAGraph`: returns (graph,
    what the captured call returned, its tensors now the graph's static
    outputs).  `bank` is a SurfelBank, a mesh's `ShardedBanks` (on one
    card or several), or None for a program without a bank (then
    `devices` names its cards, the home first).

    body(scratch) runs once first, on a side stream, against a clone of
    the bank(s): every lazily built object (geometry planes, library
    handles, the kernel libraries) is built there, outside the capture,
    where an upload from pageable memory or a synchronisation is allowed.
    The clone is freed before the capture (`torch.cuda.graph` empties the
    cache on entry); `reset` undoes the warm-up's other side effects.  The
    capture runs in "thread_local" mode: the drivers' worker threads (the
    pack worker, the fleet's pipelined rounds, pinned allocations on the
    main thread) may call CUDA while it runs, and only this thread is
    barred from calls that a capture forbids.  `pool` (`graph_pool`: one
    `torch.cuda.MemPool` per card) shares the memory of a driver's graphs;
    `kind` is the CAPTURES entry the capture counts in.

    A target over several cards is one capture over all of them: the
    capture stream is on the home card, the body forks work to the other
    cards' streams and joins it back (`parallel.sharding.mesh_program`),
    and every card's allocations while it runs go to that card's pool
    (`capture_pools`), so `pool` must hold one for each card.  The warm-up
    clones each bank on its own card."""
    devs = devices_of(bank) if bank is not None else \
        [torch.device(d) for d in devices]
    home = devs[0]
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"a CUDA graph needs CUDA banks, got "
                         f"{[str(d) for d in devs]}")
    missing = [str(d) for d in devs[1:] if pool is None or d not in pool]
    if missing:
        raise ValueError(f"a capture over several cards needs a memory "
                         f"pool on each, none for {missing}")
    scratch = None if bank is None else _scratch(bank)
    side = torch.cuda.Stream(home)
    side.wait_stream(torch.cuda.current_stream(home))
    with torch.cuda.stream(side):
        body(scratch)
    torch.cuda.current_stream(home).wait_stream(side)
    del scratch
    if reset is not None:
        reset()
    for d in devs[1:]:      # torch.cuda.graph synchronises the home card
        torch.cuda.synchronize(d)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(home), torch.cuda.graph(
            graph, pool=None if pool is None else pool[home].id,
            stream=torch.cuda.Stream(home),
            capture_error_mode="thread_local"), \
            capture_pools(pool, devs[1:]):
        out = body(bank)
    CAPTURES[kind] += 1
    timing.count_capture(kind)
    return graph, out


@contextlib.contextmanager
def capture_pools(pool, devices):
    """While a capture on the home card runs: this thread's allocations on
    each other card of `devices` go to that card's pool (`pool[d]`), where
    the graph keeps them, and the card's allocator knows a capture is
    under way (it then defers the reuse of blocks other streams used)."""
    with contextlib.ExitStack() as stack:
        for d in devices:
            stack.enter_context(torch.cuda.use_mem_pool(pool[d], d))
        yield


def graph_pool(devices):
    """The memory pools a driver's captured graphs share: {card: a
    `torch.cuda.MemPool` created under that card} for a device or a list
    of devices (a mesh's), or None off the card.  A MemPool holds its
    pool open for as long as the driver keeps it: a pool from
    `torch.cuda.graph_pool_handle()` closes when its last graph is freed,
    and capturing the next graph into it fails (a recapture frees the
    graph it replaces)."""
    devs = [torch.device(devices)] if isinstance(devices, (str,
                                                           torch.device)) \
        else [torch.device(d) for d in devices]
    if devs[0].type != "cuda":
        return None
    pools = {}
    for d in devs:
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.device(d):
            pools[d] = torch.cuda.MemPool()
    return pools


class LapGraph:
    """One lap of `fuse_frames_looped` (K compact fuse steps over a
    device-resident frame stack) captured into a `torch.cuda.CUDAGraph`.

    The lap writes the bank in place (its tensors keep their addresses), so
    each `replay()` continues the map of the one before.  The frame index
    is a device counter the graph itself advances, and captured copies
    write the bank's count after each step into `trace` ((n_loops * K,)
    i32): nothing is uploaded between replays (`capture` has the recipe)."""

    def __init__(self, config: SurfelMapConfig, bank: SurfelBank,
                 images_u8: torch.Tensor, depths_f16: torch.Tensor,
                 poses: torch.Tensor, n_loops: int):
        dev = bank.device
        self.n_loops = n_loops
        self.replays = 0
        k = images_u8.shape[0]
        counter = torch.zeros((), dtype=torch.int32, device=dev)
        self.trace = torch.zeros(n_loops * k, dtype=torch.int32, device=dev)

        def lap(target: SurfelBank) -> None:
            for i in range(k):
                fuse_frame_compact(config, target, images_u8[i],
                                   depths_f16[i], poses[i], counter)
                self.trace.index_copy_(0, counter.long().view(1),
                                       target.count.view(1))
                counter.add_(1)

        def reset() -> None:
            counter.zero_()
            self.trace.zero_()

        self.keep = step_geometry(config, bank)
        self.graph, _ = capture(bank, lap, reset=reset)

    def replay(self) -> None:
        """Enqueue one lap.  The trace has room for n_loops laps: a
        further replay would index past it, so it raises."""
        if self.replays >= self.n_loops:
            raise RuntimeError(f"the trace holds {self.n_loops} laps")
        self.replays += 1
        self.graph.replay()


class BankGraph:
    """A program over a bank captured into a `torch.cuda.CUDAGraph` at its
    first call and replayed at every later one: the counterpart of a JAX
    jit dispatched on the bank (the fuse steps below, `StepGraph`; the bank
    programs of the drivers: `jitted_compact`, `_jitted_append`,
    `migration.extract_by_pose`, `warp_active`, `warp_bank_by_pose` and the
    fleet's `_batched_warp` / `_batched_compact`; over a mesh's
    `ShardedBanks`, the `jax.jit(jax.shard_map(...))` programs of
    `parallel/sharding.py` and `parallel/frame_sharding.py`).

    `fn(bank, *inputs)` is the eager program.  The object owns one static
    input per argument (`specs`: (shape, dtype) each) on the home device
    (`devices_of`: the bank's, or a mesh's home cell; for a program
    without a bank, bank None, `devices[0]`: the sharded SGM), the
    bank(s) it was captured against (written in place, so their tensors
    keep their addresses), and what the captured call returned: static
    outputs, which the next replay overwrites, and so may the replay of a
    graph captured earlier into the same pool (its freed intermediates
    are the later graph's to reuse): read them before either.  `keep`
    holds whatever else the graph reads and must outlive it.

    `load(*args)` copies the arguments (host arrays or tensors) into the
    static inputs without blocking the host; `replay()` captures `fn` at
    its first call (`capture`: a warm-up on a scratch clone of the bank,
    then the capture, which synchronises like a jit's first call) and
    enqueues one replay on the home card's current stream, ordered after
    the other cards' current streams and before their later work;
    `__call__(*args)` does both and returns the outputs.  `graphed`
    (default: the home device is a card) is decided when the object is
    built: when False the same object runs `fn` eagerly through the same
    static inputs, as it does on a CPU bank or mesh
    (`parallel.sharding.graphed_mesh`).  A graphed object captures or
    raises.  On one card the captured program opens and closes with
    device stamps (`timing.replay_stamps`) under `name`."""

    kind = "programs"   # its CAPTURES entry

    def __init__(self, fn: Callable, bank, specs=(), pool=None, keep=(),
                 graphed: bool | None = None, devices=None,
                 name: str = "program"):
        self.fn = fn
        self.name = name
        self.bank = bank
        self.devices = (devices_of(bank) if bank is not None
                        else [torch.device(d) for d in devices])
        self.device = self.devices[0]
        self.inputs = tuple(torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                            for shape, dtype in specs)
        self.pool = pool
        self.keep = keep
        self.graphed = (self.device.type == "cuda" if graphed is None
                        else graphed)
        self.graph = None
        self.out = None
        self.replays = 0
        self.capture_ms = 0.0   # host ms of the warm-up and the capture

    def load(self, *args) -> None:
        for dst, src in zip(self.inputs, args, strict=True):
            dst.copy_(torch.as_tensor(src), non_blocking=True)

    def replay(self):
        if not self.graphed:
            return self.fn(self.bank, *self.inputs)
        if self.graph is None:
            t0 = time.perf_counter()
            self.graph, self.out = capture(
                self.bank, self._stamped, self.pool, kind=self.kind,
                devices=self.devices)
            self.capture_ms = 1e3 * (time.perf_counter() - t0)
        main = torch.cuda.current_stream(self.device)
        others = [torch.cuda.current_stream(d) for d in self.devices[1:]]
        for st in others:
            main.wait_stream(st)
        with torch.cuda.device(self.device):
            self.graph.replay()
        for st in others:
            st.wait_stream(main)
        self.replays += 1
        return self.out

    def _stamped(self, bank):
        if len(self.devices) > 1:
            return self.fn(bank, *self.inputs)
        with timing.replay_stamps(self.name, self.device):
            return self.fn(bank, *self.inputs)

    def __call__(self, *args):
        self.load(*args)
        return self.replay()


class StepGraph(BankGraph):
    """One per-frame fuse step captured into a `torch.cuda.CUDAGraph` and
    replayed once per frame: the counterpart of the JAX package's compiled
    steps (`jitted_fuse_frame_onebuf`, densesurfelmapping_tpu/pipeline/
    fuse_step.py:361-364; `jitted_fuse_frame_stereo_onebuf`, :379-384;
    `jitted_fuse_frame_packed`, :113-115, `diagnose`'s step; the host-pool
    driver's `jitted_fuse_frame`, `jitted_fuse_frame_compact` and
    `jitted_fuse_frame_stereo_packed`, :61-90, :261-265; the fleet's
    vmapped rounds), which the JAX drivers build once per step signature
    and dispatch once per frame.

    A `BankGraph` whose one static input is the frame's packed u8 payload
    of shape `shape` ((n,) for a driver, (B, n) for a fleet round) and
    whose outputs are the step's stats: `step(bank, buf) -> stats`; `keep`
    holds the cached geometry planes of `ops/superpixel.py` the graph
    reads."""

    kind = "steps"

    def __init__(self, step: Callable[[SurfelBank, torch.Tensor], dict],
                 bank, shape, pool=None, keep=(), graphed=None):
        super().__init__(step, bank, ((shape, torch.uint8),), pool, keep,
                         graphed, name="step")

    def replay(self):
        out = super().replay()
        timing.count_frame(self.device)
        return out

    @property
    def buf(self) -> torch.Tensor:
        return self.inputs[0]


def onebuf_bytes(config: SurfelMapConfig) -> int:
    """Length of `fuse_frame_onebuf`'s payload: 3 H W + 72 + P."""
    return 3 * config.height * config.width + AUX_HEAD_BYTES \
        + config.max_keyframes


def stereo_onebuf_bytes(config: SurfelMapConfig) -> int:
    """Length of `fuse_frame_stereo_onebuf`'s payload: 2 H W + 72 + P."""
    return 2 * config.height * config.width + AUX_HEAD_BYTES \
        + config.max_keyframes


def step_geometry(config: SurfelMapConfig, bank: SurfelBank):
    """The cached geometry planes a captured step reads (kept alive by its
    StepGraph: the cache may evict them)."""
    return superpixel.device_geometry(config, bank.device)


def graphed_fuse_frame_onebuf(config: SurfelMapConfig, bank: SurfelBank,
                              pool=None) -> StepGraph:
    """`fuse_frame_onebuf` on `bank` as a StepGraph (the JAX package's
    `jitted_fuse_frame_onebuf`)."""
    return StepGraph(lambda b, buf: fuse_frame_onebuf(config, b, buf)[1],
                     bank, (onebuf_bytes(config),), pool,
                     keep=step_geometry(config, bank))


def graphed_fuse_frame_stereo_onebuf(config: SurfelMapConfig, stereo_config,
                                     filter_depth: bool, bank: SurfelBank,
                                     pool=None) -> StepGraph:
    """`fuse_frame_stereo_onebuf` on `bank` as a StepGraph (the JAX
    package's `jitted_fuse_frame_stereo_onebuf`)."""
    return StepGraph(
        lambda b, buf: fuse_frame_stereo_onebuf(
            config, stereo_config, filter_depth, b, buf)[1],
        bank, (stereo_onebuf_bytes(config),), pool,
        keep=step_geometry(config, bank))


def graphed_fuse_frame_packed(config: SurfelMapConfig, bank: SurfelBank,
                              pool=None) -> StepGraph:
    """`fuse_frame_packed` on `bank` as a StepGraph (the JAX package's
    `jitted_fuse_frame_packed`).  Its payload is `core.state.pack_frame`'s
    bytes followed by a 72-byte `pack_aux` head (pose and frame index; bf
    unused, no window mask)."""
    hw3 = 3 * config.height * config.width

    def step(b: SurfelBank, buf: torch.Tensor) -> dict:
        pose, ref, _, _ = unpack_aux(buf[hw3:])
        return fuse_frame_packed(config, b, buf[:hw3], pose, ref)[1]

    return StepGraph(step, bank, (hw3 + AUX_HEAD_BYTES,), pool,
                     keep=step_geometry(config, bank))


def graphed_fuse_frame_compact(config: SurfelMapConfig, bank: SurfelBank,
                               pool=None) -> StepGraph:
    """`fuse_frame_compact` on `bank` as a StepGraph: the JAX package's
    `jitted_fuse_frame_compact`, the host-pool driver's step under
    `compact_upload`.  The compact planes travel as `pack_frame` bytes, so
    this is `graphed_fuse_frame_packed`'s graph and payload."""
    return graphed_fuse_frame_packed(config, bank, pool)


def padded_frame_bytes(config: SurfelMapConfig) -> int:
    """Length of the padded f32 image and depth planes as bytes."""
    return 8 * config.padded_height * config.padded_width


def graphed_fuse_frame(config: SurfelMapConfig, bank: SurfelBank,
                       pool=None) -> StepGraph:
    """`fuse_frame` on `bank` as a StepGraph: the JAX package's
    `jitted_fuse_frame`, the host-pool driver's step without
    `compact_upload`.  Its payload is the padded f32 image and depth planes
    (`core.state.pad_frame`) as bytes, then a 72-byte `pack_aux` head (pose
    and frame index)."""
    ph, pw = config.padded_height, config.padded_width
    n = 4 * ph * pw

    def step(b: SurfelBank, buf: torch.Tensor) -> dict:
        pose, ref, _, _ = unpack_aux(buf[2 * n:])
        return fuse_frame(config, b, FrameInput(
            image=_bitcast(buf[:n], torch.float32).view(ph, pw),
            depth=_bitcast(buf[n:2 * n], torch.float32).view(ph, pw),
            pose=pose, frame_index=ref))[1]

    return StepGraph(step, bank, (2 * n + AUX_HEAD_BYTES,), pool,
                     keep=step_geometry(config, bank))


def graphed_fuse_frame_stereo_packed(config: SurfelMapConfig, stereo_config,
                                     filter_depth: bool, bank: SurfelBank,
                                     pool=None) -> StepGraph:
    """`fuse_frame_stereo_packed` on `bank` as a StepGraph: the JAX
    package's `jitted_fuse_frame_stereo_packed`, the host-pool driver's
    stereo step.  Its payload is `core.state.pack_stereo_pair`'s bytes
    followed by a 72-byte `pack_aux` head (pose, frame index and bf)."""
    hw2 = 2 * config.height * config.width

    def step(b: SurfelBank, buf: torch.Tensor) -> dict:
        pose, ref, bf, _ = unpack_aux(buf[hw2:])
        return fuse_frame_stereo_packed(config, stereo_config, filter_depth,
                                        b, buf[:hw2], pose, ref, bf)[1]

    return StepGraph(step, bank, (hw2 + AUX_HEAD_BYTES,), pool,
                     keep=step_geometry(config, bank))


# ----------------------------------------------------------------------
# the drivers' bank programs as BankGraphs
# ----------------------------------------------------------------------
def graphed_compact(bank: SurfelBank, pool=None) -> BankGraph:
    """`fusion.compact_bank` on `bank` (the JAX package's `jitted_compact`,
    densesurfelmapping_tpu/pipeline/fuse_step.py:450)."""
    return BankGraph(fusion.compact_bank, bank, (), pool, name="compact")


def graphed_append(config: SurfelMapConfig, bank: SurfelBank,
                   pool=None) -> BankGraph:
    """The tail append of the first n rows of a migration_buffer-row slab
    (the JAX driver's `_jitted_append`, densesurfelmapping_tpu/pipeline/
    driver.py:47-56).  Inputs: the slab's fields in `FIELDS` order, then n
    () i32; returns `fusion.append_new`'s stats."""
    m = config.migration_buffer
    specs = [((m,) + getattr(bank, k).shape[1:], getattr(bank, k).dtype)
             for k in FIELDS] + [((), torch.int32)]

    def append(b: SurfelBank, *args) -> dict:
        *fields, n = args
        mask = torch.arange(m, device=b.device) < n
        return fusion.append_new(b, dict(zip(FIELDS, fields)), mask)

    return BankGraph(append, bank, specs, pool, name="append")


def graphed_extract(config: SurfelMapConfig, bank: SurfelBank,
                    pool=None) -> BankGraph:
    """`migration.extract_by_pose` over MAX_REMOVE_POSES pose ids (input:
    (MAX_REMOVE_POSES,) i32, padded with -1) into migration_buffer rows;
    returns (rows, n)."""
    return BankGraph(
        lambda b, ids: migration.extract_by_pose(b, ids,
                                                 config.migration_buffer),
        bank, (((migration.MAX_REMOVE_POSES,), torch.int32),), pool,
        name="extract")


def graphed_warp_active(bank: SurfelBank, pool=None) -> BankGraph:
    """`warp_ops.warp_active` on `bank` (input: the (4, 4) f32 warp)."""
    return BankGraph(warp_ops.warp_active, bank,
                     (((4, 4), torch.float32),), pool, name="warp_active")


def graphed_warp_bank_by_pose(config: SurfelMapConfig, bank: SurfelBank,
                              pool=None) -> BankGraph:
    """`warp_ops.warp_bank_by_pose` on `bank`.  Inputs, with P =
    config.max_keyframes: warps (P, 4, 4) f32, moved (P,) bool, the window
    mask (P,) bool and first_local () i64."""
    P = config.max_keyframes
    return BankGraph(warp_ops.warp_bank_by_pose, bank,
                     (((P, 4, 4), torch.float32), ((P,), torch.bool),
                      ((P,), torch.bool), ((), torch.int64)), pool,
                     name="pose_warp")


def segmentation_only(config: SurfelMapConfig, image: torch.Tensor,
                      depth: torch.Tensor):
    """Superpixel + plane-fit stage alone (for tests/debug visualisation,
    the analogue of the reference's `debug_show`): padded (H, W) f32 image
    and depth -> (seeds, assignment)."""
    seeds, assignment = superpixel.run_slic(config, image, depth)
    seeds = normals.compute_seed_planes(config, seeds, assignment, depth)
    return seeds, assignment
