"""Command-line runner: dataset replay -> mapping -> export.

The ROS-free equivalent of the reference's launch surface — the KITTI
publisher node (`kitti_publisher/scripts/publisher.py`), the surfel_fusion
entry node with its param block (`surfel_fusion/launch/kitti_orb.launch:5-22`,
`src/ros_node.cpp:13-53`), and the shutdown save hook — as one CLI:

    python -m densesurfelmapping_tpu_torch synthetic --frames 120 --out map
    python -m densesurfelmapping_tpu_torch kitti --root /data/kitti/00 \
        --seq 0 --poses /data/kitti/poses/00.txt --out kitti00 \
        --max-frames 500
    python -m densesurfelmapping_tpu_torch replay --feed poses.npz --root ...
    python -m densesurfelmapping_tpu_torch multi --streams 4 --frames 50
    python -m densesurfelmapping_tpu_torch serve --socket build/cli/s.sock &
    python -m densesurfelmapping_tpu_torch publish --socket build/cli/s.sock \
        --frames 120 --save map_mesh.ply --shutdown

The PyTorch port of the JAX package's CLI, with its subcommands synthetic,
kitti, stress, tum, replay, multi (B sessions in one batched pass per
round), serve and publish (the socket bridge, io/bridge.py); `diagnose` is
not ported yet.  Mapping runs on `--device` (default cuda, which raises on a
machine without a CUDA card; --device cpu runs the plain PyTorch paths).

Outputs per run (all optional, gated on --out): <out>.pcd stable cloud,
<out>_mesh.ply hexagon mesh, <out>_cameras.ply frustum/pose-graph line set,
<out>_seg.png superpixel debug render of the last frame, <out>.ckpt.npz map
checkpoint, <out>_traj.txt keyframe trajectory, <out>_mapdepth.png map
depth render, and a per-stage timing report on stdout.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def _build_mapping(args):
    import dataclasses
    from . import kitti_config, rgbd_config, mono_config
    from .config import SurfelMapConfig
    from .pipeline.driver import SurfelMapping
    from .pipeline.device_driver import DeviceResidentMapping

    if args.camera_json:
        with open(args.camera_json) as f:
            cfg = SurfelMapConfig.from_json(f.read())
    elif args.profile == "rgbd":
        cfg = rgbd_config(surfel_capacity=1 << args.capacity_log2)
    elif args.profile == "mono":
        cfg = mono_config(surfel_capacity=1 << args.capacity_log2)
    else:
        cfg = kitti_config(surfel_capacity=1 << args.capacity_log2)
    # per-sequence intrinsics overrides (KITTI sequences differ in
    # resolution/calibration; the reference hardcoded seq 00-02)
    cam_overrides = {k: getattr(args, k) for k in
                     ("width", "height", "fx", "fy", "cx", "cy")
                     if getattr(args, k, None) is not None}
    if cam_overrides:
        cam = dataclasses.replace(cfg.camera, **cam_overrides)
        cfg = dataclasses.replace(cfg, camera=cam)
    device = _device(args)
    if getattr(args, "host_pool", False):
        return SurfelMapping(cfg, kitti_alignment=args.kitti_alignment,
                             device=device), cfg
    return DeviceResidentMapping(
        cfg, kitti_alignment=args.kitti_alignment, device=device,
        pipelined=getattr(args, "pipelined", False)), cfg


def _stereo_config(args):
    """One StereoConfig construction for every stereo-capable subcommand
    (ADVICE r3: --no-post-median used to exist only on `stress`, so the
    post_median default silently applied everywhere else)."""
    from .models.stereo import StereoConfig

    if getattr(args, "hier", False) and getattr(args, "prior_rescue", False):
        # the hierarchical matcher ignores prior_disp (its validity comes
        # from the half-res solve); the fuse step skips the prior render
        # in that mode, so the flag would be silently inert (ADVICE r4)
        import sys
        print("warning: --prior-rescue has no effect with --hier "
              "(the hierarchical matcher ignores the map prior)",
              file=sys.stderr)
    return StereoConfig(
        max_disparity=getattr(args, "max_disparity", 128),
        aggregation="sgm" if getattr(args, "sgm", False) else "box",
        post_median=not getattr(args, "no_post_median", False),
        occlusion_fill=getattr(args, "occlusion_fill", False),
        hierarchical=getattr(args, "hier", False),
        prior_rescue=getattr(args, "prior_rescue", False))


def _finish(mapping, cfg, args, last_frame=None):
    from . import viz

    metr = mapping.metrics()
    print(f"frames fused: {mapping.frames_fused}, "
          f"active surfels: {metr['active_count']:.0f}, "
          f"inactive: {metr['inactive_count']:.0f}, "
          f"memory: {metr['memory_kb']:.0f} KB")
    print("stage times:", mapping.timer.report())
    if not args.out:
        return
    n_cloud = mapping.save_cloud(args.out + ".pcd")
    n_mesh = mapping.save_mesh(args.out + "_mesh.ply")
    poses = [k.cam_pose for k in mapping.graph.keyframes]
    edges = [(i, j) for i, k in enumerate(mapping.graph.keyframes)
             for j in k.linked if j > i]
    viz.save_camera_markers(args.out + "_cameras.ply", poses, cfg.camera,
                            scale=1.0, loop_edges=edges)
    mapping.save_checkpoint(args.out + ".ckpt.npz")
    n_traj = mapping.save_trajectory(args.out + "_traj.txt", fmt="kitti")
    print(f"saved {n_cloud} cloud points -> {args.out}.pcd, "
          f"{n_mesh} mesh surfels -> {args.out}_mesh.ply, "
          f"{len(poses)} cameras -> {args.out}_cameras.ply, "
          f"checkpoint -> {args.out}.ckpt.npz, "
          f"{n_traj} keyframe poses -> {args.out}_traj.txt")
    if mapping.graph.keyframes:
        # map-view render: the fused map splatted back into the latest
        # keyframe's camera (the rviz "what does the map look like" view)
        from .eval import render_depth
        d = render_depth(cfg, mapping.map_surfels(),
                         mapping.graph.keyframes[-1].loop_pose,
                         device=mapping.device)
        viz.save_png(args.out + "_mapdepth.png",
                     viz.depth_colormap(d, cfg.fuse_far))
        print(f"map depth render -> {args.out}_mapdepth.png")
    if last_frame is not None:
        _save_debug_render(mapping, cfg, args, last_frame)


def _save_debug_render(mapping, cfg, args, frame):
    """Superpixel/normal debug view of one frame (debug_show equivalent),
    segmented on the mapping's device."""
    from . import viz
    from .core.state import pad_frame
    from .pipeline.fuse_step import segmentation_only

    image, depth = frame
    if depth is None:  # stereo replay: depth never leaves the device
        depth = np.zeros_like(image, np.float32)
    pi, pd = pad_frame(cfg, image.astype(np.float32),
                       depth.astype(np.float32))
    dev = mapping.device
    seeds, assignment = segmentation_only(cfg, torch.from_numpy(pi).to(dev),
                                          torch.from_numpy(pd).to(dev))
    rgb = viz.render_segmentation(cfg, pi, assignment.cpu().numpy())
    viz.save_png(args.out + "_seg.png", rgb)
    print(f"segmentation render -> {args.out}_seg.png")


def _publish(mapping, cfg, args, frame_index: int) -> None:
    """Streaming map export every --publish-every fused frames: a rolling
    <out>_live.pcd + camera markers (the rviz-topic cadence of
    `surfel_map.cpp:188-198`) plus a numbered time-series snapshot.

    Publishing forces one device->host bank transfer per period; the
    reference publishes at 5 Hz continuously, so an N matched to the input
    rate reproduces its behavior.  Leave the flag off for maximum-rate
    mapping (readbacks drop the async dispatch fast path)."""
    from . import viz

    n = mapping.save_cloud(f"{args.out}_live.pcd")
    mapping.save_cloud(f"{args.out}_f{frame_index:06d}.pcd")
    poses = [k.loop_pose for k in mapping.graph.keyframes]
    edges = [(i, j) for i, k in enumerate(mapping.graph.keyframes)
             for j in k.linked if j > i]
    viz.save_camera_markers(f"{args.out}_live_cameras.ply", poses,
                            cfg.camera, scale=1.0, loop_edges=edges)
    print(f"published frame {frame_index}: {n} points -> "
          f"{args.out}_live.pcd (+_f{frame_index:06d}.pcd, _live_cameras.ply)")


def _maybe_publish(mapping, cfg, args, i) -> None:
    every = getattr(args, "publish_every", 0)
    if every and args.out and mapping.frames_fused > 0 \
            and mapping.frames_fused % every == 0 \
            and mapping.frames_fused != getattr(mapping,
                                                "_last_published", -1):
        # remember the count: if frames stall at a multiple of N (dropped
        # pose, lagging stamps), re-running the export every input frame
        # would hammer the hot loop with D2H readbacks
        mapping._last_published = mapping.frames_fused
        _publish(mapping, cfg, args, i)


def _throttle(rate_hz, t_last):
    if rate_hz <= 0:
        return time.perf_counter()
    period = 1.0 / rate_hz
    now = time.perf_counter()
    wait = t_last + period - now
    if wait > 0:
        time.sleep(wait)
    return time.perf_counter()


def cmd_synthetic(args):
    from .io import synthetic

    mapping, cfg = _build_mapping(args)
    scene = synthetic.default_scene()
    if args.loop:
        poses = synthetic.loop_trajectory(args.frames, radius=10.0)
    else:
        poses = synthetic.forward_trajectory(args.frames, step=0.4)
    if getattr(args, "stereo", False):
        mapping.enable_stereo(bf=cfg.camera.fx * args.baseline,
                              stereo_config=_stereo_config(args))
    t_last = 0.0
    last = None
    eval_set = []
    t0 = time.perf_counter()
    dirt = synthetic.DirtModel() if getattr(args, "dirty", False) else None
    try:
        for i, pose in enumerate(poses):
            img, dep = scene.render(cfg, pose)
            stamp = i / max(args.rate, 1e-9) if args.rate > 0 else float(i)
            fimg, fdep = (synthetic.apply_dirt(
                img, None if getattr(args, "stereo", False) else dep,
                i, dirt, cfg.camera.fx * args.baseline)
                if dirt else (img, dep))
            mapping.feed_pose(stamp, pose,
                              is_keyframe=(i % args.kf_every == 0))
            if getattr(args, "stereo", False):
                # right camera: +baseline along the camera x axis
                rp = np.array(pose, np.float64).copy()
                rp[:3, 3] += rp[:3, 0] * args.baseline
                rimg, _ = scene.render(cfg, rp)
                if dirt:
                    rimg, _ = synthetic.apply_dirt(rimg, None, i, dirt,
                                                   cfg.camera.fx *
                                                   args.baseline, right=True)
                mapping.feed_stereo(stamp, fimg, rimg)
            else:
                mapping.feed_image(stamp, fimg)
                mapping.feed_depth(stamp, fdep)
            last = (img, dep)
            if args.eval and i % max(args.frames // 8, 1) == 0:
                eval_set.append(((img, dep), pose))  # clean truth
            _maybe_publish(mapping, cfg, args, i)
            t_last = _throttle(args.rate, t_last)
    except KeyboardInterrupt:
        print("interrupted - saving map (reference shutdown-save semantics)")
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} fps incl. host render)")
    if args.eval:
        import json
        from .eval import evaluate_map, evaluate_map_clouds
        res = evaluate_map(mapping, [f for f, _ in eval_set],
                           [p for _, p in eval_set])
        print("fidelity:", json.dumps({k: round(v, 4)
                                       for k, v in res.items()}))
        cm = evaluate_map_clouds(mapping, [f for f, _ in eval_set],
                                 [p for _, p in eval_set])
        print("cloud:", json.dumps({k: round(v, 4)
                                    for k, v in cm.items()}))
    _finish(mapping, cfg, args, last)


def cmd_kitti(args):
    from .io.kitti import KittiSequence

    mapping, cfg = _build_mapping(args)
    seq = KittiSequence(args.root, seq=args.seq, rate_hz=args.rate or 5.0,
                        poses_file=args.poses or None,
                        max_frames=args.max_frames or None,
                        stereo=args.stereo)
    if seq.poses is None:
        print("error: no pose source (expected --poses or <root>/poses.txt)",
              file=sys.stderr)
        return 1
    if args.stereo:
        # depth is computed INSIDE the fuse program (no per-frame
        # readback; see fuse_step.fuse_frame_stereo_packed)
        mapping.enable_stereo(bf=seq.bf,
                              stereo_config=_stereo_config(args),
                              filter_depth=not args.no_depth_filter)
    t_last = 0.0
    last = None
    n = 0
    t0 = time.perf_counter()
    try:
        for fr in seq:
            mapping.feed_pose(fr.stamp, fr.pose,
                              is_keyframe=(fr.index % args.kf_every == 0))
            if args.stereo:
                mapping.feed_stereo(fr.stamp, fr.image, fr.right_image)
                # depth lives on-device in stereo mode; the debug render
                # tolerates depth=None (segmentation is intensity-driven)
                last = (fr.image, None)
            else:
                mapping.feed_image(fr.stamp, fr.image)
                mapping.feed_depth(fr.stamp, fr.depth)
                last = (fr.image, fr.depth)
            n += 1
            _maybe_publish(mapping, cfg, args, fr.index)
            t_last = _throttle(args.rate, t_last)
    except KeyboardInterrupt:
        print("interrupted - saving map (reference shutdown-save semantics)")
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} fps incl. IO)")
    _finish(mapping, cfg, args, last)
    return 0


def cmd_stress(args):
    """seq-00-scale loop-closure stress run: thousands of frames at the
    reference's cadence (drifting pose estimates, keyframe-every-N, <=35
    loop-edge bursts, one large mid-run pose-graph correction); reports map
    fidelity right before and right after the correction (io/stressfeed)."""
    import json
    from .eval import evaluate_map
    from .io import stressfeed, synthetic

    mapping, cfg = _build_mapping(args)
    dirt = synthetic.DirtModel() if getattr(args, "dirty", False) else None
    bf = cfg.camera.fx * 0.54
    seq = stressfeed.make_seq00_like(
        n_frames=args.frames, keyframe_every=args.kf_every,
        radius=args.radius,
        # length-normalized drift: ~0.25 rad + 0.5 m total at loop closure
        drift_yaw=0.25 / args.frames, drift_trans=0.5 / args.frames,
        revisit_radius=max(0.03 * args.radius, 1.5),
        moving_box=dirt is not None)
    print(f"stress feed: {args.frames} frames, {seq.n_keyframes} keyframes, "
          f"correction at frame {seq.loop_frame}"
          + (", DIRTY (DirtModel + moving box)" if dirt else ""))
    if getattr(args, "stereo", False):
        mapping.enable_stereo(bf=cfg.camera.fx * 0.54,
                              stereo_config=_stereo_config(args))
    eval_idx = list(range(0, args.frames, max(args.frames // 10, 1)))
    eval_set = {}
    pre = None
    last = None
    t0 = time.perf_counter()
    fuse_s = 0.0
    for i, m in enumerate(seq.feed.messages):
        img, dep = seq.scene.render(cfg, seq.gt_poses[i], time=float(i))
        if i == seq.loop_frame:       # snapshot fidelity before the warp
            pre = evaluate_map(mapping, list(eval_set.values())[:5],
                               [seq.gt_poses[j]
                                for j in list(eval_set)[:5]])
        # defects go on the FED frames only; eval stays against clean truth
        fimg, fdep = (synthetic.apply_dirt(
            img, None if getattr(args, "stereo", False) else dep,
            i, dirt, bf) if dirt else (img, dep))
        if getattr(args, "stereo", False):
            rp = np.array(seq.gt_poses[i], np.float64).copy()
            rp[:3, 3] += rp[:3, 0] * 0.54
            rimg, _ = seq.scene.render(cfg, rp, time=float(i))
            if dirt:
                rimg, _ = synthetic.apply_dirt(rimg, None, i, dirt, bf,
                                               right=True)
        tf = time.perf_counter()
        mapping.feed_pose(m.stamp, m.pose, loop_path=m.loop_path,
                          loop_edges=m.loop_edges,
                          is_keyframe=m.is_keyframe,
                          reference_index=m.reference_index)
        if getattr(args, "stereo", False):
            mapping.feed_stereo(m.stamp, fimg, rimg)
        else:
            mapping.feed_image(m.stamp, fimg)
            mapping.feed_depth(m.stamp, fdep)
        fuse_s += time.perf_counter() - tf
        if i in eval_idx:
            if dirt:
                # clean STATIC world: transient objects must not be in the
                # converged map, and defects must not be in the truth
                eval_set[i] = seq.scene.render(cfg, seq.gt_poses[i],
                                               include_movers=False)
            else:
                eval_set[i] = (img, dep)
        last = (img, dep)
        _maybe_publish(mapping, cfg, args, i)
    dt = time.perf_counter() - t0
    post = evaluate_map(mapping, list(eval_set.values()),
                        [seq.gt_poses[j] for j in eval_set])
    print(f"{args.frames} frames in {dt:.1f}s "
          f"({args.frames / dt:.1f} fps incl. host render; "
          f"feed+fuse only: {args.frames / max(fuse_s, 1e-9):.1f} fps)")
    rnd = lambda d: {k: round(v, 4) for k, v in d.items()}  # noqa: E731
    print("fidelity pre-correction: ", json.dumps(rnd(pre or {})))
    print("fidelity post-correction:", json.dumps(rnd(post)))
    from .eval import evaluate_map_clouds
    cm = evaluate_map_clouds(mapping, list(eval_set.values()),
                             [seq.gt_poses[j] for j in eval_set])
    print("cloud post-correction:", json.dumps(rnd(cm)))
    _finish(mapping, cfg, args, last)
    return 0


def cmd_tum(args):
    """TUM RGB-D sequence with the RGBD fusion profile."""
    from .io.tum import TumSequence

    mapping, cfg = _build_mapping(args)
    seq = TumSequence(args.root, max_frames=args.max_frames or None)
    t_last = 0.0
    last = None
    n = 0
    skipped = 0
    for fr in seq:
        if fr.pose is None:
            skipped += 1
            continue
        mapping.feed_pose(fr.stamp, fr.pose,
                          is_keyframe=(n % args.kf_every == 0))
        mapping.feed_image(fr.stamp, fr.image)
        mapping.feed_depth(fr.stamp, fr.depth)
        last = (fr.image, fr.depth)
        n += 1
        _maybe_publish(mapping, cfg, args, n)
        t_last = _throttle(args.rate, t_last)
    if skipped:
        print(f"skipped {skipped} frames without ground-truth pose")
    _finish(mapping, cfg, args, last)
    return 0


def cmd_replay(args):
    """Replay a recorded pose feed (the fake-SLAM contract: poses, keyframe
    flags, reference indices, loop paths/edges) against a frame source."""
    from .io.posefeed import PoseFeed
    from .io.kitti import KittiSequence

    mapping, cfg = _build_mapping(args)
    feed = PoseFeed.load(args.feed) if args.feed.endswith(".npz") \
        else PoseFeed.from_tum(args.feed, keyframe_every=args.kf_every)
    frames = iter(KittiSequence(args.root, seq=args.seq,
                                max_frames=args.max_frames or None)) \
        if args.root else None
    last = None
    for i, msg in enumerate(feed):
        if args.max_frames and i >= args.max_frames:
            break
        mapping.feed_pose(msg.stamp, msg.pose, loop_path=msg.loop_path,
                          loop_edges=msg.loop_edges,
                          is_keyframe=msg.is_keyframe,
                          reference_index=msg.reference_index)
        if frames is not None:
            try:
                fr = next(frames)
            except StopIteration:
                break
            mapping.feed_image(msg.stamp, fr.image)
            mapping.feed_depth(msg.stamp, fr.depth)
            last = (fr.image, fr.depth)
    _finish(mapping, cfg, args, last)
    return 0


def cmd_multi(args):
    """Multi-session serving demo: B synthetic streams, one batched pass of
    device work per round (pipeline/multi_session.MultiSessionMapping)."""
    from .io import synthetic
    from .pipeline.multi_session import MultiSessionMapping
    from . import kitti_config
    from .config import SurfelMapConfig

    if args.camera_json:
        with open(args.camera_json) as f:
            cfg = SurfelMapConfig.from_json(f.read())
    else:
        cfg = kitti_config(surfel_capacity=1 << args.capacity_log2)
    B = args.streams
    multi = MultiSessionMapping(cfg, n_streams=B,
                                pipelined=getattr(args, "pipelined", False),
                                device=_device(args))
    if getattr(args, "stereo", False):
        multi.enable_stereo(bf=cfg.camera.fx * 0.54,
                            stereo_config=_stereo_config(args))
    scene = synthetic.default_scene()
    t0 = time.perf_counter()
    for i in range(args.frames):
        for k in range(B):
            pose = np.eye(4)
            pose[0, 3] = 0.4 * i + 0.2 * k   # offset trajectories
            pose[2, 3] = 0.1 * k
            img, dep = scene.render(cfg, pose)
            multi.feed_pose(k, float(i), pose,
                            is_keyframe=(i % args.kf_every == 0))
            if getattr(args, "stereo", False):
                rp = pose.copy()
                rp[:3, 3] += rp[:3, 0] * 0.54
                rimg, _ = scene.render(cfg, rp)
                multi.feed_stereo(k, float(i), img, rimg)
            else:
                multi.feed_image(k, float(i), img)
                multi.feed_depth(k, float(i), dep)
        multi.step()
    metrics = multi.session_metrics()      # completes every round
    dt = time.perf_counter() - t0
    total = args.frames * B
    print(f"{total} frames across {B} sessions in {dt:.2f}s "
          f"({total / dt:.1f} frames/s aggregate incl. host render)")
    for k, m in enumerate(metrics):
        print(f"session {k}: {m['surfel_count']} surfels, "
              f"saturation {m['saturation']:.1%}, "
              f"dropped {m['surfels_dropped']}")
        if args.out:
            multi.save_cloud(k, f"{args.out}_s{k}.pcd")
            multi.save_checkpoint(k, f"{args.out}_s{k}.ckpt.npz")
    if args.out:
        print(f"saved per-session clouds + checkpoints -> {args.out}_s*")
    return 0


def cmd_serve(args):
    """Live mapping server: the reference's `ros_node` as a socket service
    (`ros_node.cpp:13-53`: subscribe, queue-decouple, fuse, shutdown-save).
    Clients stream images/depths/stereo pairs/pose messages over the bridge
    protocol (io/bridge.py) and can request saves/metrics mid-run."""
    from .io.bridge import MappingServer

    mapping, cfg = _build_mapping(args)
    if args.stereo:
        mapping.enable_stereo(bf=cfg.camera.fx * args.baseline,
                              stereo_config=_stereo_config(args))
    address = args.socket if args.socket else (args.host, args.port)
    autosave = (args.out + "_mesh.ply") if args.out else None
    with MappingServer(mapping, address, queue_depth=args.queue_depth,
                       autosave=autosave) as server:
        bound = server.address
        where = bound if isinstance(bound, str) else \
            "%s:%d" % tuple(bound[:2])
        print(f"serving on {where}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("interrupted - draining + saving")
    print(f"bridge stats: {server.stats}")
    if args.out:
        _finish(mapping, cfg, args, None)
    return 0


def cmd_publish(args):
    """Demo client: streams the synthetic scene to a `serve` process, the
    two-process live topology of the reference (publisher node -> mapping
    node, `kitti_publisher/scripts/publisher.py:15-71`).  It owns no map
    and touches no device."""
    import dataclasses
    import json as _json

    from .io import synthetic
    from .io.bridge import MappingClient
    from . import kitti_config

    cfg = kitti_config()
    cam_overrides = {k: getattr(args, k) for k in
                     ("width", "height", "fx", "fy", "cx", "cy")
                     if getattr(args, k, None) is not None}
    if cam_overrides:
        cfg = dataclasses.replace(
            cfg, camera=dataclasses.replace(cfg.camera, **cam_overrides))
    scene = synthetic.default_scene()
    poses = (synthetic.loop_trajectory(args.frames, radius=10.0) if args.loop
             else synthetic.forward_trajectory(args.frames, step=0.4))
    address = args.socket if args.socket else (args.host, args.port)
    t_last = 0.0
    with MappingClient(address) as client:
        for i, pose in enumerate(poses):
            img, dep = scene.render(cfg, pose)
            stamp = i / max(args.rate, 1e-9) if args.rate > 0 else float(i)
            client.publish_pose(stamp, pose,
                                is_keyframe=(i % args.kf_every == 0))
            if args.stereo:
                rp = np.array(pose, np.float64).copy()
                rp[:3, 3] += rp[:3, 0] * args.baseline
                rimg, _ = scene.render(cfg, rp)
                client.publish_stereo(stamp, img, rimg)
            else:
                client.publish_image(stamp, img)
                client.publish_depth(stamp, dep)
            t_last = _throttle(args.rate, t_last)
        print("metrics:", _json.dumps(
            {k: round(float(v), 3) for k, v in
             client.metrics()["metrics"].items()}))
        if args.save:
            print("saved:", client.save_map(args.save, what="mesh"))
        if args.shutdown:
            print("shutdown:", client.shutdown())
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="densesurfelmapping_tpu_torch",
        description="Dense surfel mapping on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--out", default="", help="output path prefix")
        p.add_argument("--rate", type=float, default=0.0,
                       help="throttle input to N Hz (0 = as fast as possible;"
                            " the reference publisher used 5)")
        p.add_argument("--kf-every", type=int, default=1,
                       help="keyframe every N frames")
        p.add_argument("--profile", choices=("drive", "rgbd", "mono"),
                       default="drive")
        p.add_argument("--camera-json", default="",
                       help="full SurfelMapConfig JSON (overrides --profile)")
        p.add_argument("--capacity-log2", type=int, default=21,
                       help="surfel bank capacity (2^N rows). The default "
                            "driver keeps every surfel in HBM: budget "
                            "~300 net live surfels per KITTI frame "
                            "(2^21 = 75 MB covers a full sequence)")
        for name, typ in (("width", int), ("height", int), ("fx", float),
                          ("fy", float), ("cx", float), ("cy", float)):
            p.add_argument(f"--{name}", type=typ, default=None,
                           help=f"camera {name} override")
        p.add_argument("--kitti-alignment", action="store_true",
                       help="apply the reference's KITTI axis alignment "
                            "(surfel_map.cpp:214-232)")
        p.add_argument("--host-pool", action="store_true",
                       help="use the host-pool migration driver instead of "
                            "the device-resident window-mask driver")
        p.add_argument("--pipelined", action="store_true",
                       help="overlap each frame's host pack with the "
                            "previous frame's dispatch (one-frame feed "
                            "lag, identical map; device-resident driver "
                            "only)")
        p.add_argument("--trace", default="",
                       help="write a torch.profiler Chrome trace of the run "
                            "to this directory (chrome://tracing, Perfetto)")
        p.add_argument("--device", default="cuda",
                       help="device the map lives and fuses on (cuda raises "
                            "without a CUDA card; cpu runs the plain "
                            "PyTorch paths)")
        p.add_argument("--publish-every", type=int, default=0,
                       help="streaming export: write <out>_live.pcd + camera"
                            " markers + a numbered snapshot every N fused "
                            "frames (the reference's rviz publish cadence, "
                            "surfel_map.cpp:188-198); costs one device->host"
                            " transfer per period")

    def stereo_post_opts(p):
        p.add_argument("--no-post-median", action="store_true",
                       help="disable the median/speckle disparity "
                            "post-filter on --stereo depth (A/B the "
                            "fidelity effect; BASELINE.md row)")
        p.add_argument("--occlusion-fill", action="store_true",
                       help="enable the scanline background-propagating "
                            "occlusion fill on --stereo depth (default "
                            "off: measured a net map-level loss, "
                            "BASELINE.md round-4 row; useful for dense "
                            "depth-map consumers)")
        p.add_argument("--hier", action="store_true",
                       help="hierarchical (coarse-to-fine) SGM: half-res "
                            "solve + band-limited full-res census refine "
                            "(~4x less aggregation work; A/B in "
                            "BASELINE.md round 4)")
        p.add_argument("--prior-rescue", action="store_true",
                       help="map-guided stereo: render the live surfel "
                            "bank into the camera inside the fuse program "
                            "and accept LR/uniqueness-rejected matches "
                            "that agree with the map (ops/render.py; "
                            "cross-frame evidence for occlusion bands and "
                            "periodic texture)")

    p = sub.add_parser("synthetic", help="procedural scene demo/benchmark")
    common(p)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--loop", action="store_true",
                   help="closed-loop trajectory")
    p.add_argument("--eval", action="store_true",
                   help="score the final map against ground-truth depth "
                        "(rendered-map coverage/MAE/inliers)")
    p.add_argument("--stereo", action="store_true",
                   help="render a right view and compute depth on-device "
                        "inside the fuse program (stereo-resident demo); "
                        "--eval then scores the stereo pipeline against "
                        "the ground-truth depth")
    p.add_argument("--baseline", type=float, default=0.54,
                   help="stereo baseline in m for --stereo (KITTI: 0.54)")
    p.add_argument("--sgm", action="store_true",
                   help="semi-global aggregation for --stereo")
    p.add_argument("--max-disparity", type=int, default=128)
    p.add_argument("--dirty", action="store_true",
                   help="inject real-data defects (sensor noise, exposure "
                        "drift, disparity-domain depth noise, outlier "
                        "bursts, dropout; io/synthetic.DirtModel) — --eval "
                        "still scores against CLEAN ground truth")
    stereo_post_opts(p)
    p.set_defaults(fn=cmd_synthetic)

    p = sub.add_parser("kitti", help="KITTI odometry sequence replay")
    common(p)
    p.add_argument("--root", required=True,
                   help="sequence dir with image_0/ depth_0/")
    p.add_argument("--seq", type=int, default=0)
    p.add_argument("--poses", default="",
                   help="KITTI poses txt (default <root>/poses.txt)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--stereo", action="store_true",
                   help="compute depth on-device from image_0/image_1 "
                        "(block matching) instead of loading depth_0/*.npy")
    p.add_argument("--max-disparity", type=int, default=128)
    p.add_argument("--sgm", action="store_true",
                   help="semi-global aggregation for --stereo (denser "
                        "matches on weak texture)")
    p.add_argument("--no-depth-filter", action="store_true",
                   help="skip the median/flying-pixel post-filter on "
                        "stereo depth")
    stereo_post_opts(p)
    p.set_defaults(fn=cmd_kitti)

    p = sub.add_parser("stress", help="seq-00-scale loop-closure stress run "
                                      "(drift, edge bursts, mid-run warp)")
    common(p)
    p.add_argument("--stereo", action="store_true",
                   help="stereo-resident mode: render the right view and "
                        "compute depth on-device inside the fuse program")
    p.add_argument("--sgm", action="store_true",
                   help="SGM aggregation for --stereo")
    stereo_post_opts(p)
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--radius", type=float, default=60.0,
                   help="circuit radius in meters (60 ~ a KITTI block)")
    p.add_argument("--dirty", action="store_true",
                   help="dirty twin: DirtModel defects on every fed frame "
                        "plus a moving box crossing the circuit; fidelity "
                        "is scored against the CLEAN static world, so the "
                        "gap to the clean twin measures the outlier gates")
    p.set_defaults(fn=cmd_stress, kf_every=2)

    p = sub.add_parser("tum", help="TUM RGB-D sequence (rgbd profile)")
    common(p)
    p.add_argument("--root", required=True,
                   help="TUM sequence dir (rgb.txt/depth.txt/groundtruth.txt)")
    p.add_argument("--max-frames", type=int, default=0)
    p.set_defaults(fn=cmd_tum, profile="rgbd")

    p = sub.add_parser("replay", help="replay a recorded pose feed (npz/TUM)")
    common(p)
    p.add_argument("--feed", required=True, help="PoseFeed npz or TUM txt")
    p.add_argument("--root", default="", help="optional KITTI frame source")
    p.add_argument("--seq", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("multi", help="multi-session serving demo "
                                     "(B streams, one batched pass/round)")
    common(p)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--stereo", action="store_true",
                   help="serve raw stereo pairs: depth computed on-device "
                        "for every stream (KITTI baseline)")
    p.add_argument("--sgm", action="store_true",
                   help="semi-global aggregation for --stereo")
    stereo_post_opts(p)
    p.set_defaults(fn=cmd_multi)

    def bridge_addr(p):
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=7135)
        p.add_argument("--socket", default="",
                       help="unix-domain socket path (overrides host/port)")

    p = sub.add_parser("serve", help="live mapping server over the socket "
                       "bridge (the reference's ros_node as a service)")
    common(p)
    bridge_addr(p)
    p.add_argument("--queue-depth", type=int, default=256,
                   help="ingest queue bound; oldest frames drop when full "
                        "(ros_node.cpp:24-31 queue semantics)")
    p.add_argument("--stereo", action="store_true",
                   help="expect stereo pairs; depth computed on-device")
    p.add_argument("--baseline", type=float, default=0.54)
    p.add_argument("--sgm", action="store_true")
    p.add_argument("--max-disparity", type=int, default=128)
    stereo_post_opts(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("publish", help="demo client: stream the synthetic "
                       "scene to a `serve` process")
    bridge_addr(p)
    for name, typ in (("width", int), ("height", int), ("fx", float),
                      ("fy", float), ("cx", float), ("cy", float)):
        p.add_argument(f"--{name}", type=typ, default=None,
                       help=f"camera {name} override (match the server's)")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--rate", type=float, default=0.0)
    p.add_argument("--kf-every", type=int, default=1)
    p.add_argument("--loop", action="store_true")
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--baseline", type=float, default=0.54)
    p.add_argument("--save", default="", help="ask the server to save a "
                   "mesh here when done (the save_map topic)")
    p.add_argument("--shutdown", action="store_true",
                   help="request server shutdown when done")
    p.set_defaults(fn=cmd_publish)

    args = ap.parse_args(argv)
    if getattr(args, "trace", ""):
        from .utils.timing import device_trace
        with device_trace(args.trace):
            return args.fn(args) or 0
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
