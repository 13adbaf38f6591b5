"""Host ms a fused frame in the driver's `loop_path` stage: `feed_pose`'s
pass over the whole keyframe path (`PoseGraph.update_loop_path`), over the
program's traced window."""

from benchmark import window


def read(run):
    return window.reading("host_ms", "loop_path")
