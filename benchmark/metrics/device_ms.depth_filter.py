"""Device ms a fused frame in the step's `depth_filter` phase, from its stamp
to the next: disparity to depth and the depth filter
(`depthfilter.clean_depth`); over the program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "depth_filter")
