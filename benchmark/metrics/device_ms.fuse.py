"""Device ms a fused frame in the step's `fuse` phase, from its stamp to the
next: the association and weighted fusion (`fusion.fuse_surfels`); over
the program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "fuse")
