"""Host ms a fused frame in the driver's `pack` stage: the frame, pose,
index and window mask packed into one payload (`core.state`), over the
program's traced window."""

from benchmark import window


def read(run):
    return window.reading("host_ms", "pack")
