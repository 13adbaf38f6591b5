"""Device ms a fused frame in the step's `append` phase, from its stamp to
the next: the new surfels' extraction and tail append, and the step's
stats; over the program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "append")
