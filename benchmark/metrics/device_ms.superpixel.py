"""Device ms a fused frame in the step's `superpixel` phase, from its stamp
to the next: the SLIC superpixels (B1-B3), with the frame's unpack from
the replay's start stamp; over the program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "superpixel")
