"""Device ms a fused frame in the step's `stereo_wta` phase, from its stamp
to the next: the matcher's WTA, gates and post-filters; over the program's
traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "stereo_wta")
