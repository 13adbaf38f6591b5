"""Device ms a fused frame in the step's `stereo_scan` phase, from its stamp
to the next: on the matcher's materialized route, the volume's two permuted
copies, B4's x family, its y family and their sum; over the program's
traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "stereo_scan")
