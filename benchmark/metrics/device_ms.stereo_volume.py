"""Device ms a fused frame in the step's `stereo_volume` phase, from its
stamp to the next: on the matcher's materialized route, the stereo step's
unpack, the census images and the (D', H, W) bf16 census volume; over the
program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "stereo_volume")
