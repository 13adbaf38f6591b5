"""Device ms a fused frame in the step's `stereo_aggregate` phase, from its
stamp to the next: the stereo step's unpack, census and SGM aggregation
(B5, B6); over the program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "stereo_aggregate")
