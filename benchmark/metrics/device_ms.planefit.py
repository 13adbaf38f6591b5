"""Device ms a fused frame in the step's `planefit` phase, from its stamp to
the next: the per-seed plane fit (`normals.compute_seed_planes`); over the
program's traced window."""

from benchmark import window


def read(run):
    return window.reading("device_ms", "planefit")
