"""The plane-fit kernel (`planefit_kernel`, `ops/cuda/planefit.py`) against
its roofline: the least time the work of its runs in the traced body needs
(`planefit_work`), over the time the profiler's records of that kernel
took, in %.  A checkout whose plane fit has no such kernel reads None."""

import json

from benchmark import roofline
from benchmark.reference.config import SurfelMapConfig

KERNEL = "planefit_kernel"
# f32 operations, whatever implements the fit, each counted once though four
# seeds' windows hold a pixel: at every pixel of the raw image, its gates in
# its seed's window (membership, the squared distance to the centroid and
# its max, the depth test, the Huber residual and its two tests); at each
# Huber inlier, its back-projection, its pixel normal (two neighbours
# back-projected, two differences, the cross product, its length and
# division, the view-angle gate) and its share of the point and normal sums;
# at each inlier of a seed that passes the gates, five Gauss-Newton steps
# (the residual, the Huber weight, the 4 gradient and 10 Hessian terms)
GATE_OPS = 12
INLIER_OPS = 68
GN_STEP_OPS = 42
GN_STEPS = 5
# the shares of the raw image's pixels that are Huber inliers, and inliers
# of a fitted seed, over the first 600 frames each cell feeds (NVIDIA H100,
# PERF.md section 3): the lowest of the three cells, so that no cell's need
# is counted above the work its frames bring
INLIER_SHARE = 0.57
FIT_SHARE = 0.46
# seed fields read (x, y, mean depth, normal, position, view cosine, size)
# and written (normal, position, mean depth, view cosine, size), in floats
SEED_READ, SEED_WRITTEN = 11, 9


def planefit_work(height: int, width: int, n_seeds: int) -> tuple:
    """(bytes, operations) of one plane fit over a height x width image
    with n_seeds seeds (the padded grid's, every one read and written): the
    image's depth and assignment read once, the seed fields read and
    written once, and the operations above at the shares above."""
    hw = height * width
    nbytes = 2 * hw * 4 + n_seeds * (SEED_READ + SEED_WRITTEN) * 4
    ops = hw * (GATE_OPS + INLIER_SHARE * INLIER_OPS
                + FIT_SHARE * GN_STEPS * GN_STEP_OPS)
    return nbytes, ops


def read(run):
    pk = roofline.peak(run.device_name)
    if run.view is None or pk is None:
        return None
    seen = run.view.kernel(KERNEL)
    if not seen[0]:
        return None
    cfg = SurfelMapConfig.from_json(json.dumps(run.config["mapper"]))
    work = planefit_work(cfg.height, cfg.width, cfg.num_seeds)
    return roofline.share({KERNEL: seen}, {KERNEL: work}, pk)
