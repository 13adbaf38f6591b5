"""The SLIC kernels B1-B3 (`ops/cuda/slic.py`) against their roofline: the
least time the work of their runs in the traced body needs (bytes of the
padded frame and the seed grid, each read once and written once, at the
card's memory rate; `roofline.slic_work`), over the time the profiler's
records of those kernels took, in %."""

from benchmark import roofline

KERNELS = {"slic_assign": "slic_assign_kernel",
           "slic_centroid": "slic_centroid_kernel",
           "slic_huber": "slic_huber_kernel"}


def read(run):
    pk = roofline.peak(run.device_name)
    if run.view is None or pk is None:
        return None
    m = run.config["mapper"]
    sp = m["sp_size"]
    lh = m["sublane_align"] * sp // _gcd(m["sublane_align"], sp)
    lw = m["lane_align"] * sp // _gcd(m["lane_align"], sp)
    ph = -(-m["camera"]["height"] // lh) * lh
    pw = -(-m["camera"]["width"] // lw) * lw
    work = roofline.slic_work(ph, pw, (ph // sp) * (pw // sp))
    seen = {k: run.view.kernel(name) for k, name in KERNELS.items()}
    seen = {k: v for k, v in seen.items() if v[0]}
    return roofline.share(seen, work, pk) if seen else None


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a
