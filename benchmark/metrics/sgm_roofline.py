"""The census SGM kernels B5 and B6 (`ops/cuda/sgm.py`) against their
roofline: the least time the work of their runs in the traced body needs
(`roofline.sgm_work`: the census images read once, the f32 aggregate
planes written once, at the card's memory rate), over the time the
profiler's records of those kernels took, in %."""

from benchmark import roofline

KERNELS = {"census_x": "census_x_kernel", "census_y": "census_y_kernel"}


def read(run):
    pk = roofline.peak(run.device_name)
    st = run.config.get("stereo")
    if run.view is None or pk is None or not st:
        return None
    cam = run.config["mapper"]["camera"]
    n_d = st["max_disparity"] - st.get("min_disparity", 1)
    v_paths = 3 if st.get("sgm_paths", 8) == 8 else 1
    work = roofline.sgm_work(cam["height"], cam["width"], n_d, v_paths)
    seen = {k: run.view.kernel(name) for k, name in KERNELS.items()}
    seen = {k: v for k, v in seen.items() if v[0]}
    return roofline.share(seen, work, pk) if seen else None
