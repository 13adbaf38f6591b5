"""The SGM kernel B4 (`ops/cuda/sgm.py`: `axis_scan` over a materialized
census volume) against its roofline: the least time the work of its calls
in the traced body needs, over the time the profiler's records of its
kernels took, in %.

A call scans one family: on the wide route (D' > 128) `scan_lines_kernel`
then `combine_axis_kernel`, on the narrow one `axis_line_kernel` (x family)
or `axis_band_kernel` (y family).  Its work is `roofline.sgm_work`'s
"axis_scan": the (D', H, W) bf16 volume read once and the f32 family
written once, at the card's memory rate.  The wide route's f32 scratch is
no part of that work, so a kernel that drops it is held to the same need.
None where no B4 kernel ran (the fused route, B5 and B6)."""

from benchmark import roofline

# one record of each of these ends a call
CALLS = ("combine_axis_kernel", "axis_line_kernel", "axis_band_kernel")
KERNELS = CALLS + ("scan_lines_kernel",)


def read(run):
    pk = roofline.peak(run.device_name)
    st = run.config.get("stereo")
    if run.view is None or pk is None or not st:
        return None
    calls = sum(run.view.kernel(name)[0] for name in CALLS)
    secs = sum(run.view.kernel(name)[1] for name in KERNELS)
    if not calls:
        return None
    cam = run.config["mapper"]["camera"]
    n_d = st["max_disparity"] - st.get("min_disparity", 1)
    v_paths = 3 if st.get("sgm_paths", 8) == 8 else 1
    work = roofline.sgm_work(cam["height"], cam["width"], n_d, v_paths)
    return roofline.share({"axis_scan": (calls, secs)}, work, pk)
