"""Share of the traced body in which no operation ran on the device (the
union of the profiler's device records), in %."""


def read(run):
    if run.view is None or run.view.window_s <= 0 \
            or run.view.n_records == 0:
        return None
    return 100.0 * run.view.idle_share
