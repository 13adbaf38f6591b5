"""Frames fused, divided by the window's seconds; the window closes when
the device has finished the work, not when it was enqueued (one
synchronize at its end)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.frames / run.window_s
