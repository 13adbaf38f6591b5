"""Host ms a frame inside the driver's feed calls (`feed_pose`, then
`feed_image` + `feed_depth` or `feed_stereo`), the benchmark's own spans,
over the window's untraced part.  It holds what the program's StageTimer
leaves out, `feed_pose`'s loop-path pass among it."""


def read(run):
    if not run.feed_s:
        return None
    return 1e3 * sum(run.feed_s) / len(run.feed_s)
