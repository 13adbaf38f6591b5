"""The program's own traced window (`densesurfelmapping_tpu_torch.utils.
timing.last_window`): what the port's spans, stamps and counters read over
the profiled part of a traced run, per fused frame.  None where the run
opened no window, or where the program has no such tracer."""


def last():
    from densesurfelmapping_tpu_torch.utils import timing
    read = getattr(timing, "last_window", None)
    return read() if read is not None else None


def reading(section: str, key: str):
    """last()[section][key], or None where either is missing."""
    w = last()
    return None if w is None else w.get(section, {}).get(key)
