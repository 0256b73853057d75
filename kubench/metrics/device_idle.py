"""device_idle (%, lower is better; device trace), layer: the device. The
share of the traced window in which no kernel, copy or set runs on the
card (the union of the profiler's device intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
