"""Per layer (device): 100 x (1 - the union of the device's kernels,
copies and memsets / the traced window)."""


def read(run):
    if run.trace is None or run.trace.window_seconds() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds()
                    / run.trace.window_seconds())
