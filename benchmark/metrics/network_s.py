"""End to end: the host seconds of the window's calls over their count,
each call from the table on the host to the returned network."""


def read(run):
    return run.window_s / run.networks if run.networks else None
