"""Per layer (host runtime): host seconds inside the port's spans
``gc:0``, ``gc:1`` and ``gc:2`` (the Python collector's pauses inside the
program's ``LGL`` call, by generation), a network of the traced window."""

SPANS = ("gc:0", "gc:1", "gc:2")


def read(run):
    if run.trace is None or not run.networks:
        return None
    s = sum(run.trace.range_seconds(name) for name in SPANS)
    return s / run.networks if s > 0 else None
