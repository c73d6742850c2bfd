"""Per layer (univariate pass): host seconds inside the port's profiler
range ``uv_fill`` (the grouped dict fill of the significant pairs), a
network of the traced window."""


def read(run):
    if run.trace is None or not run.networks:
        return None
    s = run.trace.range_seconds("uv_fill")
    return s / run.networks if s > 0 else None
