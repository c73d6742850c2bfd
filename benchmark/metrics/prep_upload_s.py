"""Per layer (prepare): host seconds inside the port's span
``prep_upload`` (the table's copy from the host to the device), a network
of the traced window.  The collector's pauses inside it count too
(``gc_s`` gives them apart)."""


def read(run):
    if run.trace is None or not run.networks:
        return None
    s = run.trace.range_seconds("prep_upload")
    return s / run.networks if s > 0 else None
