"""Per layer (prepare): host seconds inside the port's span
``prep_convert`` (the table's cast on the host: the float64 copy of a
continuous table, the int8 cast of a discrete one of a type the device
cannot compare), a network of the traced window.  The collector's pauses
inside it count too (``gc_s`` gives them apart)."""


def read(run):
    if run.trace is None or not run.networks:
        return None
    s = run.trace.range_seconds("prep_convert")
    return s / run.networks if s > 0 else None
