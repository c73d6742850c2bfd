"""Per layer (graph assembly): host seconds inside the port's span
``asm_collect`` (the graph assembly's walk over the neighbour dicts into
its edge lists), a network of the traced window.  The collector's pauses
inside it count too (``gc_s`` gives them apart)."""


def read(run):
    if run.trace is None or not run.networks:
        return None
    s = run.trace.range_seconds("asm_collect")
    return s / run.networks if s > 0 else None
