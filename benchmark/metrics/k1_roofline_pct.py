"""Per layer (kernels): K1's share of its roofline (``counts/k1.py``)
over its launches in the traced window."""

from benchmark.record import roofline_pct


def read(run):
    return roofline_pct(run, "k1")
