"""Per layer (kernels): K8's share of its roofline (``counts/k8.py``)
over its launches in the traced window."""

from benchmark.record import roofline_pct


def read(run):
    return roofline_pct(run, "k8")
