"""End to end: the device memory allocated at the peak of the window
(``torch.cuda.max_memory_allocated``, reset after the warm-up), GiB."""

from benchmark.record import GIB


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / GIB
