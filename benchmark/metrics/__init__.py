"""One reader a metric of ``BENCHMARK.json``: ``read(run)`` (``run`` a
``record.Run``) returns the metric's value, or None where it finds
nothing to read."""
