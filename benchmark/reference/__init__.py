"""Plain references of the port's networks, one module a test
(``<test>.py``, or the name a traffic file gives under ``reference``).

Plain PyTorch and numpy only: nothing here imports the port, jax or the
JAX package, and nothing takes a weight, table or statistic that the port
made.  Each module's ``network(table, params, dtype)`` works the network
out again from the table as the benchmark made it, on the table's device,
in ``dtype`` (float64; float32 is the control, TF32 off)."""
