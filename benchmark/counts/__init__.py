"""The work of each hand kernel a network needs, one module a kernel.

Each module names the kernel as the trace shows it (``KERNEL``, a part of
its name), the port's counter of its launches (``COUNTER``, a key of
``flashweave_tpu_torch.ops.kernels.launch_counts()``), and
``work(facts)`` gives one network's operations and bytes: ``{"ops": ...,
"peak": <key of peaks.json> or None, "bytes": ...}``.  ``facts`` holds
the table's shape (``n``, ``p``, ``levels``), the first table on the host
(``table``) and the reference's counts of the pairs (``reference``:
``pairs``, ``powered``, ``reliable``, ``candidates``).  The counts are of
what the inputs need, whatever kernel does the work: operations at the
matching published peak, each input byte read once and each output byte
written once."""
