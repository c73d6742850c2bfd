"""Device resolution for the PyTorch port.

Every entry point takes an explicit ``device``.  ``"cuda"`` (the default of
the public API) requires a visible CUDA device and raises otherwise: the
port never falls back to the CPU on its own.  The CPU runs only when the
caller asks for it (``device="cpu"``), which is how the CPU tests hold the
port against the JAX package.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device`` after checking it exists.

    Raises RuntimeError for a CUDA device when CUDA is not available or the
    index is out of range, and ValueError for device types the port does
    not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev

