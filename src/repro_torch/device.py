"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda`` and raises when no CUDA device is
present; ``device="cpu"`` runs every layer, host- or device-placed, on
CPU tensors (the tests' mode).  There is no silent fallback.
"""

from __future__ import annotations

import torch

HOST = torch.device("cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a name or ``torch.device`` -> itself, CUDA
    devices with their index filled in.  Raises ``RuntimeError`` when a
    CUDA device is asked for (explicitly or by default) and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on CPU tensors"
        )
    # an explicit index, so it compares equal to a tensor's .device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch.device("cuda", index)
