"""Device selection for the port's public entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
they raise rather than drop to the CPU; the CPU runs only when a caller
asks for it with ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.

    :raises RuntimeError: for a CUDA device when no card is available.
    :raises ValueError: for a device type other than ``cuda`` or ``cpu``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the host")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
