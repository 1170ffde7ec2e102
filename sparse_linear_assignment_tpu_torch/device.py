"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card (``"cuda"``).  A CUDA request on a
    machine without a CUDA device raises: the port never carries on
    on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU"
        )
    return dev
