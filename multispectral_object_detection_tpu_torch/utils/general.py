"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def select_device(device=None) -> torch.device:
    """The torch device for an entry point: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for (explicitly or by default) and absent; the
    CPU is used only when the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev
