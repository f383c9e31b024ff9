"""Device selection. Every function of the port takes its device explicitly;
nothing here sets a global default."""
from __future__ import annotations

import torch


def cuda_device() -> torch.device:
    """The current CUDA device. Raises when no GPU is present: callers that
    want the CPU pass ``torch.device("cpu")`` themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())
