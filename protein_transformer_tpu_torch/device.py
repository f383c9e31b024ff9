"""Device selection. Every function of the port takes its device explicitly;
nothing here sets a global default."""
from __future__ import annotations

import torch


def cuda_device(index: int | None = None) -> torch.device:
    """CUDA device ``index`` (a rank's card,
    ``parallel.distributed.local_device_index``), by default the current
    one. Raises when no GPU is present: callers that want the CPU pass
    ``torch.device("cpu")`` themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if index is None:
        index = torch.cuda.current_device()
    return torch.device("cuda", index)
