"""Where the port's entry points put the tensors they create."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` if given; else the CUDA device, which must be present.

    Entry points that create tensors run on the card unless the caller asks
    for another device (the CPU tests pass ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
