"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and there is no card. The port never carries on on the CPU in place
    of a card that was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
