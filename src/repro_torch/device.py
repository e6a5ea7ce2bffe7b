"""Device resolution for the port's entry points: no hidden fallback."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. Raises when it names CUDA and no
    card is present: the caller asks for ``"cpu"`` to run the plain
    PyTorch path, nothing switches to it silently."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available; pass device='cpu' for the CPU path")
    return dev
