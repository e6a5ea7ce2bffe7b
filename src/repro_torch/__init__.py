"""PyTorch/CUDA port of the OLAF reproduction (``repro``), for an NVIDIA H100.

Imports ``torch`` and numpy, never ``jax`` or ``repro``. Entry points take
an explicit ``device`` (default ``"cuda"``) and raise when no card is
present unless the caller asks for ``"cpu"``; see :mod:`repro_torch.device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
