"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity, at the card's full power limit), keyed by a part of the name
``torch.cuda.get_device_name()`` gives. NVIDIA H100 SXM data sheet: 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35
TB/s of HBM3."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_of(device_name: str) -> Optional[dict]:
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"not read"``."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else "not read"
