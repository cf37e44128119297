"""The H100's published peaks, the card's power limit, and roofline shares.

Peaks are NVIDIA's data sheet for the H100 SXM5 (80 GB HBM3), dense rates
without sparsity, at the full power limit of 700 W. A card set below that
limit runs slower under load, so every share is reported with the limit
that ``nvidia-smi`` reads.

The bytes a kernel must move are counted from the inputs by the plain
reference (``reference/train.py``: ``k2_bytes``), never by the program.
"""

from __future__ import annotations

import subprocess

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "fp8_flops": 1979e12,
    "int8_ops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes": 80e9,
}


def power_limit_w() -> float | None:
    """The first card's power limit in watts, or None if unreadable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def bytes_roofline_pct(nbytes: float, device_s: float) -> float | None:
    """The least time for ``nbytes`` at the HBM peak, as a share of the
    measured device time (percent); None where nothing was measured."""
    if not nbytes or not device_s or device_s <= 0:
        return None
    return 100.0 * (nbytes / PEAKS["hbm_bytes_per_s"]) / device_s
