# Frozen copy of youreditableavatar_tpu_torch/utils/device.py (the plain PyTorch path only).
"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    Raises if a CUDA device is asked for (or defaulted to) and none is
    present — work never moves to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
