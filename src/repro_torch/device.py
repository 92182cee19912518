"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


class NoCudaCardError(RuntimeError):
    """CUDA was asked for on a machine without a card."""


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked
    for the CPU.  Asking for CUDA on a machine without a card raises;
    nothing carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaCardError(
            "no CUDA card: torch.cuda.is_available() is False; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
