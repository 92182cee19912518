"""Weight initializers, drawn from an explicit ``torch.Generator``.

Each draws on the generator's device.  ``generator=None`` makes a
shape-only placeholder on the meta device: that is how a model's
skeleton is laid out before its weights are drawn or loaded.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _empty(shape, dtype, generator):
    device = "meta" if generator is None else generator.device
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def normal(generator: Optional[torch.Generator], shape: Sequence[int],
           dtype=torch.float32, stddev: float = 0.02) -> torch.Tensor:
    out = _empty(shape, torch.float32, generator)
    if generator is not None:
        out.normal_(0.0, 1.0, generator=generator).mul_(stddev)
    return out.to(dtype)


def scaled_normal(generator: Optional[torch.Generator], shape: Sequence[int],
                  dtype=torch.float32, fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal truncated at +-2, scaled by 1/sqrt(fan_in) (default: first
    dim).  Sampled by inverting the CDF over the truncated range."""
    fan = fan_in if fan_in is not None else shape[0]
    std = (1.0 / max(1, fan)) ** 0.5
    out = _empty(shape, torch.float32, generator)
    if generator is not None:
        lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
        out.uniform_(lo, hi, generator=generator)
        out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
    return out.to(dtype)


def zeros(generator: Optional[torch.Generator], shape: Sequence[int],
          dtype=torch.float32) -> torch.Tensor:
    out = _empty(shape, dtype, generator)
    return out if generator is None else out.zero_()


def ones(generator: Optional[torch.Generator], shape: Sequence[int],
         dtype=torch.float32) -> torch.Tensor:
    out = _empty(shape, dtype, generator)
    return out if generator is None else out.fill_(1.0)
