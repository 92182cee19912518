"""Normalization layers (RMSNorm / LayerNorm), computed in fp32 and cast
back to the input dtype."""
from __future__ import annotations

import torch

from repro_torch.nn import initializers as init


def rmsnorm_init(d: int, generator=None, dtype=torch.float32):
    return {"scale": init.ones(generator, (d,), dtype)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, generator=None, dtype=torch.float32):
    return {"scale": init.ones(generator, (d,), dtype),
            "bias": init.zeros(generator, (d,), dtype)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


NORM_INIT = {"rmsnorm": rmsnorm_init, "layernorm": layernorm_init}
NORM_APPLY = {"rmsnorm": rmsnorm_apply, "layernorm": layernorm_apply}
