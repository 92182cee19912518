"""Normalization layers (RMSNorm / LayerNorm), computed in fp32 (float64
in a float64 forward) and cast back to the input dtype."""
from __future__ import annotations

import torch

from repro_torch.nn import initializers as init
from repro_torch.nn.types import P


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the port accumulates ``x`` in: fp32, or float64 when the
    forward runs in float64 (the reference forward a check holds an fp32
    one to)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its accumulation dtype (:func:`acc_dtype`)."""
    return x.to(acc_dtype(x))


def rmsnorm_init(d: int, generator=None, dtype=torch.float32):
    return {"scale": P(init.ones(generator, (d,), dtype), ("embed",))}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = acc(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * acc(params["scale"])).to(x.dtype)


def layernorm_init(d: int, generator=None, dtype=torch.float32):
    return {"scale": P(init.ones(generator, (d,), dtype), ("embed",)),
            "bias": P(init.zeros(generator, (d,), dtype), ("embed",))}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = acc(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * acc(params["scale"]) + acc(params["bias"])).to(x.dtype)


NORM_INIT = {"rmsnorm": rmsnorm_init, "layernorm": layernorm_init}
NORM_APPLY = {"rmsnorm": rmsnorm_apply, "layernorm": layernorm_apply}
