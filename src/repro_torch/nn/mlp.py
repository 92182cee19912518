"""Feed-forward blocks: SwiGLU / GELU / squared-ReLU / ReLU variants."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers as init
from repro_torch.nn.types import P


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "silu": F.silu,
    # the JAX package's gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "squared_relu": squared_relu,
    "identity": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"
    gated: bool = True  # SwiGLU-style gate when True
    use_bias: bool = False


def mlp_init(cfg: MLPConfig, generator=None, dtype=torch.float32):
    params = {
        "w_up": P(init.scaled_normal(generator, (cfg.d_model, cfg.d_ff), dtype),
                  ("embed", "mlp")),
        "w_down": P(init.scaled_normal(generator, (cfg.d_ff, cfg.d_model), dtype,
                                       fan_in=cfg.d_ff), ("mlp", "embed")),
    }
    if cfg.gated:
        params["w_gate"] = P(init.scaled_normal(generator, (cfg.d_model, cfg.d_ff), dtype),
                             ("embed", "mlp"))
    if cfg.use_bias:
        params["b_up"] = P(init.zeros(generator, (cfg.d_ff,), dtype), ("mlp",))
        params["b_down"] = P(init.zeros(generator, (cfg.d_model,), dtype), ("embed",))
    return params


def mlp_apply(params, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    up = x @ params["w_up"]
    if cfg.use_bias:
        up = up + params["b_up"]
    h = act(x @ params["w_gate"]) * up if cfg.gated else act(up)
    out = h @ params["w_down"]
    if cfg.use_bias:
        out = out + params["b_down"]
    return out
