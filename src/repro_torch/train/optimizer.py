"""Optimizers (AdamW / SGD-momentum / Adafactor) as update rules over a
mapping of parameters, the JAX package's ``train/optimizer.py`` on the
port.

The parameters are a flat mapping ``{name: tensor}`` (a model's
state-dict names, :func:`repro_torch.train.step.param_dict`), and the
state holds plain tensors keyed like them: ``step`` (int32, 0-dim) and
``mu``/``nu`` (AdamW), ``mu`` (SGD) or ``v`` (Adafactor: ``{"row",
"col"}`` for a parameter of two or more dimensions, ``{"full"}`` else),
all in ``state_dtype``.  With DTensor parameters ``step`` is replicated
and AdamW's and SGD's moments take each parameter's placements, so the
update runs on local shards; Adafactor's factored moments are plain.  The rules are the reference's: AdamW's weight
decay applies to every parameter, norms included; the bias corrections
are in fp32; each update is computed in fp32 and cast to the parameter's
dtype.

:meth:`Optimizer.update` runs under ``torch.no_grad()`` and writes the
new parameters and state into the tensors it was given, then returns
them: the reference's trainer donates both (``donate_argnums=(0, 1)``),
so no caller holds the old values.

One difference follows from the layouts, not the rules: the JAX package
stacks a segment's layers on a leading axis, so its Adafactor factors a
stacked norm scale (layers, d) as a matrix and clips each update's RMS
over all layers at once; the port holds one tensor a layer, as a layer's
own parameters are factored and clipped.  On a tree of the same leaves
the two give the same numbers (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Union

import torch

from repro_torch.distributed.api import replicated_like

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0
    momentum: float = 0.9  # sgd
    # adafactor
    decay_rate: float = 0.8
    state_dtype = torch.float32


def _lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    lr = cfg.learning_rate
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32,
                                                      device=step.device)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


class Optimizer:
    """Bundles init/update over a mapping of parameters."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        cfg = self.cfg
        first = next(iter(params.values()))
        step = replicated_like(torch.zeros((), dtype=torch.int32, device=first.device), first)

        def zeros(p, shape=None):
            if shape is None:  # a DTensor parameter's moments take its placements
                return torch.zeros_like(p, dtype=cfg.state_dtype)
            return torch.zeros(shape, dtype=cfg.state_dtype, device=p.device)

        if cfg.name == "adamw":
            return {"step": step, "mu": {k: zeros(p) for k, p in params.items()},
                    "nu": {k: zeros(p) for k, p in params.items()}}
        if cfg.name == "sgd":
            return {"step": step, "mu": {k: zeros(p) for k, p in params.items()}}
        if cfg.name == "adafactor":
            def factored(p):
                if p.dim() >= 2:
                    return {"row": zeros(p, p.shape[:-1]),
                            "col": zeros(p, p.shape[:-2] + p.shape[-1:])}
                return {"full": zeros(p)}

            return {"step": step, "v": {k: factored(p) for k, p in params.items()}}
        raise ValueError(cfg.name)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict, params: Params):
        """One step: returns ``(params, state, {"lr", "grad_norm"})``, the
        first two being the given mappings with their tensors updated in
        place (``grad_norm`` is None without clipping)."""
        cfg = self.cfg
        state["step"].add_(1)
        step = state["step"]
        lr = _lr_at(cfg, step)
        grad_norm = None
        if cfg.grad_clip_norm is not None:
            grads, grad_norm = clip_by_global_norm(grads, cfg.grad_clip_norm)

        if cfg.name == "adamw":
            stepf = step.float()
            bc1 = 1.0 - torch.pow(cfg.b1, stepf)
            bc2 = 1.0 - torch.pow(cfg.b2, stepf)
            for k, p in params.items():
                gf, mu, nu = grads[k].float(), state["mu"][k], state["nu"][k]
                mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * gf)
                nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * gf.square())
                pf = p.float()
                delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) + cfg.weight_decay * pf
                p.copy_((pf - lr * delta).to(p.dtype))
        elif cfg.name == "sgd":
            for k, p in params.items():
                mu = state["mu"][k]
                mu.copy_(cfg.momentum * mu + grads[k].float())
                p.copy_((p.float() - lr * mu).to(p.dtype))
        elif cfg.name == "adafactor":
            decay = 1.0 - torch.pow(step.float(), -cfg.decay_rate)
            for k, p in params.items():
                gf, v = grads[k].float(), state["v"][k]
                g2 = gf.square() + 1e-30
                if p.dim() >= 2:
                    v["row"].copy_(decay * v["row"] + (1 - decay) * g2.mean(dim=-1))
                    v["col"].copy_(decay * v["col"] + (1 - decay) * g2.mean(dim=-2))
                    row_mean = v["row"].mean(dim=-1, keepdim=True)
                    r = (v["row"] / row_mean.clamp_min(1e-30))[..., None]
                    vhat = r * v["col"][..., None, :]
                else:
                    v["full"].copy_(decay * v["full"] + (1 - decay) * g2)
                    vhat = v["full"]
                update = gf * torch.rsqrt(vhat + 1e-30)
                # relative step clipping
                rms = torch.sqrt(update.square().mean())
                update = update / rms.clamp_min(1.0)
                pf = p.float()
                p.copy_((pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype))
        else:
            raise ValueError(cfg.name)
        return params, state, {"lr": lr, "grad_norm": grad_norm}


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(1, warmup), max=1.0)
        progress = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * progress))
        return base_lr * warm * (min_ratio + (1 - min_ratio) * cos)

    return fn
