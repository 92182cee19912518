"""Train / serve step factories, the JAX package's ``train/step.py`` on
the port.

A step is a function of an explicit mapping of parameters, ``{name:
tensor}`` keyed by the model's state-dict names (:func:`param_dict`), run
through the model with ``torch.func.functional_call``: the model's own
parameters stay frozen (``requires_grad=False``), so evaluation and
serving build no autograd graph, while a train step differentiates with
respect to the mapping it was given.

``make_train_step`` builds ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, with optional microbatch gradient accumulation
(fp32 gradients summed over the microbatches and divided by their number,
as the reference's ``lax.scan`` does) and gradient compression with error
feedback.  Model-family differences (decoder-only / enc-dec / vlm-prefix)
are absorbed by ``model_forward`` keyed on the batch contents.

The parameters may be DTensors on a mesh (``launch/train.py --mesh``, run
inside :func:`repro_torch.distributed.api.sharding_context`): gradients,
the microbatch accumulator and the optimizer's state take each
parameter's placements, so every update stays on local shards.

Training runs each sub-block's ``impl`` as its spec says; the JAX package
trains on ``impl="xla"`` (every config's default), since its Pallas
kernels have no gradient, and the port's CUDA kernels are forward-only
likewise (their wrappers refuse an input that needs a gradient).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from repro_torch.distributed.api import placed_like, replicate
from repro_torch.train.loss import chunked_cross_entropy, cross_entropy, shift_labels
from repro_torch.train.optimizer import Optimizer

Params = Dict[str, torch.Tensor]


def param_dict(model: nn.Module) -> Params:
    """The model's parameters by state-dict name, detached: the tensors
    share the module's storage, so an optimizer's in-place update trains
    the module too."""
    return {name: p.detach() for name, p in model.named_parameters()}


class _Method(nn.Module):
    """``model.<method>`` as a module's forward, so that
    ``functional_call`` can run any of the model's methods."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def call(model: nn.Module, params: Mapping[str, torch.Tensor], method: str, *args, **kwargs):
    """``model.<method>(*args, **kwargs)`` with ``params`` in place of the
    model's own parameters."""
    return torch.func.functional_call(
        _Method(model, method), {f"model.{k}": v for k, v in params.items()}, args, kwargs)


def model_forward(model, params, batch):
    """Dispatch on batch keys: tokens / frames (enc-dec) / patch_embeds."""
    if "frames" in batch:
        enc_out = call(model, params, "encode", batch["frames"])
        return call(model, params, "forward", batch["tokens"], enc_out=enc_out)
    if "patch_embeds" in batch:
        return call(model, params, "forward", batch["tokens"],
                    prefix_embeds=batch["patch_embeds"])
    return call(model, params, "forward", batch["tokens"])


def make_loss_fn(model, loss_chunk: int = 0):
    """loss_chunk > 0 selects the chunked-logits path (the logits are
    computed ``loss_chunk`` positions at a time from the final hidden
    states and the head's weight)."""

    def loss_fn(params, batch):
        if "labels" in batch:
            labels, mask = batch["labels"], batch.get("loss_mask")
        else:
            labels, mask = shift_labels(batch["tokens"])
        if loss_chunk and "frames" not in batch:
            kwargs = {}
            if "patch_embeds" in batch:
                kwargs["prefix_embeds"] = batch["patch_embeds"]
            h = call(model, params, "hidden", batch["tokens"], **kwargs)
            w, transposed = call(model, params, "head_weight")
            chunk = min(loss_chunk, h.shape[1])
            while h.shape[1] % chunk:
                chunk //= 2
            return chunked_cross_entropy(h, w, labels, chunk=max(chunk, 1), mask=mask,
                                         transposed=transposed)
        return cross_entropy(model_forward(model, params, batch), labels, mask)

    return loss_fn


def value_and_grad(loss_fn, params: Mapping[str, torch.Tensor], batch):
    """(loss, {name: gradient}) of ``loss_fn(params, batch)``; a parameter
    the loss does not reach gets a zero gradient, as under ``jax.grad``.

    With DTensor parameters (inside a sharding context) the loss is
    replicated before the backward, and each gradient comes back with its
    parameter's placements (a partial sum is reduce-scattered there)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = replicate(loss_fn(leaves, batch))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else placed_like(g, v)
                           for (k, v), g in zip(leaves.items(), grads)}


def make_train_step(model, optimizer: Optimizer, *, microbatches: int = 1,
                    compressor=None, loss_chunk: int = 0):
    loss_fn = make_loss_fn(model, loss_chunk=loss_chunk)

    def train_step(params, opt_state, batch, compress_state=None):
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            def split_mb(x, i):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches} "
                                     f"microbatches")
                size = b // microbatches
                return x[i * size:(i + 1) * size]

            loss = 0.0
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            for i in range(microbatches):
                mb = {k: split_mb(v, i) for k, v in batch.items()}
                mb_loss, mb_grads = value_and_grad(loss_fn, params, mb)
                loss = loss + mb_loss
                for k, g in mb_grads.items():
                    grads[k] += g.float()
            loss = loss / microbatches
            grads = {k: g / microbatches for k, g in grads.items()}

        if compressor is not None:
            grads, compress_state = compressor.compress_decompress(grads, compress_state)

        params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss, **{k: v for k, v in opt_metrics.items() if v is not None}}
        if compressor is not None:
            return params, opt_state, metrics, compress_state
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model, last_only: bool = False):
    """Full-sequence forward (inference prefill).

    last_only=True returns only the final position's logits: serving
    semantics (the sampler needs one next-token distribution)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        if last_only and "frames" not in batch:
            kwargs = {}
            if "patch_embeds" in batch:
                kwargs["prefix_embeds"] = batch["patch_embeds"]
            h = call(model, params, "hidden", batch["tokens"], **kwargs)
            w, transposed = call(model, params, "head_weight")
            return h[:, -1:] @ (w.T if transposed else w)
        return model_forward(model, params, batch)

    return prefill_step


def make_decode_step(model):
    """One-token decode against the KV/state cache (updated in place)."""

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return call(model, params, "decode", cache, tokens, pos)

    return decode_step


def make_eval_step(model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch)

    return eval_step
