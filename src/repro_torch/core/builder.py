"""ModelBuilder: ArchitectureIR -> executable PyTorch model (paper §IV-C).

Modules are instantiated only after the sampler has fixed all values.
The builder walks the layer IR, asks each registered LayerBuilder for an
instantiated ``BuiltLayer`` (which includes shape inference), and inserts
adapter modules from the transition registry wherever consecutive layers
disagree on data format — so heterogeneous (conv / attention / linear)
architectures compose without per-architecture glue code.

The result is a :class:`BuiltModel`, an ``nn.Module`` whose weights are
drawn by ``init`` from an explicit generator onto a device (CUDA unless
the caller asks for the CPU), plus analytical cost metadata used by the
evaluation API.  Its state-dict keys mirror the JAX package's parameter
tree: ``layer_<i>.<leaf>``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.preprocess import build_preprocessing
from repro_torch.core.registry import BuiltLayer, get_layer_builder, get_transition
from repro_torch.core.translate import ArchitectureIR
from repro_torch.device import resolve_device
from repro_torch.nn.types import frozen


class BuildError(ValueError):
    pass


class BuiltModel(nn.Module):
    """A built candidate.  Until :meth:`init` its weights are shape-only
    (meta) tensors, enough for ``state_dict`` shapes and for loading
    weights with ``load_state_dict(..., assign=True)``.  The weights are
    for evaluation and are created with ``requires_grad=False``."""

    def __init__(self, layers: List[BuiltLayer], input_shape: Tuple[int, ...],
                 output_dim: int, arch: ArchitectureIR,
                 preprocess: Optional[Callable[[Any], Any]] = None):
        super().__init__()
        self.layers = layers
        self.input_shape = input_shape
        self.output_dim = output_dim
        self.arch = arch
        self.preprocess = preprocess
        for i, layer in enumerate(layers):
            self.add_module(f"layer_{i}", _params_module(layer.init(None)))

    # -- weights and forward ---------------------------------------------------

    def init(self, generator: torch.Generator, device="cuda") -> "BuiltModel":
        """Draw every layer's weights from ``generator`` (on its device, in
        layer order) and place them on ``device``.  Returns ``self``."""
        device = resolve_device(device)
        for i, layer in enumerate(self.layers):
            params = {k: v.to(device) for k, v in layer.init(generator).items()}
            self.add_module(f"layer_{i}", _params_module(params))
        return self

    def forward(self, x):
        if self.preprocess is not None:
            x = self.preprocess(x)
        for i, layer in enumerate(self.layers):
            x = layer.apply(dict(getattr(self, f"layer_{i}").items()), x)
        return x

    # -- analytical costs ------------------------------------------------------

    @property
    def flops(self) -> int:
        return sum(l.flops for l in self.layers)

    @property
    def n_params(self) -> int:
        return sum(l.n_params for l in self.layers)

    @property
    def state_elems_per_token(self) -> int:
        """Decode-state elements that grow with context (K/V caches)."""
        return sum(l.state_elems_per_token for l in self.layers)

    @property
    def state_elems_fixed(self) -> int:
        """Context-length-independent decode-state elements (SSM state)."""
        return sum(l.state_elems_fixed for l in self.layers)

    def summary(self) -> str:
        rows = [f"input  {self.input_shape}"]
        for l in self.layers:
            rows.append(f"{l.name:<28} -> {l.out_shape} [{l.out_format}] "
                        f"flops={l.flops:,} params={l.n_params:,}")
        return "\n".join(rows)


class ModelBuilder:
    """Builds executable models from sampled architecture IR."""

    def __init__(self, input_shape: Tuple[int, ...], output_dim: int,
                 input_format: str = "BLC", ensure_head: bool = True):
        self.input_shape = tuple(int(s) for s in input_shape)
        self.output_dim = int(output_dim)
        self.input_format = input_format
        self.ensure_head = ensure_head

    def build(self, arch: ArchitectureIR) -> BuiltModel:
        # paper: (length, channels) YAML order is [channels, length]
        if self.input_format == "BLC" and len(self.input_shape) == 2:
            c, l = self.input_shape
            shape: Tuple[int, ...] = (l, c)
        else:
            shape = self.input_shape
        fmt = self.input_format
        layers: List[BuiltLayer] = []

        pre_fn, pre_out_shape = build_preprocessing(arch.preprocessing, shape)
        shape = pre_out_shape

        n = len(arch.layers)
        for i, layer_ir in enumerate(arch.layers):
            builder = get_layer_builder(layer_ir.op)
            is_last = self.ensure_head and (i == n - 1)
            # adapter insertion when formats disagree
            if builder.in_format not in ("any", fmt):
                adapter = get_transition(fmt, builder.in_format)(shape)
                layers.append(adapter)
                shape, fmt = adapter.out_shape, adapter.out_format
            built = builder.build(
                dict(layer_ir.params), shape, fmt,
                is_last=is_last, output_dim=self.output_dim,
            )
            layers.append(built)
            shape, fmt = built.out_shape, built.out_format

        if self.ensure_head and (fmt != "BF" or shape != (self.output_dim,)):
            # guarantee a classifier head of the requested output dim
            if fmt != "BF":
                adapter = get_transition(fmt, "BF")(shape)
                layers.append(adapter)
                shape, fmt = adapter.out_shape, adapter.out_format
            if shape != (self.output_dim,):
                head = get_layer_builder("linear").build(
                    {}, shape, fmt, is_last=True, output_dim=self.output_dim
                )
                layers.append(head)
                shape = head.out_shape

        return BuiltModel(
            layers=layers,
            input_shape=self.input_shape,
            output_dim=self.output_dim,
            arch=arch,
            preprocess=pre_fn,
        )


def _params_module(params: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return frozen(params)
