"""Operation & adapter registries (paper §IV-D, Listing 4).

New operations implement :class:`LayerBuilder` and self-register with
``@register_layer("op_name")``; the op is then usable in the YAML DSL
under that name with zero engine changes.  Adapters between structurally
incompatible data formats live in the *transition registry*, keyed by
(from_format, to_format) — the ModelBuilder consults it automatically
when two consecutive layers disagree (paper §IV-C).

Data formats:
  ``BLC`` — (batch, length, channels) sequence features
  ``BF``  — (batch, features) flat features
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.nn import conv as conv_mod
from repro_torch.nn import initializers as init

Shape = Tuple[int, ...]  # without the batch dim


@dataclasses.dataclass
class BuiltLayer:
    """An instantiated operation: pure init/apply + static metadata."""

    name: str
    # generator -> {leaf: tensor}; None gives shape-only (meta) tensors
    init: Callable[[Optional[torch.Generator]], Dict[str, torch.Tensor]]
    apply: Callable[[Any, Any], Any]  # (params, x) -> y
    out_shape: Shape
    out_format: str
    flops: int = 0  # fwd FLOPs per example (analytical estimate)
    n_params: int = 0
    # decode-state footprint per sequence, in *elements* (the serving
    # estimators scale by the declared cache dtype): grows-with-context
    # state (attention K/V) vs fixed-size state (SSM recurrent state)
    state_elems_per_token: int = 0
    state_elems_fixed: int = 0


class LayerBuilder(abc.ABC):
    """Implement & register to add an op (paper Listing 4).

    ``build`` receives the sampled parameter dict for this op, the input
    shape (batchless) and format, whether this is the network's last
    layer, and the target output dim (used by heads when ``is_last``).
    """

    op_name: str = ""
    in_format: str = "any"  # "BLC" | "BF" | "any"

    @abc.abstractmethod
    def build(
        self,
        params: Dict[str, Any],
        in_shape: Shape,
        in_format: str,
        *,
        is_last: bool,
        output_dim: Optional[int],
    ) -> BuiltLayer:
        ...


# the port's own registries: nothing here is shared with the JAX package
LAYER_REGISTRY: Dict[str, LayerBuilder] = {}
TRANSITION_REGISTRY: Dict[Tuple[str, str], Callable[[Shape], BuiltLayer]] = {}


def register_layer(name: str):
    """Class decorator: ``@register_layer("linear")`` (paper Listing 4)."""

    def wrap(cls):
        inst = cls()
        inst.op_name = name
        LAYER_REGISTRY[name] = inst
        return cls

    return wrap


def register_transition(from_format: str, to_format: str):
    def wrap(fn):
        TRANSITION_REGISTRY[(from_format, to_format)] = fn
        return fn

    return wrap


def get_layer_builder(name: str) -> LayerBuilder:
    if name not in LAYER_REGISTRY:
        raise KeyError(f"op {name!r} not registered; known: {sorted(LAYER_REGISTRY)}")
    return LAYER_REGISTRY[name]


def get_transition(from_format: str, to_format: str) -> Callable[[Shape], BuiltLayer]:
    key = (from_format, to_format)
    if key not in TRANSITION_REGISTRY:
        raise KeyError(f"no adapter registered for transition {key}")
    return TRANSITION_REGISTRY[key]


# ---------------------------------------------------------------------------
# built-in adapters
# ---------------------------------------------------------------------------

@register_transition("BLC", "BF")
def _flatten_adapter(in_shape: Shape) -> BuiltLayer:
    l, c = in_shape
    return BuiltLayer(
        name="adapter/flatten",
        init=lambda gen: {},
        apply=lambda p, x: x.reshape(x.shape[0], -1),
        out_shape=(l * c,),
        out_format="BF",
    )


@register_transition("BF", "BLC")
def _unsqueeze_adapter(in_shape: Shape) -> BuiltLayer:
    (f,) = in_shape
    return BuiltLayer(
        name="adapter/unsqueeze",
        init=lambda gen: {},
        apply=lambda p, x: x[:, None, :],
        out_shape=(1, f),
        out_format="BLC",
    )


# ---------------------------------------------------------------------------
# built-in operations
# ---------------------------------------------------------------------------

def _activate(y, act):
    if act == "relu":
        return F.relu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")  # jax.nn.gelu's default
    return y


@register_layer("linear")
class LinearBuilder(LayerBuilder):
    in_format = "BF"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        (fan_in,) = in_shape
        if is_last and "width" not in params:
            # bare head: project straight to the task's output dim
            width, act = int(output_dim), None
        else:
            width = int(params.get("width", 64))
            act = params.get("activation", "relu")

        def init_fn(gen):
            return {"w": init.scaled_normal(gen, (fan_in, width)),
                    "b": init.zeros(gen, (width,))}

        def apply_fn(p, x):
            y = x @ p["w"] + p["b"]
            return _activate(y, act)

        return BuiltLayer(
            name=f"linear({width})",
            init=init_fn,
            apply=apply_fn,
            out_shape=(width,),
            out_format="BF",
            flops=2 * fan_in * width,
            n_params=fan_in * width + width,
        )


@register_layer("conv1d")
class Conv1dBuilder(LayerBuilder):
    in_format = "BLC"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        l, c_in = in_shape
        k = int(params.get("kernel_size", 3))
        c_out = int(params.get("out_channels", 16))
        stride = int(params.get("stride", 1))
        act = params.get("activation", "relu")
        out_l = conv_mod.conv1d_out_len(l, k, stride, "SAME")

        def init_fn(gen):
            return conv_mod.conv1d_init(gen, c_in, c_out, k)

        def apply_fn(p, x):
            y = conv_mod.conv1d_apply(p, x, stride=stride, padding="SAME")
            return _activate(y, act)

        return BuiltLayer(
            name=f"conv1d(k={k},c={c_out},s={stride})",
            init=init_fn,
            apply=apply_fn,
            out_shape=(out_l, c_out),
            out_format="BLC",
            flops=2 * out_l * k * c_in * c_out,
            n_params=k * c_in * c_out + c_out,
        )


class _PoolBuilder(LayerBuilder):
    in_format = "BLC"
    pool_fn = staticmethod(conv_mod.maxpool1d)
    tag = "maxpool"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        l, c = in_shape
        w = int(params.get("window", 2))
        w = min(w, l)
        out_l = conv_mod.pool_out_len(l, w)
        fn = self.pool_fn
        return BuiltLayer(
            name=f"{self.tag}({w})",
            init=lambda gen: {},
            apply=lambda p, x: fn(x, window=w),
            out_shape=(out_l, c),
            out_format="BLC",
            flops=out_l * w * c,
        )


@register_layer("maxpool")
class MaxPoolBuilder(_PoolBuilder):
    pool_fn = staticmethod(conv_mod.maxpool1d)
    tag = "maxpool"


@register_layer("avgpool")
class AvgPoolBuilder(_PoolBuilder):
    pool_fn = staticmethod(conv_mod.avgpool1d)
    tag = "avgpool"


@register_layer("identity")
class IdentityBuilder(LayerBuilder):
    in_format = "any"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        return BuiltLayer(
            name="identity",
            init=lambda gen: {},
            apply=lambda p, x: x,
            out_shape=in_shape,
            out_format=in_format,
        )


@register_layer("global_avg_pool")
class GlobalAvgPoolBuilder(LayerBuilder):
    in_format = "BLC"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        l, c = in_shape
        return BuiltLayer(
            name="global_avg_pool",
            init=lambda gen: {},
            apply=lambda p, x: x.mean(dim=1),
            out_shape=(c,),
            out_format="BF",
            flops=l * c,
        )


@register_layer("layernorm")
class LayerNormBuilder(LayerBuilder):
    in_format = "any"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        d = in_shape[-1]

        def init_fn(gen):
            return {"scale": init.ones(gen, (d,)), "bias": init.zeros(gen, (d,))}

        def apply_fn(p, x):
            mu = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, keepdim=True, correction=0)
            return (x - mu) * (var + 1e-5) ** -0.5 * p["scale"] + p["bias"]

        return BuiltLayer(
            name="layernorm",
            init=init_fn,
            apply=apply_fn,
            out_shape=in_shape,
            out_format=in_format,
            flops=6 * math.prod(in_shape),
            n_params=2 * d,
        )


@register_layer("attention")
class AttentionBuilder(LayerBuilder):
    """Self-attention over a BLC sequence (residual, pre-norm)."""

    in_format = "BLC"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        from repro_torch.nn.attention import AttentionConfig, attention_apply, attention_init

        l, c = in_shape
        heads = int(params.get("heads", 4))
        heads = max(1, min(heads, c))
        while c % heads:
            heads -= 1
        # impl "pallas" routes through kernels/ops.flash_attention, the
        # CUDA kernel; causal stays False by default, as in the reference
        cfg = AttentionConfig(d_model=c, n_heads=heads, n_kv_heads=heads,
                              causal=bool(params.get("causal", False)),
                              impl=str(params.get("impl", "xla")))

        def apply_fn(p, x):
            return x + attention_apply(p, cfg, x)

        return BuiltLayer(
            name=f"attention(h={heads})",
            init=lambda gen: attention_init(cfg, gen),
            apply=apply_fn,
            out_shape=in_shape,
            out_format="BLC",
            flops=2 * l * (4 * c * c) + 4 * l * l * c,
            n_params=4 * c * c,
            state_elems_per_token=2 * c,  # K + V rows per cached token
        )


@register_layer("ssm")
class SSMBuilder(LayerBuilder):
    """Mamba2 SSD block over a BLC sequence (residual).

    impl "pallas" routes through kernels/ops.ssm_scan, the CUDA kernel.
    """

    in_format = "BLC"

    def build(self, params, in_shape, in_format, *, is_last, output_dim):
        from repro_torch.nn.ssm import Mamba2Config, mamba2_apply, mamba2_init

        l, c = in_shape
        expand = int(params.get("expand", 2))
        d_inner = expand * c
        d_head = min(int(params.get("d_head", 64)), d_inner)
        while d_inner % d_head:
            d_head //= 2
        cfg = Mamba2Config(
            d_model=c,
            d_state=int(params.get("d_state", 16)),
            d_head=max(1, d_head),
            expand=expand,
            impl=str(params.get("impl", "xla")),
        )

        def apply_fn(p, x):
            return x + mamba2_apply(p, cfg, x)

        # dominant terms: in/out projections + the SSD scan's state update
        n_params = c * (2 * cfg.d_inner + 2 * cfg.d_state + cfg.n_heads) \
            + cfg.d_inner * c
        return BuiltLayer(
            name=f"ssm(n={cfg.d_state},e={expand})",
            init=lambda gen: mamba2_init(cfg, gen),
            apply=apply_fn,
            out_shape=in_shape,
            out_format="BLC",
            flops=2 * l * n_params + 6 * l * cfg.d_inner * cfg.d_state,
            n_params=n_params,
            # recurrent state is context-length independent: SSD state
            # (heads, d_state, d_head) + rolling conv window
            state_elems_fixed=(
                cfg.n_heads * cfg.d_state * cfg.d_head
                + (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.n_groups * cfg.d_state)
            ),
        )
