"""Model specification IR.

A model is: embedding -> [LayerSpec, ...] -> final norm -> LM head.
Each LayerSpec is a tuple of residual *sub-blocks* (pre-norm residual:
``h = h + f(norm(h))``).  A standard transformer layer is
``(attention, mlp)``; a Mamba2 layer is ``(mamba2,)``; an xLSTM layer is
``(mlstm,)`` or ``(slstm,)``; a DBRX layer is ``(attention, moe)``.  A
layer marked ``shared`` is weight-tied to the model's one shared block
(zamba2).  The port builds every kind of the JAX IR but
``cross_attention``, which raises until its slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.mlp import MLPConfig
from repro_torch.nn.moe import MoEConfig

SUBBLOCK_KINDS = ("attention", "mlp", "moe", "mamba2", "mlstm", "slstm")
# what of the JAX IR is still to port, and the ROADMAP item that brings it
LATER = ("ROADMAP.md Queue 1 item 9b (the rest of the LM substrate: cross-attention "
         "and the encoder of whisper-medium, learned positions, the VLM prefix of "
         "paligemma-3b)")
LATER_KINDS = ("cross_attention",)
POSITIONALS = ("rope", "none")  # "learned": LATER


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str
    cfg: Any  # one of the nn config dataclasses (frozen => hashable)

    def __post_init__(self):
        if self.kind in LATER_KINDS:
            raise NotImplementedError(
                f"sub-block kind {self.kind!r} is not ported yet: {LATER} "
                f"(the port has {SUBBLOCK_KINDS})")
        if self.kind not in SUBBLOCK_KINDS:
            raise ValueError(f"unknown sub-block kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    subs: Tuple[SubBlock, ...]
    shared: bool = False  # weight-tied to the model's shared block (zamba2)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    d_model: int
    vocab: int
    layers: Tuple[LayerSpec, ...]
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # "rope": rotary inside attention (nothing at the LM level); "none":
    # no positional signal (recurrent kinds)
    positional: str = "rope"
    max_position: int = 1 << 20  # longest context a cache may be built for

    def __post_init__(self):
        if self.positional not in POSITIONALS:
            raise NotImplementedError(
                f"positional {self.positional!r} is not ported yet: {LATER} "
                f"(the port has {POSITIONALS})")

    @property
    def n_layers(self) -> int:
        return len(self.layers)


def transformer_layer(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    *,
    activation: str = "silu",
    gated: bool = True,
    qk_norm: bool = False,
    attn_bias: bool = False,
    mlp_bias: bool = False,
    window: Optional[int] = None,
    rope: bool = True,
    d_head: Optional[int] = None,
    rope_theta: float = 10000.0,
) -> LayerSpec:
    """Convenience constructor for a standard decoder layer."""
    return LayerSpec(subs=(
        SubBlock("attention", AttentionConfig(
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            d_head=d_head, use_bias=attn_bias, qk_norm=qk_norm, rope=rope,
            rope_theta=rope_theta, causal=True, window=window)),
        SubBlock("mlp", MLPConfig(d_model, d_ff, activation=activation,
                                  gated=gated, use_bias=mlp_bias)),
    ))


def moe_layer(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    n_experts: int,
    top_k: int,
    *,
    qk_norm: bool = False,
    dense_residual: bool = False,
    activation: str = "silu",
    capacity_factor: float = 1.25,
    rope_theta: float = 10000.0,
) -> LayerSpec:
    """A decoder layer whose feed-forward is a mixture of experts."""
    return LayerSpec(subs=(
        SubBlock("attention", AttentionConfig(
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            qk_norm=qk_norm, rope=True, rope_theta=rope_theta, causal=True)),
        SubBlock("moe", MoEConfig(
            d_model=d_model, d_ff=d_ff, n_experts=n_experts, top_k=top_k,
            capacity_factor=capacity_factor, activation=activation,
            dense_residual=dense_residual)),
    ))
