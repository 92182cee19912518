"""Model specification IR.

A model is: embedding -> [LayerSpec, ...] -> final norm -> LM head.
Each LayerSpec is a tuple of residual *sub-blocks* (pre-norm residual:
``h = h + f(norm(h))``).  A standard transformer layer is
``(attention, mlp)``; an xLSTM layer is ``(mlstm,)`` or ``(slstm,)``.
The port builds the attention, mlp, mlstm and slstm kinds; the other
kinds of the JAX IR raise until their slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.mlp import MLPConfig

SUBBLOCK_KINDS = ("attention", "mlp", "mlstm", "slstm")
# kinds of the JAX IR that arrive with a later slice of the port
LATER_KINDS = ("cross_attention", "moe", "mamba2")
POSITIONALS = ("rope", "none")  # "learned" arrives with a later slice


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str
    cfg: Any  # one of the nn config dataclasses (frozen => hashable)

    def __post_init__(self):
        if self.kind in LATER_KINDS:
            raise NotImplementedError(
                f"sub-block kind {self.kind!r} is not ported yet; it arrives "
                f"with the LM-substrate slice (the port has {SUBBLOCK_KINDS})")
        if self.kind not in SUBBLOCK_KINDS:
            raise ValueError(f"unknown sub-block kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    subs: Tuple[SubBlock, ...]


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
                f"positional {self.positional!r} is not ported; the port has {POSITIONALS}")

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
