"""Model specification IR.

A model is: embedding -> [LayerSpec, ...] -> final norm -> LM head.
Each LayerSpec is a tuple of residual *sub-blocks* (pre-norm residual:
``h = h + f(norm(h))``).  A standard transformer layer is
``(attention, mlp)``; a Mamba2 layer is ``(mamba2,)``; an xLSTM layer is
``(mlstm,)`` or ``(slstm,)``; a DBRX layer is ``(attention, moe)``; a
whisper decoder layer is ``(attention, cross_attention, mlp)``.  A layer
marked ``shared`` is weight-tied to the model's one shared block
(zamba2).  An encoder-decoder model (whisper) adds ``encoder_layers``,
run non-causally over frame embeddings by ``LM.encode``; a VLM
(paligemma) overwrites the first ``num_prefix_tokens`` embeddings with
precomputed patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.mlp import MLPConfig
from repro_torch.nn.moe import MoEConfig

SUBBLOCK_KINDS = ("attention", "cross_attention", "mlp", "moe", "mamba2", "mlstm",
                  "slstm")
POSITIONALS = ("rope", "learned", "none")
REMAT_POLICIES = (None, "dots")


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str
    cfg: Any  # one of the nn config dataclasses (frozen => hashable)

    def __post_init__(self):
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
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    # "rope": rotary inside attention (nothing at the LM level); "learned":
    # a (max_position, d_model) table added to the embeddings (the encoder's
    # frames and the decoder's tokens share it); "none": no positional
    # signal (recurrent kinds)
    positional: str = "rope"
    max_position: int = 1 << 20  # longest context; the learned table's rows
    # Encoder (whisper): encoder layers run non-causally on frame embeddings;
    # decoder layers gain cross-attention to the encoder output.
    encoder_layers: Tuple[LayerSpec, ...] = ()
    frontend: Optional[str] = None  # None | "audio_stub" | "vision_stub"
    num_prefix_tokens: int = 0  # vlm: patch-embedding prefix length
    logit_softcap: Optional[float] = None
    # remat: in a forward that builds an autograd graph (training), each
    # layer's activations are recomputed in the backward instead of kept
    # (torch.utils.checkpoint), as the reference's jax.checkpoint.
    remat: bool = True
    # remat_policy: None = keep nothing inside a layer (most recompute, least
    # memory); "dots" = the counterpart of the reference's
    # dots_with_no_batch_dims_saveable: matrix products without batch dims
    # (aten.mm, aten.addmm) are kept, everything else (aten.bmm, the
    # elementwise ops) is recomputed.
    remat_policy: Optional[str] = None
    # scan_layers: the reference scans a segment's stacked layers (True) or
    # unrolls them for its dry run's cost analysis (False); the port runs
    # every layer in a Python loop either way, so the field changes nothing.
    scan_layers: bool = True

    def __post_init__(self):
        if self.positional not in POSITIONALS:
            raise ValueError(f"unknown positional {self.positional!r}; the port has "
                             f"{POSITIONALS}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; the port has "
                             f"{REMAT_POLICIES}")

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def is_subquadratic(self) -> bool:
        """True when decode state is O(1) in context (SSM/recurrent archs,
        possibly with sliding-window attention)."""
        for layer in self.layers:
            for sub in layer.subs:
                if sub.kind == "attention" and sub.cfg.window is None:
                    return False
                if sub.kind == "cross_attention":
                    return False
        return True


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
