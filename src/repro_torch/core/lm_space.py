"""LM-backbone search spaces: the paper's DSL over LM layers.

The same YAML (or dict) format that describes spaces over conv stacks
describes spaces over *LM layers*; :class:`LMSpaceBuilder` maps the
sampled ArchitectureIR onto the ModelSpec IR executed by
:class:`repro_torch.models.lm.LM`, so hardware-in-the-loop NAS runs over
the LM families.  The port's spaces are in ``repro_torch/configs/spaces/``
(``SPACES_DIR``): ``qwen3_like.yaml``, whose identity sample reproduces
qwen3-1.7b's layers, ``hybrid_like.yaml`` and ``moe_like.yaml``.

LM ops (usable as op_candidates):
  transformer_layer: heads, kv_heads, d_ff, activation, gated, qk_norm
  moe_layer:         heads, kv_heads, d_ff, n_experts, top_k, dense_residual
  mamba2_layer:      d_state, d_head, expand
  mlstm_layer:       heads, expand
  slstm_layer:       heads
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from repro_torch.core.translate import ArchitectureIR
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock, moe_layer, transformer_layer
from repro_torch.nn.ssm import Mamba2Config
from repro_torch.nn.xlstm import MLSTMConfig, SLSTMConfig

SPACES_DIR = Path(__file__).resolve().parents[1] / "configs" / "spaces"

LM_OPS = ("transformer_layer", "moe_layer", "mamba2_layer", "mlstm_layer", "slstm_layer")


def _fit_heads(heads: int, d_model: int) -> int:
    """Adapt a sampled head count to the actual width (the LM analogue of
    the ModelBuilder's shape-compatibility logic): heads must divide
    d_model and leave an even head_dim (RoPE splits it in two)."""
    heads = max(1, min(int(heads), d_model // 2))
    while heads > 1 and (d_model % heads or (d_model // heads) % 2):
        heads -= 1
    return heads


def _fit_kv(kv: int, heads: int) -> int:
    kv = max(1, min(int(kv), heads))
    while heads % kv:
        kv -= 1
    return kv


def _layer_from_ir(op: str, p: Dict[str, Any], d_model: int) -> LayerSpec:
    if op == "transformer_layer":
        heads = _fit_heads(p.get("heads", d_model // 128), d_model)
        return transformer_layer(
            d_model,
            heads,
            _fit_kv(p.get("kv_heads", max(heads // 2, 1)), heads),
            int(p.get("d_ff", 4 * d_model)),
            activation=str(p.get("activation", "silu")),
            gated=bool(p.get("gated", True)),
            qk_norm=bool(p.get("qk_norm", False)),
            window=p.get("window"),
        )
    if op == "moe_layer":
        heads = _fit_heads(p.get("heads", d_model // 128), d_model)
        return moe_layer(
            d_model,
            heads,
            _fit_kv(p.get("kv_heads", max(heads // 2, 1)), heads),
            int(p.get("d_ff", 2 * d_model)),
            n_experts=int(p.get("n_experts", 8)),
            top_k=int(p.get("top_k", 2)),
            dense_residual=bool(p.get("dense_residual", False)),
        )
    if op == "mamba2_layer":
        return LayerSpec(subs=(SubBlock("mamba2", Mamba2Config(
            d_model,
            d_state=int(p.get("d_state", 64)),
            d_head=int(p.get("d_head", 64)),
            expand=int(p.get("expand", 2)),
        )),))
    if op == "mlstm_layer":
        return LayerSpec(subs=(SubBlock("mlstm", MLSTMConfig(
            d_model, n_heads=int(p.get("heads", 4)), expand=int(p.get("expand", 2)),
        )),))
    if op == "slstm_layer":
        return LayerSpec(subs=(SubBlock("slstm", SLSTMConfig(
            d_model, n_heads=int(p.get("heads", 4)),
        )),))
    raise KeyError(f"not an LM op: {op!r}")


class LMSpaceBuilder:
    """ArchitectureIR -> ModelSpec (the LM analogue of ModelBuilder)."""

    def __init__(self, d_model: int, vocab: int, *, tie_embeddings: bool = True,
                 norm: str = "rmsnorm"):
        self.d_model = d_model
        self.vocab = vocab
        self.tie_embeddings = tie_embeddings
        self.norm = norm

    def build(self, arch: ArchitectureIR) -> ModelSpec:
        layers = tuple(
            _layer_from_ir(l.op, l.params, self.d_model) for l in arch.layers
        )
        attention_free = all(
            all(s.kind not in ("attention", "cross_attention") for s in layer.subs)
            for layer in layers
        )
        return ModelSpec(
            name=f"lm-nas-{arch.signature()[:40]}",
            d_model=self.d_model,
            vocab=self.vocab,
            layers=layers,
            norm=self.norm,
            tie_embeddings=self.tie_embeddings,
            positional="none" if attention_free else "rope",
        )
