"""whisper-medium [audio]: enc-dec, 24L each, d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 — conv frontend stubbed: the model takes
precomputed frame embeddings (``input_specs``).  [arXiv:2212.04356; unverified]

Decode cells: decoder self-KV = cell seq; cross-attention against a fixed
1,500-frame encoder context.  Full attention -> long_500k is skipped.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock
from repro_torch.nn.attention import AttentionConfig
from repro_torch.nn.mlp import MLPConfig


def _layers(d, h, ff, max_pos):
    enc = LayerSpec(subs=(
        SubBlock("attention", AttentionConfig(d, h, h, causal=False, rope=False, use_bias=True)),
        SubBlock("mlp", MLPConfig(d, ff, activation="gelu", gated=False, use_bias=True)),
    ))
    dec = LayerSpec(subs=(
        SubBlock("attention", AttentionConfig(d, h, h, causal=True, rope=False, use_bias=True)),
        SubBlock("cross_attention", AttentionConfig(d, h, h, causal=False, rope=False, use_bias=True)),
        SubBlock("mlp", MLPConfig(d, ff, activation="gelu", gated=False, use_bias=True)),
    ))
    return enc, dec


def spec_fn(long_context: bool = False) -> ModelSpec:
    enc, dec = _layers(1024, 16, 4096, 65536)
    return ModelSpec(
        name="whisper-medium", d_model=1024, vocab=51865,
        layers=(dec,) * 24, encoder_layers=(enc,) * 24,
        norm="layernorm", positional="learned", max_position=65536,
        frontend="audio_stub", tie_embeddings=True,
    )


def smoke_spec_fn() -> ModelSpec:
    enc, dec = _layers(64, 4, 128, 128)
    return ModelSpec(
        name="whisper-smoke", d_model=64, vocab=512,
        layers=(dec,) * 2, encoder_layers=(enc,) * 2,
        norm="layernorm", positional="learned", max_position=128,
        frontend="audio_stub",
    )


ARCH = ArchConfig(
    name="whisper-medium", family="audio",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    batch_kind="encdec", enc_context=1500,
    source="arXiv:2212.04356 (unverified)",
)
