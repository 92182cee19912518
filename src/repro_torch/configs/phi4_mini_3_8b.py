"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, transformer_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = transformer_layer(
        3072, 24, 8, 8192, activation="silu", gated=True, d_head=128,
    )
    return ModelSpec(
        name="phi4-mini-3.8b", d_model=3072, vocab=200064,
        layers=(layer,) * 32, norm="rmsnorm", tie_embeddings=True,
    )


def smoke_spec_fn() -> ModelSpec:
    layer = transformer_layer(96, 6, 2, 256, activation="silu", gated=True, d_head=16)
    return ModelSpec(name="phi4-smoke", d_model=96, vocab=512, layers=(layer,) * 2)


ARCH = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="arXiv:2412.08905",
)
