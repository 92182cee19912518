"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, transformer_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = transformer_layer(
        2048, 16, 8, 6144,
        activation="silu", gated=True, qk_norm=True, d_head=128,
        rope_theta=1_000_000.0,
    )
    return ModelSpec(
        name="qwen3-1.7b", d_model=2048, vocab=151936,
        layers=(layer,) * 28, norm="rmsnorm", tie_embeddings=True,
    )


def smoke_spec_fn() -> ModelSpec:
    layer = transformer_layer(64, 4, 2, 192, activation="silu", gated=True,
                              qk_norm=True, d_head=16)
    return ModelSpec(name="qwen3-smoke", d_model=64, vocab=512,
                     layers=(layer,) * 2, tie_embeddings=True)


ARCH = ArchConfig(
    name="qwen3-1.7b", family="dense",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="hf:Qwen/Qwen3-8B",
)
