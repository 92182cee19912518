"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP vision tower stubbed: the model takes
precomputed patch embeddings (``input_specs``: 256 prefix tokens) + gemma decoder.
[arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, transformer_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = transformer_layer(
        2048, 8, 1, 16384, activation="gelu", gated=True, d_head=256,
    )
    return ModelSpec(
        name="paligemma-3b", d_model=2048, vocab=257216,
        layers=(layer,) * 18, norm="rmsnorm",
        tie_embeddings=True, embed_scale=True,
        frontend="vision_stub", num_prefix_tokens=256,
    )


def smoke_spec_fn() -> ModelSpec:
    layer = transformer_layer(64, 4, 1, 256, activation="gelu", gated=True, d_head=16)
    return ModelSpec(
        name="paligemma-smoke", d_model=64, vocab=512, layers=(layer,) * 2,
        tie_embeddings=True, embed_scale=True,
        frontend="vision_stub", num_prefix_tokens=8,
    )


ARCH = ArchConfig(
    name="paligemma-3b", family="vlm",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    batch_kind="vlm", prefix_tokens=256,
    source="arXiv:2407.07726",
)
