"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU (non-gated).  [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, transformer_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = transformer_layer(
        18432, 96, 8, 73728,
        activation="squared_relu", gated=False, d_head=192,
    )
    return ModelSpec(
        name="nemotron-4-340b", d_model=18432, vocab=256000,
        layers=(layer,) * 96, norm="layernorm",
    )


def smoke_spec_fn() -> ModelSpec:
    layer = transformer_layer(96, 6, 2, 384, activation="squared_relu",
                              gated=False, d_head=16)
    return ModelSpec(name="nemotron-smoke", d_model=96, vocab=512,
                     layers=(layer,) * 2, norm="layernorm")


ARCH = ArchConfig(
    name="nemotron-4-340b", family="dense",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="arXiv:2402.16819 (unverified)",
)
