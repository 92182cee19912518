"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752,
MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, moe_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = moe_layer(
        6144, 48, 8, 10752, n_experts=16, top_k=4,
        activation="silu", capacity_factor=1.25,
    )
    return ModelSpec(
        name="dbrx-132b", d_model=6144, vocab=100352,
        layers=(layer,) * 40, norm="rmsnorm",
    )


def smoke_spec_fn() -> ModelSpec:
    layer = moe_layer(64, 4, 2, 96, n_experts=4, top_k=2, capacity_factor=2.0)
    return ModelSpec(name="dbrx-smoke", d_model=64, vocab=512, layers=(layer,) * 2)


ARCH = ArchConfig(
    name="dbrx-132b", family="moe",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="hf:databricks/dbrx-base (unverified)",
)
