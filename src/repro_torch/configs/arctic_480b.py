"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864,
MoE 128 experts top-2 + dense residual MLP branch.
[hf:Snowflake/snowflake-arctic-base; hf]

The published Arctic uses a larger dense-branch d_ff; the assignment
fixes d_ff=4864, used here for both the experts and the dense residual
(noted deviation)."""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, moe_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = moe_layer(
        7168, 56, 8, 4864, n_experts=128, top_k=2,
        activation="silu", dense_residual=True, capacity_factor=1.25,
    )
    return ModelSpec(
        name="arctic-480b", d_model=7168, vocab=32000,
        layers=(layer,) * 35, norm="rmsnorm",
    )


def smoke_spec_fn() -> ModelSpec:
    layer = moe_layer(64, 4, 2, 96, n_experts=8, top_k=2,
                      dense_residual=True, capacity_factor=2.0)
    return ModelSpec(name="arctic-smoke", d_model=64, vocab=512, layers=(layer,) * 2)


ARCH = ArchConfig(
    name="arctic-480b", family="moe",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="hf:Snowflake/snowflake-arctic-base",
)
