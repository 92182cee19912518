"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import ModelSpec, transformer_layer


def spec_fn(long_context: bool = False) -> ModelSpec:
    layer = transformer_layer(
        2560, 20, 20, 6912, activation="silu", gated=True,
        attn_bias=True, d_head=128,
    )
    return ModelSpec(
        name="qwen1.5-4b", d_model=2560, vocab=151936,
        layers=(layer,) * 40, norm="rmsnorm",
    )


def smoke_spec_fn() -> ModelSpec:
    layer = transformer_layer(64, 4, 4, 192, activation="silu", gated=True,
                              attn_bias=True, d_head=16)
    return ModelSpec(name="qwen1.5-smoke", d_model=64, vocab=512, layers=(layer,) * 2)


ARCH = ArchConfig(
    name="qwen1.5-4b", family="dense",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    source="hf:Qwen/Qwen1.5-0.5B",
)
