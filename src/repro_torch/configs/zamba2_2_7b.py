"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240,
ssm_state=64 — Mamba2 backbone + weight-shared attention block applied
every 6 layers.  [arXiv:2411.15242; hf]

Long context: ``spec_fn(long_context=True)`` gives the shared attention
block a 4096-token sliding window; the Mamba2 state is the O(1) context
carrier.  The published model applies LoRA adapters per
shared-block invocation — omitted here (weight-tied exactly), documented
as a simplification.
"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock, transformer_layer
from repro_torch.nn.ssm import Mamba2Config

SHARED_PERIOD = 6


def _layers(d_model, n_heads, d_ff, d_state, d_head_ssm, n_mamba, period, window, smoke=False):
    mamba = LayerSpec(
        subs=(SubBlock("mamba2", Mamba2Config(
            d_model, d_state=d_state, d_head=d_head_ssm, expand=2,
            n_groups=1, chunk=8 if smoke else 128)),),
    )
    shared = LayerSpec(
        subs=transformer_layer(
            d_model, n_heads, n_heads, d_ff, activation="gelu", gated=True,
            window=window, d_head=d_model // n_heads,
        ).subs,
        shared=True,
    )
    layers = []
    for i in range(n_mamba):
        layers.append(mamba)
        if (i + 1) % period == 0:
            layers.append(shared)
    return tuple(layers)


def spec_fn(long_context: bool = False) -> ModelSpec:
    return ModelSpec(
        name="zamba2-2.7b", d_model=2560, vocab=32000,
        layers=_layers(2560, 32, 10240, 64, 64, 54, SHARED_PERIOD,
                       window=4096 if long_context else None),
        norm="rmsnorm", positional="none",
    )


def smoke_spec_fn() -> ModelSpec:
    return ModelSpec(
        name="zamba2-smoke", d_model=64, vocab=512,
        layers=_layers(64, 4, 128, 16, 16, 4, 2, window=None, smoke=True),
        norm="rmsnorm", positional="none",
    )


ARCH = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    supports_long_context=True,
    source="arXiv:2411.15242",
)
