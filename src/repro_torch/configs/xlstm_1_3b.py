"""xlstm-1.3b [ssm]: 48L d_model=2048 4H — mLSTM blocks with periodic
sLSTM blocks (7:1 ratio), d_ff=0 (blocks contain their own projections).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock
from repro_torch.nn.xlstm import MLSTMConfig, SLSTMConfig


def _layers(d_model, n_heads, n_layers, slstm_every, chunk):
    m = LayerSpec(subs=(SubBlock("mlstm", MLSTMConfig(d_model, n_heads=n_heads, expand=2, chunk=chunk)),))
    s = LayerSpec(subs=(SubBlock("slstm", SLSTMConfig(d_model, n_heads=n_heads)),))
    return tuple(
        s if (i + 1) % slstm_every == 0 else m for i in range(n_layers)
    )


def spec_fn(long_context: bool = False) -> ModelSpec:
    return ModelSpec(
        name="xlstm-1.3b", d_model=2048, vocab=50304,
        layers=_layers(2048, 4, 48, 8, 128),
        norm="layernorm", positional="none",
    )


def smoke_spec_fn() -> ModelSpec:
    return ModelSpec(
        name="xlstm-smoke", d_model=64, vocab=512,
        layers=_layers(64, 2, 4, 4, 8),
        norm="layernorm", positional="none",
    )


ARCH = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    spec_fn=spec_fn, smoke_spec_fn=smoke_spec_fn,
    supports_long_context=True,
    source="arXiv:2405.04517 (unverified)",
)
