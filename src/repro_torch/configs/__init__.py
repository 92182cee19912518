"""Architecture config registry: one module per assigned architecture."""
import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, input_specs

_ARCH_MODULES = (
    "qwen3_1_7b",
    "phi4_mini_3_8b",
    "nemotron_4_340b",
    "qwen1_5_4b",
    "zamba2_2_7b",
    "xlstm_1_3b",
    "whisper_medium",
    "dbrx_132b",
    "arctic_480b",
    "paligemma_3b",
)

ARCHS = {}
for _m in _ARCH_MODULES:
    _arch = importlib.import_module(f"repro_torch.configs.{_m}").ARCH
    ARCHS[_arch.name] = _arch


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeCell", "get_arch", "input_specs"]
