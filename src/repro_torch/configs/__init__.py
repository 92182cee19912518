"""Architecture config registry: the archs the port can build so far."""
import importlib

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = ("qwen3_1_7b", "xlstm_1_3b")

ARCHS = {}
for _m in _ARCH_MODULES:
    _arch = importlib.import_module(f"repro_torch.configs.{_m}").ARCH
    ARCHS[_arch.name] = _arch


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; the port has: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "get_arch"]
