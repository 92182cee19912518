"""Architecture config registry: the archs the port can build so far
(paligemma-3b and whisper-medium are still to port: ROADMAP.md Queue 1
item 9b)."""
import importlib

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = (
    "qwen3_1_7b",
    "phi4_mini_3_8b",
    "nemotron_4_340b",
    "qwen1_5_4b",
    "zamba2_2_7b",
    "xlstm_1_3b",
    "dbrx_132b",
    "arctic_480b",
)
# the JAX package's archs that need what the port does not have yet
_LATER = {
    "whisper-medium": "cross-attention, the encoder and learned positions",
    "paligemma-3b": "the VLM prefix (frontend, num_prefix_tokens) and embed_scale",
}

ARCHS = {}
for _m in _ARCH_MODULES:
    _arch = importlib.import_module(f"repro_torch.configs.{_m}").ARCH
    ARCHS[_arch.name] = _arch


def get_arch(name: str) -> ArchConfig:
    if name in _LATER:
        raise KeyError(f"arch {name!r} is not ported yet: it needs {_LATER[name]} "
                       f"(ROADMAP.md Queue 1 item 9b); the port has: {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; the port has: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "get_arch"]
