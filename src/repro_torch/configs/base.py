"""Architecture config protocol.

Each ``configs/<arch>.py`` exposes ``ARCH: ArchConfig`` with:
  * ``spec_fn(long_context)``  — the exact published configuration
  * ``smoke_spec_fn()``        — reduced same-family config for CPU tests
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.specs import ModelSpec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | hybrid | ssm | audio | moe | vlm
    spec_fn: Callable[..., ModelSpec]
    smoke_spec_fn: Callable[[], ModelSpec]
    source: str = ""

    def spec(self, long_context: bool = False) -> ModelSpec:
        return self.spec_fn(long_context=long_context)
