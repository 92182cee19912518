"""Architecture config protocol + the 4 assigned input-shape cells.

Each ``configs/<arch>.py`` exposes ``ARCH: ArchConfig`` with:
  * ``spec_fn(long_context)``  — the exact published configuration
  * ``smoke_spec_fn()``        — reduced same-family config for CPU tests
  * ``batch_kind``             — "lm" | "encdec" | "vlm" (input dict layout)
  * ``supports_long_context``  — whether the ``long_500k`` decode cell runs
    (sub-quadratic archs only)

``input_specs`` builds shape-only stand-ins (tensors on the ``meta``
device) for every model input of a (arch x shape) cell: nothing is
allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.specs import ModelSpec


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq: int
    batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1, long_context=True),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | hybrid | ssm | audio | moe | vlm
    spec_fn: Callable[..., ModelSpec]
    smoke_spec_fn: Callable[[], ModelSpec]
    batch_kind: str = "lm"
    supports_long_context: bool = False
    enc_context: int = 1500  # enc-dec: encoder frames available at decode
    prefix_tokens: int = 256  # vlm: patch-embedding prefix length
    source: str = ""

    def spec(self, long_context: bool = False) -> ModelSpec:
        return self.spec_fn(long_context=long_context)

    def cell_supported(self, cell: ShapeCell) -> Tuple[bool, str]:
        if cell.long_context and not self.supports_long_context:
            return False, (
                "long_500k requires sub-quadratic sequence mixing; "
                f"{self.name} is a full-attention arch, so the cell is skipped"
            )
        return True, ""


def _tok(b, s):
    return torch.empty((b, s), dtype=torch.long, device="meta")


def _act(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def input_specs(arch: ArchConfig, cell: ShapeCell, spec: Optional[ModelSpec] = None):
    """Shape-only stand-ins (``meta`` tensors) for every model input of this
    cell: the JAX package's shapes, activations in bf16, token ids int64
    (the port's index dtype; the JAX package's are int32).

    Returns (batch_dict, batch_logical_axes).
    """
    spec = spec or arch.spec(long_context=cell.long_context)
    b, s = cell.batch, cell.seq
    d = spec.d_model

    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _tok(b, s)}
        axes = {"tokens": ("batch", None)}
        if cell.kind == "train":
            batch["labels"] = _tok(b, s)
            axes["labels"] = ("batch", None)
        if arch.batch_kind == "encdec":
            batch["frames"] = _act(b, s, d)
            axes["frames"] = ("batch", None, None)
        if arch.batch_kind == "vlm":
            batch["patch_embeds"] = _act(b, arch.prefix_tokens, d)
            axes["patch_embeds"] = ("batch", None, None)
        return batch, axes

    if cell.kind == "decode":
        # one new token against a cache of cell.seq
        return {"tokens": _tok(b, 1)}, {"tokens": ("batch", None)}

    raise ValueError(cell.kind)
