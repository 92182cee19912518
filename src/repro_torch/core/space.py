"""YAML search-space DSL -> SearchSpaceDef IR (paper §IV, Listings 1-3).

Top-level syntax::

    input: <SHAPE>            # e.g. [4, 1250]  (channels, length)
    output: <INT>
    sequence:
      - block: <UNIQUE_BLOCK_NAME>
        op_candidates: <OP_NAME> | [<OP_NAME>, ...]
        type_repeat:                      # optional
          type: repeat_op | repeat_params | vary_all | repeat_block
          depth: <INT | [INT, ...]>       # optional
          ref_block: <BLOCK_NAME>         # repeat_block only
        <OP_NAME>:
          <PARAM>: <VALUE | [CHOICES] | {low:, high:, step:, log:}>
    default_op_params:                    # global fallback (paper §IV-A)
      <OP_NAME>: {<PARAM>: <VALUE|CHOICES|RANGE>}
    composites:                           # reusable sub-search-spaces (§IV-B)
      <NAME>:
        sequence: [ ...blocks... ]
    preprocessing:                        # joint pre-processing space (§IV-E)
      <STAGE>: {<PARAM>: <VALUE|CHOICES|RANGE>}

Repeat semantics follow paper Table I:
  repeat_op     — one op for the whole block, params resampled per layer
  repeat_params — op AND params sampled once, reused for every layer
  vary_all      — op and params sampled independently per layer
  repeat_block  — repeat the *sampled* configuration of ``ref_block``
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

REPEAT_MODES = ("repeat_op", "repeat_params", "vary_all", "repeat_block")


class SpaceError(ValueError):
    pass


@dataclasses.dataclass
class RepeatSpec:
    mode: str
    depth: Optional[Union[int, List[int]]] = None
    ref_block: Optional[str] = None

    def __post_init__(self):
        if self.mode not in REPEAT_MODES:
            raise SpaceError(f"unknown repeat mode {self.mode!r}; expected one of {REPEAT_MODES}")
        if self.mode == "repeat_block" and not self.ref_block:
            raise SpaceError("repeat_block requires ref_block")
        if self.mode == "repeat_op" and self.depth is None:
            raise SpaceError("repeat_op requires depth")


@dataclasses.dataclass
class BlockDef:
    name: str
    op_candidates: List[str]
    repeat: Optional[RepeatSpec] = None
    local_params: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchSpaceDef:
    input_shape: Tuple[int, ...]
    output_dim: int
    blocks: List[BlockDef]
    default_op_params: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    composites: Dict[str, List[BlockDef]] = dataclasses.field(default_factory=dict)
    preprocessing: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def op_params(self, block: BlockDef, op: str) -> Dict[str, Any]:
        """Local params override the global default_op_params fallback."""
        merged = dict(self.default_op_params.get(op, {}))
        merged.update(block.local_params.get(op, {}))
        return merged


RESERVED_KEYS = {"block", "op_candidates", "type_repeat"}


def _parse_block(raw: Dict[str, Any]) -> BlockDef:
    if "block" not in raw:
        raise SpaceError(f"sequence entry missing 'block': {raw}")
    name = str(raw["block"])
    cands = raw.get("op_candidates")
    if cands is None:
        raise SpaceError(f"block {name!r} missing op_candidates")
    if isinstance(cands, str):
        cands = [cands]
    repeat = None
    if "type_repeat" in raw:
        tr = raw["type_repeat"]
        repeat = RepeatSpec(
            mode=str(tr.get("type")),
            depth=tr.get("depth"),
            ref_block=tr.get("ref_block") or tr.get("reference_block"),
        )
    local = {k: dict(v) for k, v in raw.items() if k not in RESERVED_KEYS and isinstance(v, dict)}
    return BlockDef(name=name, op_candidates=[str(c) for c in cands], repeat=repeat, local_params=local)


def parse_search_space(source: Union[str, Dict[str, Any]]) -> SearchSpaceDef:
    """Parse a YAML string (or pre-loaded dict) into a SearchSpaceDef."""
    if isinstance(source, str):
        # imported only for a YAML string: a dict needs no PyYAML, and
        # the machine with the card has none
        import yaml

        raw = yaml.safe_load(source)
    else:
        raw = source
    if not isinstance(raw, dict):
        raise SpaceError("search space must be a mapping")
    if "sequence" not in raw:
        raise SpaceError("search space missing top-level 'sequence'")
    inp = raw.get("input")
    input_shape = tuple(inp) if isinstance(inp, (list, tuple)) else ((int(inp),) if inp is not None else ())
    output_dim = int(raw.get("output", 0))
    blocks = [_parse_block(b) for b in raw["sequence"]]
    names = [b.name for b in blocks]
    if len(set(names)) != len(names):
        raise SpaceError(f"duplicate block names: {names}")
    composites = {}
    for cname, cdef in (raw.get("composites") or {}).items():
        if "sequence" not in cdef:
            raise SpaceError(f"composite {cname!r} missing 'sequence'")
        composites[str(cname)] = [_parse_block(b) for b in cdef["sequence"]]
    space = SearchSpaceDef(
        input_shape=input_shape,
        output_dim=output_dim,
        blocks=blocks,
        default_op_params={str(k): dict(v) for k, v in (raw.get("default_op_params") or {}).items()},
        composites=composites,
        preprocessing={str(k): dict(v) for k, v in (raw.get("preprocessing") or {}).items()},
    )
    _validate(space)
    return space


def parse_search_space_file(path: str) -> SearchSpaceDef:
    with open(path) as f:
        return parse_search_space(f.read())


def _validate(space: SearchSpaceDef) -> None:
    block_names = {b.name for b in space.blocks}
    for blocks in [space.blocks] + list(space.composites.values()):
        for b in blocks:
            if b.repeat and b.repeat.mode == "repeat_block":
                if b.repeat.ref_block not in block_names:
                    raise SpaceError(
                        f"block {b.name!r}: ref_block {b.repeat.ref_block!r} is not a defined block"
                    )
    # composite recursion guard
    def expand(name: str, stack: Tuple[str, ...]):
        if name in stack:
            raise SpaceError(f"composite cycle: {' -> '.join(stack + (name,))}")
        for b in space.composites.get(name, []):
            for cand in b.op_candidates:
                if cand in space.composites:
                    expand(cand, stack + (name,))

    for cname in space.composites:
        expand(cname, ())
