"""Search-space translation: SearchSpaceDef + Trial -> ArchitectureIR.

This is the paper's "search space translator": the declarative space is
walked during each trial; every decision point becomes a named suggestion
(`<block>.<layer>.<op>.<param>`), which makes the space Optuna-compatible
(conditional decisions only materialize when their parent choice selects
them) and keeps trial records reproducible.

Models are *not* instantiated here — the output is an intermediate
architectural representation (a flat list of LayerIR with expanded
composites), consumed by the ModelBuilder (paper §IV-C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core.space import BlockDef, RepeatSpec, SearchSpaceDef, SpaceError
from repro_torch.search.trial import Trial


@dataclasses.dataclass
class LayerIR:
    op: str
    params: Dict[str, Any]
    path: str  # provenance: block path in the space (for debugging/repro)


@dataclasses.dataclass
class ArchitectureIR:
    layers: List[LayerIR]
    preprocessing: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def signature(self) -> str:
        """Canonical identity of the *full* candidate: pre-processing AND
        layers.  The pre-processing stages compile into the same XLA
        program as the model, so two candidates with identical layers but
        different pre-processing are different programs — omitting the
        stages here caused cache collisions in compiled-cost estimators."""
        body = "|".join(
            f"{l.op}({','.join(f'{k}={v}' for k, v in sorted(l.params.items()))})"
            for l in self.layers
        )
        if not self.preprocessing:
            return body
        pre = "|".join(
            f"{s.get('stage')}({','.join(f'{k}={v}' for k, v in sorted(s.items()) if k != 'stage')})"
            for s in self.preprocessing
        )
        return f"{pre}>>{body}"


def _suggest_value(trial: Trial, name: str, spec: Any) -> Any:
    """Fixed scalar, [choices] list, or {low, high, step?, log?} range."""
    if isinstance(spec, dict) and "low" in spec and "high" in spec:
        if isinstance(spec["low"], float) or isinstance(spec["high"], float) or spec.get("float"):
            return trial.suggest_float(name, float(spec["low"]), float(spec["high"]), log=bool(spec.get("log")))
        return trial.suggest_int(name, int(spec["low"]), int(spec["high"]), step=int(spec.get("step", 1)), log=bool(spec.get("log")))
    if isinstance(spec, (list, tuple)):
        return trial.suggest_categorical(name, list(spec))
    return spec  # fixed value — not a search decision


def _sample_op_params(trial: Trial, space: SearchSpaceDef, block: BlockDef, op: str, prefix: str) -> Dict[str, Any]:
    out = {}
    for pname, pspec in space.op_params(block, op).items():
        out[pname] = _suggest_value(trial, f"{prefix}.{op}.{pname}", pspec)
    return out


def _sample_depth(trial: Trial, repeat: Optional[RepeatSpec], prefix: str) -> int:
    if repeat is None or repeat.depth is None:
        return 1
    if isinstance(repeat.depth, int):
        return repeat.depth
    return int(trial.suggest_categorical(f"{prefix}.depth", list(repeat.depth)))


class SpaceTranslator:
    """Walks a SearchSpaceDef with a Trial, expanding repeats/composites."""

    def __init__(self, space: SearchSpaceDef, allowed_ops: Optional[set] = None):
        self.space = space
        # backend reflection (paper §VI): mask op_candidates to what the
        # target generator supports
        self.allowed_ops = allowed_ops
        self._block_layers: Dict[str, List[LayerIR]] = {}

    def _candidates(self, block: BlockDef) -> List[str]:
        cands = block.op_candidates
        if self.allowed_ops is not None:
            masked = [c for c in cands if c in self.allowed_ops or c in self.space.composites]
            if not masked:
                raise SpaceError(
                    f"block {block.name!r}: no op candidate supported by backend "
                    f"(candidates={cands})"
                )
            cands = masked
        return cands

    def _expand_op(self, trial: Trial, block: BlockDef, op: str, prefix: str) -> List[LayerIR]:
        """One sampled op -> one LayerIR, or a composite's expansion."""
        if op in self.space.composites:
            layers: List[LayerIR] = []
            for sub in self.space.composites[op]:
                layers.extend(self._expand_block(trial, sub, f"{prefix}/{op}"))
            return layers
        params = _sample_op_params(trial, self.space, block, op, prefix)
        return [LayerIR(op=op, params=params, path=prefix)]

    def _expand_block(self, trial: Trial, block: BlockDef, path: str) -> List[LayerIR]:
        prefix = f"{path}/{block.name}" if path else block.name
        repeat = block.repeat
        mode = repeat.mode if repeat else None

        if mode == "repeat_block":
            ref = repeat.ref_block
            if ref not in self._block_layers:
                raise SpaceError(
                    f"block {block.name!r}: ref_block {ref!r} not expanded yet "
                    "(must appear earlier in the sequence)"
                )
            depth = _sample_depth(trial, repeat, prefix)
            layers = []
            for _ in range(depth):
                layers.extend(
                    LayerIR(op=l.op, params=dict(l.params), path=f"{prefix}<~{ref}")
                    for l in self._block_layers[ref]
                )
            self._block_layers[block.name] = layers
            return layers

        depth = _sample_depth(trial, repeat, prefix)
        cands = self._candidates(block)

        def choose_op(layer_prefix: str) -> str:
            if len(cands) == 1:
                return cands[0]
            return trial.suggest_categorical(f"{layer_prefix}.op", cands)

        layers = []
        if mode is None:
            op = choose_op(prefix)
            layers = self._expand_op(trial, block, op, prefix)
        elif mode == "vary_all":
            for i in range(depth):
                op = choose_op(f"{prefix}.{i}")
                layers.extend(self._expand_op(trial, block, op, f"{prefix}.{i}"))
        elif mode == "repeat_op":
            op = choose_op(prefix)
            for i in range(depth):
                layers.extend(self._expand_op(trial, block, op, f"{prefix}.{i}"))
        elif mode == "repeat_params":
            op = choose_op(prefix)
            once = self._expand_op(trial, block, op, prefix)
            for i in range(depth):
                layers.extend(LayerIR(op=l.op, params=dict(l.params), path=f"{prefix}.{i}") for l in once)
        else:
            raise SpaceError(f"unhandled repeat mode {mode!r}")

        self._block_layers[block.name] = layers
        return layers

    def sample(self, trial: Trial) -> ArchitectureIR:
        self._block_layers = {}
        layers: List[LayerIR] = []
        for block in self.space.blocks:
            layers.extend(self._expand_block(trial, block, ""))
        pre = sample_preprocessing(trial, self.space)
        return ArchitectureIR(layers=layers, preprocessing=pre)


def sample_preprocessing(trial: Trial, space: SearchSpaceDef) -> List[Dict[str, Any]]:
    """Jointly sample the pre-processing pipeline (paper §IV-E)."""
    stages = []
    for stage, params in space.preprocessing.items():
        sampled = {"stage": stage}
        for pname, pspec in params.items():
            sampled[pname] = _suggest_value(trial, f"pre/{stage}.{pname}", pspec)
        stages.append(sampled)
    return stages


def sample_architecture(space: SearchSpaceDef, trial: Trial, allowed_ops=None) -> ArchitectureIR:
    return SpaceTranslator(space, allowed_ops=allowed_ops).sample(trial)
