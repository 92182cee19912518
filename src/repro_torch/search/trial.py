"""Trial: one sampled configuration + its evaluation lifecycle.

API mirrors the Optuna surface the paper relies on (§III, §V):
``suggest_categorical/int/float``, intermediate ``report`` + ``should_prune``
for pruners, and user attributes for bookkeeping (e.g. measured hardware
cost from the deployment pipeline).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple


class TrialState(enum.Enum):
    RUNNING = "running"
    COMPLETE = "complete"
    PRUNED = "pruned"
    FAIL = "fail"
    INFEASIBLE = "infeasible"  # hard constraint violated
    SCREENED = "screened"      # cut by a fidelity-cascade screening stage


@dataclasses.dataclass
class Distribution:
    kind: str  # "categorical" | "int" | "float"
    choices: Optional[Tuple[Any, ...]] = None
    low: Optional[float] = None
    high: Optional[float] = None
    step: Optional[float] = None
    log: bool = False

    def grid(self) -> Tuple[Any, ...]:
        if self.kind == "categorical":
            return tuple(self.choices)
        if self.kind == "int":
            step = int(self.step or 1)
            return tuple(range(int(self.low), int(self.high) + 1, step))
        raise ValueError(f"cannot grid a continuous distribution")

    def snap_int(self, value: float) -> int:
        """Round an int suggestion onto the ``low + k*step`` grid, clamped
        so the result never leaves [low, high]."""
        step = int(self.step or 1)
        lo, hi = int(self.low), int(self.high)
        v = lo + step * int(round((value - lo) / step))
        return max(lo, min(v, lo + step * ((hi - lo) // step)))

    def perturb(self, rng, value: Any) -> Any:
        """Local (polynomial-style) mutation: perturb ``value`` instead of
        resampling uniformly, so late mutations explore around the current
        front rather than teleporting across the domain.  Categorical
        distributions fall back to a uniform resample."""
        if self.kind == "float":
            span = float(self.high) - float(self.low)
            v = value + rng.gauss(0.0, 0.15 * span)
            return min(max(v, float(self.low)), float(self.high))
        if self.kind == "int":
            span = int(self.high) - int(self.low)
            step = int(self.step or 1)
            v = value + rng.gauss(0.0, max(0.15 * span, step))
            return self.snap_int(v)
        return self.random(rng)

    def random(self, rng) -> Any:
        if self.kind == "categorical":
            return self.choices[rng.randrange(len(self.choices))]
        if self.kind == "int":
            if self.log:
                lo, hi = math.log(self.low), math.log(self.high)
                # snap keeps log-sampled values on the step grid
                return self.snap_int(math.exp(lo + (hi - lo) * rng.random()))
            step = int(self.step or 1)
            n = (int(self.high) - int(self.low)) // step
            return int(self.low) + step * rng.randrange(n + 1)
        if self.kind == "float":
            if self.log:
                lo, hi = math.log(self.low), math.log(self.high)
                return math.exp(lo + (hi - lo) * rng.random())
            return self.low + (self.high - self.low) * rng.random()
        raise ValueError(self.kind)

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d.get("choices") is not None:
            d["choices"] = list(d["choices"])
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Distribution":
        d = dict(d)
        if d.get("choices") is not None:
            d["choices"] = tuple(d["choices"])
        return cls(**d)


class Trial:
    def __init__(self, number: int, study):
        self.number = number
        self.study = study
        self.params: Dict[str, Any] = {}
        self.distributions: Dict[str, Distribution] = {}
        self.state = TrialState.RUNNING
        self.values: Optional[Tuple[float, ...]] = None
        self.intermediate: Dict[int, float] = {}
        self.user_attrs: Dict[str, Any] = {}
        self.system_attrs: Dict[str, Any] = {}

    # -- suggestions ---------------------------------------------------------

    def _suggest(self, name: str, dist: Distribution) -> Any:
        if name in self.params:
            return self.params[name]
        value = self.study.sampler.sample(self.study, self, name, dist)
        self.params[name] = value
        self.distributions[name] = dist
        return value

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, Distribution("categorical", choices=tuple(choices)))

    def suggest_int(self, name: str, low: int, high: int, step: int = 1, log: bool = False) -> int:
        return int(self._suggest(name, Distribution("int", low=low, high=high, step=step, log=log)))

    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        return float(self._suggest(name, Distribution("float", low=low, high=high, log=log)))

    # -- pruning -------------------------------------------------------------

    def report(self, step: int, value: float) -> None:
        self.intermediate[int(step)] = float(value)

    def should_prune(self) -> bool:
        pruner = self.study.pruner
        if pruner is None or not self.intermediate:
            return False
        return pruner.prune(self.study, self)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "number": self.number,
            "state": self.state.value,
            "values": list(self.values) if self.values is not None else None,
            "params": self.params,
            "distributions": {k: d.to_dict() for k, d in self.distributions.items()},
            "intermediate": {str(k): v for k, v in self.intermediate.items()},
            "user_attrs": self.user_attrs,
            "system_attrs": self.system_attrs,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any], study=None) -> "Trial":
        t = cls(d["number"], study)
        t.state = TrialState(d["state"])
        t.values = tuple(d["values"]) if d.get("values") is not None else None
        t.params = dict(d.get("params", {}))
        t.distributions = {
            k: Distribution.from_dict(v) for k, v in d.get("distributions", {}).items()
        }
        t.intermediate = {int(k): v for k, v in d.get("intermediate", {}).items()}
        t.user_attrs = dict(d.get("user_attrs", {}))
        t.system_attrs = dict(d.get("system_attrs", {}))
        return t

    @property
    def value(self) -> Optional[float]:
        return self.values[0] if self.values else None
