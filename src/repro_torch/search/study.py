"""Study: the optimization loop driver (+ resumable JSONL storage).

Mirrors Optuna's surface used by the paper: ``optimize(objective,
n_trials)``, multi-objective ``directions``, ``best_trial`` /
``best_trials`` (Pareto), ask/tell, pruning via exceptions, and a
crash-tolerant append-only storage so pod-scale NAS runs resume after
preemption (the framework's fault-tolerance story applies to the search
layer too, not just training).
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import faults
from repro_torch.ioutils import lock_file, locked_append, unlock_file
from repro_torch.search.samplers import BaseSampler, RandomSampler, pareto_front
from repro_torch.search.trial import Distribution, Trial, TrialState


class TrialPruned(Exception):
    pass


class HardConstraintViolated(Exception):
    def __init__(self, name: str, value: float, limit: float,
                 direction: str = "minimize"):
        op = ">" if direction == "minimize" else "<"
        super().__init__(f"hard constraint '{name}' violated: {value} {op} {limit}")
        self.name, self.value, self.limit = name, value, limit
        self.direction = direction


def evaluate_trial(objective: Callable[[Trial], object], trial,
                   catch: Tuple) -> Tuple[Optional[object], TrialState]:
    """One objective call -> (values, state); control-flow exceptions map
    to trial states, anything else propagates to the caller.  The single
    source of this mapping: the serial Study loop and every executor
    backend (``repro.search.executors``) go through it, so they cannot
    drift."""
    try:
        return objective(trial), TrialState.COMPLETE
    except TrialPruned:
        return None, TrialState.PRUNED
    except HardConstraintViolated as e:
        trial.set_user_attr("violated", {"name": e.name, "value": e.value, "limit": e.limit})
        return None, TrialState.INFEASIBLE
    except catch as e:  # noqa: B030 — user-supplied exception classes
        trial.set_user_attr("error", repr(e))
        return None, TrialState.FAIL


class Study:
    def __init__(
        self,
        name: str = "study",
        sampler: Optional[BaseSampler] = None,
        pruner=None,
        directions: Sequence[str] = ("minimize",),
        storage: Optional[str] = None,
    ):
        for d in directions:
            assert d in ("minimize", "maximize"), d
        self.name = name
        self.sampler = sampler or RandomSampler()
        self.pruner = pruner
        self.directions = tuple(directions)
        self.storage = storage
        self.trials: List[Trial] = []
        self.distribution_registry: Dict[str, Distribution] = {}
        self._lock = threading.RLock()  # guards trials + registry + storage
        self._repair_to: Optional[int] = None  # byte offset of torn tail, if any
        if storage and os.path.exists(storage):
            self._load(storage)

    # -- persistence ----------------------------------------------------------

    def _load(self, path: str) -> None:
        # A crash mid-append (power loss, SIGKILL inside locked_append)
        # leaves a torn final record: truncated JSON, usually without its
        # newline.  That must never make the study unresumable — parse
        # what's intact, warn about the rest, and remember the byte
        # offset of the tail so the next persist truncates it away
        # (otherwise the append would concatenate onto the torn bytes
        # and corrupt the *next* record too).
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        intact_end = 0
        bad = 0
        for chunk in data.splitlines(keepends=True):
            start, pos = pos, pos + len(chunk)
            line = chunk.strip()
            if not line:
                intact_end = pos
                continue
            try:
                if not chunk.endswith(b"\n"):
                    raise ValueError("no trailing newline")
                rec = json.loads(line)
                trial_raw = rec["trial"] if rec.get("kind") == "trial" else None
                t = Trial.from_dict(trial_raw, self) if trial_raw else None
            except (ValueError, KeyError, TypeError):
                bad += 1
                continue
            intact_end = pos
            if t is not None:
                existing = {x.number: i for i, x in enumerate(self.trials)}
                if t.number in existing:
                    self.trials[existing[t.number]] = t
                else:
                    self.trials.append(t)
        if bad:
            torn_tail = intact_end < len(data)
            warnings.warn(
                f"study storage {path!r}: skipped {bad} unreadable "
                f"record(s) (torn write or corruption); resuming from "
                f"{len(self.trials)} intact trial(s)"
                + (" and repairing the torn tail on next persist"
                   if torn_tail else ""),
                RuntimeWarning, stacklevel=2)
            if torn_tail:
                self._repair_to = intact_end
        # Rebuild the distribution registry from the persisted trials so
        # grid-position bookkeeping (GridSampler's mixed-radix sweep)
        # continues where the crashed run stopped instead of restarting.
        for t in self.trials:
            for name, dist in t.distributions.items():
                self.distribution_registry.setdefault(name, dist)

    def _persist(self, trial: Trial) -> None:
        if not self.storage:
            return
        os.makedirs(os.path.dirname(self.storage) or ".", exist_ok=True)
        line = json.dumps({"kind": "trial", "trial": trial.to_dict()}) + "\n"
        line = faults.fault_point("study.persist", line)
        if line is faults.DROP:
            return
        if self._repair_to is not None:
            # Truncate the torn tail _load found before appending over
            # it.  Only the study-owning process appends to its storage
            # (executors tell in the parent), so truncating under the
            # file lock cannot drop a sibling's record.
            offset, self._repair_to = self._repair_to, None
            with open(self.storage, "r+b") as f:
                how = lock_file(f, self.storage)
                try:
                    f.truncate(offset)
                    f.seek(0, os.SEEK_END)
                    f.write(line.encode())
                    f.flush()
                    os.fsync(f.fileno())
                finally:
                    unlock_file(f, how)
            return
        # Lock-safe append: serialized against sibling threads by the study
        # lock (callers hold it) and against other processes sharing the
        # storage file by the flock inside locked_append.
        locked_append(self.storage, line)

    # -- ask / tell -------------------------------------------------------------

    def ask(self) -> Trial:
        with self._lock:
            trial = Trial(len(self.trials), self)
            self.trials.append(trial)
            self.sampler.on_trial_start(self, trial)
            return trial

    def tell(self, trial: Trial, values, state: TrialState = TrialState.COMPLETE) -> None:
        # The whole transition happens under the study lock: concurrent
        # best_trial / completed_trials readers must never observe a trial
        # whose state says COMPLETE while values is still being written
        # (or vice versa), and storage must get exactly one final record.
        with self._lock:
            if trial.state != TrialState.RUNNING:
                raise RuntimeError(
                    f"trial {trial.number} was already told "
                    f"(state={trial.state.value}); telling it again would "
                    "append a duplicate record to storage"
                )
            if values is not None:
                if isinstance(values, (int, float)):
                    values = (float(values),)
                trial.values = tuple(float(v) for v in values)
            trial.state = state
            self._persist(trial)

    # -- optimize ---------------------------------------------------------------

    def optimize(self, objective: Callable[[Trial], object], n_trials: int,
                 catch: Tuple = ()) -> None:
        for _ in range(n_trials):
            trial = self.ask()
            values, state = evaluate_trial(objective, trial, catch)
            self.tell(trial, values, state)

    # -- results ---------------------------------------------------------------

    @property
    def completed_trials(self) -> List[Trial]:
        with self._lock:
            return [t for t in self.trials if t.state == TrialState.COMPLETE and t.values]

    @property
    def best_trial(self) -> Optional[Trial]:
        done = self.completed_trials
        if not done:
            return None
        sign = 1.0 if self.directions[0] == "minimize" else -1.0
        return min(done, key=lambda t: sign * t.values[0])

    @property
    def best_trials(self) -> List[Trial]:
        """Pareto-optimal set under all directions."""
        with self._lock:
            return pareto_front(self.trials, self.directions)
