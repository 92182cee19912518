"""Deterministic, seeded fault injection for chaos testing.

The crash-safety story of the storage, cache, and remote layers is only
trustworthy if it is *exercised*: this module threads named fault sites
through the seams the engine already owns and lets a test (or an
operator reproducing an incident) inject crashes, delays, corruption,
and dropped frames on a fixed seed — the same schedule every run, on
every backend.

Sites (see :data:`SITES`) are crossed with actions:

``raise``
    Raise :class:`InjectedFault` at the site.  The hardened caller is
    expected to degrade (cache miss, skipped persist, resubmitted
    trial) rather than propagate.
``kill``
    ``SIGKILL`` the *current process* — a real crash, no cleanup, no
    ``finally`` blocks.  Only meaningful at sites that run inside a
    worker process/daemon (``worker.trial``); in a serial study it
    would kill the study itself.
``delay``
    Sleep ``delay_s`` seconds, then continue.  Turns races (compaction
    vs. writer, heartbeat vs. result) from rare interleavings into
    deterministic ones.
``corrupt``
    Damage the payload the site is about to commit: ``str`` payloads
    are truncated at a seeded offset (a torn write), ``bytes`` payloads
    get one seeded byte flipped (bit rot / a mangled frame).  The site
    then proceeds with the damaged payload, and the *reader's*
    integrity checks (CRC32, JSON parse, torn-tail recovery) must cope.
``drop``
    The site returns the :data:`DROP` sentinel and the caller silently
    skips the operation (an unsent frame, a swallowed record).

Plans are deterministic: every rule owns a ``random.Random`` seeded
from ``(plan seed, rule index, site, action)``, so probabilistic rules
(``p=0.25``) fire on the same hits in every run.

Activation is explicit and cheap when off: :func:`fault_point` is a
single global load + ``is None`` test until :func:`install` is called
(directly, by the ``faults:`` spec section, or by the ``REPRO_FAULTS``
environment variable — which spawned worker processes inherit, so one
knob covers the whole tree).

Must stay import-light (stdlib only): the disk cache and the kernel
transport call :func:`fault_point` on their hot paths.
"""
from __future__ import annotations

import os
import signal
import threading
import time
import zlib
from random import Random
from typing import Any, Dict, List, Optional

__all__ = [
    "SITES", "ACTIONS", "DROP", "InjectedFault", "FaultRule", "FaultPlan",
    "fault_point", "install", "uninstall", "active_plan",
]

#: Every named seam a rule may target.  Adding a site means adding a
#: ``fault_point`` call at the seam *and* hardening for what the
#: injector can now do there.
SITES = (
    "disk_cache.read",   # one record line, before parse (str payload)
    "disk_cache.write",  # one record line, before append (str payload)
    "study.persist",     # one trial JSONL line, before append (str payload)
    "transport.send",    # pickled frame payload, before write (bytes)
    "transport.recv",    # pickled frame payload, after read (bytes)
    "worker.trial",      # entering a detached trial (key = trial number)
    "executor.submit",   # executor accepting a trial (key = trial number)
    "compile",           # entering XLAGenerator.generate
)

ACTIONS = ("raise", "kill", "delay", "corrupt", "drop")


class InjectedFault(Exception):
    """Raised by a ``raise`` rule.  Hardened callers treat it exactly
    like the real fault it stands in for (an ``OSError``, a lost
    worker) — never as a test artifact to special-case."""


class _DropSentinel:
    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<faults.DROP>"


#: Returned by :func:`fault_point` when a ``drop`` rule fires; the
#: caller skips the operation (doesn't send the frame / write the line).
DROP = _DropSentinel()


def _corrupt(rng: Random, payload: Any) -> Any:
    if isinstance(payload, (bytes, bytearray)):
        buf = bytearray(payload)
        if not buf:
            return bytes(buf)
        buf[rng.randrange(len(buf))] ^= rng.randrange(1, 256)
        return bytes(buf)
    if isinstance(payload, str):
        if len(payload) <= 1:
            return ""
        return payload[:rng.randrange(1, len(payload))]
    return payload


class FaultRule:
    """One (site, action) schedule entry.

    ``p``        activation probability per eligible hit (default 1.0).
    ``times``    total activation cap (default unlimited).
    ``after``    skip the first N hits (default 0).
    ``delay_s``  sleep length for ``delay`` rules (default 0.05).
    ``key``      only hits whose ``key`` stringifies to this activate —
                 e.g. ``key=3`` on ``worker.trial`` marks trial 3 as
                 the poison trial.
    """

    __slots__ = ("site", "action", "p", "times", "after", "delay_s", "key")

    def __init__(self, site: str, action: str, *, p: float = 1.0,
                 times: Optional[int] = None, after: int = 0,
                 delay_s: float = 0.05, key: Optional[str] = None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (one of {', '.join(SITES)})")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} (one of {', '.join(ACTIONS)})")
        if not (0.0 < p <= 1.0):
            raise ValueError(f"fault probability must be in (0, 1], got {p!r}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times!r}")
        if after < 0:
            raise ValueError(f"after must be >= 0, got {after!r}")
        if delay_s <= 0:
            raise ValueError(f"delay_s must be > 0, got {delay_s!r}")
        self.site = site
        self.action = action
        self.p = p
        self.times = times
        self.after = after
        self.delay_s = delay_s
        self.key = None if key is None else str(key)

    _PARAMS = ("p", "times", "after", "delay_s", "key")

    @classmethod
    def from_string(cls, segment: str) -> "FaultRule":
        """``site:action`` or ``site:action@p=0.5,times=2,key=3``."""
        head, _, params = segment.partition("@")
        site, sep, action = head.partition(":")
        if not sep:
            raise ValueError(
                f"fault rule {segment!r} must look like 'site:action[@k=v,...]'")
        kwargs: Dict[str, Any] = {}
        for pair in filter(None, (p.strip() for p in params.split(","))):
            name, sep, raw = pair.partition("=")
            if not sep or name not in cls._PARAMS:
                raise ValueError(
                    f"bad fault rule param {pair!r} (one of {', '.join(cls._PARAMS)})")
            if name == "key":
                kwargs[name] = raw
            elif name in ("p", "delay_s"):
                kwargs[name] = float(raw)
            else:
                kwargs[name] = int(raw)
        return cls(site.strip(), action.strip(), **kwargs)

    def to_string(self) -> str:
        params = []
        if self.p != 1.0:
            params.append(f"p={self.p}")
        if self.times is not None:
            params.append(f"times={self.times}")
        if self.after:
            params.append(f"after={self.after}")
        if self.delay_s != 0.05:
            params.append(f"delay_s={self.delay_s}")
        if self.key is not None:
            params.append(f"key={self.key}")
        head = f"{self.site}:{self.action}"
        return head + ("@" + ",".join(params) if params else "")

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "FaultRule":
        unknown = set(raw) - {"site", "action", *cls._PARAMS}
        if unknown:
            raise ValueError(f"unknown fault rule keys: {sorted(unknown)}")
        if "site" not in raw or "action" not in raw:
            raise ValueError(f"fault rule needs 'site' and 'action': {raw!r}")
        kwargs = {k: raw[k] for k in cls._PARAMS if raw.get(k) is not None}
        return cls(raw["site"], raw["action"], **kwargs)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"site": self.site, "action": self.action}
        if self.p != 1.0:
            out["p"] = self.p
        if self.times is not None:
            out["times"] = self.times
        if self.after:
            out["after"] = self.after
        if self.delay_s != 0.05:
            out["delay_s"] = self.delay_s
        if self.key is not None:
            out["key"] = self.key
        return out


class _RuleState:
    __slots__ = ("hits", "fired", "rng")

    def __init__(self, rng: Random):
        self.hits = 0
        self.fired = 0
        self.rng = rng


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s plus per-rule counters."""

    def __init__(self, rules: List[FaultRule], *, seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._state = [
            _RuleState(Random(zlib.crc32(
                f"{self.seed}:{i}:{r.site}:{r.action}".encode())))
            for i, r in enumerate(self.rules)
        ]

    # -- construction --------------------------------------------------------

    @classmethod
    def from_string(cls, spec: str) -> "FaultPlan":
        """``"seed=7;worker.trial:kill@key=3;disk_cache.write:corrupt@p=0.25"``"""
        seed = 0
        rules: List[FaultRule] = []
        for segment in filter(None, (s.strip() for s in spec.split(";"))):
            if segment.startswith("seed="):
                seed = int(segment[len("seed="):])
            else:
                rules.append(FaultRule.from_string(segment))
        return cls(rules, seed=seed)

    @classmethod
    def from_spec(cls, raw: Dict[str, Any]) -> "FaultPlan":
        """Dict form (the ``faults:`` experiment-spec section):
        ``{"seed": 7, "rules": [{"site": ..., "action": ...}, ...]}``.
        Rules may also be given as spec strings."""
        if not isinstance(raw, dict):
            raise ValueError(f"faults spec must be a mapping, got {type(raw).__name__}")
        unknown = set(raw) - {"seed", "rules"}
        if unknown:
            raise ValueError(f"unknown faults keys: {sorted(unknown)}")
        rules_raw = raw.get("rules") or []
        if not isinstance(rules_raw, list):
            raise ValueError("faults.rules must be a list")
        rules = [
            FaultRule.from_string(r) if isinstance(r, str) else FaultRule.from_dict(r)
            for r in rules_raw
        ]
        return cls(rules, seed=raw.get("seed", 0))

    def to_string(self) -> str:
        """The ``REPRO_FAULTS`` encoding — how a plan rides the
        environment into spawned process workers and daemons."""
        parts = [f"seed={self.seed}"] if self.seed else []
        parts.extend(r.to_string() for r in self.rules)
        return ";".join(parts)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"rules": [r.to_dict() for r in self.rules]}
        if self.seed:
            out["seed"] = self.seed
        return out

    # -- introspection -------------------------------------------------------

    def counters(self) -> List[Dict[str, Any]]:
        """Per-rule hit/activation counts (for assertions and reports)."""
        with self._lock:
            return [
                {"rule": r.to_string(), "hits": s.hits, "fired": s.fired}
                for r, s in zip(self.rules, self._state)
            ]

    # -- the injection path --------------------------------------------------

    def apply(self, site: str, payload: Any, key: Any) -> Any:
        for idx, rule in enumerate(self.rules):
            if rule.site != site:
                continue
            if rule.key is not None and (key is None or str(key) != rule.key):
                continue
            with self._lock:
                state = self._state[idx]
                state.hits += 1
                if state.hits <= rule.after:
                    continue
                if rule.times is not None and state.fired >= rule.times:
                    continue
                if rule.p < 1.0 and state.rng.random() >= rule.p:
                    continue
                state.fired += 1
                rng = state.rng
            action = rule.action
            if action == "delay":
                time.sleep(rule.delay_s)
            elif action == "corrupt":
                payload = _corrupt(rng, payload)
            elif action == "drop":
                return DROP
            elif action == "raise":
                raise InjectedFault(f"injected fault at {site}"
                                    + (f" (key={key})" if key is not None else ""))
            elif action == "kill":  # pragma: no cover - kills the process
                os.kill(os.getpid(), signal.SIGKILL)
        return payload


# -- module state ------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def fault_point(site: str, payload: Any = None, *, key: Any = None) -> Any:
    """The seam marker.  With no plan installed this is one global load
    and an ``is None`` test — the hot path pays nothing.  With a plan,
    matching rules run in order and may raise, kill, sleep, corrupt the
    payload, or return :data:`DROP`."""
    plan = _PLAN
    if plan is None:
        return payload
    return plan.apply(site, payload, key)


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (and return it)."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def _install_from_env() -> None:
    # Spawned process workers and `python -m repro.worker` daemons
    # import this module fresh and inherit the parent's environment, so
    # a plan installed via REPRO_FAULTS covers the whole process tree.
    from repro_torch.envvars import read_env

    plan = read_env("REPRO_FAULTS", None)
    if plan is not None and plan.rules:
        install(plan)


_install_from_env()
