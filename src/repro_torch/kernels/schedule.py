"""Kernel schedules: block/tile/chunk parameters as first-class values.

A copy of the JAX package's ``kernels/schedule.py`` (standard library
only), so that requested and effective schedules, their signatures and the
candidate grids are the same in both packages and a cache key written by
one names the same launch in the other:

  * :class:`KernelSchedule` — a frozen (hashable) record of the tunable
    launch parameters: ``block_q``/``block_kv`` for flash attention,
    ``chunk`` for the scan kernels, plus the reference's ``interpret``
    field (kept so a spec's schedules parse the same; the CUDA kernels
    have no interpreter and ignore it);
  * :func:`validate_schedule` — per-kernel legal-range / power-of-two
    checks whose errors name the offending field;
  * :func:`effective_schedule` — the shape-clamped values a call will
    *actually* request (``block_q=128`` on a 64-token sequence is 64);
    cache keys carry these.  The CUDA flash kernel then launches the
    largest tile pair it is built for at or below them, which
    :mod:`repro_torch.kernels.ops` records beside them as ``launched``;
  * :func:`use_schedules` — a context that makes per-kernel schedules
    active for every kernel call resolved inside it, so a generator can
    retarget every kernel in a model without the model's call sites
    knowing about schedules;
  * :func:`record_kernel_calls` — a recorder: every resolved kernel call
    notes its (requested, effective, shapes) into the sink, which is how
    the autotuner discovers which kernels a candidate uses (a forward on
    the ``meta`` device, where the wrappers record and launch nothing).

The named ``default`` schedule is the reference's pre-schedule constants
(every block/chunk = 128).
"""
from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple


class ScheduleError(ValueError):
    """A schedule failed validation; the message names the bad field."""


# size fields each kernel understands (everything else is illegal for it)
KERNEL_FIELDS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("block_q", "block_kv"),
    "ssm_scan": ("chunk",),
    "mlstm_scan": ("chunk",),
}

# legal range for every size field: powers of two within [MIN, MAX].
# 8 is the f32 sublane tile; 1024 comfortably exceeds any VMEM-feasible
# block for these kernels.
MIN_SIZE = 8
MAX_SIZE = 1024

_SIZE_FIELDS = ("block_q", "block_kv", "chunk")


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """One kernel's launch parameters.  ``None`` fields fall back to the
    kernel's default; frozen so an instance can be a dict key."""

    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    chunk: Optional[int] = None
    # tri-state: None = backend detection (REPRO_PALLAS_INTERPRET),
    # True/False = force
    interpret: Optional[bool] = None

    def to_dict(self) -> Dict[str, Any]:
        """Set fields only — round-trips through :meth:`from_dict` and
        stays JSON-minimal for cache records / artifact metadata."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "KernelSchedule":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ScheduleError(
                f"unknown schedule field(s) {unknown}; known fields: "
                f"{sorted(known)}")
        return cls(**dict(raw))

    def merged_over(self, base: "KernelSchedule") -> "KernelSchedule":
        """This schedule with unset fields filled from ``base``."""
        fills = {f.name: getattr(base, f.name)
                 for f in dataclasses.fields(self)
                 if getattr(self, f.name) is None}
        return dataclasses.replace(self, **fills) if fills else self


# the named default: exactly the constants the kernels shipped with
DEFAULT_SCHEDULES: Dict[str, KernelSchedule] = {
    "flash_attention": KernelSchedule(block_q=128, block_kv=128),
    "ssm_scan": KernelSchedule(chunk=128),
    "mlstm_scan": KernelSchedule(chunk=128),
}


def default_schedule(kernel: str) -> KernelSchedule:
    """The named ``default`` schedule (the pre-schedule constants)."""
    _check_kernel(kernel)
    return DEFAULT_SCHEDULES[kernel]


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNEL_FIELDS:
        raise ScheduleError(
            f"unknown kernel {kernel!r}; schedulable kernels: "
            f"{sorted(KERNEL_FIELDS)}")


def validate_schedule(kernel: str, schedule: KernelSchedule) -> KernelSchedule:
    """Raise :class:`ScheduleError` (naming the offending field) unless
    every set size field applies to ``kernel``, is a power of two, and
    lies in ``[MIN_SIZE, MAX_SIZE]``.  Returns the schedule unchanged."""
    _check_kernel(kernel)
    if not isinstance(schedule, KernelSchedule):
        raise ScheduleError(
            f"{kernel}: expected a KernelSchedule, got "
            f"{type(schedule).__name__}")
    legal = KERNEL_FIELDS[kernel]
    for field in _SIZE_FIELDS:
        value = getattr(schedule, field)
        if value is None:
            continue
        if field not in legal:
            raise ScheduleError(
                f"{kernel}: field {field!r} does not apply to this kernel "
                f"(legal fields: {list(legal)})")
        if not isinstance(value, int) or isinstance(value, bool):
            raise ScheduleError(
                f"{kernel}: field {field!r} must be an integer, got "
                f"{value!r}")
        if value < MIN_SIZE or value > MAX_SIZE:
            raise ScheduleError(
                f"{kernel}: field {field!r}={value} outside the legal "
                f"range [{MIN_SIZE}, {MAX_SIZE}]")
        if value & (value - 1):
            raise ScheduleError(
                f"{kernel}: field {field!r}={value} must be a power of two")
    return schedule


def as_schedule(kernel: str, value: Any) -> KernelSchedule:
    """Coerce a mapping / KernelSchedule to a validated schedule with
    every size field filled from the kernel default."""
    if isinstance(value, Mapping):
        value = KernelSchedule.from_dict(value)
    validate_schedule(kernel, value)
    return value.merged_over(default_schedule(kernel))


# Candidate grids swept by the autotuner, default-first so a tune budget
# of 1 degenerates to the named default and a tuned pick can never lose
# to it.  Small on purpose: every candidate is a timed launch.
CANDIDATE_SCHEDULES: Dict[str, Tuple[KernelSchedule, ...]] = {
    "flash_attention": (
        KernelSchedule(block_q=128, block_kv=128),
        KernelSchedule(block_q=64, block_kv=64),
        KernelSchedule(block_q=256, block_kv=256),
        KernelSchedule(block_q=128, block_kv=64),
        KernelSchedule(block_q=64, block_kv=128),
        KernelSchedule(block_q=256, block_kv=128),
        KernelSchedule(block_q=128, block_kv=256),
    ),
    "ssm_scan": tuple(KernelSchedule(chunk=c) for c in (128, 32, 64, 256, 512)),
    "mlstm_scan": tuple(KernelSchedule(chunk=c) for c in (128, 32, 64, 256, 512)),
}

# per-field choices exposed as trial parameters in `kernel_tuning.mode:
# search` — the sampler co-optimizes these alongside the architecture
SEARCH_CHOICES: Dict[str, Tuple[int, ...]] = {
    "block_q": (64, 128, 256),
    "block_kv": (64, 128, 256),
    "chunk": (32, 64, 128, 256),
}


# ---------------------------------------------------------------------------
# effective (shape-clamped) schedules
# ---------------------------------------------------------------------------

def _clamp_block(block: int, seq: int) -> int:
    # the flash-attention clamp: never exceed the (16-floored) sequence
    return min(block, max(16, seq))


def _clamp_chunk(chunk: int, seq: int) -> int:
    # the scan clamp: halve until the chunk divides the sequence
    ck = min(chunk, seq)
    while seq % ck:
        ck //= 2
    return max(ck, 1)


def effective_schedule(kernel: str, schedule: Optional[KernelSchedule],
                       *, seq_len: int, kv_len: Optional[int] = None
                       ) -> KernelSchedule:
    """The launch parameters a call with ``schedule`` actually uses for
    these sequence lengths — the values that must reach cache keys and
    artifact metadata (a requested ``block_q=128`` on a 64-token
    sequence runs as 64; see module docstring).  ``schedule=None`` means
    the kernel default."""
    _check_kernel(kernel)
    sched = (schedule or KernelSchedule()).merged_over(default_schedule(kernel))
    if kernel == "flash_attention":
        return dataclasses.replace(
            sched,
            block_q=_clamp_block(sched.block_q, seq_len),
            block_kv=_clamp_block(sched.block_kv,
                                  seq_len if kv_len is None else kv_len))
    return dataclasses.replace(sched, chunk=_clamp_chunk(sched.chunk, seq_len))


def schedule_signature(kernel: str, schedule: KernelSchedule) -> str:
    """Canonical short form, e.g. ``flash_attention[block_kv=64,block_q=64]``
    — stable across field ordering, for cache keys and reports."""
    fields = sorted((f, getattr(schedule, f)) for f in KERNEL_FIELDS[kernel])
    inner = ",".join(f"{name}={value}" for name, value in fields)
    return f"{kernel}[{inner}]"


# ---------------------------------------------------------------------------
# active schedules + call recording
# ---------------------------------------------------------------------------

_ACTIVE: ContextVar[Optional[Dict[str, KernelSchedule]]] = ContextVar(
    "repro_active_kernel_schedules", default=None)
_SINK: ContextVar[Optional[Dict[Tuple[str, str], Dict[str, Any]]]] = ContextVar(
    "repro_kernel_call_sink", default=None)


@contextlib.contextmanager
def use_schedules(schedules: Optional[Mapping[str, Any]]) -> Iterator[None]:
    """Make per-kernel schedules active for every kernel call resolved
    inside the block.  Values may be ``KernelSchedule``
    instances or plain field mappings; everything is validated up front.
    An active schedule overrides call-site block/chunk kwargs — that is
    the point: the generator retargets kernels the model's layers
    configured with their own constants.  ``None``/empty is a no-op."""
    if not schedules:
        yield
        return
    resolved = {k: as_schedule(k, v) for k, v in schedules.items()}
    token = _ACTIVE.set(resolved)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_schedule(kernel: str) -> Optional[KernelSchedule]:
    active = _ACTIVE.get()
    return active.get(kernel) if active else None


@contextlib.contextmanager
def record_kernel_calls(sink: Dict[Tuple[str, str], Dict[str, Any]]
                        ) -> Iterator[Dict[Tuple[str, str], Dict[str, Any]]]:
    """Collect every kernel call resolved inside the block into ``sink``,
    keyed by ``(kernel, shapes_signature)``.  Each entry records the
    requested and *effective* schedules plus the call's argument shapes
    and masking metadata — enough for an autotuner to rebuild synthetic
    inputs, and for artifacts to embed what they were built with.
    Composes with a forward on the ``meta`` device for a discovery pass
    that launches nothing."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def _shapes_signature(shapes: Mapping[str, Tuple[int, ...]]) -> str:
    return ",".join(f"{name}={'x'.join(str(d) for d in shape)}"
                    for name, shape in sorted(shapes.items()))


def note_kernel_call(kernel: str, requested: KernelSchedule,
                     effective: KernelSchedule,
                     shapes: Mapping[str, Tuple[int, ...]],
                     meta: Optional[Mapping[str, Any]] = None,
                     launched: Optional[Mapping[str, int]] = None) -> None:
    """Called by :mod:`repro_torch.kernels.ops` at resolve time.  No-op
    without an active recorder.  ``launched`` is what the CUDA kernel
    launches (or would, on the ``meta`` device) for the effective schedule:
    the flash kernel's tile pair, a scan's chunk; None on the CPU.  Each
    entry counts the calls made at its shapes (``calls``)."""
    sink = _SINK.get()
    if sink is None:
        return
    shapes = {name: tuple(int(d) for d in shape)
              for name, shape in shapes.items()}
    key = (kernel, _shapes_signature(shapes))
    previous = sink.get(key)
    sink[key] = {
        "kernel": kernel,
        "requested": requested,
        "effective": effective,
        "launched": None if launched is None else dict(launched),
        "shapes": shapes,
        "meta": dict(meta or {}),
        # every call at these shapes: a candidate with two ssm layers of one
        # width makes two calls under one key
        "calls": 1 if previous is None else previous.get("calls", 1) + 1,
    }


def effective_signature(sink: Mapping[Tuple[str, str], Dict[str, Any]]) -> str:
    """One canonical string for every recorded call's *effective*
    schedule — the cache-key component that makes compiled-artifact
    entries schedule-aware without double-compiling requests that clamp
    to the same launch."""
    parts = []
    for (kernel, shapes_sig) in sorted(sink):
        eff = sink[(kernel, shapes_sig)]["effective"]
        parts.append(f"{shapes_sig}->{schedule_signature(kernel, eff)}")
    return ";".join(parts)
