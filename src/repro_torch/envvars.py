"""Single registry of every ``REPRO_*`` environment variable.

Each knob is declared exactly once, with its parser, default, and the
documented malformed-value fallback; the readers
(:mod:`repro_torch.evaluation.disk_cache`,
:mod:`repro_torch.evaluation.artifact_store`, :mod:`repro_torch.faults`,
:mod:`repro_torch.search.remote`, ...) consult this
registry through :func:`read_env`, and ``scripts/gen_docs.py`` renders
``docs/reference/env.md`` from the same entries — the prose cannot drift
from the behaviour because they share one source of truth.

Fallback contract: a malformed value never raises.  It emits a
``RuntimeWarning`` naming the variable and the value, then behaves as if
the variable were unset — a typo'd shell export must not explode at
first compile deep inside a worker thread.  Unset or blank values are
silent and use the caller's default.

Must stay import-light (stdlib only): the worker daemon
(:mod:`repro_torch.search.remote.worker`) reads it before torch is
imported and :mod:`repro_torch.evaluation.disk_cache` at cache
construction, neither of which may pull in the search stack.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class EnvVar:
    """One declared environment knob: parser + documentation metadata."""

    name: str
    parse: Callable[[str], Any]  # raises ValueError on malformed input
    expected: str       # what a well-formed value looks like (for the warning)
    description: str    # what the knob does (docs)
    default: str        # human-readable default (docs; the *value* is the caller's)
    malformed: str      # documented fallback behaviour (docs)
    consulted_by: str   # the reading module(s) (docs)


ENV_VARS: Dict[str, EnvVar] = {}


def register_env(var: EnvVar) -> EnvVar:
    """Publish one knob.  Re-registering a name raises — two call sites
    declaring the same variable with different parsers would make the
    generated reference ambiguous."""
    if var.name in ENV_VARS and ENV_VARS[var.name] is not var:
        raise ValueError(f"environment variable {var.name!r} already registered")
    ENV_VARS[var.name] = var
    return var


def read_env(name: str, default: Any) -> Any:
    """Read + parse a registered variable.

    Unset/blank returns ``default`` silently; a value the registered
    parser rejects warns (``RuntimeWarning`` naming the variable) and
    returns ``default``.  Reading an unregistered name raises — every
    ``REPRO_*`` lookup must go through the registry or the generated
    docs lie by omission.
    """
    try:
        var = ENV_VARS[name]
    except KeyError:
        raise KeyError(
            f"environment variable {name!r} is not registered in "
            f"repro_torch.envvars.ENV_VARS; declare it there so docs/reference/"
            f"env.md stays complete"
        ) from None
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return var.parse(raw)
    except ValueError:
        warnings.warn(
            f"ignoring malformed {name}={raw!r} (expected {var.expected}); "
            f"falling back to the default of {default!r}",
            RuntimeWarning, stacklevel=3)
        return default


def _positive_int(raw: str) -> int:
    value = int(raw)
    if value < 1:
        raise ValueError(raw)
    return value


def _clamped_int(raw: str) -> int:
    return max(1, int(raw))


def _flag(raw: str) -> bool:
    return raw not in ("0", "false")


def _non_negative_int(raw: str) -> int:
    value = int(raw)
    if value < 0:
        raise ValueError(raw)
    return value


def _positive_float(raw: str) -> float:
    value = float(raw)
    if value <= 0:
        raise ValueError(raw)
    return value


def _faults_plan(raw: str):
    # Deferred import: repro_torch.faults is stdlib-only, but envvars must not
    # pull it in unless the knob is actually set.
    from repro_torch.faults import FaultPlan

    try:
        return FaultPlan.from_string(raw)
    except ValueError:
        raise
    except Exception as e:  # int()/float() garbage inside a rule param
        raise ValueError(str(e))


def _addr_list(raw: str) -> list:
    addrs = [part.strip() for part in raw.split(",") if part.strip()]
    for addr in addrs:
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(raw)
    if not addrs:
        raise ValueError(raw)
    return addrs


# -- the registry ------------------------------------------------------------
# Declared here, read elsewhere: generator/disk_cache/ops/bench_roofline call
# read_env() with their own computed defaults.

register_env(EnvVar(
    name="REPRO_COMPILE_CONCURRENCY",
    parse=_clamped_int,
    expected="an integer",
    description=(
        "Maximum concurrent XLA compilations per process (the admission "
        "gate around the generate/benchmark pipeline).  XLA's compiler "
        "has its own internal thread pool, so unbounded concurrent "
        "compiles oversubscribe the host; serializing them while workers "
        "overlap tracing/init/benchmarking pipelines the study instead."),
    default="`cpu_count / 2` (minimum 1)",
    malformed=("warns and uses the default; values below 1 clamp to 1 "
               "(a zero would deadlock every compile)"),
    consulted_by="`repro/hwgen/generator.py` (the JAX package; the port's "
                 "generator has no compile gate to size)",
))

register_env(EnvVar(
    name="REPRO_CACHE_MAX_ENTRIES",
    parse=_positive_int,
    expected="a positive integer",
    description=(
        "Record cap for the disk cache's `entries.jsonl`.  An append "
        "that pushes the file past the cap triggers an in-place "
        "rewrite under `flock`: superseded-toolchain records are "
        "dropped first, then least-recently-used records down to ~75% "
        "of the cap (headroom so steady-state appends don't rewrite "
        "every time)."),
    default="unset — the store grows without bound (append-only)",
    malformed="warns and leaves the store unbounded",
    consulted_by="`repro_torch/evaluation/disk_cache.py`",
))

register_env(EnvVar(
    name="REPRO_CACHE_DIR",
    parse=str,
    expected="a directory path",
    description=(
        "Overrides the store directory of every disk evaluation cache "
        "opened in the process, regardless of the path the spec or "
        "constructor asked for.  Worker daemons (`python -m repro_torch.worker "
        "--cache-dir ...`) set it so experiment specs shipped from a "
        "submitting host — whose `cache.dir` names a path that only "
        "exists over there — land in the worker's local or "
        "cluster-shared store instead."),
    default="unset — the spec/constructor path is used as-is",
    malformed="not applicable — every non-blank value is a valid path",
    consulted_by="`repro_torch/evaluation/disk_cache.py`, "
                 "`repro_torch/evaluation/artifact_store.py`",
))

register_env(EnvVar(
    name="REPRO_REMOTE_WORKERS",
    parse=lambda raw: _addr_list(raw),
    expected="a comma-separated list of host:port addresses",
    description=(
        "Default worker pool for the remote executor: a comma-separated "
        "`host:port` list (e.g. `10.0.0.4:7471,10.0.0.5:7471`) consulted "
        "when neither the `executor.workers` spec key nor the "
        "constructor argument names one.  Lets `--backend remote` on the "
        "CLI work without editing the experiment YAML."),
    default="unset — the executor requires an explicit worker list",
    malformed="warns and behaves as unset",
    consulted_by="`repro_torch/search/remote/executor.py`",
))

register_env(EnvVar(
    name="REPRO_REMOTE_TIMEOUT_S",
    parse=_positive_float,
    expected="a positive number of seconds",
    description=(
        "Heartbeat timeout for remote workers: a worker silent for "
        "longer (no heartbeat, report, ack, or result) is declared dead, "
        "its connection is closed, and its in-flight trial is resubmitted "
        "to a sibling.  Worker daemons heartbeat every "
        "`REPRO_REMOTE_HEARTBEAT_S` seconds, so the timeout should be a "
        "comfortable multiple of that.  The `heartbeat_timeout_s` "
        "executor option wins over the environment."),
    default="10.0",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/search/remote/client.py`",
))

register_env(EnvVar(
    name="REPRO_REMOTE_HEARTBEAT_S",
    parse=_positive_float,
    expected="a positive number of seconds",
    description=(
        "Interval at which a worker daemon sends heartbeat frames on "
        "each live connection (the liveness signal behind "
        "`REPRO_REMOTE_TIMEOUT_S`).  Read by the daemon, not the "
        "executor; the `--heartbeat` CLI flag wins over the "
        "environment."),
    default="2.0",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/search/remote/worker.py`",
))

register_env(EnvVar(
    name="REPRO_REMOTE_RETRIES",
    parse=lambda raw: _non_negative_int(raw),
    expected="a non-negative integer",
    description=(
        "How many times the remote executor resubmits one trial after "
        "worker failures (death, heartbeat timeout, straggler timeout) "
        "before surfacing the failure as a study error.  Resubmission is "
        "safe because detached plans are deterministic: the retried "
        "trial reproduces the original's parameters exactly.  The "
        "`retries` executor option wins over the environment."),
    default="2",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/search/remote/client.py`",
))

register_env(EnvVar(
    name="REPRO_PALLAS_INTERPRET",
    parse=_flag,
    expected="a flag (`0`/`false` disables, anything else enables)",
    description=(
        "Force Pallas kernels into interpreter mode (`0`/`false` "
        "disables it even off-TPU).  Interpret mode is how hosts "
        "without a TPU validate the TPU kernels."),
    default="enabled unless running on a TPU backend",
    malformed="not applicable — every non-blank value parses as a flag",
    consulted_by="`repro/kernels/ops.py` (the JAX package; the port's "
                 "kernels have no interpret mode)",
))

register_env(EnvVar(
    name="REPRO_PROXY_BATCH",
    parse=_positive_int,
    expected="a positive integer",
    description=(
        "Batch size for the zero-cost proxy estimators (`synflow`, "
        "`grad_norm`) — one eager forward/backward per candidate, so "
        "this bounds tier-0 screening cost in the fidelity cascade.  "
        "Proxy scores are rankings, not costs; the default is small on "
        "purpose.  An explicit `batch` estimator param wins over the "
        "environment."),
    default="2",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/evaluation/proxies.py`",
))

register_env(EnvVar(
    name="REPRO_TUNE_BUDGET",
    parse=_positive_int,
    expected="a positive integer",
    description=(
        "Maximum schedule candidates the kernel autotuner times per "
        "(kernel, shape-bucket) sweep.  Candidate grids are ordered "
        "default-first, so a budget of 1 degenerates to the named "
        "`default` schedule with zero search.  An explicit "
        "`kernel_tuning.budget` in the experiment spec wins over the "
        "environment."),
    default="8 (the full built-in candidate grid)",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/hwgen/autotune.py`",
))

register_env(EnvVar(
    name="REPRO_FAULTS",
    parse=_faults_plan,
    expected=("a fault-plan string: `seed=N;site:action[@k=v,...];...` "
              "(see `repro_torch/faults.py`)"),
    description=(
        "Deterministic fault-injection plan, installed at import and "
        "inherited by spawned process workers and `python -m "
        "repro_torch.worker` daemons.  Rules name a site "
        "(`disk_cache.read/write`, `study.persist`, "
        "`transport.send/recv`, `worker.trial`, `executor.submit`, "
        "`compile`) and an action (`raise`, `kill`, `delay`, `corrupt`, "
        "`drop`), with optional `p=`, `times=`, `after=`, `delay_s=`, "
        "and `key=` params — e.g. "
        "`seed=7;worker.trial:kill@key=3,times=2;disk_cache.write:corrupt@p=0.25`.  "
        "A `faults:` section in the experiment spec wins over the "
        "environment for the run and is re-exported to it so workers "
        "see the same plan."),
    default="unset — injection disabled, the fault points are no-ops",
    malformed="warns and leaves injection disabled",
    consulted_by="`repro_torch/faults.py`",
))

register_env(EnvVar(
    name="REPRO_ARTIFACTS",
    parse=_flag,
    expected="a flag (`0`/`false` disables, anything else enables)",
    description=(
        "Whether disk-cached explorations also persist each candidate's "
        "*program* (a weight-free `torch.export` program of `(params, x)`) "
        "into the content-addressed artifact store "
        "(`<cache.dir>/artifacts/`), which is what lets `python -m "
        "repro_torch.launch.serve --from-report` boot without generating "
        "the winner (`compiles`, which counts generates, stays 0).  "
        "`0`/`false` keeps artifacts memory-only (the pre-store "
        "behaviour): scalar values still persist, serving generates."),
    default="enabled",
    malformed="not applicable — every non-blank value parses as a flag",
    consulted_by="`repro_torch/evaluation/artifact_store.py`, "
                 "`repro_torch/launch/serve.py`",
))

register_env(EnvVar(
    name="REPRO_QUARANTINE_DEATHS",
    parse=_positive_int,
    expected="a positive integer",
    description=(
        "How many worker deaths one trial may be implicated in before "
        "the process/remote executor quarantines it: the trial is told "
        "`FAIL` with `user_attrs[\"quarantined\"]` set instead of being "
        "resubmitted, so a poison trial (one that OOM-kills or "
        "segfaults every worker it lands on) cannot burn its retries "
        "across every sibling and drain the pool.  The "
        "`quarantine_after` executor option wins over the environment."),
    default="2",
    malformed="warns and uses the default",
    consulted_by="`repro_torch/search/executors.py`, `repro_torch/search/remote/executor.py`",
))

register_env(EnvVar(
    name="REPRO_DRYRUN_DIR",
    parse=str,
    expected="a directory path",
    description=("Output directory for `benchmarks/bench_roofline.py` "
                 "dry-run artifacts (compiled-program cost records)."),
    default="`results/dryrun`",
    malformed="not applicable — every non-blank value is a valid path",
    consulted_by="`benchmarks/bench_roofline.py`",
))
