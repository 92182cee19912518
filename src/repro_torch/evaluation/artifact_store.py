"""Content-addressed artifact store: candidates' programs that survive
the process.

The disk evaluation cache (:mod:`repro_torch.evaluation.disk_cache`)
persists *scalar* estimator values; the generated artifacts stayed in
memory, so a server booting after an exploration (a different process)
had to generate the winning candidate again although the study had
already paid for it.  This store closes that gap: it persists each
candidate's program as a ``torch.export`` ``ExportedProgram`` of
``(params, x)`` (:func:`repro_torch.hwgen.generator.export_candidate`)
plus the artifact's analysis, content-addressed by the same identity the
evaluation cache uses, so ``python -m repro_torch.launch.serve
--from-report`` generates **nothing** for any program the exploration
touched.  This is the JAX package's ``evaluation/artifact_store.py`` on
the port, name for name.

The program, not a compiled package
-----------------------------------
The reference serializes an XLA executable that already exists.  The
port's counterpart is the exported program, which replays the same aten
ops and the same hand-written kernels (each a registered op,
:mod:`repro_torch.kernels.ops`, with its tiles baked in) that the
measurement ran.  It holds no weights: like the reference's executable,
which draws its parameters from seed 0 at each use, a loaded program is
called on the seed-0 weights its user draws.  At zamba2-2.7b widths a
candidate's weights are 0.1-0.3 GB, so a store that kept them would
write gigabytes an exploration; a program is a few hundred KB.

Content key
-----------
An entry's identity is the estimator program key, ``(name, mesh_scope,
batch, full architecture signature[, effective kernel schedules])``,
wrapped with the **toolchain salt** of
:func:`repro_torch.evaluation.disk_cache.canonical_key` (the framework
tag and the torch, CUDA and Triton versions): two candidates share an
entry iff they are the same program, and an upgrade misses instead of
loading a program traced by another torch.

Layout
------
``<dir>/artifacts/manifest.torch.jsonl``: append-only JSONL under the
same lock and CRC32 discipline as the value cache, one record ``{"key":
<canonical>, "blob": <sha256>, "format": "torch.export", "meta": {...},
"crc": ...}`` per store; a corrupt record reads back as a miss.
``<dir>/artifacts/<sha256>.pt2``: the ``torch.export.save`` archive,
written to a temporary name and renamed, so a reader never sees a torn
blob.  The blob name is the sha256 of the canonical key.  The JAX
package's store may share the directory: its ``manifest.jsonl`` and
pickled ``.bin`` blobs are never opened here, and this store's files
are never opened there.

Degradation
-----------
Every failure degrades to a miss and the caller generates, as before the
store existed: an export that raises, a blob missing, torn or traced by
another salt, a program whose ops the loading process has not registered
(``torch.export.load`` refuses it: :mod:`repro_torch.kernels.ops` must be
imported first, which this module does).  ``REPRO_ARTIFACTS=0`` disables
the store (registered in :mod:`repro_torch.envvars`).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
import zlib
from typing import Any, Dict, Hashable, Optional

from repro_torch import faults
from repro_torch.envvars import read_env
from repro_torch.evaluation.disk_cache import CACHE_DIR_ENV, canonical_key
from repro_torch.ioutils import locked_append
from repro_torch.kernels import ops  # noqa: F401  (registers the kernels' ops)

ARTIFACTS_ENV = "REPRO_ARTIFACTS"

FORMAT = "torch.export"


def store_enabled() -> bool:
    """False when ``REPRO_ARTIFACTS=0`` disables program persistence."""
    return read_env(ARTIFACTS_ENV, True)


def content_hash(canonical: str) -> str:
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def _manifest_crc(key: str, blob: str) -> int:
    return zlib.crc32(json.dumps([key, blob], sort_keys=True,
                                 separators=(",", ":")).encode("utf-8"))


def load_program(path: str) -> Optional[Any]:
    """The callable of the exported program saved at ``path``, or None on
    any failure (missing or torn archive, an op not registered here)."""
    import torch

    try:
        return torch.export.load(path).module()
    except Exception:
        return None


class ArtifactStore:
    """Content-addressed program store next to a disk value cache.

    ``path`` is the evaluation-cache store directory; blobs and the
    manifest live in an ``artifacts/`` subdirectory, so the two tiers
    share one location (and one ``cache.dir`` knob)."""

    SUBDIR = "artifacts"
    MANIFEST = "manifest.torch.jsonl"
    SUFFIX = ".pt2"

    def __init__(self, path: str):
        override = read_env(CACHE_DIR_ENV, None)
        base = str(override) if override else str(path)
        self.path = os.path.join(base, self.SUBDIR)
        self._manifest = os.path.join(self.path, self.MANIFEST)
        self._lock = threading.Lock()
        self._index: Dict[str, Dict[str, Any]] = {}  # canonical key -> record
        self._offset = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.bad_blobs = 0  # blobs that failed to load
        self.export_s = 0.0  # seconds this process spent exporting
        self.blob_bytes = 0  # bytes this process wrote as blobs
        os.makedirs(self.path, exist_ok=True)
        self.refresh()

    # -- manifest ----------------------------------------------------------

    def refresh(self) -> int:
        with self._lock:
            return self._read_new()

    def _read_new(self) -> int:
        if not os.path.exists(self._manifest):
            return 0
        try:
            with open(self._manifest, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return 0
        lines = data.split(b"\n")
        self._offset += len(data) - len(lines[-1])
        n = 0
        for raw in lines[:-1]:
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
            if not isinstance(rec, dict) or rec.get("format") != FORMAT:
                continue
            key, blob = rec.get("key"), rec.get("blob")
            if not isinstance(key, str) or not isinstance(blob, str):
                continue
            if rec.get("crc") != _manifest_crc(key, blob):
                continue  # torn/rotted record: a miss, never a wrong program
            self._index[key] = rec
            n += 1
        return n

    # -- keys --------------------------------------------------------------

    @staticmethod
    def canonical(key: Hashable) -> Optional[str]:
        """The store's canonical string key: the evaluation-cache program
        key wrapped with the toolchain salt.  None = not storable (a None
        part, e.g. an uncacheable candidate, or a non-JSON one)."""
        if isinstance(key, tuple) and any(k is None for k in key):
            return None
        return canonical_key(key)

    def keys(self):
        with self._lock:
            return list(self._index)

    def __contains__(self, key: Hashable) -> bool:
        ck = self.canonical(key)
        if ck is None:
            return False
        with self._lock:
            self._read_new()
            return ck in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def _blob_path(self, blob: str) -> str:
        return os.path.join(self.path, blob + self.SUFFIX)

    # -- store/load --------------------------------------------------------

    def put(self, key: Hashable, artifact: Any) -> bool:
        """Persist one artifact's program; returns True when (newly or
        already) stored.  ``artifact.program`` is saved when it is an
        ``ExportedProgram``; otherwise ``artifact.fn`` (a ``BuiltModel``)
        is exported (:func:`~repro_torch.hwgen.generator.export_candidate`)
        at ``artifact.example_args``' shapes for ``artifact.target`` under
        ``artifact.schedules``.  Never raises: an export that fails or an
        unwritable store leaves the artifact memory-only.  An exported
        candidate's record also keeps its counted flops, bytes and
        collective bytes (:func:`~repro_torch.hwgen.generator.program_cost`)."""
        import torch

        from repro_torch.hwgen.generator import export_candidate, program_cost

        if not store_enabled():
            return False
        ck = self.canonical(key)
        if ck is None:
            return False
        with self._lock:
            self._read_new()
            if ck in self._index:
                return True  # content-addressed: same key == same program
        t0 = time.perf_counter()
        counted = None
        try:
            program = artifact.program
            if not isinstance(program, torch.export.ExportedProgram):
                program = export_candidate(artifact.fn, artifact.example_args,
                                           artifact.target, artifact.schedules)
                counted = program_cost(artifact.fn, artifact.example_args,
                                       artifact.schedules)
        except Exception as e:
            warnings.warn(f"artifact store: exporting {key!r} failed ({e!r}); the "
                          f"artifact stays memory-only", RuntimeWarning, stacklevel=2)
            return False
        export_s = time.perf_counter() - t0
        blob_name = content_hash(ck)
        blob_path = self._blob_path(blob_name)
        try:
            if not os.path.exists(blob_path):
                tmp = os.path.join(self.path, f"{blob_name}.tmp.{os.getpid()}."
                                              f"{threading.get_ident()}{self.SUFFIX}")
                torch.export.save(program, tmp)
                with open(tmp, "rb+") as f:
                    os.fsync(f.fileno())
                os.replace(tmp, blob_path)  # atomic: readers never see a torn blob
            blob_bytes = os.path.getsize(blob_path)
            meta = {
                # the program's counted terms (program_cost), as the
                # reference keeps its compiled artifact's analysis
                "flops": None if counted is None else counted.flops,
                "bytes_accessed": None if counted is None else counted.bytes_accessed,
                "collective_bytes": None if counted is None else counted.collective_bytes,
                "memory": {k: int(v) for k, v in artifact.memory.items()},
                # which process measured ``memory``: a spawned worker or the
                # process that ran the exploration
                "measured_by": {"pid": os.getpid(),
                                "process": _process_role()} if artifact.memory else None,
                "schedules": _jsonable_schedules(artifact.schedules),
                "export_s": export_s,
                "blob_bytes": blob_bytes,
            }
            line = json.dumps({"key": ck, "blob": blob_name, "format": FORMAT, "meta": meta,
                               "crc": _manifest_crc(ck, blob_name)}) + "\n"
            locked_append(self._manifest, line)
        except (OSError, RuntimeError, faults.InjectedFault) as e:
            warnings.warn(
                f"artifact store append to {self._manifest!r} failed ({e!r}); "
                f"the artifact stays memory-only", RuntimeWarning, stacklevel=2)
            return False
        with self._lock:
            self._index[ck] = {"key": ck, "blob": blob_name, "format": FORMAT, "meta": meta}
            self.puts += 1
            self.export_s += export_s
            self.blob_bytes += blob_bytes
            self._read_new()  # consume our own append (offset hygiene)
        return True

    def record(self, key: Hashable) -> Optional[Dict[str, Any]]:
        """The manifest record of ``key`` (its ``meta``: memory, schedules,
        export seconds, blob bytes), or None."""
        ck = self.canonical(key)
        if ck is None:
            return None
        with self._lock:
            self._read_new()
            return self._index.get(ck)

    def get(self, key: Hashable, target: Any = None, fn: Any = None,
            example_args=()) -> Optional[Any]:
        """Load one artifact, bound to ``target``, whose runs call the
        stored program on ``fn``'s weights (``fn`` is the candidate with
        the weights its caller drew) at ``example_args``; None on a miss
        or any load failure (the caller generates)."""
        from repro_torch.hwgen.generator import Artifact
        from repro_torch.hwgen.targets import get_target

        if not store_enabled():
            return None
        ck = self.canonical(key)
        if ck is None:
            return None
        with self._lock:
            if ck not in self._index:
                self._read_new()  # a sibling may have stored it since
            rec = self._index.get(ck)
            if rec is None:
                self.misses += 1
                return None
        program = load_program(self._blob_path(str(rec["blob"])))
        if program is None:
            with self._lock:
                self.bad_blobs += 1
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        meta = rec.get("meta") or {}
        if isinstance(target, str):
            target = get_target(target)
        return Artifact(target=target, fn=fn, example_args=tuple(example_args),
                        memory={k: int(v) for k, v in (meta.get("memory") or {}).items()},
                        schedules=meta.get("schedules"), program=program)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._index),
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "bad_blobs": self.bad_blobs,
                "export_s": self.export_s,
                "blob_bytes": self.blob_bytes,
            }


def _process_role() -> str:
    import multiprocessing

    return "parent" if multiprocessing.parent_process() is None else "worker"


def _jsonable_schedules(schedules) -> Optional[Dict[str, Any]]:
    """Schedules as the manifest keeps them: each kernel's fields."""
    if schedules is None:
        return None
    return {k: (s.to_dict() if hasattr(s, "to_dict") else s) for k, s in schedules.items()}
