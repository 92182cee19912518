"""Builds the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout, compiled by ``nvcc`` for ``sm_90a`` with a plain
C interface and loaded through ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes).  The hash is that of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Only the
sources in the checkout are built; nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    if Path(DEFAULT_NVCC).is_file():
        return DEFAULT_NVCC
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(f"nvcc not found (looked at {DEFAULT_NVCC} and on PATH)")
    return found


def sources() -> List[str]:
    """Names of the kernels that have a source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns {name: ptxas report} for
    the sources compiled by this call; raises if any compile fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise KernelBuildError("\n".join(failures))
    return reports


def build_files(paths, out_dir) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile the given ``.cu`` files (edited copies of a source, say) into
    ``out_dir``, one ``nvcc`` per file, all started together, and load
    them.  Returns {path: (library, ptxas report)}; raises if any compile
    fails."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    outs = {src: out_dir / f"{i}-{Path(src).stem}.so" for i, src in enumerate(paths)}
    procs = {src: subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(out), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, out in outs.items()}
    built, failures = {}, []
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        built[src] = (ctypes.CDLL(str(outs[src])), log)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return built


def registers(log: str):
    """(kernel, ptxas's "Used ..." line) for each kernel in an nvcc report."""
    kernel = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "Used" in line and kernel:
            yield kernel, line.split(":", 1)[1].strip()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
