"""Fault-tolerant checkpointing, the JAX package's
``checkpoint/checkpointer.py`` on the port, with its layout on disk.

  * atomic: write to ``step_<10 digits>.tmp/`` then rename: a preempted
    writer never corrupts the latest checkpoint;
  * one ``.npy`` a leaf inside the step directory, and ``manifest.json``
    naming each leaf by its path (dict keys joined by ``/``, leaves in
    sorted key order, as ``jax.tree_util`` flattens a dict), its file,
    shape and dtype; a bfloat16 leaf, which numpy cannot hold, is stored
    as its raw 16 bits (``uint16``) under the dtype ``bfloat16``;
  * async: ``save_async`` snapshots to host memory synchronously (one
    device->host copy) and writes to disk on a worker thread so training
    continues during I/O;
  * restore: ``restore(like=..., device=...)`` returns the caller's
    structure with each leaf on ``device`` (by default the device of the
    ``like`` leaf); ``shardings=`` (a tree of DTensor placements on the
    sharding context's mesh) reshards each leaf onto that mesh, whatever
    mesh saved it;
  * sharded trees: a DTensor leaf is saved whole (every rank gathers it,
    rank 0 writes), so a checkpoint does not depend on the mesh;
  * retention: keep the newest K checkpoints.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.api import current_mesh, is_dtensor

_BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: str = "", is_leaf=None) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts, lists and tuples, dict keys
    in sorted order."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, val in items:
        out.extend(_flatten_with_paths(val, f"{prefix}/{key}" if prefix else key, is_leaf))
    return out


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and bool(x) and all(isinstance(p, Placement) for p in x)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the running process group, (0, 1) without."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _unflatten_like(like, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(like, Mapping):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _structure(tree) -> str:
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host and its dtype's name."""
    if torch.is_tensor(leaf):
        if is_dtensor(leaf):  # a collective: every rank saves
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ------------------------------------------------------------

    def _write(self, step: int, host_leaves: List[Tuple[str, np.ndarray, str]],
               structure: str):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (key, arr, dtype) in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"key": key, "file": fname,
                                       "shape": list(arr.shape), "dtype": dtype})
        manifest["treedef"] = structure
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)
        else:
            os.replace(tmp, final)
        self._retain()

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    def _to_host(self, tree) -> Tuple[List[Tuple[str, np.ndarray, str]], str]:
        host = [(key, *_host_array(leaf)) for key, leaf in _flatten_with_paths(tree)]
        return host, _structure(tree)

    def save(self, step: int, tree) -> None:
        host, structure = self._to_host(tree)
        rank, world = _world()
        if rank == 0:
            self._write(step, host, structure)
        if world > 1:
            import torch.distributed as dist

            dist.barrier()

    def save_async(self, step: int, tree) -> None:
        if self._error:
            raise self._error
        host, structure = self._to_host(tree)  # sync device->host snapshot
        if _world()[0] != 0:  # rank 0 writes; :meth:`wait` joins the ranks
            return
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._q.put((step, host, structure))

    def _drain(self):
        while True:
            try:
                item = self._q.get(timeout=5.0)
            except queue.Empty:
                return
            try:
                self._write(*item)
            except BaseException as e:  # surfaced on the next save_async or wait
                self._error = e
            finally:
                self._q.task_done()

    def wait(self):
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
        if _world()[1] > 1:
            import torch.distributed as dist

            dist.barrier()
        if self._error:
            raise self._error

    # -- read ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like=None, device=None, shardings=None):
        """Load a checkpoint: ``(step, {path: numpy array})``, or with
        ``like`` (a tree) ``(step, tree)`` of the same structure whose
        leaves are tensors on ``device`` (default: each ``like`` leaf's
        device, the CPU for a leaf that is not a tensor).  Raises
        ``KeyError`` for a leaf of ``like`` the checkpoint lacks.

        ``shardings`` is a tree like ``like`` whose leaves are tuples of
        DTensor placements on the sharding context's mesh; each leaf comes
        back as a DTensor with its placements, each rank slicing its shard
        from the saved whole."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {}
        for entry in manifest["leaves"]:
            arr = np.load(os.path.join(d, entry["file"]))
            arrays[entry["key"]] = (torch.from_numpy(arr).view(torch.bfloat16)
                                    if entry["dtype"] == _BF16 else arr)
        if like is None:
            return step, arrays
        placed = (dict(_flatten_with_paths(shardings, is_leaf=_is_placements))
                  if shardings is not None else {})
        mesh = current_mesh()
        if placed and mesh is None:
            raise RuntimeError("restore(shardings=) needs a sharding context's mesh")
        out = {}
        for key, leaf in _flatten_with_paths(like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r} (structure changed?)")
            where = device if device is not None else (
                leaf.device if torch.is_tensor(leaf) else "cpu")
            t = torch.as_tensor(arrays[key]).to(where)
            if key in placed:
                from torch.distributed.tensor import distribute_tensor

                t = distribute_tensor(t, mesh, placed[key], src_data_rank=None)
            out[key] = t
        return step, _unflatten_like(like, out)
