"""Checkpointing built for restart-resilience on shared filesystems.

* **Atomic**: write to ``step_N.tmp-<pid>-<id>`` then ``os.replace`` — a
  crash mid-write can never corrupt the latest valid checkpoint.
* **Self-validating**: a manifest (leaf paths, shapes, dtypes) and a
  per-leaf checksum; restore verifies before use.
* **Keep-N GC** and ``latest_step`` discovery for restart-from-latest.
* **Async**: ``CheckpointManager(async_save=True)`` takes a blocking
  host copy of every tensor (``.cpu()``) and then hands serialization to
  a background thread, so training can overwrite its tensors at once.

The on-disk format is the JAX package's, byte for byte in meaning:
``step_N/arrays.npz`` (leaf ``i`` under key ``a{i}``, in JAX's leaf
order) and ``step_N/manifest.json`` with each leaf's ``path``, ``key``,
``shape``, ``dtype`` and ``sum`` (the first 16 hex digits of the sha1 of
its bytes).  Leaf order and path strings come from
:mod:`repro_torch.tree`, so a checkpoint written by either package
restores in the other.  No pickle.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import (
    flatten, from_numpy, paths, to_numpy, tree_map, unflatten,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str | Path, step: int, tree: Any) -> Path:
    """Atomically persist a tree of tensors / arrays under
    `directory/step_N`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step}"
    # unique per writer: two writers of one step in one process (a
    # relaunch while the crashed run's async write is still in flight)
    # must not share a tmp dir
    tmp = directory / f"step_{step}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True, exist_ok=True)

    leaves, _ = flatten(tree)
    manifest = {"step": step, "leaves": []}
    arrays = {}
    for i, (name, leaf) in enumerate(zip(paths(tree), leaves)):
        arr = to_numpy(leaf)
        key = f"a{i}"
        arrays[key] = arr
        bf16 = (isinstance(leaf, torch.Tensor)
                and leaf.dtype == torch.bfloat16)
        dtype = "bfloat16" if bf16 else str(arr.dtype)
        manifest["leaves"].append(
            {
                "path": name,
                "key": key,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sum": _checksum(arr),
            }
        )
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():  # crashed mid-GC previously; replace
        shutil.rmtree(final, ignore_errors=True)
    try:
        os.replace(tmp, final)
    except OSError:     # another writer of this step landed first
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    return final


def restore_checkpoint(
    directory: str | Path, step: int, like: Any, *, strict: bool = True
) -> Any:
    """Restore into the structure of `like`.  A tensor leaf of `like`
    gets a tensor on its device (the stored dtype); any other leaf gets
    the NumPy array.  Verifies checksums and shapes."""
    directory = Path(directory)
    path = directory / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}

    leaves, treedef = flatten(like)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    for name, leaf in zip(paths(like), leaves):
        if name not in by_path:
            if strict:
                raise KeyError(f"checkpoint missing leaf {name}")
            out.append(leaf)
            continue
        m = by_path[name]
        arr = arrays[m["key"]]
        if strict:
            if _checksum(arr) != m["sum"]:
                raise ValueError(f"checksum mismatch for {name}")
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {name}: "
                    f"{arr.shape} vs {tuple(leaf.shape)}"
                )
        if isinstance(leaf, torch.Tensor):
            out.append(from_numpy(arr, leaf.device, m["dtype"]))
        else:
            out.append(arr)
    return unflatten(treedef, out)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(m.group(1))
        for p in directory.iterdir()
        if (m := _STEP_RE.match(p.name)) and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


class CheckpointManager:
    """save-every-k + keep-N + optional async writer."""

    def __init__(
        self,
        directory: str | Path,
        *,
        save_every: int = 100,
        keep: int = 3,
        async_save: bool = False,
    ):
        self.directory = Path(directory)
        self.save_every = save_every
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree: Any, *, force: bool = False):
        if not (force or self.should_save(step)):
            return
        # a blocking host copy now, so the caller may overwrite its
        # tensors while the writer thread runs
        host = tree_map(_host_copy, tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host), daemon=True
            )
            self._thread.start()
        else:
            self._save_and_gc(step, host)

    def _save_and_gc(self, step: int, host_tree: Any):
        save_checkpoint(self.directory, step, host_tree)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for p in self.directory.iterdir()
            if (m := _STEP_RE.match(p.name))
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like)


def _host_copy(leaf):
    """A CPU copy of a tensor (bfloat16 kept), an array of anything
    else."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
