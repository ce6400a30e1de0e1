"""Checkpointing: manifest-committed, async, restart-safe, in the
reference's on-disk format (``repro.ckpt.checkpoint``), so a checkpoint
written by either package restores in the other.

  * ``step_%09d/`` holds one ``.npy`` per leaf, named by the leaf's tree
    path (dict keys in sorted order joined by ``/``, as JAX flattens a
    dict) in ``MANIFEST.json`` with its shape and dtype;
  * the step is written under ``.tmp_step_%09d`` with the manifest last,
    then the directory is renamed into place: a torn write is never
    loadable;
  * an async writer thread overlaps the file IO with the next steps
    (``wait()`` fences); the device-to-host copy happens in ``save``, so
    the caller may overwrite its tensors right after;
  * ``keep`` bounds disk usage (the oldest checkpoints pruned after a
    commit); ``restore`` checks every leaf's shape against a template.

Leaves are tensors (any device) or numpy arrays; ``restore`` returns numpy
arrays in the template's structure. The reference's ``shardings`` argument
(re-sharding on load) has no counterpart on one device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._tree import tree_paths


def _unflatten(template: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in template.items()}
    return leaves[prefix[:-1]]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later writes to the leaf do not reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. The device-to-host copy happens
        here; the file IO happens on the writer thread unless ``blocking``."""
        host_items = [(k, _host(v)) for k, v in tree_paths(tree)]
        self.wait()
        if self._thread is None or blocking:
            self._write(step, host_items)
        else:
            self._q.put((step, host_items))

    def wait(self) -> None:
        """Fence: block until the in-flight async save committed."""
        if self._thread is not None:
            self._q.join()
        if self._err:
            raise self._err

    def _worker(self) -> None:
        while True:
            step, items = self._q.get()
            try:
                self._write(step, items)
            except Exception as e:  # surfaced at the next wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, items) -> None:
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "arrays": {}}
        for i, (key, arr) in enumerate(items):
            fname = f"a{i:05d}.npy"
            np.save(tmp / fname, arr, allow_pickle=False)
            manifest["arrays"][key] = {"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        # manifest written last, then the whole directory commits via rename
        with open(tmp / "MANIFEST.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "MANIFEST.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> Any:
        """Load into the structure of ``template`` (leaves with a ``shape``:
        tensors, arrays); every leaf's shape must match the checkpoint's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        with open(d / "MANIFEST.json") as f:
            manifest = json.load(f)
        leaves = {}
        for key, leaf in tree_paths(template):
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            arr = np.load(d / meta["file"], allow_pickle=False)
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs template {tuple(leaf.shape)}")
            leaves[key] = arr
        return _unflatten(template, leaves)
