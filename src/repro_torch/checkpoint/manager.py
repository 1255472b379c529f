"""Checkpoints in the JAX package's on-disk format.

``<dir>/step_<k:012d>/`` holds ``arrays.npz`` (one array per leaf, keyed by
its ``/``-joined tree path, e.g. ``params/pcores0/1/phases_u``),
``meta.json`` and a ``COMMITTED`` marker; writes go to ``.tmp`` and are
renamed into place, so a crash never leaves a half checkpoint behind.  No
framework owns the format, so a solver trained by the JAX package loads
into the port and the other way round.

``CheckpointManager(async_save=True)`` copies the tree to the host at
``save`` and writes it on a thread while training goes on; ``wait()``
joins the write (and raises what it raised) before a restore, before the
next save and at the end of training.

Port of the single-process part of ``repro.checkpoint.manager``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "read_checkpoint_meta",
           "latest_step", "CheckpointManager"]


def _flatten(tree, prefix: str = "") -> dict:
    """``/``-joined path → leaf; dict keys sorted, as JAX flattens them."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _step_dir(directory: Path, step: int | None) -> Path:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = directory / f"step_{step:012d}"
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"incomplete checkpoint {path}")
    return path


def save_checkpoint(directory: str | os.PathLike, step: int, tree,
                    extra_meta: dict | None = None) -> Path:
    """Atomic checkpoint write of a tree of tensors. Returns the final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:012d}"
    tmp = directory / f"step_{step:012d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = {k: v.detach().cpu().numpy() for k, v in _flatten(tree).items()}
    np.savez(tmp / "arrays.npz", **flat)
    meta = {"step": step, "keys": sorted(flat),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()}}
    if extra_meta:
        meta.update(extra_meta)
    (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
    (tmp / "COMMITTED").write_text("ok")   # marker inside, then atomic rename
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_checkpoint(directory: str | os.PathLike, tree_like,
                       step: int | None = None) -> tuple:
    """Restore the leaves of ``tree_like`` (a tree of tensors) from a
    checkpoint, each with its template's dtype and device; arrays of the
    checkpoint that the template lacks stay on disk.  Returns
    ``(tree, meta)``."""
    path = _step_dir(Path(directory), step)
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz") as data:
        def restore(node, prefix):
            if isinstance(node, dict):
                return {k: restore(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [restore(v, f"{prefix}/{i}") for i, v in enumerate(node)]
            if prefix not in data.files:
                raise KeyError(f"checkpoint {path} has no array {prefix!r}")
            arr = data[prefix]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(node.shape)}")
            return torch.tensor(arr, dtype=node.dtype, device=node.device)

        return restore(tree_like, ""), meta


def read_checkpoint_meta(directory: str | os.PathLike,
                         step: int | None = None) -> dict:
    """``meta.json`` of a complete checkpoint without loading its arrays."""
    return json.loads((_step_dir(Path(directory), step)
                       / "meta.json").read_text())


def _complete_steps(directory: Path) -> list:
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.name.startswith("step_") and not p.name.endswith(".tmp")
                  and (p / "COMMITTED").exists())


def latest_step(directory: str | os.PathLike) -> int | None:
    steps = _complete_steps(Path(directory))
    return steps[-1] if steps else None


class CheckpointManager:
    """Keep-k checkpoint policy around ``save_checkpoint`` /
    ``restore_checkpoint``, optionally writing on a thread."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 save_every: int = 100, async_save: bool = False):
        self.directory = Path(directory)
        self.keep = keep
        self.save_every = save_every
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save(self, step: int, tree, extra_meta: dict | None = None) -> Path:
        """Write step ``step`` and drop all but the newest ``keep``.  With
        ``async_save`` the tree is copied to the host now (the caller may
        go on updating its tensors) and written on a thread; the path
        returned is where it lands."""
        path = self.directory / f"step_{step:012d}"
        if not self.async_save:
            self._save_and_gc(step, tree, extra_meta)
            return path
        snapshot = _snapshot(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, snapshot, extra_meta),
            name=f"checkpoint-{step}")
        self._thread.start()
        return path

    def _write(self, step, tree, extra_meta):
        try:
            self._save_and_gc(step, tree, extra_meta)
        except BaseException as e:      # handed to wait(), which raises it
            self._error = e

    def _save_and_gc(self, step, tree, extra_meta):
        save_checkpoint(self.directory, step, tree, extra_meta)
        if self.keep:
            for s in _complete_steps(self.directory)[:-self.keep]:
                shutil.rmtree(self.directory / f"step_{s:012d}",
                              ignore_errors=True)

    def wait(self) -> None:
        """Join the pending write, if any; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") \
                from err

    def restore_latest(self, tree_like) -> tuple:
        self.wait()
        return restore_checkpoint(self.directory, tree_like)


def _snapshot(tree):
    """A host copy of every tensor of ``tree`` (a CPU tensor is copied
    too: the caller keeps updating its own)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_snapshot(v) for v in tree]
    return tree.detach().to("cpu", copy=True)
