"""Snapshot store: atomic, async, retention-managed, numpy and JSON only.

The port's counterpart of ``repro.checkpoint.store``.  Its on-disk layout is
the reference's, byte for byte, so each package reads the other's
snapshots (the streaming engines resume across the two):

Layout per step:  <root>/step_<n>/
    manifest.json      keys + shapes/dtypes + user metadata
    arrays.npz         the arrays (key = the flat name, e.g. ``cp/selected``)

A tree is nested dicts, NamedTuples, lists and tuples of arrays or tensors
(a ``train.TrainState``), or a flat ``dict[str, array]`` (the engines'
snapshots).  It is flattened as the reference flattens a JAX pytree: dict
keys in sorted order, NamedTuple fields and list items in order, each
leaf's name its path joined with ``"/"`` (``params/embed/table``,
``opt/step``), so a flat dict keeps its own keys.

Fault-tolerance properties:
  * atomic publish — written to step_<n>.tmp, fsync'd, then renamed, so a
    crash mid-save never yields a readable-but-corrupt checkpoint;
  * async — ``CheckpointManager.save(..., blocking=False)`` hands the host
    copy to a writer thread;
  * retention — keep the newest ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

_SEP = "/"

# Version of the on-disk checkpoint layout (manifest + arrays.npz).  Bump on
# incompatible changes; ``load_checkpoint``/``load_arrays`` refuse snapshots
# written under a different major layout instead of mis-restoring them.
#   1: {step, keys, shapes, dtypes, metadata, schema_version}
SCHEMA_VERSION = 1


class CheckpointError(RuntimeError):
    """A snapshot on disk is unreadable: corrupted/truncated arrays, a
    missing or unparsable manifest, or a schema-version mismatch.  Distinct
    from FileNotFoundError (no snapshot at all) so recovery code can fall
    back to an older step or to log replay instead of crashing."""


def _read_manifest(path: Path) -> dict:
    mpath = path / "manifest.json"
    if not mpath.exists():
        raise CheckpointError(f"checkpoint {path} has no manifest.json")
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"corrupt manifest at {mpath}: {e}") from e
    version = manifest.get("schema_version")
    if version != SCHEMA_VERSION:
        raise CheckpointError(
            f"checkpoint {path} has schema_version {version!r}, "
            f"this build reads {SCHEMA_VERSION}")
    return manifest


def _read_arrays(path: Path, manifest: dict) -> dict[str, np.ndarray]:
    try:
        with np.load(path / "arrays.npz") as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as e:     # zipfile/OSError/ValueError: all mean corrupt
        raise CheckpointError(f"corrupt arrays.npz in {path}: {e}") from e
    missing = [k for k in manifest["keys"] if k not in arrays]
    if missing:
        raise CheckpointError(
            f"checkpoint {path} arrays missing manifest keys: {missing[:5]}")
    return arrays


def _map_with_path(fn, tree, path: str = ""):
    """``fn(name, leaf)`` over the leaves of ``tree``, in its structure and
    the reference's flattening order; ``name`` is the leaf's flat name.
    ``None`` is an empty subtree."""
    def sub(key, value):
        return _map_with_path(fn, value, f"{path}{_SEP}{key}" if path else str(key))

    if isinstance(tree, dict):
        return {k: sub(k, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub(f, v) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(i, v) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _flatten(tree) -> dict:
    """``{flat name: leaf}`` in the reference's flattening order."""
    items: dict = {}
    _map_with_path(items.__setitem__, tree)
    return items


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host array (a tensor copied off its device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host(tree) -> dict[str, np.ndarray]:
    """The tree's leaves as host arrays by flat name."""
    return {k: _to_host(v) for k, v in _flatten(tree).items()}


def save_checkpoint(root: str | os.PathLike, step: int, tree,
                    metadata: dict | None = None):
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = _host(tree)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    with open(tmp / "manifest.json") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(root: str | os.PathLike) -> int | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(root: str | os.PathLike, step: int, like_tree):
    """Restore into the structure of ``like_tree``: ``(tree, metadata)``,
    each leaf the numpy array saved under its flat name."""
    path = Path(root) / f"step_{step:08d}"
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    manifest = _read_manifest(path)
    data = _read_arrays(path, manifest)
    missing = [k for k in _flatten(like_tree) if k not in data]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")
    return _map_with_path(lambda k, _: data[k], like_tree), manifest["metadata"]


def load_arrays(root: str | os.PathLike, step: int):
    """Raw restore: ``(arrays: dict[str, np.ndarray], metadata: dict)``
    without a ``like_tree``.  Used by snapshot consumers (the streaming
    engine's restore path) whose keys are data-dependent — which tenants
    hold GP blocks, how many trials have run — and therefore unknowable
    before the snapshot itself is read."""
    path = Path(root) / f"step_{step:08d}"
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    manifest = _read_manifest(path)
    return _read_arrays(path, manifest), manifest["metadata"]


class CheckpointManager:
    """Async save + retention.  One writer thread; ``wait()`` joins pending."""

    def __init__(self, root: str | os.PathLike, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self._pending: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._writer_lock = threading.Lock()   # one writer at a time
        self._saved_steps: set[int] = set()

    def save(self, step: int, tree, metadata: dict | None = None,
             blocking: bool = True):
        with self._lock:
            if step in self._saved_steps:
                return
            self._saved_steps.add(step)
        # a host copy now, in the tree's structure (its flattening order)
        host_tree = _map_with_path(lambda _, v: np.array(_to_host(v)), tree)

        def work():
            with self._writer_lock:
                save_checkpoint(self.root, step, host_tree, metadata)
                self._gc()

        if blocking:
            work()
        else:
            t = threading.Thread(target=work, daemon=True)
            t.start()
            with self._lock:
                self._pending.append(t)

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    def restore_latest(self, like_tree):
        step = latest_step(self.root)
        if step is None:
            return None
        tree, meta = load_checkpoint(self.root, step, like_tree)
        return step, tree, meta

    def _gc(self):
        steps = sorted(p for p in self.root.glob("step_*") if not p.name.endswith(".tmp"))
        for p in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(p, ignore_errors=True)
